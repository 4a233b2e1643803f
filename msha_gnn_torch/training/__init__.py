from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .link_prediction import (
    LinkPredConfig,
    LinkPredModel,
    build_link_prediction,
    evaluate,
    linkpred_loss,
    run_link_prediction,
    train_step,
)
from .losses import bce_loss
from .metrics import binary_auc, hits_at_k
from .optim import adam_l2
from .tasks import flow_inputs, gcn_task
from .trainer import Task

__all__ = [
    "LinkPredConfig",
    "LinkPredModel",
    "Task",
    "adam_l2",
    "bce_loss",
    "binary_auc",
    "build_link_prediction",
    "evaluate",
    "flow_inputs",
    "gcn_task",
    "hits_at_k",
    "linkpred_loss",
    "run_link_prediction",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "train_step",
]
