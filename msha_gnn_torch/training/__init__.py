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
from .losses import bce_loss, nll_loss
from .metrics import (
    accuracy,
    binary_auc,
    classification_report,
    f1,
    hits_at_k,
    multiclass_auc,
    precision_recall,
)
from .optim import adam_l2, sgd_momentum
from .tasks import (flow_inputs, gat_task, gcn_task, hgane_task, msha_task,
                    sage_task)
from .trainer import (
    Task,
    Trainer,
    TrainState,
    make_eval_multi_step,
    make_eval_step,
    make_train_multi_step,
    make_train_step,
)

__all__ = [
    "LinkPredConfig",
    "LinkPredModel",
    "Task",
    "TrainState",
    "Trainer",
    "accuracy",
    "adam_l2",
    "bce_loss",
    "binary_auc",
    "build_link_prediction",
    "classification_report",
    "evaluate",
    "f1",
    "flow_inputs",
    "gat_task",
    "gcn_task",
    "hgane_task",
    "hits_at_k",
    "latest_step",
    "linkpred_loss",
    "make_eval_multi_step",
    "make_eval_step",
    "make_train_multi_step",
    "make_train_step",
    "msha_task",
    "multiclass_auc",
    "nll_loss",
    "precision_recall",
    "restore_checkpoint",
    "run_link_prediction",
    "sage_task",
    "save_checkpoint",
    "sgd_momentum",
    "train_step",
]
