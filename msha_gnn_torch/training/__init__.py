from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .tasks import flow_inputs, gcn_task
from .trainer import Task

__all__ = [
    "Task",
    "flow_inputs",
    "gcn_task",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
]
