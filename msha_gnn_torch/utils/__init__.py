from .config import TrainConfig
from .logging import JsonlLogger
from .prof import StepTimer, annotate, trace

__all__ = ["JsonlLogger", "StepTimer", "TrainConfig", "annotate", "trace"]
