from .config import LLPConfig, SGAEConfig, TrainConfig
from .logging import JsonlLogger
from .prof import StepTimer, annotate, trace

__all__ = ["JsonlLogger", "LLPConfig", "SGAEConfig", "StepTimer",
           "TrainConfig", "annotate", "trace"]
