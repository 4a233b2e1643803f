from .config import LLPConfig, SGAEConfig, TrainConfig
from .logging import JsonlLogger
from .prof import span, trace

__all__ = ["JsonlLogger", "LLPConfig", "SGAEConfig", "TrainConfig", "span",
           "trace"]
