from .config import TrainConfig
from .logging import JsonlLogger

__all__ = ["JsonlLogger", "TrainConfig"]
