from .diffusion_trainer import DiffusionConfig, DiffusionTrainer
from .ema import ema_update
from .trainer import Trainer, TrainerConfig

__all__ = ["DiffusionConfig", "DiffusionTrainer", "Trainer", "TrainerConfig", "ema_update"]
