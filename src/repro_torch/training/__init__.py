from .trainer import DistGNNTrainer, TrainJobConfig

__all__ = ["DistGNNTrainer", "TrainJobConfig"]
