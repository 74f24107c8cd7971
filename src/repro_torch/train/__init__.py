"""Training of the port: the counterpart of ``repro.train``."""
from repro_torch.train.loop import TrainConfig, Trainer, make_train_step

__all__ = ["TrainConfig", "Trainer", "make_train_step"]
