"""The FQT training loop (PyTorch counterpart of ``repro.train``)."""
from repro_torch.train.step import (TrainConfig, TrainState, init_state,
                                    make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["TrainConfig", "TrainState", "init_state", "make_train_step",
           "Trainer", "TrainerConfig"]
