from repro_torch.train.loop import train_loop
from repro_torch.train.step import TrainState, init_train_state, make_train_step

__all__ = ["TrainState", "make_train_step", "init_train_state", "train_loop"]
