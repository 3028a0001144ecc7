from .train_step import TrainConfig, init_train_state, make_train_step

__all__ = ["TrainConfig", "init_train_state", "make_train_step"]
