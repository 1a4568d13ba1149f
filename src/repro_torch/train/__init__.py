from repro_torch.train.step import TrainConfig, build_train_step, init_state  # noqa: F401
from repro_torch.train import trainer  # noqa: F401
