from morphganformer_tpu_torch.training.loss import LossConfig  # noqa: F401
from morphganformer_tpu_torch.training.train_step import (  # noqa: F401
    GANTrainer,
    TrainConfig,
    TrainState,
)
