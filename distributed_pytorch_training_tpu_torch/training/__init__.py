"""Training: optimizers, state, tasks and the Trainer (single device)."""

from .loop import Trainer, TrainConfig  # noqa: F401
from .optim import make_optimizer, make_schedule  # noqa: F401
from .train_state import TrainState  # noqa: F401
