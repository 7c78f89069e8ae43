"""Training substrate: optimizers, grad machinery (``grad.compressed_psum``
among it), steps and their shardings, checkpoint, fault (port of
``repro/train``), and the serving steps (``serve_step``)."""

from repro_torch.train.optimizer import (
    OPTIMIZERS, adafactor, adamw, warmup_cosine,
)
from repro_torch.train.train_step import (
    batch_shardings, init_state, make_optimizer, make_train_step,
    state_shardings,
)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import (
    FaultInjector, InjectedFault, Watchdog, run_training,
)

__all__ = [
    "OPTIMIZERS", "adamw", "adafactor", "warmup_cosine",
    "init_state", "make_optimizer", "make_train_step", "state_shardings",
    "batch_shardings",
    "CheckpointManager", "FaultInjector", "InjectedFault", "Watchdog",
    "run_training",
]
