"""Training substrate: optimizers, grad machinery, steps, checkpoint, fault
(port of ``repro/train``), and the serving steps (``serve_step``).

The reference's ``state_shardings``, ``batch_shardings`` and
``grad.compressed_psum`` come with the sharding item of ROADMAP 1.9."""

from repro_torch.train.optimizer import (
    OPTIMIZERS, adafactor, adamw, warmup_cosine,
)
from repro_torch.train.train_step import (
    init_state, make_optimizer, make_train_step,
)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import (
    FaultInjector, InjectedFault, Watchdog, run_training,
)

__all__ = [
    "OPTIMIZERS", "adamw", "adafactor", "warmup_cosine",
    "init_state", "make_optimizer", "make_train_step",
    "CheckpointManager", "FaultInjector", "InjectedFault", "Watchdog",
    "run_training",
]
