"""Fault-tolerant training driver: checkpoint/restart, watchdog, injection.

Port of ``repro/train/fault.py``.  Everything stateful lives in (state,
step); the data stream is seekable (data/synthetic.py), so crash ->
restore -> replay repeats the run bit for bit where every op on the path
is deterministic.  ``FaultInjector`` simulates node failures at chosen
steps.

Straggler policy: the watchdog times every step against an SLO budget
(EMA-relative), on work that has finished: the driver synchronizes the
card where the reference calls ``block_until_ready``.  One process logs
and carries on; the hook is where a fleet controller would swap in a
spare.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from repro_torch.train.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.fault")


class InjectedFault(RuntimeError):
    """Simulated node failure."""


@dataclasses.dataclass
class FaultInjector:
    """Raises InjectedFault the first time each listed step is reached."""
    fail_at_steps: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFault(f"injected failure at step {step}")


@dataclasses.dataclass
class Watchdog:
    """EMA step-time SLO: flags steps slower than ratio x EMA."""
    ratio: float = 3.0
    ema: Optional[float] = None
    slow_steps: int = 0

    def observe(self, dt: float, step: int):
        if self.ema is None:
            self.ema = dt
            return False
        slow = dt > self.ratio * self.ema
        if slow:
            self.slow_steps += 1
            log.warning("straggler: step %d took %.3fs (EMA %.3fs)",
                        step, dt, self.ema)
        self.ema = 0.9 * self.ema + 0.1 * dt
        return slow


def _finish(metrics: dict) -> None:
    """Wait for the card's work behind ``metrics`` (a no-op on the CPU)."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def run_training(
    *,
    init_state_fn: Callable[[], dict],
    train_step: Callable,                 # (state, batch) -> (state, metrics)
    stream,                               # .batch_at(step)
    ckpt: CheckpointManager,
    num_steps: int,
    ckpt_every: int = 50,
    device=None,
    state_shardings=None,
    injector: Optional[FaultInjector] = None,
    watchdog: Optional[Watchdog] = None,
    max_restarts: int = 10,
    log_every: int = 10,
    metrics_cb: Optional[Callable] = None,
):
    """Run to num_steps with restart-on-failure.  Returns (state, history).

    A restored checkpoint goes where ``state_shardings`` (a tree of
    ``NamedSharding``, ``train_step.state_shardings``) places it, the
    mesh's first device, or else on ``device`` (the card unless named)."""
    restarts = 0
    history = []
    state = None
    while True:
        try:
            if state is None:
                restored = ckpt.restore(device=device,
                                        shardings=state_shardings)
                if restored is not None:
                    state = restored
                    log.info("restored checkpoint at step %d",
                             int(state["step"]))
                else:
                    state = init_state_fn()
            step = int(state["step"])
            while step < num_steps:
                if injector is not None:
                    injector.check(step)
                batch = stream.batch_at(step)
                t0 = time.perf_counter()
                state, metrics = train_step(state, batch)
                if watchdog is not None:
                    _finish(metrics)    # time real work, not the enqueue
                dt = time.perf_counter() - t0
                if watchdog is not None:
                    watchdog.observe(dt, step)
                step = int(state["step"])
                if step % log_every == 0 or step == num_steps:
                    loss = float(metrics.get("loss", float("nan")))
                    history.append({"step": step, "loss": loss, "dt": dt})
                    if metrics_cb:
                        metrics_cb(step, metrics)
                if step % ckpt_every == 0 or step == num_steps:
                    ckpt.save_async(state, step)
            ckpt.wait()
            return state, history
        except InjectedFault as e:
            restarts += 1
            log.warning("%s -> restart %d/%d", e, restarts, max_restarts)
            if restarts > max_restarts:
                raise
            ckpt.wait()
            state = None        # force restore-from-latest on re-entry
