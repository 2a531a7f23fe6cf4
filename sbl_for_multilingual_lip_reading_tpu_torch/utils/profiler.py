"""Step-time tracker of the training loop (``StepTimer`` of the JAX
package's ``utils/profiler.py``; its ``trace`` wraps ``jax.profiler`` and
waits for the port's ``--profile-dir``, ROADMAP.md queue A item 13)."""
from __future__ import annotations

import contextlib
import time


class StepTimer:
    """Rolling step-time / throughput tracker on the host clock.

    >>> timer = StepTimer(batch_size=240)
    >>> with timer.step():
    ...     metrics = train_step(batch, generator)
    >>> timer.clips_per_sec

    A step's time is the host's: the device may still be running it, so a
    rolling mean over many steps is what it measures."""

    def __init__(self, batch_size: int, window: int = 50):
        self.batch_size = batch_size
        self.window = window
        self.times: list = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def mean_step_time(self) -> float:
        # drop the first step (kernel build, cuDNN's choice) when possible
        ts = self.times[1:] if len(self.times) > 1 else self.times
        return sum(ts) / max(len(ts), 1)

    @property
    def clips_per_sec(self) -> float:
        st = self.mean_step_time
        return self.batch_size / st if st > 0 else 0.0
