"""Tracing and step timing of the training loop (counterpart of the JAX
package's ``utils/profiler.py``).

``Trace`` is ``--profile-dir``'s trace: ``torch.profiler`` over CPU and, on
a card, CUDA activity (the kernels by symbol, with device times), written
as a Chrome trace (``trace.json``, one ``trace_rank<r>.json`` a process in
a data-parallel run) for chrome://tracing or ui.perfetto.dev; the trainer
takes it over steps 1-3 of the first epoch, as JAX's ``jax.profiler`` trace
(JAX ``training/trainer.py:492-506``).  ``StepTimer`` is the rolling
step-time tracker."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class Trace:
    """A ``torch.profiler`` trace written to ``<logdir>/<name>`` when it
    stops."""

    def __init__(self, logdir: str, device, name: str = "trace.json"):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.path = os.path.join(logdir, name)
        os.makedirs(logdir, exist_ok=True)
        self._prof: Optional[torch.profiler.profile] = torch.profiler.profile(
            activities=activities)
        self._prof.start()

    def stop(self) -> str:
        """Stop (once) and write the trace; returns its path."""
        if self._prof is not None:
            self._prof.stop()
            self._prof.export_chrome_trace(self.path)
            self._prof = None
        return self.path


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
