"""The first train step's memory guard (counterpart of the JAX package's
``training/memguard.py::GuardedTrainStep``).

JAX checks XLA's compiled-memory estimate against the device before the
first dispatch and, when the step does not fit, rebuilds it once with
``remat_frontend=True`` (JAX ``training/trainer.py:192-202``).  PyTorch has
no such estimate, so the guard measures instead: the first step runs, and
if it runs out of card memory (``torch.cuda.OutOfMemoryError``) before its
optimizer update began, the guard frees what the failed step held, logs,
makes the step recompute the frontend (``rebuild``) and runs it once more
on the same batch and random state.  If that fails too, or no rebuild is
left, it raises ``MemoryError`` with the peak the card saw
(``torch.cuda.max_memory_allocated``) and its capacity
(``torch.cuda.mem_get_info``).  It never retries more than once and never
moves work to the CPU.  Later steps run unguarded: an OOM there is an
error, as any other.
"""
from __future__ import annotations

import gc
from typing import Callable, Optional, Tuple

import torch

GIB = 2 ** 30


def card_memory(device) -> Tuple[int, int]:
    """(peak bytes allocated, the card's capacity in bytes) of ``device``."""
    return (torch.cuda.max_memory_allocated(device),
            torch.cuda.mem_get_info(device)[1])


class GuardedTrainStep:
    """Calls ``step(batch, generator, ...)`` (a step of
    ``training/steps.py``; or ``fused(i, None, ...)``, the epoch-fused step,
    which takes its batch from the epoch's constants and no generator),
    guarding the first call.  ``rebuild()`` returns
    the cheaper step (the Trainer's turns ``remat_frontend`` on); ``memory``
    returns (peak, capacity) in bytes for the message (default
    ``card_memory`` of the step's device).  ``rebuilt`` tells whether the
    rebuild ran."""

    def __init__(self, step: Callable, rebuild: Optional[Callable] = None,
                 logger=None,
                 memory: Optional[Callable[[], Tuple[int, int]]] = None):
        self.step = step
        self._rebuild = rebuild
        self._logger = logger
        self._memory = memory
        self.rebuilt = False
        self._first = True

    @property
    def state(self):
        return self.step.state

    def _numbers(self) -> str:
        device = next(self.step.state.model.parameters()).device
        peak, cap = (self._memory or (lambda: card_memory(device)))()
        return (f"peak {peak / GIB:.2f} GiB allocated of the card's "
                f"{cap / GIB:.2f} GiB")

    def _free(self) -> None:
        self.step.state.optimizer.zero_grad(set_to_none=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _attempt(self, batch, generator, args, kw):
        """(metrics, None) or (None, the OOM's text); the exception (and
        the tensors its frames hold) is gone when this returns."""
        try:
            return self.step(batch, generator, *args, **kw), None
        except torch.cuda.OutOfMemoryError as e:
            if getattr(self.step, "updating", False):
                raise MemoryError(
                    f"out of memory inside the first optimizer update "
                    f"({self._numbers()}); not retried, the update may have "
                    f"begun: {e}") from e
            return None, str(e).splitlines()[0]

    def __call__(self, batch, generator: Optional[torch.Generator], *args, **kw):
        if not self._first:
            return self.step(batch, generator, *args, **kw)
        # the epoch-fused step (batch: its index) draws from no generator
        rng_state = None if generator is None else generator.get_state()
        out, oom = self._attempt(batch, generator, args, kw)
        if oom is not None:
            self._free()
            if self._rebuild is None:
                raise MemoryError(f"the first train step ran out of memory "
                                  f"({self._numbers()}): {oom}")
            if self._logger:
                self._logger.warning(
                    f"the first train step ran out of memory "
                    f"({self._numbers()}); retrying once with "
                    f"remat_frontend=True")
            self.step = self._rebuild()
            self.rebuilt = True
            if generator is not None:
                generator.set_state(rng_state)
            out, oom = self._attempt(batch, generator, args, kw)
            if oom is not None:
                self._free()
                raise MemoryError(
                    f"the first train step ran out of memory with "
                    f"remat_frontend=True too ({self._numbers()}); reduce "
                    f"batch_size: {oom}")
        self._first = False
        return out
