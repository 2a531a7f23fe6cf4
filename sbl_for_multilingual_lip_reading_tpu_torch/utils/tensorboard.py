"""Scalar metric logging (counterpart of the JAX package's
``utils/tensorboard.py``): TensorBoard event files through
``torch.utils.tensorboard`` when the ``tensorboard`` package is importable,
else one JSON line a scalar in ``<logdir>/metrics.jsonl`` ({"tag", "value",
"step", "time"}), as the JAX writer falls back when TensorFlow is missing."""
from __future__ import annotations

import json
import os
import time


class SummaryWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._tb = self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        else:
            self._tb = TBWriter(logdir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        else:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}) + "\n")
            self._jsonl.flush()

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
