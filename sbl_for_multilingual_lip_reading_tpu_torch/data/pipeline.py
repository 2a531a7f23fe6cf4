"""Host batching, a producer thread, and prefetch to the card (counterpart
of the JAX package's ``data/pipeline.py``; its ``device_ingest`` is
``data/ingest.py`` here).

The host only assembles uint8 batches and small integer plans; the pixel
work runs on the device.  ``Batcher`` and ``background_iter`` are copies of
the JAX ones (the same order for the same seed); ``prefetch_to_device``
copies each batch from pinned host memory with ``non_blocking`` copies to
an explicit device, keeping ``size`` batches in flight.
"""
from __future__ import annotations

import collections
import queue as queue_mod
import threading
import time
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch


class Batcher:
    """Fixed-size batches of numpy arrays from an indexable dataset whose
    items are dicts of fixed-shape numpy arrays.  ``drop_last`` drops the
    ragged tail (every training batch has one shape); ``sampler`` yields
    lists of indices instead of the shuffled order.

    Multi-host: with ``process_index``/``process_count`` each process
    assembles its stripe ``idx[p::P]`` of every GLOBAL batch (batch_size is
    global; every process uses the same seed so the order agrees)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 sampler: Optional[Iterable] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.sampler = sampler
        self.process_index = process_index or 0
        self.process_count = process_count or 1
        if batch_size % self.process_count:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{self.process_count} processes")

    def __len__(self):
        if self.sampler is not None:
            return len(self.sampler)
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        for idx in self.index_batches():
            yield self._collate([self.dataset[i] for i in self._local(idx)])

    def index_batches(self) -> Iterator[np.ndarray]:
        """The GLOBAL index batches ``__iter__`` collates (each process its
        stripe of them), in the same order."""
        if self.sampler is not None:
            for idx_batch in self.sampler:
                yield np.asarray(idx_batch)
            return
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        stop = (len(order) // self.batch_size * self.batch_size
                if self.drop_last else len(order))
        for s in range(0, stop, self.batch_size):
            yield order[s:s + self.batch_size]

    def _local(self, global_idx):
        """This process's stripe of a global index batch: strided, so a
        ragged tail spreads over the processes and every index lands on
        exactly one."""
        if self.process_count == 1:
            return list(global_idx)
        return list(global_idx[self.process_index::self.process_count])

    @staticmethod
    def _collate(samples) -> dict:
        return {key: np.stack([s[key] for s in samples]) for key in samples[0]}


def background_iter(it: Iterable, depth: int = 1) -> Iterator:
    """Run ``it`` on a producer thread, keeping up to ``depth`` items queued,
    so batch assembly (plan draws, host gathers, a device-cache gather)
    overlaps the device's work.

    Producer exceptions re-raise in the consumer after the queued items.
    Closing the generator (or exhausting it) stops the thread and closes
    the wrapped iterator; the thread never blocks forever on a full queue
    once the consumer has stopped."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    end = object()
    err: list = []

    def run():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue_mod.Full:
                        continue
                if stop.is_set():
                    break
        except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
            err.append(e)
        finally:
            if stop.is_set():
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            # a timed put: after stop the consumer no longer reads the
            # sentinel, and an untimed put could block this thread forever
            while True:
                try:
                    q.put(end, timeout=0.1)
                    break
                except queue_mod.Full:
                    if stop.is_set():
                        break

    t = threading.Thread(target=run, daemon=True, name="batch-producer")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        # drain while joining: an in-flight put may refill the queue
        deadline = time.monotonic() + 5.0
        while t.is_alive() and time.monotonic() < deadline:
            try:
                q.get_nowait()
            except queue_mod.Empty:
                pass
            t.join(timeout=0.05)


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``: host
    arrays go through pinned memory with a non-blocking copy when the
    device is a card; tensors already there stay."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        if t.device != device and device.type == "cuda":
            if t.device.type == "cpu":
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        elif t.device != device:
            t = t.to(device)
        out[k] = t
    return out


def prefetch_to_device(it: Iterable[dict], device, size: int = 2
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Host -> device copies ``size`` batches ahead of the consumer, so the
    card does not wait on the bus (the copies run on the current stream,
    ordered before the steps that read them)."""
    pending = collections.deque()
    it = iter(it)
    for batch in it:
        pending.append(to_device(batch, device))
        if len(pending) == size:
            break
    while pending:
        batch = pending.popleft()
        nxt = next(it, None)
        if nxt is not None:
            pending.append(to_device(nxt, device))
        yield batch
