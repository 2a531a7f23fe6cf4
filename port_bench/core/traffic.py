"""The generator of the benchmark's evaluation traffic: clips made from the
seed, and the closed loop with one batch in flight that an evaluation
entry (``entries/<entry>.py``) runs its batches under.  A mix is a data
file (``traffic/<name>.json``) of parameters; its ``entry`` names the file
of ``entries/`` that drives the program, so a new way to call the program
is a new file there, and a new mix of an existing entry is data alone.

Parameters every evaluation mix has:
    entry           the file of ``entries/`` that drives the program
    batch           clips a batch
    pool            pinned host batches, cycled
    warmup_batches  batches run in set-up (every shape the window uses)
    trace_batches   batches of the traced slice
    sample          batches judged after the window (one clip of each)
An entry may read more (the beam's width and bigram table).

Clips are uint8 (T, raw, raw) with the configuration's frames and raw size:
a smooth random field per clip (4 x 6 x 6 values, interpolated over time
and space) plus 20% per-pixel noise, so that clips differ as video does.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def make_clips(generator: torch.Generator, n: int, frames: int, raw: int,
               device) -> torch.Tensor:
    coarse = torch.rand((n, 1, 4, 6, 6), generator=generator, device=device)
    x = F.interpolate(coarse, size=(frames, raw, raw), mode="trilinear",
                      align_corners=False)[:, 0]
    x = 0.8 * x + 0.2 * torch.rand((n, frames, raw, raw), generator=generator,
                                   device=device)
    return (x * 255.0).to(torch.uint8)


class Timer:
    """Milliseconds of one batch: CUDA events on the card, from before the
    clips' copy to the device to after the answers' copy to the host; the
    host clock on the CPU (the tests' runs only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, start) -> float:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            e.synchronize()
            return start.elapsed_time(e)
        return (time.perf_counter() - start) * 1e3


class ClosedLoop:
    """Inputs from the seed and the closed loop over one entry of the
    program.  A subclass gives ``entry(clips) -> (served, logits)``: the
    device tensors the program served for the batch, and the per-step
    logits of the batch's judged row ``self.row`` (all rows where it is
    None) where the entry makes them, else None.  ``answers``: per batch,
    the host copies of both."""

    def __init__(self, model, cfg, mix: dict, seed: int, device):
        self.model, self.cfg, self.mix = model, cfg, mix
        self.seed, self.device = int(seed), torch.device(device)
        B, T, R = mix["batch"], cfg.data.frames, cfg.data.raw_size
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        pin = self.device.type == "cuda"
        self.pool = []
        for _ in range(mix["pool"]):
            host = torch.empty((B, T, R, R), dtype=torch.uint8, pin_memory=pin)
            host.copy_(make_clips(g, B, T, R, self.device))
            self.pool.append(host)
        self.clips = torch.empty((B, T, R, R), dtype=torch.uint8, device=self.device)
        self.rows = np.random.default_rng([self.seed, 3])
        self.timer = Timer(self.device)
        self.row: Optional[int] = None   # the judged row of the batch; None: all
        self.on_served = None            # called when the entry has returned
        self.host: Optional[List[torch.Tensor]] = None
        self.answers: List[dict] = []
        self.latencies_ms: List[float] = []

    def entry(self, clips: torch.Tensor) -> Tuple[tuple, Optional[tuple]]:
        raise NotImplementedError

    def batch(self, i: int, keep: bool = True) -> float:
        """Run batch ``i`` (the pool's batch i mod pool); returns its ms."""
        row = self.row = int(self.rows.integers(self.mix["batch"])) if keep else 0
        t = self.timer.start()
        self.clips.copy_(self.pool[i % len(self.pool)], non_blocking=True)
        served, logits = self.entry(self.clips)
        if self.on_served is not None:
            self.on_served()
        outs = list(served) + ([] if logits is None else list(logits))
        if self.host is None:
            self.host = [torch.empty(o.shape, dtype=o.dtype,
                                     pin_memory=self.device.type == "cuda")
                         for o in outs]
        for h, o in zip(self.host, outs):
            h.copy_(o, non_blocking=True)
        ms = self.timer.stop(t)
        if keep:
            n = len(served)
            self.answers.append({"pool": i % len(self.pool), "row": row,
                                 "served": [h.clone() for h in self.host[:n]],
                                 "logits": [h.clone() for h in self.host[n:]]})
            self.latencies_ms.append(ms)
        return ms

    def answered(self) -> int:
        """Clips of the kept batches whose answers reached the host."""
        return sum(len(a["served"][0]) for a in self.answers)

    def release(self) -> None:
        """Drop the program's state this loop holds (the model, the device
        buffer, whatever the subclass names in ``held``); the answers and
        the pool stay."""
        self.model = self.clips = None
        for name in getattr(self, "held", ()):
            setattr(self, name, None)

    def sample(self, n: int) -> dict:
        """The judged sample after the window: ``n`` batches drawn from the
        seed, each with its judged row: the clips, what was served for
        them, and their logits where the entry serves them."""
        rng = np.random.default_rng([self.seed, 1])
        picks = sorted(rng.choice(len(self.answers), size=min(n, len(self.answers)),
                                  replace=False).tolist())
        chosen = [self.answers[p] for p in picks]
        clips = torch.stack([self.pool[a["pool"]][a["row"]] for a in chosen])
        served = [torch.stack([a["served"][k][a["row"]] for a in chosen])
                  for k in range(len(chosen[0]["served"]))]
        logits = [torch.stack([a["logits"][k] for a in chosen])
                  for k in range(len(chosen[0]["logits"]))]
        return {"clips": clips, "served": served, "logits": logits,
                "batches": picks}


class Spans:
    """The benchmark's spans around the program's layers in the traced
    slice: CUDA events from forward hooks on ``model.frontend`` (pre and
    post) and ``model.encoder`` (post), and at the batch's end, after the
    entry returned.  ``frontend`` and ``decode`` ms a batch."""

    def __init__(self, model):
        self.model = model
        self.cur: Dict[str, object] = {}
        self.rows = []

    def _mark(self, key):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.cur[key] = e

    def __enter__(self):
        m = self.model
        self.handles = [
            m.frontend.register_forward_pre_hook(lambda *_: self._mark("f0")),
            m.frontend.register_forward_hook(lambda *_: self._mark("f1")),
            m.encoder.register_forward_hook(lambda *_: self._mark("e1"))]
        return self

    def served(self) -> None:
        self._mark("end")
        self.rows.append(self.cur)
        self.cur = {}

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def ms(self) -> Dict[str, list]:
        torch.cuda.synchronize()
        out = {"frontend": [], "decode": []}
        for r in self.rows:
            if all(k in r for k in ("f0", "f1", "e1", "end")):
                out["frontend"].append(r["f0"].elapsed_time(r["f1"]))
                out["decode"].append(r["e1"].elapsed_time(r["end"]))
        return out


class EvalPart:
    """The part of a run an evaluation entry plays: batches of clips under
    the closed loop.  An entry's ``Part`` gives ``make_loop()`` (its
    ``ClosedLoop``), ``expected_launches()`` (kernel launches a batch) and
    ``judge(state, control)``; the end-to-end values are the window's
    clips a second and the 90th percentile of its batches' latency."""

    def __init__(self, torch_mod, model, cfg, conf, mix, seed, dev):
        from sbl_for_multilingual_lip_reading_tpu_torch import ops
        self.ops, self.cfg, self.conf, self.mix = ops, cfg, conf, mix
        self.model, self.seed, self.dev = model, int(seed), dev
        self.loop = self.make_loop()
        self.i = 0

    def make_loop(self) -> ClosedLoop:
        raise NotImplementedError

    def expected_launches(self) -> Dict[str, int]:
        raise NotImplementedError

    def set_up(self) -> None:
        for i in range(self.mix["warmup_batches"]):
            self.loop.batch(i, keep=False)

    def window(self, seconds: float) -> dict:
        self.before = self.ops.launch_counts()
        start = time.perf_counter()
        while True:
            self.loop.batch(self.i)
            self.i += 1
            if time.perf_counter() - start >= seconds:
                break
        self.after = self.ops.launch_counts()
        clips = self.i * self.mix["batch"]
        return {"batches": self.i, "clips": clips, "attempted": clips,
                "failed": clips - self.loop.answered()}

    def spans(self, model) -> dict:
        # a slice of its own: the profiler's cost on the host would
        # stretch the decode loop's spans
        with Spans(model) as sp:
            self.loop.on_served = sp.served
            self.traced_slice()
            self.loop.on_served = None
        return sp.ms()

    def traced_slice(self) -> None:
        for _ in range(self.mix["trace_batches"]):
            self.loop.batch(self.i, keep=False)
            self.i += 1

    def path_numbers(self, cuda: bool) -> dict:
        """Launches a batch as the entry's path makes them on the card (the
        CPU takes the kernels' plain versions and counts none), and the
        clips left unanswered."""
        want = self.expected_launches() if cuda else {}
        n = len(self.loop.answers)
        return {"launches_off": float(launches_off(self.before, self.after, n, want)),
                "unanswered": float(n * self.mix["batch"] - self.loop.answered())}

    def release(self) -> None:
        self.sample = self.loop.sample(self.mix["sample"])
        self.loop.release()
        self.model = None

    def judge(self, state, control: bool = False) -> dict:
        raise NotImplementedError

    def end_to_end(self, window: dict) -> dict:
        lat = self.loop.latencies_ms
        return {"recognize_clips_per_s": window["clips"] / window["seconds"],
                "recognize_batch_p90_ms": p90(lat) if lat else None}


def launches_off(before: dict, after: dict, batches: int, want: dict) -> int:
    """How far the kernel launches of ``batches`` batches (the counters
    ``after`` less ``before``) lie from ``want`` a batch, summed over the
    kernels."""
    return sum(abs((after[k] - before[k]) - batches * want.get(k, 0)) for k in after)


def p90(values) -> float:
    """The 90th percentile (Python's inclusive quantiles; one value is its
    own)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[8]
