"""The two cached training routes on one CUDA card, side by side: the
epoch-fused route (the whole step one CUDA graph, replayed once a step) and
the per-step route (``SBL_NO_EPOCH_FUSED=1``: the batch gathered and the
step's kernels launched from the host every step).

    python3 -m sbl_for_multilingual_lip_reading_tpu_torch.profile_fused \\
        [--rounds 3] [--out DIR]

``config.sbl()`` in bf16 at B=240 with ``PALLAS_INGEST=1 PALLAS_BN=1``,
seeded random weights, on ``SyntheticPatternDataset`` clips resident on the
card (1,440 clips: 6 steps an epoch), with ``remat_frontend`` on and off.
For each setting:

* memory: each route alone in a fresh ``Trainer`` for two epochs (the
  first builds, warms up and captures), the card's peak allocated and
  reserved bytes (a graph's activations live in its private pool, which
  counts as reserved), and the capture's seconds;
* time: one ``Trainer`` a route, their epochs in turns (fused, per-step,
  per-step, fused, ...) for ``rounds`` rounds after one warm-up epoch each:
  ms/step of each epoch on the host clock, ended by a synchronize;
* trace: three steps of each route under ``torch.profiler`` (the fused
  route's are graph replays): kernels on the device a step, host-side
  launches a step (CUDA runtime calls that launch work: kernels, graphs,
  copies, sets), device time a step and the idle share of the window.

Prints a line per measurement, the card's nvidia-smi name and power limit,
and last one JSON line of everything; with ``--out`` also writes the JSON
there.  Runs only on a card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
from pathlib import Path
from typing import Dict, List

import torch

from . import config as C
from .profile_recognize import card_name

BATCH = 240
CLIPS = 1440
TRACE_STEPS = 3
# the CUDA API calls that put work on the card
_LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset",
                 "cuLaunchKernel", "LaunchCooperativeKernel")


@contextlib.contextmanager
def route(fused: bool):
    """The environment that selects a cached route (JAX's switch)."""
    old = os.environ.get("SBL_NO_EPOCH_FUSED")
    if fused:
        os.environ.pop("SBL_NO_EPOCH_FUSED", None)
    else:
        os.environ["SBL_NO_EPOCH_FUSED"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("SBL_NO_EPOCH_FUSED", None)
        else:
            os.environ["SBL_NO_EPOCH_FUSED"] = old


def switches_on() -> None:
    os.environ["PALLAS_INGEST"] = "1"
    os.environ["PALLAS_BN"] = "1"


def dataset(cfg):
    """CLIPS SyntheticPatternDataset clips (24 a word), built once."""
    from .data import SyntheticPatternDataset
    spw = 24
    ds = SyntheticPatternDataset(n_words=CLIPS // spw, samples_per_word=spw,
                                 frames=cfg.data.frames,
                                 raw_size=cfg.data.raw_size)
    for i in range(len(ds)):
        ds[i]
    return ds


def trainer(cfg, ds, device):
    from .training.trainer import Trainer
    return Trainer(cfg, ds, device=device, cache_on_device=True)


def timed_epoch(tr, epoch: int, fused: bool, max_steps=None) -> Dict:
    """One epoch of ``tr`` on a route: ms/step, its losses."""
    history: List[Dict[str, float]] = []
    with route(fused):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_epoch(epoch, max_steps=max_steps, history=history)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return dict(ms_per_step=dt * 1e3 / len(history),
                losses=[h["loss"] for h in history])


def memory(cfg, ds, device, fused: bool) -> Dict:
    """A fresh Trainer alone for two epochs on a route: peak GB allocated
    and reserved, the capture's seconds (fused) and the losses."""
    release()
    torch.cuda.reset_peak_memory_stats()
    tr = trainer(cfg, ds, device)
    runs = [timed_epoch(tr, e, fused) for e in range(2)]
    out = dict(peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               losses=runs[0]["losses"] + runs[1]["losses"])
    if fused:
        out["capture_s"] = tr.fused_step.capture_seconds
        out["captured_launches"] = tr.fused_step.captured_launches
        out["replays"] = tr.fused_step.replays
    del tr
    release()
    return out


def release() -> None:
    """Free the card's memory of dropped Trainers: a Trainer sits in
    reference cycles (its steps' closures), and its CUDA graph's private
    pool goes only with it."""
    gc.collect()
    torch.cuda.empty_cache()


def traced(tr, epoch: int, fused: bool) -> Dict:
    """TRACE_STEPS steps of ``tr`` on a route under torch.profiler: device
    kernels, host-side launches and device ms a step, the idle share."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    with route(fused):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_epoch(epoch, max_steps=TRACE_STEPS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_ms = host_launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels += 1
            device_ms += e.time_range.elapsed_us() / 1e3
        elif any(c in e.name for c in _LAUNCH_CALLS):
            host_launches += 1
    return dict(kernels_per_step=kernels / TRACE_STEPS,
                host_launches_per_step=host_launches / TRACE_STEPS,
                device_ms_per_step=device_ms / TRACE_STEPS,
                wall_ms_per_step=wall_ms / TRACE_STEPS,
                idle_share=max(0.0, 1.0 - device_ms / wall_ms))


def compare_routes(cfg, ds, device, rounds: int, log=print) -> Dict:
    """Memory alone, then the two routes' epochs in turns for ``rounds``
    rounds (fused first in even rounds, per-step first in odd ones) after a
    warm-up epoch each, then a traced window of each."""
    label = f"remat {'on' if cfg.remat_frontend else 'off'}"
    out = {"memory": {}, "ms_per_step": {"fused": [], "per_step": []}}
    for fused in (True, False):
        name = "fused" if fused else "per_step"
        out["memory"][name] = m = memory(cfg, ds, device, fused)
        log(f"{label} {name}: peak {m['peak_allocated_gb']:.2f} GB allocated, "
            f"{m['peak_reserved_gb']:.2f} GB reserved"
            + (f"; capture {m['capture_s']:.2f} s, {m['replays']} replays"
               if fused else ""))
    trs = {True: trainer(cfg, ds, device), False: trainer(cfg, ds, device)}
    for fused in (True, False):
        timed_epoch(trs[fused], 0, fused)
    for r in range(rounds):
        for fused in ((True, False) if r % 2 == 0 else (False, True)):
            ms = timed_epoch(trs[fused], 1 + r, fused)["ms_per_step"]
            out["ms_per_step"]["fused" if fused else "per_step"].append(ms)
    log(f"{label} ms/step, rounds in turns: fused "
        f"{[round(x, 1) for x in out['ms_per_step']['fused']]}, per-step "
        f"{[round(x, 1) for x in out['ms_per_step']['per_step']]}")
    out["trace"] = {}
    for fused in (True, False):
        name = "fused" if fused else "per_step"
        out["trace"][name] = t = traced(trs[fused], 1 + rounds, fused)
        log(f"{label} {name} traced {TRACE_STEPS} steps: "
            f"{t['kernels_per_step']:.0f} kernels and "
            f"{t['host_launches_per_step']:.0f} host-side launches a step, "
            f"{t['device_ms_per_step']:.1f} ms device of "
            f"{t['wall_ms_per_step']:.1f} ms a step, idle share "
            f"{t['idle_share']:.3f}")
    del trs
    release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fused: torch sees no CUDA device")
    device = torch.device("cuda", 0)
    switches_on()
    base = dataclasses.replace(C.sbl(), batch_size=BATCH)
    t0 = time.perf_counter()
    ds = dataset(base)
    print(f"{len(ds)} clips built in {time.perf_counter() - t0:.1f} s")
    result = {"card": card_name(), "clips": len(ds), "batch": BATCH,
              "dtype": base.compute_dtype}
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat_frontend=remat)
        result[f"remat_{'on' if remat else 'off'}"] = compare_routes(
            cfg, ds, device, args.rounds)
    print(result["card"])
    line = json.dumps(result)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "profile_fused.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
