"""Where the time of one call of a main path goes, on one CUDA card.

    python3 -m sbl_for_multilingual_lip_reading_tpu_torch.profile_paths \\
        recognize|train [--batch B] [--seed S] [--out DIR]

Builds ``config.sbl()`` at full width with seeded random weights (bf16, the
kernel path).  ``recognize`` (B 512 by default): one warm-up batch of random
uint8 clips through ``recognize_batch``.  ``train`` (B 240 by default):
dropout on, each decode step checkpointed, two warm-up steps of the train
step on one batch of synthetic clips with their augmentation plans.  Then,
for either path:

* stage split: one call under ``torch.profiler`` with the program's spans
  recorded (``utils/profiler.py::stage_split``), each kernel's device time
  counted under the stage span that launched it -- recognize: ingest,
  frontend, encoder, decode; train: the ``train.*`` spans (ingest, forward,
  backward, optimizer) -- gaps left out;
* one call under ``torch.profiler``: device time per kernel name and per
  ``aten`` op, the total device (kernel) time, the kernel launch count, the
  call's host-clock wall time, and the device's idle share of it (the
  profiler's own host overhead is inside that wall time).

Prints the tables and, last, one JSON line of the totals; with ``--out``
also writes that JSON and the chrome trace there.  Whole paths are timed
by the benchmark (``port_bench/run.py``), in pairs of runs on one card; this
tool says where one call's time goes.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import config as C
from .utils.profiler import stage_split

TOP = 20
# the spans recognize_batch opens, in order
RECOGNIZE_STAGES = ("ingest", "frontend", "encoder", "decode")
TRAIN_WARMUP = 2


def _self_device_us(avg) -> float:
    return getattr(avg, "self_device_time_total", None) or getattr(
        avg, "self_cuda_time_total", 0.0)


def profile_call(fn, trace_path=None):
    """Profile one call of ``fn``; returns (per-kernel, per-aten-op,
    totals)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = kernels[e.name]
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    ops = [(a.key, a.count, _self_device_us(a) / 1e3)
           for a in prof.key_averages() if a.key.startswith("aten::")]
    ops = sorted((o for o in ops if o[2] > 0), key=lambda o: -o[2])
    device_ms = sum(ms for _, ms in kernels.values())
    totals = dict(wall_ms=wall_ms, device_ms=device_ms,
                  launches=sum(n for n, _ in kernels.values()),
                  idle_share=max(0.0, 1.0 - device_ms / wall_ms))
    table = sorted(((name, n, ms) for name, (n, ms) in kernels.items()),
                   key=lambda k: -k[2])
    return table, ops, totals


def card_name() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=False).stdout.strip()


def report(title, smi, batch, stages, profiled, json_path=None) -> None:
    """Print the totals, the stage split and the kernel and aten-op tables,
    then one JSON line of the totals; write all of it to ``json_path``."""
    kernels, ops, totals = profiled
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"{title}: wall {totals['wall_ms']:.1f} ms, device "
          f"{totals['device_ms']:.1f} ms, idle share {totals['idle_share']:.3f},"
          f" {totals['launches']} kernel launches")
    print("stage split (device ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    print(f"\ntop {TOP} kernels by device time:")
    for name, n, ms in kernels[:TOP]:
        print(f"  {ms:9.2f} ms {n:6d}x  {name[:110]}")
    print(f"\ntop {TOP} aten ops by self device time:")
    for name, n, ms in ops[:TOP]:
        print(f"  {ms:9.2f} ms {n:6d}x  {name}")
    result = dict(card=smi, batch=batch, stages_ms=stages, **totals,
                  kernels=[dict(name=k, launches=n, ms=ms)
                           for k, n, ms in kernels[:TOP]],
                  aten_ops=[dict(name=k, calls=n, ms=ms)
                            for k, n, ms in ops[:TOP]])
    if json_path is not None:
        json_path.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in (
        "card", "batch", "stages_ms", "wall_ms", "device_ms", "launches",
        "idle_share")}))


def recognize_call(cfg, dev, batch: int, seed: int):
    """One recognize batch of random clips, warmed up; (call, stages)."""
    from .models import build_model
    from .recognize import recognize_batch
    model = build_model(cfg, dev, seed=seed)
    rng = np.random.default_rng(seed)
    clips = torch.from_numpy(rng.integers(
        0, 256, size=(batch, cfg.data.frames, cfg.data.raw_size,
                      cfg.data.raw_size), dtype=np.uint8)).to(dev)

    def call():
        return recognize_batch(model, clips, cfg.data.crop_size)
    call()
    return call, RECOGNIZE_STAGES


def train_call(cfg, dev, batch: int, seed: int):
    """One train step on a resident batch, warmed up; (call, stages)."""
    from .data import Batcher, SyntheticLipDataset
    from .models import build_model
    from .training.schedule import make_optimizer
    from .training.steps import TRAIN_STAGES, make_sbl_train_step
    from .training.trainer import attach_plans
    model = build_model(cfg, dev, seed=seed)
    step = make_sbl_train_step(model, make_optimizer(model, cfg.optim), cfg)
    data = SyntheticLipDataset(size=batch, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=seed)
    host = attach_plans(next(iter(Batcher(data, batch, seed=seed))),
                        np.random.default_rng(seed), cfg)
    on_card = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in host.items()}
    generator = torch.Generator().manual_seed(seed)

    def call():
        return step(on_card, generator)
    for _ in range(TRAIN_WARMUP):
        call()
    return call, TRAIN_STAGES


# each path's call and default batch
PATHS = {"recognize": (recognize_call, 512), "train": (train_call, 240)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", choices=tuple(PATHS))
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (recognize 512, train 240)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit(f"profile_paths {args.path}: torch sees no CUDA device")
    build, default = PATHS[args.path]
    batch = args.batch or default
    call, names = build(C.sbl(), torch.device("cuda", 0), batch, args.seed)
    stages = stage_split(call, names)
    trace = None
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        trace = args.out / f"{args.path}_trace.json"
    profiled = profile_call(call, trace)
    report(f"{args.path} B={batch} bf16", card_name(), batch, stages, profiled,
           args.out / f"{args.path}_profile.json" if args.out else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
