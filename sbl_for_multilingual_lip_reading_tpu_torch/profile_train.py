"""Where the time of one train step goes, on one CUDA card.

    python3 -m sbl_for_multilingual_lip_reading_tpu_torch.profile_train \\
        [--batch 240] [--out DIR]

Builds ``config.sbl()`` at full width with seeded random weights (bf16, the
kernel path, dropout on, each decode step checkpointed), runs two warm-up
steps on one batch of synthetic clips with their augmentation plans, then:

* stage split: CUDA events at the step's stage boundaries (ingest, forward,
  backward, optimizer), device-timeline time, gaps included;
* one step under ``torch.profiler``: the tables and totals that
  ``profile_recognize`` prints (device time per kernel and per ``aten`` op,
  launches, wall time, the device's idle share).

Prints the tables and, last, one JSON line of the totals; with ``--out``
also writes the JSON and the chrome trace there.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from . import config as C
from .data import Batcher, SyntheticLipDataset
from .models import build_model
from .profile_recognize import card_name, profile_call, report
from .training.schedule import make_optimizer
from .training.steps import make_sbl_train_step
from .training.trainer import attach_plans

WARMUP_STEPS = 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=240)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: torch sees no CUDA device")
    dev = torch.device("cuda", 0)
    cfg = C.sbl()
    model = build_model(cfg, dev, seed=args.seed)
    step = make_sbl_train_step(model, make_optimizer(model, cfg.optim), cfg)
    data = SyntheticLipDataset(size=args.batch, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=args.seed)
    batch = attach_plans(next(iter(Batcher(data, args.batch, seed=args.seed))),
                         np.random.default_rng(args.seed), cfg)
    batch = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}
    generator = torch.Generator().manual_seed(args.seed)
    for _ in range(WARMUP_STEPS):
        step(batch, generator)
    marks = []
    step(batch, generator, marks=marks)
    torch.cuda.synchronize()
    stages = {name: a.elapsed_time(b)
              for (_, a), (name, b) in zip(marks, marks[1:])}
    trace = None
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        trace = args.out / "train_trace.json"
    profiled = profile_call(lambda: step(batch, generator), trace)
    report(f"train step B={args.batch} bf16", card_name(), args.batch, stages,
           profiled, args.out / "train_profile.json" if args.out else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
