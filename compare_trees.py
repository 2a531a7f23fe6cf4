"""Time the port's two earliest main paths in two checkouts, in one call.

    python3 compare_trees.py PARENT_DIR [CHANGE_DIR]

Runs parent, change, change, parent (``CHANGE_DIR`` defaults to this
script's directory), each in a process of its own with that checkout's
package first on ``sys.path``, so one card and one host serve both trees.
Each run builds (or loads) its checkout's kernels, then measures on the
card, bf16, with seeded random weights at full width (``config.sbl()``):

- recognize at B=512: clips/s over 5 batches after a warm-up (host clock
  ending in a synchronise), as ``chip_smoke.py`` phase 4 does;
- the ``sbl`` train step at B=240: ms/step over 5 steps on one resident
  batch after 2 warm-up steps, as phase 5 does.

Each run prints one JSON line; the last lines are the card's name and power
limit and a JSON summary, also written to ``chiprun_out/compare_trees.json``.
Needs a CUDA card; both checkouts need the port's package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
RECOGNIZE_BATCH = 512
RECOGNIZE_BATCHES = 5
TRAIN_BATCH = 240
TRAIN_WARMUP = 2
TRAIN_TIMED = 5
PKG = "sbl_for_multilingual_lip_reading_tpu_torch"


def child(tree: str) -> dict:
    """One checkout's measurements (runs in its own process)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    pkg = __import__(PKG)
    if not Path(pkg.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"{PKG} came from {pkg.__file__}, not {tree}")
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch.data import (
        Batcher, SyntheticLipDataset)
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.ops import _build
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
        recognize_batch)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
        make_optimizer)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        make_sbl_train_step)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (
        attach_plans)

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    cfg = C.sbl()
    T, raw, crop = cfg.data.frames, cfg.data.raw_size, cfg.data.crop_size

    model = build_model(cfg, dev, seed=0)
    clips = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(RECOGNIZE_BATCH, T, raw, raw), dtype=np.uint8)).to(dev)
    recognize_batch(model, clips, crop)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RECOGNIZE_BATCHES):
        out = recognize_batch(model, clips, crop)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    if not bool(torch.isfinite(out.logits_l2r).all()):
        raise RuntimeError("non-finite recognize logits")
    del model, clips, out
    torch.cuda.empty_cache()

    model = build_model(cfg, dev, seed=0)
    data = SyntheticLipDataset(size=TRAIN_BATCH, frames=T, raw_size=raw, seed=0)
    b = attach_plans(next(iter(Batcher(data, TRAIN_BATCH, seed=2))),
                     np.random.default_rng(2), cfg)
    batch = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in b.items()}
    step = make_sbl_train_step(model, make_optimizer(model, cfg.optim), cfg)
    gen = torch.Generator().manual_seed(3)
    for _ in range(TRAIN_WARMUP):
        step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(batch, gen)["loss"] for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_TIMED
    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses {losses}")
    return dict(tree=tree, build_s=build_s,
                recognize_clips_per_s=RECOGNIZE_BATCHES * RECOGNIZE_BATCH / rec_s,
                train_ms_per_step=step_s * 1e3,
                train_clips_per_s=TRAIN_BATCH / step_s,
                train_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                losses=losses)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device", file=sys.stderr)
        return 1
    if not argv or len(argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = str(Path(argv[0]).resolve())
    change = str(Path(argv[1]).resolve()) if len(argv) > 1 else str(HERE)
    runs = []
    for label, tree in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--child", tree], cwd=tree, capture_output=True,
                             text=True, timeout=900, check=False)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            raise RuntimeError(f"{label} run in {tree} failed")
        run = dict(json.loads(res.stdout.strip().splitlines()[-1]), label=label)
        print(json.dumps(run), flush=True)
        runs.append(run)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False).stdout.strip()
    summary = {k: {lab: [r[k] for r in runs if r["label"] == lab]
                   for lab in ("parent", "change")}
               for k in ("recognize_clips_per_s", "train_ms_per_step",
                         "train_peak_gb")}
    summary["card"] = smi
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "compare_trees.json").write_text(json.dumps(dict(runs=runs,
                                                            summary=summary)))
    print(smi)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
