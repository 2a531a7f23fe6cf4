"""Where the time of one recognize batch goes, on one CUDA card.

    python3 -m sbl_for_multilingual_lip_reading_tpu_torch.profile_recognize \\
        [--batch 512] [--out DIR]

Builds ``config.sbl()`` at full width with seeded random weights (bf16, the
kernel path), recognizes one warm-up batch of random uint8 clips, then:

* stage split: CUDA events at the stage boundaries of one batch (ingest,
  frontend, encoder, decoder), so each figure is device-timeline time,
  gaps where the card waited for the host included;
* one batch under ``torch.profiler``: device time per kernel name and per
  ``aten`` op, the total device (kernel) time, the kernel launch count, the
  batch's host-clock wall time, and the device's idle share of it (the
  profiler's own host overhead is inside that wall time).

Prints the tables and, last, one JSON line of the numbers; with ``--out``
also writes that JSON and the chrome trace there.
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
from .data.ingest import device_ingest
from .models import build_model
from .models.layers import cast_dense_weights
from .recognize import recognize_batch

TOP = 20


def stage_split(model, clips, crop):
    """ms per stage of one batch, from CUDA events on the current stream
    (the once-per-batch weight cast counts in ingest)."""
    names = ("ingest", "frontend", "encoder", "decoder")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    with torch.inference_mode():
        events[0].record()
        with cast_dense_weights(model):
            video = device_ingest(clips, crop, model.frontend.dtype)
            events[1].record()
            feats = model.frontend(video)
            events[2].record()
            enc = model.encoder(feats)
            events[3].record()
            model.decoder.decode(enc)
            events[4].record()
    torch.cuda.synchronize()
    return {n: events[i].elapsed_time(events[i + 1]) for i, n in enumerate(names)}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_recognize: torch sees no CUDA device")
    dev = torch.device("cuda", 0)
    smi = card_name()
    cfg = C.sbl()
    crop = cfg.data.crop_size
    model = build_model(cfg, dev, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    clips = torch.from_numpy(rng.integers(
        0, 256, size=(args.batch, cfg.data.frames, cfg.data.raw_size,
                      cfg.data.raw_size), dtype=np.uint8)).to(dev)
    recognize_batch(model, clips, crop)                   # warm-up
    stages = stage_split(model, clips, crop)
    trace = None
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        trace = args.out / "recognize_trace.json"
    profiled = profile_call(lambda: recognize_batch(model, clips, crop), trace)
    report(f"recognize B={args.batch} bf16", smi, args.batch, stages, profiled,
           args.out / "recognize_profile.json" if args.out else None)
    return 0


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
    print("stage split (ms): " + ", ".join(
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


if __name__ == "__main__":
    raise SystemExit(main())
