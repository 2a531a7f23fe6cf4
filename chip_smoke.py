#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA card and the CUDA
toolkit (nvcc on PATH or under /usr/local/cuda).  It needs no network, and
imports nothing of JAX or of the JAX package.  Phases, each printing one
line (phase 2 adds nvcc's per-kernel register report):

  1. card   -- nvidia-smi's name and power limit, torch's device name;
  2. build  -- build (or load) the hand-written kernels from csrc/;
  3. kernels vs plain versions on the card, at the recognize path's shapes:
     K2 stack_frames bit-exact; K1 small_mha_flat within K1_TOL; CUDA-event
     times of both (median of TIMING_REPS after a warm-up);
  4. slice at the full config.sbl() width with seeded random weights:
     kernel path vs plain path at B=32 in f32 (TF32 off) and bf16, then the
     bf16 recognize path at B=512: launch counts, output checks, stage
     split, clips/s;
  5. a JSON line of the kernels, then the result line
     {"ok": true, "device": {...}}.

Any failed phase raises, so the script exits non-zero without the result
line; so it does when torch sees no CUDA device, and when the port's
package is not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# K1 against its plain version: f32 differs only in summation order; bf16
# outputs are rounded once from f32 on both sides, so they may sit one bf16
# ulp apart (2^-6 for |out| in [2, 4); |out| stays below 4 at these inputs)
K1_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the slice at B=SLICE_CHECK_BATCH: kernel path vs plain path, same card,
# weights and clips.  f32 differs in summation order only.  In bf16 a K1 or
# stem flip of one ulp moves the LayerNorms after it, so whole logits move
# by a few ulps (one is 2^-5 for |logit| in [4, 8)).
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
MIN_TOKEN_AGREEMENT = {"float32": 0.99, "bfloat16": 0.95}
TIMING_WARMUP = 3
TIMING_REPS = 20
SLICE_BATCH = 512
SLICE_CHECK_BATCH = 32
RATE_BATCHES = 5


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(torch, fn) -> float:
    """Median CUDA-event time of fn() in ms, after a warm-up."""
    for _ in range(TIMING_WARMUP):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_card(torch):
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    smi = res.stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 card: torch device 0 = {name}, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return smi, name


def phase_build():
    from sbl_for_multilingual_lip_reading_tpu_torch.ops import _build
    target = _build.library_path()
    cached = target.exists()
    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    print(f"phase 2 build: {seconds:.2f} s ({'loaded' if cached else 'built'}"
          f" {target.name} with {' '.join(_build.NVCC_FLAGS)})")
    log = target.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or ("spill" in line
                                  and "0 bytes spill stores, 0 bytes spill loads"
                                  not in line):
                print(f"  ptxas: {line.strip()}")
    return seconds


def phase_kernels(torch, dev):
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"stack_frames": [], "small_mha_flat": []}

    # K2 at the stem's shape: B=512 clips of 30 frames of 88x88
    for dt in (torch.bfloat16, torch.float32):
        video = torch.randn((SLICE_BATCH, 30, 88, 88), generator=g,
                            device=dev, dtype=dt)
        got = ops.stack_frames(video)
        want = ops.stack_frames_plain(video)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K2 {dt} is not bit-exact")
        ms = cuda_ms(torch, lambda: ops.stack_frames(video))
        plain_ms = cuda_ms(torch, lambda: ops.stack_frames_plain(video))
        results["stack_frames"].append(dict(
            case="stem (512,30,88,88)", dtype=str(dt).split(".")[-1],
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms))
        del video, got, want

    causal = ops.mask_to_bias(
        torch.ones(17, 17, dtype=torch.bool, device=dev).triu(1)[None], 17, 17)
    lengths = torch.randint(1, 18, (2 * SLICE_BATCH,), generator=g, device=dev)
    key_pad = ops.mask_to_bias(
        (torch.arange(17, device=dev)[None, :] >= lengths[:, None])[:, None],
        17, 17)
    masked_row = torch.zeros(1, 17, 17, device=dev)
    masked_row[0, 0] = ops.MASK_FILL
    long_pad = ops.mask_to_bias(
        torch.arange(150, device=dev)[None, None, :]
        >= torch.randint(1, 151, (64, 1, 1), generator=g, device=dev), 17, 150)
    cases = [  # (name, B, Tq, Tk, bias): the recognize path's shapes, H=8
        ("encoder (512,30,512)", SLICE_BATCH, 30, 30, None),
        ("decoder self (1024,17,512) causal", 2 * SLICE_BATCH, 17, 17, causal),
        ("cross (1024,17)x(1024,30)", 2 * SLICE_BATCH, 17, 30, None),
        ("per-batch bias (1024,17,17)", 2 * SLICE_BATCH, 17, 17, key_pad),
        ("masked row", 2 * SLICE_BATCH, 17, 17, masked_row),
        # off the path: the multi-chunk key loop (any Tk)
        ("extra: Tk=150", 64, 17, 150, None),
        ("extra: Tk=150 per-batch bias", 64, 17, 150, long_pad),
    ]
    H = 8
    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).split(".")[-1]
        for name, B, Tq, Tk, bias in cases:
            q = torch.randn((B, Tq, H * 64), generator=g, device=dev, dtype=dt)
            k = torch.randn((B, Tk, H * 64), generator=g, device=dev, dtype=dt)
            v = torch.randn((B, Tk, H * 64), generator=g, device=dev, dtype=dt)
            got = ops.small_mha_flat(q, k, v, H, bias=bias)
            want = ops.small_mha_flat_plain(q, k, v, H, bias=bias)
            err = (got.float() - want.float()).abs().max().item()
            check(err <= K1_TOL[name_dt] and torch.isfinite(got).all().item(),
                  f"K1 {name} {name_dt}: max abs err {err} > {K1_TOL[name_dt]}")
            ms = cuda_ms(torch, lambda: ops.small_mha_flat(q, k, v, H, bias=bias))
            plain_ms = cuda_ms(torch, lambda: ops.small_mha_flat_plain(
                q, k, v, H, bias=bias))
            results["small_mha_flat"].append(dict(
                case=name, dtype=name_dt, max_abs_err=err, ms=ms,
                plain_ms=plain_ms))
    for kernel, rows in results.items():
        for r in rows:
            print(f"phase 3 {kernel} {r['case']} {r['dtype']}: max abs err "
                  f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms")
    return results


def phase_slice(torch, np, dev):
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.profile_recognize import (
        stage_split)
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
        expected_launches, recognize_batch)
    from sbl_for_multilingual_lip_reading_tpu_torch.vocab import decode_ids

    cfg = C.sbl()
    T, raw, crop = cfg.data.frames, cfg.data.raw_size, cfg.data.crop_size
    V, maxlen = cfg.decoder.vocab_size, cfg.decoder.maxlen
    rng = np.random.default_rng(0)

    def clips(batch):
        return torch.from_numpy(rng.integers(0, 256, size=(batch, T, raw, raw),
                                             dtype=np.uint8)).to(dev)

    # the kernel path against the plain path, same weights and clips
    small = clips(SLICE_CHECK_BATCH)
    for dtype in ("float32", "bfloat16"):
        runs = []
        for kernels in (True, False):
            model = build_model(dataclasses.replace(
                cfg, compute_dtype=dtype, use_pallas_attention=kernels),
                dev, seed=0)
            runs.append(recognize_batch(model, small, crop))
            del model
        torch.cuda.synchronize()
        kern, plain = runs
        diffs = [(a - b).abs() for a, b in ((kern.logits_l2r, plain.logits_l2r),
                                            (kern.logits_r2l, plain.logits_r2l))]
        first = max(d[:, 0].max().item() for d in diffs)
        every = max(d.max().item() for d in diffs)
        agree = torch.cat([(kern.ys_l2r == plain.ys_l2r)[:, 1:],
                           (kern.ys_r2l == plain.ys_r2l)[:, 1:]]).float().mean().item()
        print(f"phase 4 {dtype} B={SLICE_CHECK_BATCH} kernel vs plain path: "
              f"first-step logits max abs diff {first:.3g} (tol "
              f"{LOGIT_TOL[dtype]}), all steps {every:.3g}, token agreement "
              f"{agree:.4f} (min {MIN_TOKEN_AGREEMENT[dtype]})")
        check(first <= LOGIT_TOL[dtype],
              f"{dtype} first-step logits differ by {first}")
        check(agree >= MIN_TOKEN_AGREEMENT[dtype],
              f"{dtype} tokens agree only {agree}")
        del runs, kern, plain
    torch.cuda.empty_cache()

    # bf16 recognize at B=512: the main path
    model = build_model(cfg, dev, seed=0)
    batch = clips(SLICE_BATCH)
    recognize_batch(model, batch, crop)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = recognize_batch(model, batch, crop)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expected = expected_launches(cfg)
    print(f"phase 4 bf16 B={SLICE_BATCH} launches per batch: {launches} "
          f"(expected {expected})")
    check(launches == expected, f"launch counts {launches} != {expected}")
    for ys in (out.ys_l2r, out.ys_r2l):
        check(tuple(ys.shape) == (SLICE_BATCH, maxlen + 1),
              f"tokens shape {tuple(ys.shape)}")
        check(int(ys.min()) >= 0 and int(ys.max()) < V, "token out of range")
    for lg in (out.logits_l2r, out.logits_r2l):
        check(tuple(lg.shape) == (SLICE_BATCH, maxlen, V), "logits shape")
        check(bool(torch.isfinite(lg).all()), "non-finite logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # stage split of one batch (CUDA events at the stage boundaries)
    stages = stage_split(model, batch, crop)
    print("phase 4 bf16 stage split (device timeline, ms per batch): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))

    t0 = time.perf_counter()
    for _ in range(RATE_BATCHES):
        recognize_batch(model, batch, crop)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = RATE_BATCHES * SLICE_BATCH / dt
    words = [" ".join(decode_ids(out.ys_l2r[i].tolist())) for i in (0, 1)]
    print(f"phase 4 bf16 B={SLICE_BATCH}: {rate:.1f} clips/s "
          f"({dt / RATE_BATCHES * 1e3:.1f} ms per batch over {RATE_BATCHES} "
          f"batches), peak memory {peak_gb:.2f} GB; clip 0 l2r: "
          f"[{words[0]}]; clip 1 l2r: [{words[1]}]")
    return launches, rate


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs only "
              "on the card", file=sys.stderr)
        return 1
    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi, name = phase_card(torch)
    phase_build()
    kernels = phase_kernels(torch, dev)
    launches, rate = phase_slice(torch, np, dev)

    sources = {
        "small_mha_flat": ("sbl_for_multilingual_lip_reading_tpu_torch/csrc/attention.cu",
                           "sbl_for_multilingual_lip_reading_tpu/ops/attention.py:573"),
        "stack_frames": ("sbl_for_multilingual_lip_reading_tpu_torch/csrc/stem.cu",
                         "sbl_for_multilingual_lip_reading_tpu/ops/stem.py:39"),
    }
    # the headline row of each kernel: its busiest bf16 shape on the path
    headline = {"small_mha_flat": "decoder self (1024,17,512) causal",
                "stack_frames": "stem (512,30,88,88)"}
    rows = []
    for kernel, (source, replaces) in sources.items():
        head = next(r for r in kernels[kernel]
                    if r["case"] == headline[kernel] and r["dtype"] == "bfloat16")
        rows.append({"name": kernel, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[kernel],
                     "max_abs_err": max(r["max_abs_err"] for r in kernels[kernel]
                                        if r["dtype"] == "bfloat16"
                                        and not r["case"].startswith("extra")),
                     "ms": head["ms"], "plain_ms": head["plain_ms"],
                     "cases": kernels[kernel]})
    print(json.dumps({"kernels": rows, "card": smi,
                      "recognize_clips_per_s": rate}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
