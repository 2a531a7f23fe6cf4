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
  3b. the training kernels vs their plain versions at the B=240 train
     step's shapes, f32 and bf16: K5 dropout_keep_mask_flat bit-exact
     against the plain Philox, keep fraction KEEP_FRACTION; K3
     small_mha_dropout_fwd_flat and K4 small_mha_dropout_bwd_flat within
     TRAIN_TOL given K5's mask; K3 at rate 0 against K1; times of all
     three and their plain versions; max-pool tie gradients, card vs CPU;
  4. recognize slice at the full config.sbl() width with seeded random
     weights: kernel path vs plain path at B=32 in f32 (TF32 off) and bf16,
     then the bf16 recognize path at B=512: launch counts, output checks,
     stage split, clips/s;
  5. train slice at the full config.sbl() width: kernel path vs plain path
     for one step at B=TRAIN_CHECK_BATCH, f32 and bf16 (loss, every
     gradient, BN running statistics); the bf16 step at B=240 through
     training.trainer.train_steps (launch counts, finite loss, every
     parameter moved), then TRAIN_WARMUP + TRAIN_TIMED timed steps: ms/step,
     clips/s, peak memory, stage split;
  6. a JSON line of the kernels, then the result line
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
# training kernels against their plain versions on the same inputs and
# mask.  f32: summation order only (forward ~1e-6, gradients sum up to 30
# products of O(10) terms).  bf16: both round one f32 result, so they may
# sit one bf16 ulp apart (2^-7 relative), plus a floor at the tensor's scale
# for values near zero, where f32 noise exceeds an ulp.
TRAIN_TOL = {"float32": {"fwd": 1e-5, "grad": 1e-4},
             "bfloat16": {"rel": 2.0 ** -7, "floor": 2.0 ** -12}}
DROPOUT_RATE = 0.1
KEEP_FRACTION = (0.895, 0.905)
TRAIN_BATCH = 240
TRAIN_CHECK_BATCH = 16
TRAIN_WARMUP = 2
TRAIN_TIMED = 5
# one train step, kernel path vs plain path: same weights, batch and seeds,
# so the same masks.  f32 (TF32 off): attention sums in another order;
# bf16: one-ulp flips in K3/K4 move the LayerNorms after them.  Gradients
# compare per parameter as ||kernel - plain|| / ||plain||.
TRAIN_LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_GRAD_TOL = {"float32": 1e-3, "bfloat16": 0.1}
TRAIN_BN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


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


def _bf16_close(got, want):
    """Max abs error and whether every element is within one bf16 ulp of
    the plain value (2^-7 relative) plus the floor of TRAIN_TOL."""
    tol = TRAIN_TOL["bfloat16"]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = want.abs() * tol["rel"] + want.abs().max() * tol["floor"]
    return err.max().item(), bool((err <= bound).all())


def _train_close(got, want, kind):
    """(max abs error, within TRAIN_TOL): f32 absolute at the tensor's
    scale (``kind`` "fwd" or "grad"), bf16 in ulps."""
    if dtype_name(want) == "float32":
        err = (got - want).abs().max().item()
        tol = TRAIN_TOL["float32"][kind] * max(1.0, want.abs().max().item())
        return err, err <= tol
    return _bf16_close(got, want)


def dtype_name(t):
    return str(t.dtype).split(".")[-1]


def phase_train_kernels(torch, dev):
    """K3/K4/K5 against their plain versions at the train step's shapes."""
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    g = torch.Generator(device=dev).manual_seed(1)
    H, B = 8, TRAIN_BATCH
    L = 17
    causal = ops.mask_to_bias(
        torch.ones(L, L, dtype=torch.bool, device=dev).triu(1)[None], L, L)
    beyond = ops.mask_to_bias(
        (torch.arange(3, device=dev) > 1)[None, None, :], 3, 3)
    masked_row = torch.zeros(1, L, L, device=dev)
    masked_row[0, 0] = ops.MASK_FILL
    cases = [  # (name, rows, Tq, Tk, bias): the train step's shapes, H=8
        ("encoder (240,30,512)", B, 30, 30, None),
        ("decoder self (480,17,512) causal", 2 * B, L, L, causal),
        ("decoder self (480,3,512) prefix", 2 * B, 3, 3, beyond),
        ("cross (480,17)x(480,30)", 2 * B, L, 30, None),
        ("masked row (480,17,512)", 2 * B, L, L, masked_row),
    ]
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).split(".")[-1]
        for case, N, Tq, Tk, bias in cases:
            seed = 1000 + N * Tq + Tk
            q = torch.randn((N, Tq, H * 64), generator=g, device=dev, dtype=dt)
            k = torch.randn((N, Tk, H * 64), generator=g, device=dev, dtype=dt)
            v = torch.randn((N, Tk, H * 64), generator=g, device=dev, dtype=dt)
            dout = torch.randn((N, Tq, H * 64), generator=g, device=dev, dtype=dt)
            keep = ops.dropout_keep_mask_flat(N, Tq, Tk, H, seed, DROPOUT_RATE, dev)
            plain_keep = ops.dropout_keep_mask_flat_plain(N, Tq, Tk, H, seed,
                                                          DROPOUT_RATE, dev)
            torch.cuda.synchronize()
            check(torch.equal(keep, plain_keep), f"K5 {case}: mask differs "
                  "from the plain Philox")
            frac = keep.float().mean().item()
            if Tq * Tk >= 289:
                check(KEEP_FRACTION[0] <= frac <= KEEP_FRACTION[1],
                      f"K5 {case}: keep fraction {frac}")
            args = (q, k, v, H, bias, seed, DROPOUT_RATE, None)
            got = ops.small_mha_dropout_fwd_flat(*args)
            want = ops.small_mha_dropout_flat_plain(*args, keep=plain_keep)
            fwd_err, ok = _train_close(got, want, "fwd")
            check(ok and bool(torch.isfinite(got).all()),
                  f"K3 {case} {name_dt}: max abs err {fwd_err}")
            got0 = ops.small_mha_dropout_fwd_flat(q, k, v, H, bias, 0, 0.0)
            want0 = ops.small_mha_flat(q, k, v, H, bias=bias)
            k1_err, ok = _train_close(got0, want0, "fwd")
            check(ok, f"K3 at rate 0 vs K1 {case} {name_dt}: {k1_err}")
            grads = ops.small_mha_dropout_bwd_flat(*args, dout)
            wants = ops.small_mha_dropout_bwd_flat_plain(*args, dout,
                                                         keep=plain_keep)
            bwd_err = 0.0
            for which, a, b in zip("qkv", grads, wants):
                err, ok = _train_close(a, b, "grad")
                check(ok and bool(torch.isfinite(a).all()),
                      f"K4 {case} {name_dt} d{which}: max abs err {err}")
                bwd_err = max(bwd_err, err)
            rows.append(dict(
                case=case, dtype=name_dt, keep_fraction=frac,
                fwd_err=fwd_err, bwd_err=bwd_err, rate0_vs_k1_err=k1_err,
                fwd_ms=cuda_ms(torch, lambda: ops.small_mha_dropout_fwd_flat(*args)),
                fwd_plain_ms=cuda_ms(torch, lambda: ops.small_mha_dropout_flat_plain(*args)),
                bwd_ms=cuda_ms(torch, lambda: ops.small_mha_dropout_bwd_flat(*args, dout)),
                bwd_plain_ms=cuda_ms(torch, lambda: ops.small_mha_dropout_bwd_flat_plain(
                    *args, dout)),
                mask_ms=cuda_ms(torch, lambda: ops.dropout_keep_mask_flat(
                    N, Tq, Tk, H, seed, DROPOUT_RATE, dev)),
                mask_plain_ms=cuda_ms(torch, lambda: ops.dropout_keep_mask_flat_plain(
                    N, Tq, Tk, H, seed, DROPOUT_RATE, dev))))
    for r in rows:
        print(f"phase 3b {r['case']} {r['dtype']}: keep {r['keep_fraction']:.4f}; "
              f"K3 err {r['fwd_err']:.3g}, {r['fwd_ms']:.4f} ms (plain "
              f"{r['fwd_plain_ms']:.4f}); K4 err {r['bwd_err']:.3g}, "
              f"{r['bwd_ms']:.4f} ms (plain {r['bwd_plain_ms']:.4f}); K5 "
              f"bit-exact, {r['mask_ms']:.4f} ms (plain {r['mask_plain_ms']:.4f}); "
              f"K3 rate 0 vs K1 err {r['rate0_vs_k1_err']:.3g}")

    # max-pool tie gradients: the card's backward against the CPU's on a
    # post-ReLU bf16 input of small integers, full of ties (zeros and equal
    # values), with integer output gradients, so that every sum of them is
    # exact and only where each window's gradient goes is compared
    import torch.nn.functional as F
    x = torch.randint(-6, 6, (32, 64, 44, 44), generator=g, device=dev)
    x = torch.relu(x).to(torch.bfloat16)
    dy = torch.randint(-8, 8, (32, 64, 22, 22), generator=g, device=dev
                       ).to(torch.bfloat16)
    grads = []
    for d in (dev, torch.device("cpu")):
        xi = x.to(d, copy=True).requires_grad_(True)
        F.max_pool2d(xi, 3, 2, 1).backward(dy.to(d))
        grads.append(xi.grad.cpu())
    ties = (x == 0).float().mean().item()
    check(torch.equal(*grads), "max-pool tie gradients differ card vs CPU")
    print(f"phase 3b max pool (32,64,44,44) bf16, {ties:.2f} zeros: card "
          f"backward routes every tie as the CPU's does")
    return rows


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


def _grad_errors(kern, plain):
    """Per parameter ||kernel - plain|| / max(||plain||, 1e-3 * G), G the
    largest per-parameter gradient norm: the floor covers the gradients
    that are zero in exact arithmetic and carry only rounding noise (the
    key projections' biases: a softmax does not see a shift of all its
    scores)."""
    norms = {n: g.norm().item() for n, g in plain.items()}
    floor = 1e-3 * max(norms.values())
    return {n: (kern[n] - g).norm().item() / max(norms[n], floor)
            for n, g in plain.items()}


def phase_train(torch, np, dev):
    """The train slice: kernel path vs plain path, then the B=240 bf16 step
    through the entry point, then its timing."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch import ops
    from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
        make_optimizer)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
        expected_launches, make_sbl_train_step)
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (
        attach_plans, batches, train_steps)

    cfg = C.sbl()
    data = SyntheticLipDataset(size=TRAIN_BATCH, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=0)

    def device_batch(n, seed):
        b = attach_plans(next(batches(data, n, seed)),
                         np.random.default_rng(seed), cfg)
        return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in b.items()}

    # the kernel path against the plain path: one step, same weights, batch
    # and generator seed, so the same dropout masks and coins
    small = device_batch(TRAIN_CHECK_BATCH, 1)
    for dtype in ("float32", "bfloat16"):
        runs = []
        for kernels in (True, False):
            c = dataclasses.replace(cfg, compute_dtype=dtype,
                                    use_pallas_attention=kernels)
            model = build_model(c, dev, seed=0)
            step = make_sbl_train_step(model, make_optimizer(model, c.optim), c)
            loss = step(small, torch.Generator().manual_seed(5))["loss"].item()
            runs.append((loss, {n: p.grad.detach().clone()
                                for n, p in model.named_parameters()},
                         {n: b.clone() for n, b in model.named_buffers()
                          if "running" in n}))
            del model, step
        (lk, gk, bk), (lp, gp, bp) = runs
        errs = _grad_errors(gk, gp)
        worst = max(errs, key=errs.get)
        bn_err = max((bk[n] - b).abs().max().item() for n, b in bp.items())
        print(f"phase 5 {dtype} B={TRAIN_CHECK_BATCH} kernel vs plain path: "
              f"loss {lk:.6f} vs {lp:.6f} (tol {TRAIN_LOSS_TOL[dtype]}); "
              f"gradient rel err max {errs[worst]:.3g} at {worst}, median "
              f"{statistics.median(errs.values()):.3g} (tol "
              f"{TRAIN_GRAD_TOL[dtype]}); BN running stats max abs diff "
              f"{bn_err:.3g} (tol {TRAIN_BN_TOL[dtype]})")
        check(abs(lk - lp) <= TRAIN_LOSS_TOL[dtype], f"{dtype} losses differ")
        check(errs[worst] <= TRAIN_GRAD_TOL[dtype],
              f"{dtype} gradient of {worst} differs by {errs[worst]}")
        check(bn_err <= TRAIN_BN_TOL[dtype], f"{dtype} BN stats differ")
        del runs, gk, gp
    torch.cuda.empty_cache()

    # the main path: one bf16 step at B=240 through the entry point
    model = build_model(cfg, dev, seed=0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    result = train_steps(cfg, data, 1, dev, seed=0, model=model)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expected = expected_launches(cfg)
    print(f"phase 5 bf16 B={TRAIN_BATCH} launches per step: {launches} "
          f"(expected {expected})")
    check(launches == expected, f"launch counts {launches} != {expected}")
    loss = result.history[0]["loss"]
    check(np.isfinite(loss), f"non-finite loss {loss}")
    state = model.state_dict()
    still = [n for n, _ in model.named_parameters() if torch.equal(before[n], state[n])]
    check(not still, f"parameters that did not move: {still[:5]}")
    stats = [n for n in state if "running" in n]
    check(all(not torch.equal(before[n], state[n]) for n in stats),
          "BN running statistics did not move")
    print(f"phase 5 bf16 B={TRAIN_BATCH} step 1: loss {loss:.4f}, all "
          f"{len(before) - len(stats)} parameter tensors and {len(stats)} BN "
          f"statistics moved")
    del before, state

    # timing: the train step on one resident batch
    step = make_sbl_train_step(model, result.optimizer, cfg)
    step.state.step = len(result.history)
    batch = device_batch(TRAIN_BATCH, 2)
    gen = torch.Generator().manual_seed(3)
    for _ in range(TRAIN_WARMUP):
        step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(batch, gen)["loss"] for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [x.item() for x in losses]
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    marks = []
    step(batch, gen, marks=marks)
    torch.cuda.synchronize()
    stages = {name: a.elapsed_time(b) for (_, a), (name, b) in zip(marks, marks[1:])}
    rate = TRAIN_BATCH / dt
    print(f"phase 5 bf16 B={TRAIN_BATCH}: {dt * 1e3:.1f} ms/step, {rate:.1f} "
          f"clips/s over {TRAIN_TIMED} steps, peak memory {peak_gb:.2f} GB; "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}")
    print("phase 5 bf16 stage split (device timeline, ms per step): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    return launches, dict(ms_per_step=dt * 1e3, clips_per_s=rate,
                          peak_gb=peak_gb, stages=stages)


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
    train_kernels = phase_train_kernels(torch, dev)
    launches, rate = phase_slice(torch, np, dev)
    train_launches, train = phase_train(torch, np, dev)

    csrc = "sbl_for_multilingual_lip_reading_tpu_torch/csrc/"
    jax_attention = "sbl_for_multilingual_lip_reading_tpu/ops/attention.py:"
    rows = []
    # K1, K2: the headline row is the busiest bf16 shape of the recognize path
    for kernel, source, replaces, headline in (
            ("small_mha_flat", csrc + "attention.cu", jax_attention + "573",
             "decoder self (1024,17,512) causal"),
            ("stack_frames", csrc + "stem.cu",
             "sbl_for_multilingual_lip_reading_tpu/ops/stem.py:39",
             "stem (512,30,88,88)")):
        head = next(r for r in kernels[kernel]
                    if r["case"] == headline and r["dtype"] == "bfloat16")
        rows.append({"name": kernel, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[kernel],
                     "launches_by_path": {"recognize": launches[kernel],
                                          "train": train_launches[kernel]},
                     "max_abs_err": max(r["max_abs_err"] for r in kernels[kernel]
                                        if r["dtype"] == "bfloat16"
                                        and not r["case"].startswith("extra")),
                     "ms": head["ms"], "plain_ms": head["plain_ms"],
                     "cases": kernels[kernel]})
    # K3, K4, K5: the headline row is the decoder self-attention in bf16;
    # K5 draws the mask K3/K4 draw inline, so the train path launches it
    # no time (it serves the card check)
    head = next(r for r in train_kernels if r["dtype"] == "bfloat16"
                and r["case"] == "decoder self (480,17,512) causal")
    bf16 = [r for r in train_kernels if r["dtype"] == "bfloat16"]
    for kernel, replaces, err, ms in (
            ("small_mha_dropout_fwd_flat", "724", "fwd_err", "fwd_ms"),
            ("small_mha_dropout_bwd_flat", "774", "bwd_err", "bwd_ms"),
            ("dropout_keep_mask_flat", "874", None, "mask_ms")):
        rows.append({"name": kernel, "route": "cuda",
                     "source": csrc + "attention_train.cu",
                     "replaces": jax_attention + replaces,
                     "launches": train_launches[kernel],
                     "launches_by_path": {"recognize": launches[kernel],
                                          "train": train_launches[kernel]},
                     "on_main_path": kernel != "dropout_keep_mask_flat",
                     "max_abs_err": max(r[err] for r in bf16) if err else 0.0,
                     "ms": head[ms], "plain_ms": head[ms.replace("_ms", "_plain_ms")],
                     "cases": [{k: r[k] for k in ("case", "dtype", ms,
                                                  ms.replace("_ms", "_plain_ms"))}
                               for r in train_kernels]})
    print(json.dumps({"kernels": rows, "card": smi,
                      "recognize_clips_per_s": rate, "train": train}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
