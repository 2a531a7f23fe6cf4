"""End-to-end trainability checks of the port on synthetic data
(counterpart of the JAX package's ``tools/convergence_check.py``, with its
two modes and settings).

Default mode -- memorize a tiny set: the tiny ``sbl`` config (dropout off,
teacher forcing 0.1, no label smoothing, k 0.5, warmup 100) trains on the 8
clips of ``SyntheticLipDataset(size=8)``, one batch of 8 a step, until the
greedy bidirectional decode reproduces every target (WER 0 in both
directions; checked every 50 steps).  Prints MEMORIZED.

``--full-dims`` -- convergence at the reference width: ``config.sbl()``
(d_model 512, 6 + 6 layers, k 0.2, warmup 4000, label smoothing 0.1) at
B=240 with ``remat_frontend`` and the device-resident dataset, on
``SyntheticPatternDataset`` (200 words x 25 clips to train on, 4 clips a
word held out), teacher forcing 0.5 until epoch 220 and 0.1 after;
greedy WER on the held-out clips every 10 epochs, until both directions are
at most 0.02 (CONVERGED) or 400 epochs have run.  ``--time-limit`` stops it
earlier, and says so.

    python -m sbl_for_multilingual_lip_reading_tpu_torch.convergence_check [--steps 800]
    python -m sbl_for_multilingual_lip_reading_tpu_torch.convergence_check --full-dims [--epochs 400]

Runs on the card unless ``--cpu`` is given.  Exits 1 when the target is
not reached.  ``PALLAS_BN=1`` / ``PALLAS_INGEST=1`` in the environment put
K7/K8 and K6 on the train step, as everywhere in the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import config as C


def memorize_config() -> C.WorkloadConfig:
    """The default mode's config: ``tiny_test("sbl")`` at B=8 with dropout
    off, teacher forcing 0.1, k 0.5, warmup 100 and no label smoothing."""
    cfg = C.tiny_test("sbl")
    return dataclasses.replace(
        cfg, batch_size=8,
        dims=dataclasses.replace(cfg.dims, dropout=0.0),
        frontend=dataclasses.replace(cfg.frontend, dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, teacher_forcing_rate=0.1),
        optim=dataclasses.replace(cfg.optim, k=0.5, warmup_steps=100,
                                  label_smoothing=0.0))


def memorize(steps: int, device, eval_every: int = 50,
             log: Callable[[str], None] = print) -> Dict:
    """Train ``memorize_config()`` on 8 synthetic clips for at most
    ``steps`` steps, decoding them every ``eval_every`` steps; stop when
    both directions reproduce every target.  Returns {"memorized": bool,
    "step": the last step, "losses": every step's loss}."""
    from .data import SyntheticLipDataset
    from .training.trainer import Trainer
    cfg = memorize_config()
    ds = SyntheticLipDataset(size=8, frames=cfg.data.frames,
                             raw_size=cfg.data.raw_size)
    tr = Trainer(cfg, ds, device=device)
    losses: List[float] = []
    t0 = time.time()
    for epoch in range(steps):
        losses.append(tr.train_epoch(epoch, max_steps=1))
        if epoch % eval_every == eval_every - 1:
            out = tr.validate_seq2seq(ds, max_batches=1)
            log(f"step {tr.state.step} loss {losses[-1]:.3f} {out} "
                f"({time.time() - t0:.0f}s)")
            if out["l2r_wer"] == 0.0 and out["r2l_wer"] == 0.0:
                return {"memorized": True, "step": tr.state.step,
                        "losses": losses}
    return {"memorized": False, "step": tr.state.step, "losses": losses}


def _card_line(device) -> str:
    import torch
    if device.type != "cuda":
        return "device: cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi: not read"
    return f"device: {torch.cuda.get_device_name(device)} ({smi})"


def run_full_dims(args, device) -> int:
    from .data import SyntheticPatternDataset
    from .training.trainer import Trainer
    cfg = dataclasses.replace(C.sbl(), batch_size=args.batch_size,
                              remat_frontend=True)
    mk = dict(n_words=args.n_words, samples_per_word=args.samples_per_word,
              frames=cfg.data.frames, raw_size=cfg.data.raw_size)
    train_ds = SyntheticPatternDataset(split="train", **mk)
    held = SyntheticPatternDataset(split="heldout",
                                   **{**mk, "samples_per_word": 4})
    print(f"{_card_line(device)}; sbl at B={cfg.batch_size}, "
          f"{cfg.compute_dtype}, remat_frontend, device cache; "
          f"{len(train_ds)} train / {len(held)} held-out clips; "
          f"PALLAS_BN={os.environ.get('PALLAS_BN', '')} "
          f"PALLAS_INGEST={os.environ.get('PALLAS_INGEST', '')}", flush=True)
    tr = Trainer(cfg, train_ds, {"heldout": held}, device=device,
                 cache_on_device=True)
    t0 = time.time()
    for epoch in range(args.epochs):
        if epoch == args.stage2_epoch:
            # stage 2 (the reference README.md:62-68): teacher forcing
            # 0.5 -> 0.1.  As JAX's tool rebuilds its Trainer here, the
            # model, optimizer, update count and step random numbers carry
            # on, and the plan generator starts again from the seed.
            tr.model.decoder.teacher_forcing_rate = 0.1
            tr.np_rng = np.random.default_rng(cfg.seed)
            print(f"epoch {epoch}: teacher forcing -> 0.1", flush=True)
        loss = tr.train_epoch(epoch)
        if epoch % args.eval_every == args.eval_every - 1:
            out = tr.validate_seq2seq(held)
            print(f"epoch {epoch} step {tr.state.step} loss {loss:.3f} "
                  f"heldout {out} ({time.time() - t0:.0f}s)", flush=True)
            if (out["l2r_wer"] <= args.target_wer
                    and out["r2l_wer"] <= args.target_wer):
                print(f"CONVERGED: held-out WER <= {args.target_wer} at "
                      f"step {tr.state.step}", flush=True)
                return 0
        if args.time_limit and time.time() - t0 > args.time_limit:
            print(f"NOT converged within the time limit ({args.time_limit} s, "
                  f"epoch {epoch}, step {tr.state.step})", flush=True)
            return 1
    print("NOT converged within budget", flush=True)
    return 1


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--full-dims", action="store_true")
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--batch-size", type=int, default=240)
    ap.add_argument("--n-words", type=int, default=200)
    ap.add_argument("--samples-per-word", type=int, default=25)
    ap.add_argument("--stage2-epoch", type=int, default=220,
                    help="epoch at which teacher forcing anneals to 0.1")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--target-wer", type=float, default=0.02)
    ap.add_argument("--time-limit", type=float, default=None,
                    help="stop --full-dims after this many seconds")
    args = ap.parse_args(argv)
    from .utils.device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    if args.full_dims:
        return run_full_dims(args, device)
    out = memorize(args.steps, device, log=lambda s: print(s, flush=True))
    print("MEMORIZED" if out["memorized"] else "NOT memorized within budget")
    return 0 if out["memorized"] else 1


if __name__ == "__main__":
    sys.exit(main())
