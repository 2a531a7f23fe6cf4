"""The cached-training mix (entry ``train_cached``): the program's
``Trainer`` on a dataset made from the seed and resident on the device,
the epoch-fused step replayed as one CUDA graph a step, as ``cli train
--cache-on-device`` runs it; and its judgement by ``reference/train.py``.

Set-up builds one Trainer and drives it through its first steps with the
calls its epoch loop makes (``_epoch_const`` for the first epoch, cut to
``first_steps``, then the fused step once a step: the first eagerly, the
second captured and replayed), reading the loss of each from the metrics
ring, the first gradient from Adam's first moment after one step, and the
parameters' change after the last.  The window then runs whole epochs of
the same Trainer (``train_epoch``).

Parameters of the mix: ``batch``, ``clips`` (the resident set, a whole
number of batches), ``first_steps``, ``trace_steps``, ``labels``
(``pad_len``, the lengths of the two languages' label sequences), ``env``
(set before the program is imported), ``config_overrides``.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import train as RT
from .traffic import make_clips

IGNORE = -1


class SeededDataset:
    """``clips`` uint8 (N, T, H, W) and label sequences made from the seed:
    even items LRW-like (lang 0), odd items LRW-1000-like (lang 1), the
    tokens uniform over the vocabulary without sos and eos."""

    def __init__(self, clips: np.ndarray, labels: np.ndarray, lang: np.ndarray):
        self.clips, self.labels, self.lang = clips, labels, lang

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        lab = self.labels[i]
        n = int((lab != IGNORE).sum())
        rev = np.full_like(lab, IGNORE)
        rev[:n] = lab[:n][::-1]
        return {"clip_u8": self.clips[i], "labels": lab, "labels_reverse": rev,
                "lang_id": np.int32(self.lang[i])}


def make_dataset(seed: int, n: int, frames: int, raw: int, vocab: int,
                 spec: dict, device) -> SeededDataset:
    g = torch.Generator(device=device).manual_seed(int(seed))
    clips = np.empty((n, frames, raw, raw), np.uint8)
    for a in range(0, n, 512):
        b = min(n, a + 512)
        clips[a:b] = make_clips(g, b - a, frames, raw, device).cpu().numpy()
    rng = np.random.default_rng([int(seed), 4])
    lang = (np.arange(n) % 2).astype(np.int32)
    labels = np.full((n, spec["pad_len"]), IGNORE, np.int64)
    for i in range(n):
        lo, hi = spec["english_len"] if lang[i] == 0 else spec["mandarin_len"]
        k = int(rng.integers(lo, hi + 1))
        labels[i, :k] = rng.integers(2, vocab, size=k)
    return SeededDataset(clips, labels, lang)


def expected_launches(cfg, bns: int) -> Dict[str, int]:
    """Kernel launches of one captured step (a frozen copy of
    ``training.steps.expected_launches`` for the bidirectional decoder with
    ``PALLAS_INGEST`` and ``PALLAS_BN`` on): K2 once, K3 once per encoder
    layer and twice per decoder layer and decode step (self and cross),
    again in each step's checkpointed recompute, K4 once per K3 of the
    forward, K6 once, K7 once per frontend BatchNorm and again for each
    block's in the remat recompute, K8 once per BatchNorm."""
    enc, d = cfg.dims.n_enc_layers, cfg.decoder
    dec_bwd = 2 * d.maxlen * cfg.dims.n_dec_layers
    dec_fwd = dec_bwd * (2 if cfg.remat_decoder else 1)
    recomputed = bns - 1 if cfg.remat_frontend else 0
    return {"stack_frames": 1, "small_mha_dropout_fwd_flat": enc + dec_fwd,
            "small_mha_dropout_bwd_flat": enc + dec_bwd, "ingest_train": 1,
            "channel_sums": bns + recomputed, "channel_sums_pair": bns}


class TrainDriver:
    """The Trainer of one run, its first steps' readings and its epochs."""

    def __init__(self, model, cfg, mix: dict, seed: int, device):
        from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.dataset = make_dataset(seed, mix["clips"], cfg.data.frames, cfg.data.raw_size,
                                    cfg.decoder.vocab_size, mix["labels"], self.device)
        self.trainer = Trainer(cfg, self.dataset, cache_on_device=True,
                               device=self.device, model=model)
        self.steps_per_epoch = mix["clips"] // mix["batch"]
        self.epoch = 0
        self.steps = 0

    def first_steps(self) -> dict:
        """The program's readings of the first steps (losses, the first
        gradient's and the change's norm per parameter, on the host)."""
        tr, n = self.trainer, self.mix["first_steps"]
        named = list(tr.model.named_parameters())
        start = {k: p.detach().clone() for k, p in named}
        const, steps = tr._epoch_const(0, n)
        step_fn = tr._ensure_fused_step()
        b1 = self.cfg.optim.adam_b1
        grad = None
        for i in range(steps):
            step_fn(i)
            if i == 0:
                # Adam's first moment after one update is (1 - b1) g; a
                # parameter without one got no update
                state = tr.optimizer.state
                grad = {k: float(state[p]["exp_avg"].norm()) / (1.0 - b1)
                        if "exp_avg" in state.get(p, {}) else 0.0 for k, p in named}
        losses = const.ring[:steps, 0].tolist()
        change = {k: float((p.detach() - start[k]).norm()) for k, p in named}
        self.epoch, self.steps = 1, steps
        return {"losses": losses, "grad": grad, "change": change}

    def run_epoch(self, max_steps=None) -> int:
        """One (possibly cut) epoch of the Trainer's own loop; its steps."""
        self.trainer.train_epoch(self.epoch, max_steps=max_steps)
        self.epoch += 1
        n = self.steps_per_epoch if max_steps is None else min(max_steps, self.steps_per_epoch)
        self.steps += n
        return n

    def path(self, bns: int) -> Dict[str, float]:
        """How far the run's path lies from the cell's: replays that did not
        run as graph replays, a step the memory guard rebuilt, launches of
        the captured step off the count."""
        from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import GraphedStep
        fs = self.trainer.fused_step
        if not isinstance(fs, GraphedStep):
            return {"replays_off": float(self.steps), "rebuilt": 1.0, "launches_off": 1.0}
        want = expected_launches(self.cfg, bns)
        have = fs.captured_launches or {}
        off = sum(abs(have.get(k, 0) - want.get(k, 0)) for k in set(have) | set(want))
        return {"replays_off": float(abs(fs.replays - (self.steps - 1))),
                "rebuilt": float(bool(getattr(fs.fn, "rebuilt", True))),
                "launches_off": float(off)}

    def release(self) -> None:
        self.trainer = None
        gc.collect()


def reference_config(conf: dict, mix: dict) -> dict:
    return dict(conf["model"], **conf["train"], batch=mix["batch"])


def batches_of(dataset: SeededDataset, draws: RT.Draws, device) -> List[dict]:
    out = []
    for t, idx in enumerate(draws.order):
        rev = np.stack([dataset[int(i)]["labels_reverse"] for i in idx])
        out.append({"clips": torch.from_numpy(dataset.clips[idx]).to(device),
                    "plans": draws.plans[t],
                    "labels": torch.from_numpy(dataset.labels[idx]).to(device),
                    "labels_reverse": torch.from_numpy(rev).to(device),
                    "seeds": draws.seeds[t], "coins": draws.coins[t]})
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Per leaf, the gap between the program's norm and the reference's
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The first steps' numbers: loss_gap (the worst step's relative gap of
    the loss); grad_gap and delta_gap (the worst leaf's gap of the first
    gradient's and of the change's norm, ``leaf_gaps``); grad_gap_median
    and delta_gap_median (the median leaf's).  The leaves whose reference
    gradient is under a thousandth of the median leaf's are left out (a
    key's bias under softmax, whose gradient is nought to rounding)."""
    med = float(np.median(list(ref["grad"].values())))
    keep = [k for k, v in ref["grad"].items() if v >= 1e-3 * med]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad = leaf_gaps(prog["grad"], ref["grad"], keep)
    delta = leaf_gaps(prog["change"], ref["change"], keep)
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "grad_gap_median": float(np.median(list(grad.values()))),
            "delta_gap": max(delta.values()),
            "delta_gap_median": float(np.median(list(delta.values()))),
            "leaves_left_out": float(len(ref["grad"]) - len(keep)),
            "grad_worst": max(grad, key=grad.get), "delta_worst": max(delta, key=delta.get)}


def reference_readings(state: Dict[str, torch.Tensor], param_names, dataset, seed: int,
                       rcfg: dict, steps: int, device, prec: str = "f32",
                       half: bool = False) -> dict:
    """The reference's first steps from the run's start: losses, the first
    gradient's and the change's norm per parameter.  ``half``: the fault
    of half of the batch left out, the mean taken over the rest."""
    draws = RT.first_epoch_draws(seed, dataset.lang, rcfg, steps)
    batches = batches_of(dataset, draws, device)
    if half:
        h = rcfg["batch"] // 2
        batches = [dict(b, clips=b["clips"][:h], labels=b["labels"][:h],
                        labels_reverse=b["labels_reverse"][:h],
                        plans=tuple(p[:h] for p in b["plans"])) for b in batches]
    params = {k: state[k].to(device).float() for k in param_names}
    buffers = {k: v.to(device) for k, v in state.items() if k not in params}
    t = time.perf_counter()
    losses, grad, change = RT.run_steps(params, buffers, batches, rcfg, prec)
    return {"losses": losses, "grad": {k: float(v.norm()) for k, v in grad.items()},
            "change": {k: float(v.norm()) for k, v in change.items()},
            "seconds": time.perf_counter() - t}


def with_config(cfg, mix: dict, seed: int):
    """The program's config of the mix: its overrides, the run's seed."""
    over = {k: v for k, v in mix.get("config_overrides", {}).items()}
    return dataclasses.replace(cfg, seed=int(seed), **over)
