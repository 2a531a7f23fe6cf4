"""The train slice's entry point (counterpart of the JAX package's
``Trainer.train_epoch(max_steps=n)`` for the ``sbl`` workload).

Batches come from an indexable dataset, shuffled per epoch as the JAX
``Batcher`` shuffles them, get their augmentation plans on the host
(``attach_plans``), move to the device as uint8, and go through the train
step.  Checkpoints, eval loops, the three-stage recipe and the CLI are not
ported yet (ROADMAP.md queue A item 8).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..data.transforms import make_train_plans
from ..models import build_model
from .schedule import make_optimizer
from .steps import make_sbl_train_step


class TrainResult(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    history: List[Dict[str, float]]   # one dict of metrics per step


def attach_plans(batch: Dict, rng: np.random.Generator, cfg) -> Dict:
    """Add integer augmentation plans to a raw uint8 batch (JAX
    ``trainer.attach_plans`` with train=True): LRW clips (lang_id 0) get
    per-frame crop offsets in [0, raw-crop], LRW-1000 clips one per-clip
    offset in [0, (raw-crop)//2]; flip and FrameRemoval apply to both."""
    B, T = batch["clip_u8"].shape[:2]
    raw, crop = batch["clip_u8"].shape[2], cfg.data.crop_size
    lang = np.asarray(batch.get("lang_id", np.zeros(B, np.int32)))
    per_frame = (lang == 0) & (not cfg.data.per_clip_crop)
    clip_hi = np.where(lang == 0, raw - crop, (raw - crop) // 2)
    offsets, flip, fmap = make_train_plans(
        rng, B, T, raw, crop, cfg.data.frame_removal_p,
        per_frame_mask=per_frame, clip_hi=clip_hi,
        random_drop_p=cfg.data.random_drop_p)
    return dict(batch, offsets=offsets, flip=flip, frame_map=fmap)


def batches(dataset, batch_size: int, seed: int) -> Iterator[Dict]:
    """One epoch of full batches in a shuffled order (JAX ``Batcher``
    with shuffle=True, drop_last=True)."""
    order = np.arange(len(dataset))
    np.random.default_rng(seed).shuffle(order)
    for s in range(0, len(order) // batch_size * batch_size, batch_size):
        samples = [dataset[int(i)] for i in order[s:s + batch_size]]
        yield {k: np.stack([x[k] for x in samples]) for k in samples[0]}


def train_steps(cfg, dataset, n_steps: int, device, seed: Optional[int] = None,
                model: Optional[torch.nn.Module] = None) -> TrainResult:
    """Run ``n_steps`` train steps of the ``sbl`` workload on ``device``.

    The model is built from ``seed`` (default ``cfg.seed``) unless one is
    given.  The seed also drives the batch order (``seed + epoch``), the
    plans and the steps' random numbers.  Returns the trained model, its
    optimizer and the metrics of every step."""
    seed = cfg.seed if seed is None else seed
    if model is None:
        model = build_model(cfg, device, seed)
    optimizer = make_optimizer(model, cfg.optim)
    step = make_sbl_train_step(model, optimizer, cfg)
    plan_rng = np.random.default_rng(seed)
    generator = torch.Generator().manual_seed(seed)
    metrics = []
    epoch = 0
    while len(metrics) < n_steps:
        for batch in batches(dataset, cfg.batch_size, seed + epoch):
            if len(metrics) == n_steps:
                break
            batch = attach_plans(batch, plan_rng, cfg)
            batch = {k: torch.as_tensor(np.asarray(v)).to(device)
                     for k, v in batch.items()}
            metrics.append(step(batch, generator))
        epoch += 1
    history = [{k: float(v) for k, v in m.items()} for m in metrics]
    return TrainResult(model, optimizer, history)
