"""Train-time augmentation plans, drawn on the host in numpy (a copy of the
JAX package's ``data/transforms.py::make_train_plans``; the same
``np.random.Generator`` state gives the same plans).

All randomness goes into small integer arrays: per-frame crop offsets, a
whole-clip flip flag, and a FrameRemoval source-frame map.  The pixel work
(crop, flip, gather, ColorNormalize) runs on the device in
``data/ingest.py::device_ingest``.  Reference semantics: RandomCrop draws an
offset in [0, raw-crop] per frame (cvtransforms.py:28-29), LRW-1000 clips
one offset per clip; HorizontalFlip with p=0.5; FrameRemoval duplicates the
previous frame w.p. ``frame_removal_p`` (data_gen.py:104-108), after the
crop, so a duplicated frame keeps its source's offset; the LRW project's
RandomDrop packs kept frames to the front and repeats the last.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def make_train_plans(rng: np.random.Generator, batch: int, frames: int,
                     raw: int, crop: int, frame_removal_p: float = 0.05,
                     per_frame_mask: Optional[np.ndarray] = None,
                     clip_hi: Optional[np.ndarray] = None,
                     random_drop_p: float = 0.0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One vectorized draw of the whole batch's plans.

    per_frame_mask: (B,) bool -- rows drawing per-frame crop offsets in
      [0, raw-crop]; other rows draw one per-clip offset.  Default all-true.
    clip_hi: (B,) int -- per-clip max offset for the non-per-frame rows.
      Default raw-crop.

    Returns (offsets (B,T,2) i32, flip (B,) bool, frame_map (B,T) i32).
    """
    B, T = batch, frames
    hi = raw - crop
    if per_frame_mask is None:
        per_frame_mask = np.ones(B, dtype=bool)
    if clip_hi is None:
        clip_hi = np.full(B, hi, dtype=np.int64)
    offs = rng.integers(0, hi + 1, size=(B, T, 2)).astype(np.int32)
    offs_clip = rng.integers(
        0, np.asarray(clip_hi).reshape(B, 1, 1) + 1,
        size=(B, 1, 2)).astype(np.int32)
    offs = np.where(per_frame_mask[:, None, None], offs,
                    np.broadcast_to(offs_clip, (B, T, 2)))
    flip = rng.random(B) < 0.5
    # FrameRemoval: frame i w.p. p becomes a copy of the previous KEPT
    # frame -> frame_map = running max of kept indices
    drop = rng.random((B, T)) < frame_removal_p
    drop[:, 0] = False                      # reference loop starts at 1
    idx = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    fmap = np.maximum.accumulate(np.where(drop, np.int32(-1), idx), axis=1)
    fmap = fmap.astype(np.int32)
    # removal happens after crop: duplicated frames reuse the source's crop
    offs = np.take_along_axis(offs, fmap[..., None], axis=1)
    if random_drop_p > 0.0:
        # RandomDrop: frame j drops iff its coin lands and the number of
        # drops before j is within the cap min(10, 0.2*T); while under the
        # cap every candidate is a drop, so candidate j is real iff the
        # number of candidates before it is within the cap
        cap = min(10.0, 0.2 * T)
        cand = rng.random((B, T)) <= random_drop_p
        before = np.cumsum(cand, axis=1) - cand
        dropd = cand & (before <= cap)
        keep = ~dropd
        order = np.argsort(dropd, axis=1, kind="stable")  # kept first
        packed = np.take_along_axis(idx, order, axis=1)
        k = keep.sum(axis=1)
        pos = np.minimum(idx, np.maximum(k - 1, 0)[:, None])
        dmap = np.take_along_axis(packed, pos, axis=1).astype(np.int32)
        fmap = np.take_along_axis(fmap, dmap, axis=1)
        offs = np.take_along_axis(offs, dmap[..., None], axis=1)
    return offs, flip, fmap
