"""Eval ingest: uint8 clips -> center-cropped, normalized frames.

Counterpart of the eval branch of the JAX package's
``data/pipeline.py::device_ingest`` (``offsets=None``, ``flip=None``,
``frame_map=None``): the reference test protocol's CenterCrop +
ColorNormalize, run on the device from uint8.  The train branch (per-frame
crop offsets, flip, FrameRemoval) belongs to the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import DataConfig

# ColorNormalize constants (reference cvtransforms.py:44-48)
MEAN = DataConfig.mean
STD = DataConfig.std


def device_ingest(clips_u8: torch.Tensor, crop: int,
                  dtype: torch.dtype = torch.float32,
                  n_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """clips_u8: (B, T, H, W) uint8 raw frames; n_frames: optional (B,)
    valid-frame counts, whose time-pad slots are zeroed AFTER
    normalization (the reference pads the normalized clip with 0.0).
    Returns (B, T, crop, crop) frames in ``dtype``; the normalization runs
    in f32 and is cast once at the end."""
    if clips_u8.dim() != 4 or clips_u8.dtype != torch.uint8:
        raise ValueError(f"clips must be (B, T, H, W) uint8; got "
                         f"{tuple(clips_u8.shape)} {clips_u8.dtype}")
    B, T, H, W = clips_u8.shape
    # one offset for both axes, as the JAX slice takes it (square frames)
    c = int(round((H - crop) / 2.0))
    x = clips_u8[:, :, c:c + crop, c:c + crop].to(torch.float32) * (1.0 / 255.0)
    x = (x - MEAN) / STD
    if n_frames is not None:
        valid = torch.arange(T, device=x.device)[None, :] < n_frames[:, None]
        x = torch.where(valid[:, :, None, None], x, 0.0)
    return x.to(dtype)
