"""Device ingest: uint8 clips -> cropped, normalized frames.

Counterpart of the JAX package's ``data/pipeline.py::device_ingest``, run
on the device from uint8.  Without plans it is the eval branch (the
reference test protocol's CenterCrop + ColorNormalize); with the plans of
``data/transforms.py::make_train_plans`` it is the train branch: the
FrameRemoval gather, per-frame crop offsets and the whole-clip flip, in
uint8, then the normalization.  Plain PyTorch: the JAX default path here is
XLA, not a Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import DataConfig
from ..utils import profiler

# ColorNormalize constants (reference cvtransforms.py:44-48)
MEAN = DataConfig.mean
STD = DataConfig.std


def crop_frames(clips: torch.Tensor, offsets: torch.Tensor, crop: int) -> torch.Tensor:
    """Per-frame crop of (B, T, H, W) at (B, T, 2) (y, x) offsets: one gather
    over rows, then one over columns."""
    B, T, H, W = clips.shape
    span = torch.arange(crop, device=clips.device)
    rows = offsets[..., 0:1].long() + span                    # (B, T, crop)
    out = torch.gather(clips, 2, rows[..., None].expand(B, T, crop, W))
    cols = offsets[..., 1:2].long() + span                    # (B, T, crop)
    return torch.gather(out, 3, cols[:, :, None, :].expand(B, T, crop, crop))


def device_ingest(clips_u8: torch.Tensor, crop: int,
                  dtype: torch.dtype = torch.float32,
                  n_frames: Optional[torch.Tensor] = None,
                  offsets: Optional[torch.Tensor] = None,
                  flip: Optional[torch.Tensor] = None,
                  frame_map: Optional[torch.Tensor] = None,
                  mean: float = MEAN, std: float = STD) -> torch.Tensor:
    """clips_u8: (B, T, H, W) uint8 raw frames; n_frames: optional (B,)
    valid-frame counts, whose time-pad slots are zeroed AFTER
    normalization (the reference pads the normalized clip with 0.0, so
    the temporal stem sees past a clip's end what the clip alone would);
    mean, std: the normalization's (a config's ``data.mean``, ``data.std``);
    offsets: (B, T, 2) per-frame (y, x) crop offsets, or None for the center
    crop; flip: (B,) bool whole-clip horizontal flip, or None; frame_map:
    (B, T) source frame of each output slot (FrameRemoval), or None.
    Returns (B, T, crop, crop) frames in ``dtype``; the normalization runs
    in f32 and is cast once at the end."""
    if clips_u8.dim() != 4 or clips_u8.dtype != torch.uint8:
        raise ValueError(f"clips must be (B, T, H, W) uint8; got "
                         f"{tuple(clips_u8.shape)} {clips_u8.dtype}")
    # outside a training step an evaluation batch begins here
    with profiler.span("ingest", batch=profiler.NEXT):
        return _ingest(clips_u8, crop, dtype, n_frames, offsets, flip, frame_map,
                       mean, std)


def _ingest(clips_u8: torch.Tensor, crop: int, dtype: torch.dtype,
            n_frames, offsets, flip, frame_map, mean=MEAN, std=STD) -> torch.Tensor:
    B, T, H, W = clips_u8.shape
    clips = clips_u8
    if frame_map is not None:
        rows = torch.arange(B, device=clips.device)[:, None]
        clips = clips[rows, frame_map.long()]
    if offsets is None:
        # one offset for both axes, as the JAX slice takes it (square frames)
        c = int(round((H - crop) / 2.0))
        cropped = clips[:, :, c:c + crop, c:c + crop]
    else:
        cropped = crop_frames(clips, offsets, crop)
    if flip is not None:
        # in uint8, before the normalization, which commutes with it
        cropped = torch.where(flip[:, None, None, None], cropped.flip(-1), cropped)
    x = cropped.to(torch.float32) * (1.0 / 255.0)
    x = (x - mean) / std
    if n_frames is not None:
        valid = torch.arange(T, device=x.device)[None, :] < n_frames[:, None]
        x = torch.where(valid[:, :, None, None], x, 0.0)
    return x.to(dtype)
