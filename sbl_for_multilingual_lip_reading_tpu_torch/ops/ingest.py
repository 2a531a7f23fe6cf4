"""Training ingest in one pass (kernel K6) and its plain PyTorch version.

Counterpart of the JAX package's ``ops/ingest.py::ingest_train`` (a Pallas
TPU kernel, behind ``PALLAS_INGEST=1`` in ``training/steps.py``): uint8
clips and the integer plans of ``data/transforms.py::make_train_plans`` go
to normalized crops in one pass,

    out[b, t] = normalize(flip_b(crop_{offsets[b, t]}(clip[b, frame_map[b, t]])))

with the slots ``t >= n_frames[b]`` zeroed after the normalization.  The
normalization is the TPU kernel's ``x * (1 / (255 STD)) - MEAN / STD``, two
f32 roundings; ``data/ingest.py::device_ingest`` computes
``(x / 255 - MEAN) / STD``, which rounds differently.  The CUDA kernel is
``csrc/ingest.cu``; its design note is there.  It takes one of two routes,
which ``route`` mirrors: 16-byte output pieces (8 bf16 or 4 f32 outputs a
thread's load and store) where the crop and the source rows are whole
pieces and words and both pointers are 16-byte aligned, else single
outputs.

``ingest_train`` is the wrapper the train step calls.  On CPU tensors it runs
``ingest_train_plain``; on CUDA tensors it launches the kernel or raises.
``ingest_train.launches`` counts the kernel's launches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.ingest import MEAN, STD, crop_frames
from . import _build

MAX_OFFSET = 8  # RandomCrop's offset range [0, 8], as the TPU kernel takes it
PIECE_BYTES = 16  # one store of the kernel's vector route
INV_STD = float(np.float32(1.0 / (255.0 * STD)))
SHIFT = float(np.float32(MEAN / STD))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(clips_u8, offsets, flip, frame_map, crop, dtype, n_frames):
    if clips_u8.dim() != 4 or clips_u8.dtype != torch.uint8:
        raise ValueError(f"clips must be (B, T, H, W) uint8; got "
                         f"{tuple(clips_u8.shape)} {clips_u8.dtype}")
    B, T, H, W = clips_u8.shape
    if H - crop > MAX_OFFSET or W - crop > MAX_OFFSET or crop > min(H, W):
        raise ValueError(f"ingest_train takes crop offsets in [0, {MAX_OFFSET}]:"
                         f" {H}x{W} frames cannot be cropped to {crop}")
    shapes = {"offsets": (offsets, (B, T, 2)), "flip": (flip, (B,)),
              "frame_map": (frame_map, (B, T))}
    if n_frames is not None:
        shapes["n_frames"] = (n_frames, (B,))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"ingest_train writes f32 or bf16; got {dtype}")


def route(clips_u8: torch.Tensor, out: torch.Tensor, crop: int) -> int:
    """Outputs a piece of K6 holds for these tensors, as ``csrc/ingest.cu``
    chooses: 16 bytes' worth of ``out`` (8 bf16, 4 f32) on the vector route,
    where the crop is a whole number of pieces, a source row a whole number
    of words of as many bytes, and both pointers are 16-byte aligned; else 1
    (the scalar route)."""
    epv = PIECE_BYTES // out.element_size()
    W = clips_u8.shape[-1]
    if (crop % epv == 0 and W % epv == 0 and clips_u8.data_ptr() % PIECE_BYTES == 0
            and out.data_ptr() % PIECE_BYTES == 0):
        return epv
    return 1


def ingest_train_plain(clips_u8: torch.Tensor, offsets: torch.Tensor,
                       flip: torch.Tensor, frame_map: torch.Tensor, crop: int,
                       dtype: torch.dtype = torch.bfloat16,
                       n_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K6.  Plans are clamped into the frame, as the kernel
    clamps them (``make_train_plans`` never leaves it)."""
    _check(clips_u8, offsets, flip, frame_map, crop, dtype, n_frames)
    B, T, H, W = clips_u8.shape
    rows = torch.arange(B, device=clips_u8.device)[:, None]
    clips = clips_u8[rows, frame_map.long().clamp(0, T - 1)]
    offs = torch.stack([offsets[..., 0].clamp(0, H - crop),
                        offsets[..., 1].clamp(0, W - crop)], dim=-1)
    cropped = crop_frames(clips, offs, crop)
    cropped = torch.where(flip.bool()[:, None, None, None], cropped.flip(-1),
                          cropped)
    x = (cropped.to(torch.float32) * INV_STD) - SHIFT
    if n_frames is not None:
        valid = torch.arange(T, device=x.device)[None, :] < n_frames[:, None]
        x = torch.where(valid[:, :, None, None], x, 0.0)
    return x.to(dtype)


def ingest_train(clips_u8: torch.Tensor, offsets: torch.Tensor,
                 flip: torch.Tensor, frame_map: torch.Tensor, crop: int,
                 dtype: torch.dtype = torch.bfloat16,
                 n_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: (B, T, H, W) uint8 clips + plans -> (B, T, crop, crop) in
    ``dtype`` (f32 or bf16).  offsets: (B, T, 2) per-frame (y, x) in
    [0, H - crop]; flip: (B,) bool; frame_map: (B, T) source frames;
    n_frames: optional (B,) valid-frame counts.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    _check(clips_u8, offsets, flip, frame_map, crop, dtype, n_frames)
    if clips_u8.device.type == "cpu":
        return ingest_train_plain(clips_u8, offsets, flip, frame_map, crop,
                                  dtype, n_frames)
    if clips_u8.device.type != "cuda":
        raise ValueError(f"ingest_train: unsupported device {clips_u8.device}")
    B, T, H, W = clips_u8.shape
    dev = clips_u8.device
    clips = clips_u8.contiguous()
    plans = [t.to(device=dev, dtype=torch.int32).contiguous()
             for t in (offsets, frame_map)]
    fl = flip.to(device=dev, dtype=torch.uint8).contiguous()
    nf = (None if n_frames is None
          else n_frames.to(device=dev, dtype=torch.int32).contiguous())
    out = torch.empty((B, T, crop, crop), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    err = _build.library().sbl_ingest_train(
        clips.data_ptr(), plans[0].data_ptr(), fl.data_ptr(),
        plans[1].data_ptr(), None if nf is None else nf.data_ptr(),
        out.data_ptr(), B, T, H, W, crop, INV_STD, SHIFT, _DTYPE_CODES[dtype],
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ingest_train")
    ingest_train.launches += 1
    return out


ingest_train.launches = 0
