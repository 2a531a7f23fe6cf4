"""Temporal frame stack for the Conv3D-as-2D stem (kernel K2), the same
fused with the uint8 eval ingest (kernel K9), and their plain PyTorch
versions.

Counterpart of the JAX package's ``ops/stem.py::stack_frames`` (a Pallas TPU
kernel).  The frontend runs the reference's Conv3d(1->64, k=(5,7,7)) as a
2-D conv over 5 temporally shifted copies of each frame stacked into input
channels; this op builds that stack in one pass:

    (B, T, H, W) -> (B, T, kt, H, W),  out[b, t, k] = video[b, t + k - kt//2]

with zero padding at the temporal edges.  The CUDA kernel is
``csrc/stem.cu``; its design note is there.

``stack_frames`` is the wrapper the frontend calls.  On a CPU tensor it runs
``stack_frames_plain``; on a CUDA tensor it launches the kernel or raises.
``stack_frames.launches`` counts the kernel's launches.

``stack_frames_u8`` (JAX ``ops/stem.py::stack_frames_u8``) goes from the
uint8 clips to the stacked, normalized tensor in one pass: center crop,
``x * (1 / (255 STD)) - MEAN / STD`` (two f32 roundings, as the TPU kernel
writes it; ``data/ingest.py::device_ingest`` computes ``(x / 255 - MEAN) /
STD``, which rounds differently), cast, stack.  It zeroes no padding frames
(no ``n_frames``), so it serves fixed-length batches; as in the JAX package
no entry point calls it, and ``VisualFrontend.forward_stacked`` takes its
output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .ingest import _DTYPE_CODES, INV_STD, SHIFT

VECTOR_BYTES = 16  # the kernel's access width: planes and pointers align to it


def _check(video: torch.Tensor, kt: int):
    if video.dim() != 4:
        raise ValueError(f"video must be (B, T, H, W); got {tuple(video.shape)}")
    if kt <= 0:
        raise ValueError(f"kt must be positive; got {kt}")


def stack_frames_plain(video: torch.Tensor, kt: int = 5) -> torch.Tensor:
    """Plain PyTorch version of K2 (pad + kt shifted slices)."""
    _check(video, kt)
    T = video.shape[1]
    pad = kt // 2
    xp = F.pad(video, (0, 0, 0, 0, pad, pad))
    return torch.stack([xp[:, k:k + T] for k in range(kt)], dim=2)


def stack_frames(video: torch.Tensor, kt: int = 5) -> torch.Tensor:
    """(B, T, H, W) -> (B, T, kt, H, W) temporal stack.  CUDA tensors
    (contiguous, any dtype, H*W*itemsize a multiple of 16 bytes) launch
    kernel K2; CPU tensors take the plain version."""
    _check(video, kt)
    if video.device.type == "cpu":
        return stack_frames_plain(video, kt)
    if video.device.type != "cuda":
        raise ValueError(f"stack_frames: unsupported device {video.device}")
    if not video.is_contiguous():
        raise ValueError("stack_frames: video must be contiguous")
    B, T, H, W = video.shape
    plane_bytes = H * W * video.element_size()
    if plane_bytes % VECTOR_BYTES or video.data_ptr() % VECTOR_BYTES:
        raise ValueError(f"stack_frames: the kernel copies {VECTOR_BYTES}-byte "
                         f"vectors; a {H}x{W} {video.dtype} plane is "
                         f"{plane_bytes} B at address {video.data_ptr():#x}")
    out = torch.empty((B, T, kt, H, W), dtype=video.dtype, device=video.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    err = lib.sbl_stack_frames(
        video.data_ptr(), out.data_ptr(), B, T, plane_bytes,
        kt, video.device.index,
        torch.cuda.current_stream(video.device).cuda_stream)
    _build.check(err, "stack_frames")
    stack_frames.launches += 1
    return out


stack_frames.launches = 0


def _check_u8(clips_u8: torch.Tensor, crop: int, dtype, kt: int) -> int:
    """Validate; returns the center crop's offset (JAX: round((H-crop)/2),
    Python's round, for rows and columns alike)."""
    if clips_u8.dim() != 4 or clips_u8.dtype != torch.uint8:
        raise ValueError(f"clips must be (B, T, H, W) uint8; got "
                         f"{tuple(clips_u8.shape)} {clips_u8.dtype}")
    H, W = clips_u8.shape[2:]
    c0 = int(round((H - crop) / 2.0))
    if kt <= 0 or crop <= 0 or c0 < 0 or c0 + crop > min(H, W):
        raise ValueError(f"cannot center-crop {H}x{W} frames to {crop} "
                         f"(kt={kt})")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"stack_frames_u8 writes f32 or bf16; got {dtype}")
    return c0


def stack_frames_u8_plain(clips_u8: torch.Tensor, crop: int,
                          dtype: torch.dtype = torch.bfloat16,
                          kt: int = 5) -> torch.Tensor:
    """Plain PyTorch version of K9: crop, normalize with two roundings,
    cast, then K2's plain stack."""
    c0 = _check_u8(clips_u8, crop, dtype, kt)
    x = clips_u8[:, :, c0:c0 + crop, c0:c0 + crop].to(torch.float32)
    return stack_frames_plain(((x * INV_STD) - SHIFT).to(dtype), kt)


def stack_frames_u8(clips_u8: torch.Tensor, crop: int,
                    dtype: torch.dtype = torch.bfloat16,
                    kt: int = 5) -> torch.Tensor:
    """K9: (B, T, H, W) uint8 -> (B, T, kt, crop, crop) normalized ``dtype``
    (f32 or bf16), center-cropped and temporally stacked.  CUDA tensors
    (contiguous) launch the kernel; CPU tensors take the plain version."""
    c0 = _check_u8(clips_u8, crop, dtype, kt)
    if clips_u8.device.type == "cpu":
        return stack_frames_u8_plain(clips_u8, crop, dtype, kt)
    if clips_u8.device.type != "cuda":
        raise ValueError(f"stack_frames_u8: unsupported device {clips_u8.device}")
    if not clips_u8.is_contiguous():
        raise ValueError("stack_frames_u8: clips must be contiguous")
    B, T, H, W = clips_u8.shape
    out = torch.empty((B, T, kt, crop, crop), dtype=dtype,
                      device=clips_u8.device)
    if out.numel() == 0:
        return out
    err = _build.library().sbl_stack_frames_u8(
        clips_u8.data_ptr(), out.data_ptr(), B, T, H, W, crop, c0, kt, INV_STD,
        SHIFT, _DTYPE_CODES[dtype], clips_u8.device.index,
        torch.cuda.current_stream(clips_u8.device).cuda_stream)
    _build.check(err, "stack_frames_u8")
    stack_frames_u8.launches += 1
    return out


stack_frames_u8.launches = 0
