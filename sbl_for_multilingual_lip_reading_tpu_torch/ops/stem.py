"""Temporal frame stack for the Conv3D-as-2D stem (kernel K2) and its plain
PyTorch version.

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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

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
