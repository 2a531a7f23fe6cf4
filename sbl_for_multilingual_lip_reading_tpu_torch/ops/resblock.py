"""Fused eval-mode ResNet BasicBlock (kernel K10) and its plain PyTorch
version.

Counterpart of the JAX package's ``ops/resblock.py`` (a Pallas TPU kernel
behind ``use_pallas_resblock``, default off there and here): a stride-1
block whose input and output widths are equal, with both eval BatchNorms
folded into per-channel affines,

    h   = relu(conv3x3(x, w1) * a1 + b1)       rounded to x's dtype
    out = relu(conv3x3(h, w2) * a2 + b2 + x)   residual added in f32

The JAX function takes NHWC activations and HWIO weights; the port's
frontend is NCHW with OIHW weights, and these functions take that layout as
it is: x (N, C, S, S), w (C, C, 3, 3).  Both convolutions accumulate in f32
over operands in x's dtype.  (The kernel walks K as (ky, kx, in), as the TPU
kernel does, so its wrapper re-lays the 9 C^2 weights once per call; no
activation is copied.)  The CUDA kernel is ``csrc/resblock.cu``; its
design note is there.

``fused_resblock`` is the wrapper ``BasicBlock`` calls.  On CPU tensors it
runs ``fused_resblock_plain``; on CUDA tensors it launches the kernel or
raises.  ``fused_resblock.launches`` counts the kernel's launches.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from .ingest import _DTYPE_CODES

MAX_TILE = 8    # samples a thread block takes at most (f32 route)
WHOLE_PLANE = 11  # planes up to this side are never cut into row bands (f32)
# pixels one pass of the bf16 route's GEMM covers (two warpgroups of 4
# tiles of 64 rows, csrc/resblock.cu's kConvMaxMB)
PASS_PIXELS = 512


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, epsilon: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm y = (x - mean) * rsqrt(var + eps) * scale + bias as a
    per-channel affine y = x * a + b, all f32 (JAX ``fold_bn``)."""
    inv = torch.rsqrt(var.to(torch.float32) + epsilon) * scale.to(torch.float32)
    return inv, bias.to(torch.float32) - mean.to(torch.float32) * inv


def _check(x, w1, a1, b1, w2, a2, b2):
    if x.dim() != 4 or x.shape[2] != x.shape[3]:
        raise ValueError(f"x must be (N, C, S, S); got {tuple(x.shape)}")
    C = x.shape[1]
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (C, C, 3, 3):
            raise ValueError(f"{name} must be ({C}, {C}, 3, 3); got "
                             f"{tuple(w.shape)}")
        if w.dtype != x.dtype:
            raise ValueError(f"{name} is {w.dtype}, x is {x.dtype}")
    for name, v in (("a1", a1), ("b1", b1), ("a2", a2), ("b2", b2)):
        if tuple(v.shape) != (C,):
            raise ValueError(f"{name} must be ({C},); got {tuple(v.shape)}")


def _conv_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 'same' conv of operands in their dtype with an f32 result: the
    values are widened (exactly) and the conv runs in full f32."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv2d(x.to(torch.float32), w.to(torch.float32), padding=1)


def fused_resblock_plain(x: torch.Tensor, w1: torch.Tensor, a1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor, a2: torch.Tensor,
                         b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10, with the kernel's rounding points."""
    _check(x, w1, a1, b1, w2, a2, b2)
    ch = (1, -1, 1, 1)
    a1, b1, a2, b2 = (v.to(torch.float32).view(ch) for v in (a1, b1, a2, b2))
    h = torch.relu(_conv_f32(x, w1) * a1 + b1).to(x.dtype)
    y = _conv_f32(h, w2) * a2 + b2 + x.to(torch.float32)
    return torch.relu(y).to(x.dtype)


def pick_mma_tile(lib, C: int, S: int) -> Tuple[int, int]:
    """(samples, output rows) a block takes on the bf16 route: whole
    planes, as many samples as one GEMM pass (PASS_PIXELS pixels) and the
    shared memory take; else one sample in the fewest equal row bands
    whose conv1 rows fit a pass and the shared memory; else the tallest
    band the shared memory takes (its GEMMs then take several passes).
    The shared memory is the source's sizer's count."""
    def fits(bt, bh):
        return lib.sbl_resblock_mma_smem_bytes(C, S, bt, bh) <= _build.MAX_SMEM_BYTES
    if S * S <= PASS_PIXELS and fits(1, S):
        bt = 1
        while (bt + 1) * S * S <= PASS_PIXELS and fits(bt + 1, S):
            bt += 1
        return bt, S
    for bands in range(2, S + 1):
        bh = -(-S // bands)
        if min(bh + 2, S) * S <= PASS_PIXELS and fits(1, bh):
            return 1, bh
    for bh in range(S, 0, -1):
        if fits(1, bh):
            return 1, bh
    raise ValueError(f"fused_resblock: a {C}-channel row of width {S} does "
                     f"not fit the kernel's shared memory")


def pick_tile(lib, C: int, S: int, elem: int) -> Tuple[int, int]:
    """(samples, output rows) a thread block takes on the f32 route: whole planes, as many
    samples as fit (at most MAX_TILE), for planes up to WHOLE_PLANE wide;
    one sample in the tallest row band that fits for larger ones."""
    def fits(bt, bh):
        # 1 KB stays free for the kernel's static tables
        return (lib.sbl_resblock_smem_bytes(C, S, bt, bh, elem)
                <= _build.MAX_SMEM_BYTES - 1024)
    if S <= WHOLE_PLANE:
        for bt in range(MAX_TILE, 0, -1):
            if fits(bt, S):
                return bt, S
    for bh in range(S, 0, -1):
        if fits(1, bh):
            return 1, bh
    raise ValueError(f"fused_resblock: a {C}-channel row of width {S} does "
                     f"not fit the kernel's shared memory")


def fused_resblock(x: torch.Tensor, w1: torch.Tensor, a1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, a2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    """K10: x (N, C, S, S) f32 or bf16, w1/w2 (C, C, 3, 3) in x's dtype,
    a*/b* (C,) folded BN affines.  Returns relu(bn2(conv2(relu(bn1(conv1(x)))))
    + x) in x's dtype.  CUDA tensors (contiguous) launch the kernel; CPU
    tensors take the plain version."""
    _check(x, w1, a1, b1, w2, a2, b2)
    if x.device.type == "cpu":
        return fused_resblock_plain(x, w1, a1, b1, w2, a2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_resblock: dtype {x.dtype} not supported")
    if not x.is_contiguous():
        raise ValueError("fused_resblock: x must be contiguous")
    N, C, S, _ = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    aff = torch.stack([a1, b1, a2, b2]).to(device=x.device,
                                           dtype=torch.float32).contiguous()
    # the kernel's K order is (ky, kx, in), the TPU kernel's: one tap's input
    # channels contiguous.  Only the 9 C^2 weights are re-laid; x is read
    # and out written as NCHW
    w1k = w1.permute(0, 2, 3, 1).contiguous()
    w2k = w2.permute(0, 2, 3, 1).contiguous()
    lib = _build.library()
    if x.dtype == torch.bfloat16:
        bt, bh = pick_mma_tile(lib, C, S)
    else:
        bt, bh = pick_tile(lib, C, S, x.element_size())
    err = lib.sbl_fused_resblock(
        x.data_ptr(), w1k.data_ptr(), w2k.data_ptr(), aff.data_ptr(),
        out.data_ptr(), N, C, S, bt, bh, _DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_resblock")
    fused_resblock.launches += 1
    return out


fused_resblock.launches = 0
