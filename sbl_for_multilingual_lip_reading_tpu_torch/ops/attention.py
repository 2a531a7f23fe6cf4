"""Fused small-sequence attention (kernel K1) and its plain PyTorch version.

Counterpart of the JAX package's ``ops/attention.py::fused_small_mha_flat``
(a Pallas TPU kernel): softmax(Q Kᵀ · scale + bias) V per (batch row, head)
on the projections' FLAT (B, T, H·d) layout, the head split and merge done
inside the kernel, the softmax in f32.  The CUDA kernel is
``csrc/attention.cu``; its design note is there.

``small_mha_flat`` is the wrapper the model calls.  On a CPU tensor it runs
``small_mha_flat_plain``; on a CUDA tensor it launches the kernel or raises.
``small_mha_flat.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

# additive fill for disallowed positions; -inf is avoided so a fully masked
# row gives a uniform distribution instead of NaN (JAX models/layers.py)
MASK_FILL = -1e9

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64  # the one head width the kernel is built for (d_k = d_v = 64)


def mask_to_bias(mask: torch.Tensor, tq: int, tk: int) -> torch.Tensor:
    """Boolean mask (True = disallowed) broadcastable to (mb, Tq, Tk) ->
    contiguous additive f32 bias (mb, Tq, Tk), the form the flat kernel
    takes (one bias per batch row, shared by all heads).  The JAX
    ``mask_to_bias`` returns the same values with a head axis,
    (mb, 1, Tq, Tk), for its legacy (B, H, T, d) kernel."""
    mask = torch.broadcast_to(mask, (mask.shape[0], tq, tk))
    return torch.where(mask, MASK_FILL, 0.0).to(torch.float32).contiguous()


def _check(q, k, v, n_head, bias):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q/k/v must be (B, T, H*d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, D) or v.shape != (B, Tk, D):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if n_head <= 0 or D % n_head:
        raise ValueError(f"width {D} is not divisible by n_head={n_head}")
    if Tk == 0:
        raise ValueError("attention over zero keys")
    if bias is not None and (bias.dim() != 3 or bias.shape[0] not in (1, B)
                             or tuple(bias.shape[1:]) != (Tq, Tk)):
        raise ValueError(f"bias must be (1|{B}, {Tq}, {Tk}); got "
                         f"{tuple(bias.shape)}")
    return B, Tq, Tk, D


def small_mha_flat_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_head: int, bias: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K1: same signature and math, operands
    upcast to f32, output in q's dtype."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    d = D // n_head
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def heads(x, T):
        return x.to(torch.float32).reshape(B, T, n_head, d).transpose(1, 2)

    s = torch.matmul(heads(q, Tq), heads(k, Tk).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(torch.float32)[:, None]
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, heads(v, Tk))
    return o.transpose(1, 2).reshape(B, Tq, D).to(q.dtype)


def small_mha_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   n_head: int, bias: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Tq, H*d), k/v: (B, Tk, H*d); bias: optional additive
    (1|B, Tq, Tk) f32 (broadcast over heads).  Returns (B, Tq, H*d) in q's
    dtype.  CUDA tensors launch kernel K1 (d = 64; f32 or bf16; all
    contiguous); CPU tensors take the plain version."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    if q.device.type == "cpu":
        return small_mha_flat_plain(q, k, v, n_head, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"small_mha_flat: unsupported device {q.device}")
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    if any(t.device != q.device for t in tensors):
        raise ValueError("small_mha_flat: q/k/v/bias on different devices")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"small_mha_flat: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype} not supported")
    if bias is not None and bias.dtype != torch.float32:
        raise ValueError(f"small_mha_flat: bias must be float32, got "
                         f"{bias.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("small_mha_flat: inputs must be contiguous")
    d = D // n_head
    if d != HEAD_DIM:
        raise ValueError(f"small_mha_flat: head dim {d}; the kernel takes "
                         f"{HEAD_DIM}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    err = lib.sbl_small_mha_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, Tq, Tk, n_head, d, int(bias is not None and bias.shape[0] > 1),
        float(scale), _DTYPE_CODES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "small_mha_flat")
    small_mha_flat.launches += 1
    return out


small_mha_flat.launches = 0
