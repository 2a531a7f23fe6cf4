"""Small-sequence attention kernels and their plain PyTorch versions.

Counterparts of the JAX package's ``ops/attention.py`` Pallas TPU kernels,
all on the projections' FLAT (B, T, H·d) layout with the head split and
merge done inside the kernel and the softmax in f32:

* K1 ``small_mha_flat`` (``fused_small_mha_flat``): softmax(Q Kᵀ · scale +
  bias) V, the deterministic attention of recognize.  CUDA source
  ``csrc/attention.cu``.
* K3 ``small_mha_dropout_fwd_flat`` (``fused_small_mha_dropout_fwd_flat``):
  K1's math with attention-probability dropout, the keep mask drawn in the
  kernel from a seed; K4 ``small_mha_dropout_bwd_flat``
  (``fused_small_mha_dropout_bwd_flat``): its dQ, dK, dV, regenerating the
  mask from the same seed; K5 ``dropout_keep_mask_flat``: that mask.  CUDA
  source ``csrc/attention_train.cu``, whose header gives the Philox counter
  layout that ``philox4x32_10`` here reproduces bit for bit.
* ``small_mha_dropout_flat``: the ``torch.autograd.Function`` the training
  path calls (JAX ``small_mha_dropout_grad_flat``, a custom VJP): K3 forward,
  K4 backward, saving only q, k, v and the bias.

Each kernel wrapper takes its plain version on a CPU tensor; on a CUDA
tensor it launches the kernel or raises.  ``<wrapper>.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils.device import resolve_device
from . import _build

# additive fill for disallowed positions; -inf is avoided so a fully masked
# row gives a uniform distribution instead of NaN (JAX models/layers.py)
MASK_FILL = -1e9

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64  # the one head width the kernels are built for (d_k = d_v = 64)
# the training kernels give each key one lane of a warp
TRAIN_MAX_T = 32


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


def _check_cuda(name, tensors, bias, d, max_t=None):
    """Refuse what a CUDA kernel does not take: tensors[0] is q, whose
    device and dtype every other operand shares; the bias is f32."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    every = tensors if bias is None else tensors + (bias,)
    if any(t.device != q.device for t in every):
        raise ValueError(f"{name}: operands on different devices")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name}: dtypes "
                         f"{'/'.join(str(t.dtype) for t in tensors)} not supported")
    if bias is not None and bias.dtype != torch.float32:
        raise ValueError(f"{name}: bias must be float32, got {bias.dtype}")
    if not all(t.is_contiguous() for t in every):
        raise ValueError(f"{name}: inputs must be contiguous")
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head dim {d}; the kernel takes {HEAD_DIM}")
    if max_t is not None and max(t.shape[1] for t in tensors) > max_t:
        raise ValueError(f"{name}: sequence length above {max_t}")


def _scale(scale, D, n_head):
    return 1.0 / math.sqrt(D // n_head) if scale is None else scale


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, H*d) -> (B, H, T, d), upcast to at least f32."""
    B, T, D = x.shape
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return x.reshape(B, T, n_head, D // n_head).transpose(1, 2)


def _merge(x: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, T, d) -> (B, T, H*d) in ``dtype``."""
    B, H, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, H * d).to(dtype)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def small_mha_flat_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_head: int, bias: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K1: same signature and math, operands
    upcast to f32, output in q's dtype."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    scale = _scale(scale, D, n_head)
    s = torch.matmul(_heads(q, n_head), _heads(k, n_head).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(s.dtype)[:, None]
    p = torch.softmax(s, dim=-1)
    return _merge(torch.matmul(p, _heads(v, n_head)), q.dtype)


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
    _check_cuda("small_mha_flat", (q, k, v), bias, D // n_head)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _build.library().sbl_small_mha_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, Tq, Tk, n_head, D // n_head, int(bias is not None and bias.shape[0] > 1),
        float(_scale(scale, D, n_head)), _DTYPE_CODES[q.dtype], q.device.index,
        _stream(q.device))
    _build.check(err, "small_mha_flat")
    small_mha_flat.launches += 1
    return out


small_mha_flat.launches = 0


# ---------------------------------------------------------------------------
# Training attention: dropout on the attention probabilities (K3, K4, K5).
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def dropout_threshold(rate: float) -> int:
    """keep <=> bits >= uint32(rate * 2^32), the JAX kernels' threshold."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1); got {rate}")
    return int(rate * 4294967296.0)


def _check_seed(seed) -> int:
    if not 0 <= int(seed) < 2 ** 64:
        raise ValueError(f"seed must be a 64-bit unsigned integer; got {seed}")
    return int(seed)


def _mulhilo32(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors holding uint32
    values: a splits into 16-bit halves so no product leaves int64."""
    lo_part = (a & 0xFFFF) * m
    hi_part = (a >> 16) * m
    mid = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter, seed: int):
    """Philox4x32-10 (Random123's constants) in plain PyTorch: ``counter``
    is four broadcastable int64 tensors of uint32 words, ``seed`` a 64-bit
    key.  Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo32(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_keep_mask_flat_plain(B: int, Tq: int, Tk: int, H: int, seed: int,
                                 rate: float, device=None) -> torch.Tensor:
    """Plain version of K5: the (B, H, Tq, Tk) bool keep mask, from word 0
    of Philox4x32-10 at counter (key, query, head, batch row)."""
    seed = _check_seed(seed)

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    bits = philox4x32_10((axis(Tk, 3), axis(Tq, 2), axis(H, 1), axis(B, 0)),
                         seed)[0]
    return bits >= dropout_threshold(rate)


def dropout_keep_mask_flat(B: int, Tq: int, Tk: int, H: int, seed: int,
                           rate: float, device=None) -> torch.Tensor:
    """K5: the (B, H, Tq, Tk) bool keep mask that K3 and K4 draw for
    ``seed`` on a (B, Tq, H*d) x (B, Tk, H*d) launch.  On a CUDA device (the
    default) it launches the kernel, and raises without a card; on the CPU
    (``device="cpu"``) it takes the plain version."""
    seed = _check_seed(seed)
    thresh = dropout_threshold(rate)
    device = resolve_device(device)
    if device.type == "cpu":
        return dropout_keep_mask_flat_plain(B, Tq, Tk, H, seed, rate, device)
    if device.type != "cuda":
        raise ValueError(f"dropout_keep_mask_flat: unsupported device {device}")
    out = torch.empty((B, H, Tq, Tk), dtype=torch.bool, device=device)
    if out.numel() == 0:
        return out
    err = _build.library().sbl_dropout_keep_mask_flat(
        out.data_ptr(), B, H, Tq, Tk, seed, thresh, device.index,
        _stream(device))
    _build.check(err, "dropout_keep_mask_flat")
    dropout_keep_mask_flat.launches += 1
    return out


dropout_keep_mask_flat.launches = 0


def _train_probs(q, k, v, n_head, bias, seed, rate, scale, keep):
    """Shared plain forward/backward recompute: heads (B, H, T, d), P and
    P after dropout (B, H, Tq, Tk) in at least f32, and the keep mask (None
    at rate 0, where nothing is drawn)."""
    qh, kh, vh = _heads(q, n_head), _heads(k, n_head), _heads(v, n_head)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(s.dtype)[:, None]
    p = torch.softmax(s, dim=-1)
    if rate == 0.0:
        return qh, kh, vh, p, p, None
    if keep is None:
        keep = dropout_keep_mask_flat_plain(q.shape[0], q.shape[1], k.shape[1],
                                            n_head, seed, rate, q.device)
    return qh, kh, vh, p, torch.where(keep, p, 0.0) * (1.0 / (1.0 - rate)), keep


def small_mha_dropout_flat_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, n_head: int,
                                 bias: Optional[torch.Tensor] = None,
                                 seed: int = 0, rate: float = 0.0,
                                 scale: Optional[float] = None,
                                 keep: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain version of K3.  ``keep`` injects a (B, H, Tq, Tk) mask; by
    default it is drawn from ``seed`` with the plain Philox (K5's bits)."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    dropout_threshold(rate)
    _, _, vh, _, pd, _ = _train_probs(q, k, v, n_head, bias, seed, rate,
                                      _scale(scale, D, n_head), keep)
    return _merge(torch.matmul(pd, vh), q.dtype)


def small_mha_dropout_bwd_flat_plain(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, n_head: int,
                                     bias: Optional[torch.Tensor],
                                     seed: int, rate: float,
                                     scale: Optional[float],
                                     dout: torch.Tensor,
                                     keep: Optional[torch.Tensor] = None):
    """Plain version of K4: (dq, dk, dv) of K3 for the output gradient
    ``dout``, in the dtypes of q, k, v, by the JAX kernel's formulas."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q")
    dropout_threshold(rate)
    scale = _scale(scale, D, n_head)
    qh, kh, vh, p, pd, keep = _train_probs(q, k, v, n_head, bias, seed, rate,
                                           scale, keep)
    g = _heads(dout, n_head)
    dv = torch.matmul(pd.transpose(-1, -2), g)
    dp = torch.matmul(g, vh.transpose(-1, -2))
    if keep is not None:
        dp = torch.where(keep, dp, 0.0) * (1.0 / (1.0 - rate))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


def _dropout_launch_args(rate):
    return dropout_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0)


def small_mha_dropout_fwd_flat(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, n_head: int,
                               bias: Optional[torch.Tensor] = None,
                               seed: int = 0, rate: float = 0.0,
                               scale: Optional[float] = None) -> torch.Tensor:
    """K3: flat attention with dropout ``rate`` on its probabilities, the
    mask drawn from ``seed``.  CUDA tensors (d = 64, Tq and Tk at most 32,
    f32 or bf16, contiguous) launch the kernel; CPU tensors take the plain
    version."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    seed = _check_seed(seed)
    thresh, inv_keep, on = _dropout_launch_args(rate)
    if q.device.type == "cpu":
        return small_mha_dropout_flat_plain(q, k, v, n_head, bias, seed, rate,
                                            scale)
    _check_cuda("small_mha_dropout_fwd_flat", (q, k, v), bias, D // n_head,
                TRAIN_MAX_T)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _build.library().sbl_small_mha_dropout_fwd_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, Tq, Tk, n_head, D // n_head, int(bias is not None and bias.shape[0] > 1),
        float(_scale(scale, D, n_head)), seed, thresh, inv_keep, on,
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q.device))
    _build.check(err, "small_mha_dropout_fwd_flat")
    small_mha_dropout_fwd_flat.launches += 1
    return out


small_mha_dropout_fwd_flat.launches = 0


def small_mha_dropout_bwd_flat(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, n_head: int,
                               bias: Optional[torch.Tensor], seed: int,
                               rate: float, scale: Optional[float],
                               dout: torch.Tensor):
    """K4: (dq, dk, dv) of K3, regenerating its mask from ``seed``.  CUDA
    tensors launch the kernel (K3's conditions, dout like q); CPU tensors
    take the plain version."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q")
    seed = _check_seed(seed)
    thresh, inv_keep, on = _dropout_launch_args(rate)
    if q.device.type == "cpu":
        return small_mha_dropout_bwd_flat_plain(q, k, v, n_head, bias, seed,
                                                rate, scale, dout)
    _check_cuda("small_mha_dropout_bwd_flat", (q, k, v, dout), bias,
                D // n_head, TRAIN_MAX_T)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    err = _build.library().sbl_small_mha_dropout_bwd_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Tq, Tk, n_head, D // n_head, int(bias is not None and bias.shape[0] > 1),
        float(_scale(scale, D, n_head)), seed, thresh, inv_keep, on,
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q.device))
    _build.check(err, "small_mha_dropout_bwd_flat")
    small_mha_dropout_bwd_flat.launches += 1
    return dq, dk, dv


small_mha_dropout_bwd_flat.launches = 0


class _DropoutAttention(torch.autograd.Function):
    """Forward K3 (or its plain version), backward K4 (or its plain
    version); saves only q, k, v and the bias, as the JAX custom VJP saves
    (q2, k2, v2, bias, seed).  The bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, n_head, seed, rate, scale, use_kernels):
        ctx.save_for_backward(q, k, v, bias)
        ctx.args = (n_head, seed, rate, scale, use_kernels)
        fwd = (small_mha_dropout_fwd_flat if use_kernels
               else small_mha_dropout_flat_plain)
        return fwd(q, k, v, n_head, bias, seed, rate, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        n_head, seed, rate, scale, use_kernels = ctx.args
        bwd = (small_mha_dropout_bwd_flat if use_kernels
               else small_mha_dropout_bwd_flat_plain)
        dq, dk, dv = bwd(q, k, v, n_head, bias, seed, rate, scale,
                         dout.contiguous())
        return dq, dk, dv, None, None, None, None, None, None


def small_mha_dropout_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_head: int, bias: Optional[torch.Tensor] = None,
                           seed: int = 0, rate: float = 0.0,
                           scale: Optional[float] = None,
                           use_kernels: bool = True) -> torch.Tensor:
    """Differentiable training attention (JAX ``small_mha_dropout_grad_flat``):
    K3 forward and K4 backward through their wrappers (plain versions on CPU
    tensors), or with ``use_kernels=False`` the plain versions on any
    device.  At rate 0 nothing is drawn and the forward is K1's math."""
    return _DropoutAttention.apply(q, k, v, bias, n_head, seed, rate, scale,
                                   use_kernels)
