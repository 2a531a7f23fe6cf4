"""Small-sequence attention kernels and their plain PyTorch versions.

Counterparts of the JAX package's ``ops/attention.py`` Pallas TPU kernels.
The main paths use the projections' FLAT (B, T, H·d) layout, with the head
split and merge done inside the kernel and the softmax in f32:

* K1 ``small_mha_flat`` (``fused_small_mha_flat``): softmax(Q Kᵀ · scale +
  bias) V, the deterministic attention of recognize.  CUDA source
  ``csrc/attention.cu``.
* K3 ``small_mha_dropout_fwd_flat`` (``fused_small_mha_dropout_fwd_flat``):
  K1's math with attention-probability dropout, the keep mask drawn in the
  kernel from a seed; K4 ``small_mha_dropout_bwd_flat``
  (``fused_small_mha_dropout_bwd_flat``): its dQ, dK, dV, regenerating the
  mask from the same seed; K5 ``dropout_keep_mask_flat``: that mask.  CUDA
  source ``csrc/attention_train.cu``, whose header gives the Philox counter
  layout that ``philox4x32_10`` here reproduces bit for bit.  Two maps place
  a launch in the one-process run whose masks it draws: ``rows``
  (``BatchRows``, a data-parallel process's batch rows) and ``h0`` (the
  first of a tensor-parallel process's heads: the counter's head is
  h0 + h).
* ``small_mha_dropout_flat``: the ``torch.autograd.Function`` the training
  path calls (JAX ``small_mha_dropout_grad_flat``, a custom VJP): K3 forward,
  K4 backward, saving only q, k, v and the bias.

* K13 ``cached_attention_step``: one autoregressive self-attention step
  over the flat (N, L, H·d) K/V caches of a KV-cached decoder, the new
  slot written in place (``MultiHeadAttention.decode_step``; the JAX
  package's is plain einsums, not a kernel).  CUDA source
  ``csrc/decode_attention.cu``.  It is not in ``ops.KERNELS``: its counts
  are ``.launches`` and ``.slots`` (rows x valid slots read).

The JAX package also kept two layouts that no model path of either package
calls (its tests and probes do); each has its counterpart here:

* the (B, T, H, d) twins.  A contiguous (B, T, H, d) tensor has the bytes
  of (B, T, H·d), so each twin launches the flat kernel on a VIEW, no copy:
  ``fused_small_mha`` (JAX ``fused_small_mha``, K1), ``small_mha_bwd``
  (JAX ``_small_mha_bwd``: K4 at rate 0, where no mask is drawn),
  ``small_mha_dropout_fwd`` / ``small_mha_dropout_bwd`` (JAX
  ``fused_small_mha_dropout_fwd`` / ``_bwd``: K3, K4) and
  ``dropout_keep_mask`` (K5); ``small_mha`` and ``small_mha_dropout`` are
  their autograd Functions (JAX ``small_mha_grad``,
  ``small_mha_dropout_grad``).  The JAX package kept them as kernels of
  their own because a Mosaic block spec binds the layout;
* K12 ``fused_mha`` (JAX ``fused_mha``), the legacy head-major (B, H, T, d)
  attention with a bias that may differ per head: K1's kernel body with the
  head-major strides (``csrc/attention.cu``, entry ``sbl_fused_mha``).

Each kernel wrapper takes its plain version on a CPU tensor; on a CUDA
tensor it launches the kernel or raises, and it refuses (never copies) a
non-contiguous input.  ``<wrapper>.launches`` counts the launches each
wrapper makes; a twin counts its own, not the flat kernel's.

Head widths.  K1/K12 and K3/K4 are built for d in HEAD_DIMS (a template
parameter of each kernel).  K1/K12 take any sequence lengths; K3/K4's f32
route stages a head's operands whole in shared memory, so their lengths
are bounded by ``train_smem_bytes`` (Tq = Tk <= 116 at d = 64), and their
bf16 (tensor-core) route, whose shared memory ``train_mma_smem_bytes``
counts, takes the same lengths.  ``models.build_model``
refuses a configuration whose shapes these kernels do not take before
anything runs on the card; a wrapper given such a CUDA tensor raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..utils.device import resolve_device
from . import _build

# additive fill for disallowed positions; -inf is avoided so a fully masked
# row gives a uniform distribution instead of NaN (JAX models/layers.py)
MASK_FILL = -1e9

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head widths the attention kernels are built for (a template parameter)
HEAD_DIMS = (16, 32, 64, 128)
_TRAIN_WARPS = 4   # warps of a K3/K4 f32 block
# csrc/mma.cuh: keys per score tile, and the most warps (16 rows each) of a
# tensor-core block
_KEY_TILE = 32
_MAX_MMA_WARPS = 4


def train_smem_bytes(tq: int, tk: int, d: int, backward: bool) -> int:
    """Bytes of shared memory a K3 (``backward`` False) or K4 block of the
    f32 route takes: the head's f32 rows of stride d + 1 (K and V; in K4
    also Q and dO), K4's (Tq, Tk) dS and dropped P, and a row of Tk per warp
    (csrc/attention_train.cu ``f32_smem_bytes``).  It bounds the lengths
    both routes take."""
    pad = d + 1
    if not backward:
        return 4 * (2 * tk * pad + _TRAIN_WARPS * d + _TRAIN_WARPS * tk)
    return 4 * ((2 * tq + 2 * tk) * pad + 2 * tq * tk + _TRAIN_WARPS * tk)


def train_mma_smem_bytes(tq: int, tk: int, d: int, backward: bool) -> int:
    """Bytes of shared memory a block of the bf16 (tensor-core) route takes.
    K3 runs K1's body: a tile of K and V and 16 query rows per warp, bf16
    rows of d + 8 (csrc/mma.cuh ``mma_smem_elems``), whatever the lengths.
    K4 stages Q and dO (rows padded to 16) and K and V (to tiles of 32 keys)
    whole, per query row three f32 statistics and one keep word per key
    tile, and, at one key tile and at most 64 query rows, the bf16 hi and lo
    halves of P_drop and dS in rows of 40 (csrc/attention_train.cu
    ``bwd_mma_smem_bytes``)."""
    if not backward:
        warps = min(-(-tq // 16), _MAX_MMA_WARPS)
        return 2 * (2 * _KEY_TILE + 16 * warps) * (d + 8)
    rows = -(-tq // 16) * 16
    key_tiles = -(-tk // _KEY_TILE)
    tiles = (4 * rows * (_KEY_TILE + 8) * 2
             if tk <= _KEY_TILE and tq <= 16 * _MAX_MMA_WARPS else 0)
    return (2 * (2 * rows + 2 * key_tiles * _KEY_TILE) * (d + 8)
            + 4 * rows * (3 + key_tiles) + tiles)


def train_kernels_fit(d: int, tq: int, tk: int) -> bool:
    """Whether K3 and K4 take head width d at query/key lengths tq, tk (the
    f32 route's shared memory bounds both routes)."""
    return d in HEAD_DIMS and all(
        train_smem_bytes(tq, tk, d, bwd) <= _build.MAX_SMEM_BYTES
        for bwd in (False, True))


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


def _check_cuda(name, tensors, bias, d, train=False):
    """Refuse what a CUDA kernel does not take: tensors[0] is q, whose
    device and dtype every other operand shares, tensors[1] k; the bias is
    f32.  ``train``: K3/K4, whose lengths ``train_kernels_fit`` bounds."""
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
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d}; the kernel takes {HEAD_DIMS}")
    if train:   # (B, T, ...) layouts: q's and k's T
        tq, tk = q.shape[1], tensors[1].shape[1]
        if not train_kernels_fit(d, tq, tk):
            raise ValueError(f"{name}: Tq={tq}, Tk={tk} at d={d} need more "
                             f"shared memory than a block may take")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: bf16 operands must be 16-byte aligned")


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
    dtype.  CUDA tensors launch kernel K1 (d in HEAD_DIMS; f32 or bf16; all
    contiguous, bf16 16-byte aligned); CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return small_mha_flat_plain(q, k, v, n_head, bias, scale)
    out = _k1("small_mha_flat", q, k, v, n_head, bias, scale)
    small_mha_flat.launches += 1
    return out


small_mha_flat.launches = 0


def _k1(name, q, k, v, n_head, bias, scale):
    """Launch K1 on flat CUDA operands (checked here) into a new tensor."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    _check_cuda(name, (q, k, v), bias, D // n_head)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _build.library().sbl_small_mha_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, Tq, Tk, n_head, D // n_head, int(bias is not None and bias.shape[0] > 1),
        float(_scale(scale, D, n_head)), _DTYPE_CODES[q.dtype], q.device.index,
        _stream(q.device))
    _build.check(err, name)
    return out


# ---------------------------------------------------------------------------
# Training attention: dropout on the attention probabilities (K3, K4, K5).
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
MAX_MASK_ELEMENTS = 2 ** 31  # K5 indexes its elements in 32 bits


def dropout_threshold(rate: float) -> int:
    """keep <=> bits >= uint32(rate * 2^32), the JAX kernels' threshold."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1); got {rate}")
    return int(rate * 4294967296.0)


def _check_seed(seed):
    """A seed is a 64-bit unsigned int, or an int64 tensor of one element
    holding its bits (two's complement), on the device of the launch: the
    kernels read it there, so a step replayed as a CUDA graph reads each
    replay's seed; its value is never read on the host."""
    if torch.is_tensor(seed):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError(f"a seed tensor holds one int64; got {seed.dtype} "
                             f"{tuple(seed.shape)}")
        return seed
    if not 0 <= int(seed) < 2 ** 64:
        raise ValueError(f"seed must be a 64-bit unsigned integer; got {seed}")
    return int(seed)


def _seed_arg(seed, device, drawn: bool = True):
    """The address the kernels read the seed from: the element of an int64
    tensor on the launch's device (``DropoutRNG.seed``, a view of the train
    step's row there), so that a step replayed as a CUDA graph reads each
    replay's seed; None when nothing is drawn (dropout rate 0).  An int is
    refused here: only the plain versions take one, as the JAX package's
    tests give it."""
    seed = _check_seed(seed)
    if not drawn:
        return None
    if not torch.is_tensor(seed):
        raise ValueError("the kernels read their seed on the device: pass an "
                         "int64 tensor there, not an int")
    if seed.device != device:
        raise ValueError(f"the seed lies on {seed.device}, the launch on {device}")
    return seed.data_ptr()


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
    key (an int, or an int64 tensor of one element: ``_check_seed``).
    Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    if torch.is_tensor(seed):
        seed = seed.reshape(()).to(c0.device)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo32(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


class BatchRows(NamedTuple):
    """Where a launch's batch rows sit in the batch whose masks they take:
    local row b is row (b // local) * total + first + b % local of it.  A
    data-parallel process has (its first row, its rows, the whole batch),
    which also maps the decoder's (2 * local) rows, both directions in one
    launch, onto the 2 * total of the one-process run."""
    first: int
    local: int
    total: int


def _check_h0(H: int, h0: int) -> int:
    """The counter's first head: every head h0 + h below 2^31."""
    h0 = int(h0)
    if h0 < 0 or h0 + H > 2 ** 31:
        raise ValueError(f"head offset {h0} of {H} heads outside [0, 2^31)")
    return h0


def _row_args(B: int, rows: Optional[BatchRows]):
    """(row0, rows, row_stride) of the kernels' batch-row map: the identity
    without ``rows``."""
    if rows is None:
        return 0, B, B
    first, local, total = (int(r) for r in rows)
    if first < 0 or local <= 0 or total < first + local:
        raise ValueError(f"batch rows {tuple(rows)} do not lie in their batch")
    if ((B - 1) // local) * total + first + (B - 1) % local >= 2 ** 31:
        raise ValueError(f"batch rows {tuple(rows)} pass 2^31")
    return first, local, total


def dropout_keep_mask_flat_plain(B: int, Tq: int, Tk: int, H: int, seed: int,
                                 rate: float, device=None,
                                 rows: Optional[BatchRows] = None,
                                 h0: int = 0) -> torch.Tensor:
    """Plain version of K5: the (B, H, Tq, Tk) bool keep mask, from word 0
    of Philox4x32-10 at counter (key, query, h0 + head, batch row), the
    batch row mapped by ``rows`` where given."""
    seed = _check_seed(seed)
    row0, local, stride = _row_args(B, rows)
    h0 = _check_h0(H, h0)

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    b = axis(B, 0)
    b = (b // local) * stride + row0 + b % local
    bits = philox4x32_10((axis(Tk, 3), axis(Tq, 2), axis(H, 1) + h0, b),
                         seed)[0]
    return bits >= dropout_threshold(rate)


def dropout_keep_mask_flat(B: int, Tq: int, Tk: int, H: int, seed: int,
                           rate: float, device=None,
                           rows: Optional[BatchRows] = None,
                           h0: int = 0) -> torch.Tensor:
    """K5: the (B, H, Tq, Tk) bool keep mask that K3 and K4 draw for
    ``seed`` (and ``rows``, ``h0``) on a (B, Tq, H*d) x (B, Tk, H*d) launch.  On a
    CUDA device (the default) it launches the kernel, and raises without a
    card; on the CPU (``device="cpu"``) it takes the plain version."""
    device = resolve_device(device)
    if device.type == "cpu":
        return dropout_keep_mask_flat_plain(B, Tq, Tk, H, seed, rate, device,
                                            rows, h0)
    out = _k5("dropout_keep_mask_flat", B, Tq, Tk, H, seed, rate, device, rows,
              h0)
    dropout_keep_mask_flat.launches += 1
    return out


dropout_keep_mask_flat.launches = 0


def _k5(name, B, Tq, Tk, H, seed, rate, device, rows=None, h0=0):
    """Launch K5 on a CUDA device into a new (B, H, Tq, Tk) bool mask.  K5
    indexes its elements in 32 bits, so a mask of MAX_MASK_ELEMENTS or more
    is refused before it is allocated (the plain version has no such
    limit).  K5 reads its seed on the card (``_seed_arg``)."""
    _check_seed(seed)
    thresh = dropout_threshold(rate)
    row_args = _row_args(B, rows)
    h0 = _check_h0(H, h0)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if B * H * Tq * Tk >= MAX_MASK_ELEMENTS:
        raise ValueError(f"{name}: a mask of {B}x{H}x{Tq}x{Tk} elements exceeds "
                         f"{MAX_MASK_ELEMENTS - 1}")
    out = torch.empty((B, H, Tq, Tk), dtype=torch.bool, device=device)
    if out.numel() == 0:
        return out
    seed_ptr = _seed_arg(seed, device)
    err = _build.library().sbl_dropout_keep_mask_flat(
        out.data_ptr(), B, H, Tq, Tk, seed_ptr, thresh, *row_args, h0,
        device.index, _stream(device))
    _build.check(err, name)
    return out


def _train_probs(q, k, v, n_head, bias, seed, rate, scale, keep, rows=None,
                 h0=0):
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
                                            n_head, seed, rate, q.device, rows,
                                            h0)
    return qh, kh, vh, p, torch.where(keep, p, 0.0) * (1.0 / (1.0 - rate)), keep


def small_mha_dropout_flat_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, n_head: int,
                                 bias: Optional[torch.Tensor] = None,
                                 seed: int = 0, rate: float = 0.0,
                                 scale: Optional[float] = None,
                                 keep: Optional[torch.Tensor] = None,
                                 rows: Optional[BatchRows] = None,
                                 h0: int = 0) -> torch.Tensor:
    """Plain version of K3.  ``keep`` injects a (B, H, Tq, Tk) mask; by
    default it is drawn from ``seed`` (and ``rows``, ``h0``) with the plain
    Philox (K5's bits)."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    dropout_threshold(rate)
    _, _, vh, _, pd, _ = _train_probs(q, k, v, n_head, bias, seed, rate,
                                      _scale(scale, D, n_head), keep, rows, h0)
    return _merge(torch.matmul(pd, vh), q.dtype)


def small_mha_dropout_bwd_flat_plain(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, n_head: int,
                                     bias: Optional[torch.Tensor],
                                     seed: int, rate: float,
                                     scale: Optional[float],
                                     dout: torch.Tensor,
                                     keep: Optional[torch.Tensor] = None,
                                     rows: Optional[BatchRows] = None,
                                     h0: int = 0):
    """Plain version of K4: (dq, dk, dv) of K3 for the output gradient
    ``dout``, in the dtypes of q, k, v, by the JAX kernel's formulas."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q")
    dropout_threshold(rate)
    scale = _scale(scale, D, n_head)
    qh, kh, vh, p, pd, keep = _train_probs(q, k, v, n_head, bias, seed, rate,
                                           scale, keep, rows, h0)
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
                               scale: Optional[float] = None,
                               rows: Optional[BatchRows] = None,
                               h0: int = 0) -> torch.Tensor:
    """K3: flat attention with dropout ``rate`` on its probabilities, the
    mask drawn from ``seed`` (its batch rows mapped by ``rows``, its heads
    starting at ``h0``).  CUDA tensors (``train_kernels_fit``: d in
    HEAD_DIMS, Tq and Tk within its shared memory; f32 or bf16, contiguous)
    launch the kernel; CPU tensors take the plain version."""
    _check(q, k, v, n_head, bias)
    _check_seed(seed)
    dropout_threshold(rate)
    if q.device.type == "cpu":
        return small_mha_dropout_flat_plain(q, k, v, n_head, bias, seed, rate,
                                            scale, rows=rows, h0=h0)
    out = _k3("small_mha_dropout_fwd_flat", q, k, v, n_head, bias, seed, rate,
              scale, rows, h0)
    small_mha_dropout_fwd_flat.launches += 1
    return out


small_mha_dropout_fwd_flat.launches = 0


def _k3(name, q, k, v, n_head, bias, seed, rate, scale, rows=None, h0=0):
    """Launch K3 on flat CUDA operands (checked here) into a new tensor."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    _check_seed(seed)
    thresh, inv_keep, on = _dropout_launch_args(rate)
    row_args = _row_args(B, rows)
    h0 = _check_h0(n_head, h0)
    _check_cuda(name, (q, k, v), bias, D // n_head, train=True)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    seed = _seed_arg(seed, q.device, rate > 0.0)
    err = _build.library().sbl_small_mha_dropout_fwd_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, Tq, Tk, n_head, D // n_head, int(bias is not None and bias.shape[0] > 1),
        float(_scale(scale, D, n_head)), seed, thresh, inv_keep, on, *row_args,
        h0, _DTYPE_CODES[q.dtype], q.device.index, _stream(q.device))
    _build.check(err, name)
    return out


def small_mha_dropout_bwd_flat(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, n_head: int,
                               bias: Optional[torch.Tensor], seed: int,
                               rate: float, scale: Optional[float],
                               dout: torch.Tensor,
                               rows: Optional[BatchRows] = None,
                               h0: int = 0):
    """K4: (dq, dk, dv) of K3, regenerating its mask from ``seed`` (and
    ``rows``, ``h0``).  CUDA
    tensors launch the kernel (K3's conditions, dout like q); CPU tensors
    take the plain version."""
    _check(q, k, v, n_head, bias)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q")
    _check_seed(seed)
    dropout_threshold(rate)
    if q.device.type == "cpu":
        return small_mha_dropout_bwd_flat_plain(q, k, v, n_head, bias, seed,
                                                rate, scale, dout, rows=rows,
                                                h0=h0)
    grads = _k4("small_mha_dropout_bwd_flat", q, k, v, n_head, bias, seed,
                rate, scale, dout, rows, h0)
    small_mha_dropout_bwd_flat.launches += 1
    return grads


small_mha_dropout_bwd_flat.launches = 0


def _k4(name, q, k, v, n_head, bias, seed, rate, scale, dout, rows=None,
        h0=0):
    """Launch K4 on flat CUDA operands (checked here) into new tensors.  At
    rate 0 the kernel draws no mask and never reads ``inv_keep``, so its
    gradients are those of the plain backward without dropout."""
    B, Tq, Tk, D = _check(q, k, v, n_head, bias)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q")
    _check_seed(seed)
    thresh, inv_keep, on = _dropout_launch_args(rate)
    row_args = _row_args(B, rows)
    h0 = _check_h0(n_head, h0)
    _check_cuda(name, (q, k, v, dout), bias, D // n_head, train=True)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    seed = _seed_arg(seed, q.device, rate > 0.0)
    err = _build.library().sbl_small_mha_dropout_bwd_flat(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Tq, Tk, n_head, D // n_head, int(bias is not None and bias.shape[0] > 1),
        float(_scale(scale, D, n_head)), seed, thresh, inv_keep, on, *row_args,
        h0, _DTYPE_CODES[q.dtype], q.device.index, _stream(q.device))
    _build.check(err, name)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Forward ``fwd(q, k, v, bias)``, backward ``bwd(q, k, v, bias, dout) ->
    (dq, dk, dv)``; saves only q, k, v and the bias, as the JAX custom VJPs
    save them (with the seed, which ``fwd`` and ``bwd`` close over).  The
    bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, fwd, bwd):
        ctx.save_for_backward(q, k, v, bias)
        ctx.bwd = bwd
        return fwd(q, k, v, bias)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, bias, dout.contiguous())
        return dq, dk, dv, None, None, None


def small_mha_dropout_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n_head: int, bias: Optional[torch.Tensor] = None,
                           seed: int = 0, rate: float = 0.0,
                           scale: Optional[float] = None,
                           use_kernels: bool = True,
                           rows: Optional[BatchRows] = None,
                           h0: int = 0) -> torch.Tensor:
    """Differentiable training attention (JAX ``small_mha_dropout_grad_flat``):
    K3 forward and K4 backward through their wrappers (plain versions on CPU
    tensors), or with ``use_kernels=False`` the plain versions on any
    device.  At rate 0 nothing is drawn and the forward is K1's math.
    ``rows`` maps the batch rows of the masks (``BatchRows``), ``h0`` their
    first head."""
    fwd = small_mha_dropout_fwd_flat if use_kernels else small_mha_dropout_flat_plain
    bwd = (small_mha_dropout_bwd_flat if use_kernels
           else small_mha_dropout_bwd_flat_plain)
    return _Attention.apply(
        q, k, v, bias,
        lambda q, k, v, b: fwd(q, k, v, n_head, b, seed, rate, scale,
                               rows=rows, h0=h0),
        lambda q, k, v, b, g: bwd(q, k, v, n_head, b, seed, rate, scale, g,
                                  rows=rows, h0=h0))


# ---------------------------------------------------------------------------
# The (B, T, H, d) twins: the flat kernels on views.
# ---------------------------------------------------------------------------

def _check_headed(qh, kh, vh, bias):
    """(B, Tq, H, d) q and (B, Tk, H, d) k, v; bias (1|B, Tq, Tk) or None.
    Returns H."""
    if qh.dim() != 4 or kh.dim() != 4 or vh.dim() != 4:
        raise ValueError(f"q/k/v must be (B, T, H, d); got {tuple(qh.shape)}, "
                         f"{tuple(kh.shape)}, {tuple(vh.shape)}")
    B, _, H, d = qh.shape
    Tk = kh.shape[1]
    if kh.shape != (B, Tk, H, d) or vh.shape != (B, Tk, H, d):
        raise ValueError(f"k/v {tuple(kh.shape)}/{tuple(vh.shape)} do not match "
                         f"q {tuple(qh.shape)}")
    return H


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, d) -> (B, T, H*d).  A view of a contiguous tensor; the
    plain versions also take others (a copy), the kernel wrappers refuse
    them first."""
    B, T, H, d = x.shape
    return x.reshape(B, T, H * d)


def _unflat(x: torch.Tensor, H: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.view(B, T, H, D // H)


def _headed_cuda(name, tensors, bias, train=False):
    """Refuse what the flat kernel does not take, on the (B, T, H, d)
    tensors themselves (no copy is made), then return their flat views."""
    _check_cuda(name, tensors, bias, tensors[0].shape[-1], train)
    return [_flat(t) for t in tensors]


def fused_small_mha_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of ``fused_small_mha``: K1's plain version on views."""
    H = _check_headed(qh, kh, vh, bias)
    return _unflat(small_mha_flat_plain(_flat(qh), _flat(kh), _flat(vh), H,
                                        bias, scale), H)


def fused_small_mha(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """JAX ``fused_small_mha``: q (B, Tq, H, d), k/v (B, Tk, H, d), bias
    (1|B, Tq, Tk) f32 or None -> (B, Tq, H, d).  CUDA tensors launch K1 on
    the flat views (K1's conditions); CPU tensors take the plain version."""
    H = _check_headed(qh, kh, vh, bias)
    if qh.device.type == "cpu":
        return fused_small_mha_plain(qh, kh, vh, bias, scale)
    q, k, v = _headed_cuda("fused_small_mha", (qh, kh, vh), bias)
    out = _k1("fused_small_mha", q, k, v, H, bias, scale)
    fused_small_mha.launches += 1
    return _unflat(out, H)


fused_small_mha.launches = 0


def small_mha_bwd_plain(qh, kh, vh, bias, scale, dout):
    """Plain version of ``small_mha_bwd``: K4's plain version at rate 0 (no
    mask) on views."""
    H = _check_headed(qh, kh, vh, bias)
    grads = small_mha_dropout_bwd_flat_plain(
        _flat(qh), _flat(kh), _flat(vh), H, bias, 0, 0.0, scale, _flat(dout))
    return tuple(_unflat(g, H) for g in grads)


def small_mha_bwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                  bias: Optional[torch.Tensor], scale: Optional[float],
                  dout: torch.Tensor):
    """JAX ``_small_mha_bwd``: (dq, dk, dv) of ``fused_small_mha`` for the
    output gradient ``dout`` (B, Tq, H, d).  CUDA tensors launch K4 at rate 0
    on the flat views (K3/K4's lengths); CPU tensors take the plain
    version."""
    H = _check_headed(qh, kh, vh, bias)
    if dout.shape != qh.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q")
    if qh.device.type == "cpu":
        return small_mha_bwd_plain(qh, kh, vh, bias, scale, dout)
    q, k, v, g = _headed_cuda("small_mha_bwd", (qh, kh, vh, dout), bias,
                              train=True)
    grads = _k4("small_mha_bwd", q, k, v, H, bias, 0, 0.0, scale, g)
    small_mha_bwd.launches += 1
    return tuple(_unflat(x, H) for x in grads)


small_mha_bwd.launches = 0


def small_mha(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable (B, T, H, d) attention without dropout (JAX
    ``small_mha_grad``): ``fused_small_mha`` forward (K1), ``small_mha_bwd``
    backward (K4 at rate 0); plain versions on CPU tensors."""
    return _Attention.apply(
        qh, kh, vh, bias, lambda q, k, v, b: fused_small_mha(q, k, v, b, scale),
        lambda q, k, v, b, g: small_mha_bwd(q, k, v, b, scale, g))


def small_mha_dropout_fwd_plain(qh, kh, vh, bias, seed, scale, rate, keep=None,
                                h0=0):
    """Plain version of ``small_mha_dropout_fwd``: K3's on views; ``keep``
    injects a (B, H, Tq, Tk) mask."""
    H = _check_headed(qh, kh, vh, bias)
    return _unflat(small_mha_dropout_flat_plain(
        _flat(qh), _flat(kh), _flat(vh), H, bias, seed, rate, scale, keep,
        h0=h0), H)


def small_mha_dropout_fwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                          bias: Optional[torch.Tensor], seed: int,
                          scale: Optional[float], rate: float,
                          h0: int = 0) -> torch.Tensor:
    """JAX ``fused_small_mha_dropout_fwd`` (argument order as there; ``h0``
    the counter's first head): K3 on
    the flat views for CUDA tensors (K3/K4's lengths), the plain
    version for CPU tensors.  The mask is the flat kernel's, which does not
    depend on the layout (see ``dropout_keep_mask``)."""
    H = _check_headed(qh, kh, vh, bias)
    _check_seed(seed)
    dropout_threshold(rate)
    if qh.device.type == "cpu":
        return small_mha_dropout_fwd_plain(qh, kh, vh, bias, seed, scale, rate,
                                           h0=h0)
    q, k, v = _headed_cuda("small_mha_dropout_fwd", (qh, kh, vh), bias,
                           train=True)
    out = _k3("small_mha_dropout_fwd", q, k, v, H, bias, seed, rate, scale,
              h0=h0)
    small_mha_dropout_fwd.launches += 1
    return _unflat(out, H)


small_mha_dropout_fwd.launches = 0


def small_mha_dropout_bwd_plain(qh, kh, vh, bias, seed, scale, rate, dout,
                                keep=None, h0=0):
    """Plain version of ``small_mha_dropout_bwd``: K4's on views."""
    H = _check_headed(qh, kh, vh, bias)
    grads = small_mha_dropout_bwd_flat_plain(
        _flat(qh), _flat(kh), _flat(vh), H, bias, seed, rate, scale,
        _flat(dout), keep, h0=h0)
    return tuple(_unflat(g, H) for g in grads)


def small_mha_dropout_bwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                          bias: Optional[torch.Tensor], seed: int,
                          scale: Optional[float], rate: float,
                          dout: torch.Tensor, h0: int = 0):
    """JAX ``fused_small_mha_dropout_bwd``: (dq, dk, dv) of
    ``small_mha_dropout_fwd``, K4 on the flat views for CUDA tensors, the
    plain version for CPU tensors."""
    H = _check_headed(qh, kh, vh, bias)
    if dout.shape != qh.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q")
    _check_seed(seed)
    dropout_threshold(rate)
    if qh.device.type == "cpu":
        return small_mha_dropout_bwd_plain(qh, kh, vh, bias, seed, scale, rate,
                                           dout, h0=h0)
    q, k, v, g = _headed_cuda("small_mha_dropout_bwd", (qh, kh, vh, dout),
                              bias, train=True)
    grads = _k4("small_mha_dropout_bwd", q, k, v, H, bias, seed, rate, scale, g,
                h0=h0)
    small_mha_dropout_bwd.launches += 1
    return tuple(_unflat(x, H) for x in grads)


small_mha_dropout_bwd.launches = 0


def small_mha_dropout(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                      bias: Optional[torch.Tensor], seed: int,
                      scale: Optional[float], rate: float,
                      h0: int = 0) -> torch.Tensor:
    """Differentiable (B, T, H, d) training attention (JAX
    ``small_mha_dropout_grad``): ``small_mha_dropout_fwd`` forward (K3) and
    ``small_mha_dropout_bwd`` backward (K4, the mask regenerated from
    ``seed``); plain versions on CPU tensors."""
    return _Attention.apply(
        qh, kh, vh, bias,
        lambda q, k, v, b: small_mha_dropout_fwd(q, k, v, b, seed, scale, rate,
                                                 h0),
        lambda q, k, v, b, g: small_mha_dropout_bwd(q, k, v, b, seed, scale,
                                                    rate, g, h0))


def dropout_keep_mask(B: int, Tq: int, Tk: int, H: int, seed: int,
                      rate: float, device=None, h0: int = 0) -> torch.Tensor:
    """JAX ``dropout_keep_mask``: the (B, H, Tq, Tk) bool keep mask the
    (B, T, H, d) dropout twins draw for ``seed``.  K5 on a CUDA device (the
    default; raises without a card); on the CPU its plain version,
    ``dropout_keep_mask_flat_plain``.

    It is the flat kernels' mask: an element's bits come from Philox at
    counter (key, query, head, batch row), which does not depend on how q,
    k and v are laid out, so the (B, T, H, d) views draw what the flat
    tensors draw.  JAX's two helpers differ because its draw order was a
    property of the per-program TPU PRNG (seeded by seed + program id, with
    a batch tile per program); Philox has no such order."""
    device = resolve_device(device)
    if device.type == "cpu":
        return dropout_keep_mask_flat_plain(B, Tq, Tk, H, seed, rate, device,
                                            None, h0)
    out = _k5("dropout_keep_mask", B, Tq, Tk, H, seed, rate, device, None, h0)
    dropout_keep_mask.launches += 1
    return out


dropout_keep_mask.launches = 0


# ---------------------------------------------------------------------------
# K12: the legacy head-major (B, H, T, d) attention.
# ---------------------------------------------------------------------------

def _check_head_major(q, k, v, bias):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q/k/v must be (B, H, T, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, d) or v.shape != (B, H, Tk, d):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if Tk == 0:
        raise ValueError("attention over zero keys")
    if bias is not None and (bias.dim() != 4 or bias.shape[0] != B
                             or bias.shape[1] not in (1, H)
                             or tuple(bias.shape[2:]) != (Tq, Tk)):
        raise ValueError(f"bias must be ({B}, 1|{H}, {Tq}, {Tk}); got "
                         f"{tuple(bias.shape)}")
    return B, H, Tq, Tk, d


def fused_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K12: operands upcast to f32, output in q's dtype."""
    B, H, Tq, Tk, d = _check_head_major(q, k, v, bias)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    f = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(f)
    return torch.matmul(torch.softmax(s, dim=-1), v.to(f)).to(q.dtype)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """K12 (JAX ``fused_mha``): q (B, H, Tq, d), k/v (B, H, Tk, d), bias an
    optional additive (B, H|1, Tq, Tk) f32, per head or broadcast over the
    heads -> (B, H, Tq, d).  CUDA tensors (d in HEAD_DIMS; f32
    or bf16; all contiguous, bf16 16-byte aligned) launch the kernel, any
    Tk; CPU tensors take the plain version."""
    B, H, Tq, Tk, d = _check_head_major(q, k, v, bias)
    if q.device.type == "cpu":
        return fused_mha_plain(q, k, v, bias, scale)
    _check_cuda("fused_mha", (q, k, v), bias, d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    bias_batch = bias_head = 0
    if bias is not None:
        bias_head = Tq * Tk if bias.shape[1] > 1 else 0
        bias_batch = bias.shape[1] * Tq * Tk
    err = _build.library().sbl_fused_mha(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, H, Tq, Tk, d, bias_batch, bias_head,
        float(1.0 / math.sqrt(d) if scale is None else scale),
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q.device))
    _build.check(err, "fused_mha")
    fused_mha.launches += 1
    return out


fused_mha.launches = 0


# ---------------------------------------------------------------------------
# K13: one cached self-attention step over the flat K/V caches.
# ---------------------------------------------------------------------------

def _check_step(q, k_new, v_new, k_cache, v_cache, step, n_head):
    """Refuse shapes that neither K13 nor its plain version takes, on any
    device: q, k_new, v_new (N, H*d), caches (N, L, H*d), H dividing H*d,
    0 <= step < L."""
    if k_cache.dim() != 3 or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches must be two (N, L, H*d); got {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    N, L, D = k_cache.shape
    if any(t.shape != (N, D) for t in (q, k_new, v_new)):
        raise ValueError(f"q/k_new/v_new must be ({N}, {D}); got {tuple(q.shape)}, "
                         f"{tuple(k_new.shape)}, {tuple(v_new.shape)}")
    if n_head <= 0 or D % n_head:
        raise ValueError(f"width {D} does not split over n_head={n_head}")
    if not 0 <= step < L:
        raise ValueError(f"step {step} outside the caches' {L} slots")
    return N, L, D


def cached_attention_step_plain(q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, step: int, n_head: int,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K13, the einsums of ``MultiHeadAttention.decode_step``
    (JAX's): slot ``step`` of the caches written in place, the caches
    upcast to f32, the logits divided by sqrt(d) (or multiplied by
    ``scale``), slots after ``step`` filled with MASK_FILL, the f32 softmax
    rounded to q's dtype before P V.  Any shapes and head widths the
    einsums take; returns (N, H*d) in q's dtype."""
    N, L, D = k_cache.shape
    d = D // n_head
    f32 = torch.float32
    k_cache[:, step] = k_new
    v_cache[:, step] = v_new
    qh = q.reshape(N, n_head, d).to(f32)
    kh = k_cache.reshape(N, L, n_head, d).to(f32)
    vh = v_cache.reshape(N, L, n_head, d).to(f32)
    logits = torch.einsum("bhd,bkhd->bhk", qh, kh)
    logits = logits / math.sqrt(d) if scale is None else logits * scale
    invalid = torch.arange(L, device=q.device) > step
    logits = torch.where(invalid[None, None, :], MASK_FILL, logits)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhk,bkhd->bhd", attn.to(f32), vh).to(q.dtype).reshape(N, D)


def cached_attention_step(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, step: int, n_head: int,
                          scale: Optional[float] = None) -> torch.Tensor:
    """K13 (no TPU kernel: the JAX ``decode_step`` is plain einsums): one
    cached self-attention step.  q, k_new, v_new: (N, H*d), this step's
    projections; k_cache, v_cache: (N, L, H*d), slot ``step`` written with
    k_new and v_new in place; scale None for 1/sqrt(d).  Returns
    softmax(q K^T * scale) V over slots 0..step, (N, H*d) in q's dtype.

    CUDA tensors launch the kernel (``csrc/decode_attention.cu``), which
    reads the valid slots of the caches once in their own dtype and keeps
    the probabilities in f32 (the plain version rounds them to q's dtype
    before P V); it refuses (never copies) what it does not take: mixed or
    other dtypes than f32 and bf16, non-contiguous operands, d outside
    HEAD_DIMS.  CPU tensors take the plain version.  Either way ``step``
    must lie inside the caches.  ``.launches`` counts the launches and
    ``.slots`` the rows x valid slots they read."""
    N, L, D = _check_step(q, k_new, v_new, k_cache, v_cache, step, n_head)
    if q.device.type == "cpu":
        return cached_attention_step_plain(q, k_new, v_new, k_cache, v_cache,
                                           step, n_head, scale)
    _check_cuda("cached_attention_step", (q, k_new, v_new, k_cache, v_cache),
                None, D // n_head)
    out = torch.empty_like(q)
    err = _build.library().sbl_cached_attention_step(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), N, L, n_head, D // n_head, step,
        float(_scale(scale, D, n_head)), _DTYPE_CODES[q.dtype], q.device.index,
        _stream(q.device))
    _build.check(err, "cached_attention_step")
    cached_attention_step.launches += 1
    cached_attention_step.slots += N * (step + 1)
    return out


cached_attention_step.launches = 0
cached_attention_step.slots = 0
