"""Train-mode BatchNorm on one-pass channel statistics (kernels K7 and K8)
and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/batchnorm.py`` (Pallas TPU kernels
behind ``PALLAS_BN=1`` or ``use_pallas_bn``, ``models/frontend.py``):

* K7 ``channel_sums``: x (N, C, H, W) -> f32 (C,) sum x and sum x^2, one
  read of x;
* K8 ``channel_sums_pair``: (dy, x, mean, inv) -> f32 (C,) sum dy and
  sum dy * (x - mean) * inv, one read of each, which are d_bias and d_scale;
  both form each term in f32 and sum in double (the kernel K7's sum of
  squares per position as a compensated f32 pair, folded into double), so
  both give the exact sum rounded once to f32 (JAX sums in f32): an ulp of
  difference in a mean would flip ReLU and max-pool routing downstream;
* ``bn_train``: a ``torch.autograd.Function`` mirroring the JAX custom VJP:
  y = (x * a + b) cast to x's dtype with a = inv * scale and
  b = bias - mean * a, the biased variance q/n - mean^2 (no clamp), and dx
  in its affine form dx = g1 * dy + A * x + (B - A * mean), honouring
  cotangents on the returned mean and var (zero when they are unused).

The JAX kernels reduce (N, HW, C) blocks; the port keeps activations NCHW,
so K7 and K8 reduce over (N, H, W) for each C of an NCHW tensor: the same
sums in another memory order.  The CUDA kernels are ``csrc/batchnorm.cu``,
one launch a call, and their design note is there.  This module picks
their geometry: ``route`` (16-byte pieces when the row C*H*W is a multiple
of 16 bytes' worth of elements and the pointers are 16-byte aligned, else
single elements), ``tiling`` (cg adjacent channels a block, whose run of
cg*H*W positions is a whole number of pieces, as many sample phases as fit
the block's 2048 position slots, and as many chunks of samples per group
as fill the card once: ``capacity``, the blocks it holds at a time), and
keeps the kernels' integer arrival counters (``_arrivals``, one buffer a
device and stream, 0 between calls).

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.  ``channel_sums.launches`` and
``channel_sums_pair.launches`` count the kernels' launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

MAX_RUN = 2048         # position slots of a block (256 threads x 8)
PIECE_BYTES = 16       # one load of the vector route
MAX_CHUNKS = 65535     # blocks along N (the grid's y)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class Tiling(NamedTuple):
    cg: int        # adjacent channels a block sums (the last group may hold fewer)
    phases: int    # sample phases a block's slots hold: MAX_RUN // (cg * HW)
    chunks: int    # blocks along N, each over N / chunks samples


def _as3(x: torch.Tensor) -> torch.Tensor:
    if x.dim() < 2:
        raise ValueError(f"expected (N, C, ...) activations; got {tuple(x.shape)}")
    return x.reshape(x.shape[0], x.shape[1], -1)


@functools.lru_cache(maxsize=None)
def tiling(N: int, C: int, HW: int, epv: int, capacity: int) -> Optional[Tiling]:
    """The launch geometry of K7/K8 over (N, C, HW) in pieces of ``epv``
    elements, on a card that holds ``capacity`` blocks at a time.  For each
    group whose run cg * HW fits MAX_RUN and is a whole number of pieces:
    as many chunks per group as fill the card once (none shorter than the
    block's sample phases); of those, the one whose blocks take the fewest
    sample iterations (times the waves of blocks, where the groups alone
    overfill the card), ties to the longer run.  None when no group
    qualifies."""
    best = None
    for cg in range(1, min(C, MAX_RUN // HW) + 1):
        if cg * HW % epv:
            continue
        groups, phases = -(-C // cg), MAX_RUN // (cg * HW)
        chunks = max(1, min(capacity // groups, -(-N // phases), MAX_CHUNKS))
        waves = -(-groups * chunks // capacity)
        iters = waves * -(-(-(-N // chunks)) // phases)
        if best is None or iters <= best[0]:
            best = (iters, Tiling(cg, phases, chunks))
    return None if best is None else best[1]


def route(*tensors: torch.Tensor) -> int:
    """Elements a piece of K7/K8 holds for these (N, C, ...) inputs: 16
    bytes' worth (8 bf16, 4 f32) on the vector route, where the row C*H*W
    is a whole number of pieces, a group's run can be, and every pointer is
    16-byte aligned; else 1 (the scalar route)."""
    x = tensors[-1]
    N, C, HW = _as3(x).shape
    epv = PIECE_BYTES // x.element_size()
    if (C * HW % epv == 0 and all(t.data_ptr() % PIECE_BYTES == 0 for t in tensors)
            and tiling(N, C, HW, epv, 1) is not None):
        return epv
    return 1


def channel_sums_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: (sum x, sum x^2) per channel of (N, C, ...), the
    squares in f32 and the sums in double, rounded once to f32."""
    xf = _as3(x).to(torch.float32)
    return (xf.sum(dim=(0, 2), dtype=torch.float64).float(),
            (xf * xf).sum(dim=(0, 2), dtype=torch.float64).float())


def channel_sums_pair_plain(dy: torch.Tensor, x: torch.Tensor,
                            mean: torch.Tensor, inv: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8: (sum dy, sum dy * (x - mean) * inv) per channel
    of (N, C, ...), the terms in f32 and the sums in double, rounded once
    to f32."""
    g = _as3(dy).to(torch.float32)
    xhat = (_as3(x).to(torch.float32) - mean[:, None]) * inv[:, None]
    return (g.sum(dim=(0, 2), dtype=torch.float64).float(),
            (g * xhat).sum(dim=(0, 2), dtype=torch.float64).float())


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    x = tensors[-1]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in tensors:
        if t.dtype != x.dtype or t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name}: dy and x must match in shape, dtype and "
                             f"device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: takes f32 or bf16; got {x.dtype}")
    HW = _as3(x).shape[2]
    if HW > MAX_RUN:
        raise ValueError(f"{name}: a block holds planes of at most {MAX_RUN} "
                         f"positions; got {HW}")


@functools.lru_cache(maxsize=None)
def capacity(device: int, pair: bool, vec: bool, dtype_code: int) -> int:
    """Blocks of the K7 (K8 with ``pair``) kernel of a route and dtype that
    card ``device`` holds at a time: the library's occupancy query times
    the card's SMs."""
    blocks = _build.library().sbl_channel_sums_blocks_per_sm(
        int(pair), int(vec), dtype_code, device)
    if blocks <= 0:
        raise RuntimeError(f"channel_sums: occupancy query failed (CUDA error "
                           f"{-blocks})")
    return blocks * torch.cuda.get_device_properties(device).multi_processor_count


_ARRIVALS = {}


def _arrivals(device: torch.device, stream: int, groups: int) -> torch.Tensor:
    """The arrival counters of the kernels launched on (device, stream):
    zeros, which every launch leaves at 0 again (launches on one stream run
    in order, so they may share them)."""
    buf = _ARRIVALS.get((device.index, stream))
    if buf is None or buf.numel() < groups:
        buf = torch.zeros(max(groups, 1024), dtype=torch.int32, device=device)
        _ARRIVALS[(device.index, stream)] = buf
    return buf


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name, fn, inputs, extra, x, pair):
    N, C, HW = _as3(x).shape
    if x.numel() == 0:
        out = torch.zeros((2, C), dtype=torch.float32, device=x.device)
        return out[0], out[1]
    epv, code = route(*inputs), _DTYPE_CODES[x.dtype]
    geo = tiling(N, C, HW, epv, capacity(x.device.index, pair, epv > 1, code))
    stream = _stream(x.device)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    part = torch.empty((2, geo.chunks, C), dtype=torch.float64, device=x.device)
    arrivals = _arrivals(x.device, stream, -(-C // geo.cg))
    err = fn(*[t.data_ptr() for t in inputs], *[t.data_ptr() for t in extra],
             part.data_ptr(), arrivals.data_ptr(), out.data_ptr(), N, C, HW, geo.cg,
             geo.chunks, int(epv > 1), code, x.device.index, stream)
    _build.check(err, name)
    return out[0], out[1]


def channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: f32 (C,) sum x and sum x^2 over (N, H, W) of an (N, C, H, W)
    tensor.  CUDA tensors (f32 or bf16, contiguous, H*W <= 2048) launch the
    kernel; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return channel_sums_plain(x)
    _check_cuda("channel_sums", x)
    s, q = _launch("channel_sums", _build.library().sbl_channel_sums, (x,),
                   (), x, False)
    channel_sums.launches += 1
    return s, q


channel_sums.launches = 0


def channel_sums_pair(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: f32 (C,) sum dy and sum dy * (x - mean) * inv over (N, H, W).
    CUDA tensors (K7's conditions, dy like x, mean and inv f32 (C,)) launch
    the kernel; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return channel_sums_pair_plain(dy, x, mean, inv)
    _check_cuda("channel_sums_pair", dy, x)
    C = x.shape[1]
    stats = [t.to(device=x.device, dtype=torch.float32).contiguous()
             for t in (mean, inv)]
    if any(tuple(t.shape) != (C,) for t in stats):
        raise ValueError(f"channel_sums_pair: mean and inv must be ({C},)")
    s, q = _launch("channel_sums_pair", _build.library().sbl_channel_sums_pair,
                   (dy, x), stats, x, True)
    channel_sums_pair.launches += 1
    return s, q


channel_sums_pair.launches = 0


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.view(-1, *([1] * (x.dim() - 2)))


def _all_reduce_pair(mesh, a: torch.Tensor, b: torch.Tensor):
    """(a, b) summed over the processes of ``mesh``, in one collective."""
    both = torch.cat([a, b])
    mesh.all_reduce_(both)
    return both[:a.shape[0]], both[a.shape[0]:]


class _BNTrain(torch.autograd.Function):
    """Forward K7 (or its plain version), backward K8 (or its plain
    version); saves x, scale, mean and inv, as the JAX custom VJP does.

    With a ``mesh`` (synchronised BatchNorm over data-parallel processes)
    K7's sums are summed over the processes before the statistics are
    taken, and K8's before dx: the statistics and dx are those of the whole
    batch.  The scale and bias gradients stay this process's own sums;
    the step's gradient all-reduce adds them up (returning the summed ones
    there would count them once per process)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, use_kernels, mesh=None):
        s, q = (channel_sums if use_kernels else channel_sums_plain)(x)
        n = x.numel() // x.shape[1]
        if mesh is not None:
            s, q = _all_reduce_pair(mesh, s, q)
            n *= mesh.size
        mean = s / n
        var = q / n - mean * mean
        inv = torch.rsqrt(var + eps)
        a = inv * scale
        b = bias - mean * a
        y = (x.to(torch.float32) * _per_channel(a, x)
             + _per_channel(b, x)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.use_kernels, ctx.mesh = use_kernels, mesh
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, scale, mean, inv = ctx.saved_tensors
        pair = channel_sums_pair if ctx.use_kernels else channel_sums_pair_plain
        own_dy, own_dy_xhat = pair(dy.contiguous(), x, mean, inv)
        sum_dy, sum_dy_xhat = own_dy, own_dy_xhat
        n = x.numel() // x.shape[1]
        if ctx.mesh is not None:
            sum_dy, sum_dy_xhat = _all_reduce_pair(ctx.mesh, own_dy, own_dy_xhat)
            n *= ctx.mesh.size
        # dx = g1 (dy - sum_dy/n - xhat sum_dy_xhat/n) + dmean/n
        #      + 2 dvar (x - mean)/n, with g1 = inv * scale, as affine in x
        g1 = inv * scale
        A = -(g1 * inv * sum_dy_xhat) / n + 2.0 * dvar / n
        B = -(g1 * sum_dy) / n + dmean / n
        dx = (_per_channel(g1, x) * dy.to(torch.float32)
              + _per_channel(A, x) * x.to(torch.float32)
              + _per_channel(B - A * mean, x)).to(x.dtype)
        return dx, own_dy_xhat, own_dy, None, None, None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, use_kernels: bool = True, mesh=None):
    """Train-mode BatchNorm over all but axis 1 of ``x`` (N, C, ...).
    Returns (y in x's dtype, f32 mean, f32 biased variance).  The forward
    takes K7 and the backward K8 through their wrappers (plain versions on
    CPU tensors), or with ``use_kernels=False`` the plain versions on any
    device.  ``mesh`` (a ``parallel.DataMesh``) takes the statistics over
    the batch of every process (every process holds as many rows)."""
    return _BNTrain.apply(x, scale, bias, eps, use_kernels, mesh)
