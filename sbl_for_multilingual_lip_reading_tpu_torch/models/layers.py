"""Core transformer building blocks (counterpart of the JAX package's
``models/layers.py``).

* ``Dense`` / ``LayerNorm`` -- the flax layers these modules are made of.
  ``dirs=2`` gives them a leading direction axis (weights (2, out, in)),
  the form the JAX decoder gets from ``nn.vmap`` over its two directions:
  the projections then run as one ``torch.bmm`` over (2, B*L, D).
* ``MultiHeadAttention`` -- post-LN residual
  ``LayerNorm(dropout(fc(attn)) + q)``; the projections stay FLAT
  (B, T, H*d) and go to the attention kernels (``ops/attention.py``), which
  split the heads themselves: K1 when deterministic, K3/K4 (with dropout on
  the attention probabilities) in training.
* ``CrossKV`` / ``CachedCrossAttention`` -- cross-attention with the
  encoder's K/V projected once per clip instead of once per decode step.
* ``PositionwiseFeedForward``, ``EncoderLayer``, ``DecoderLayer``,
  ``sinusoid_position_encoding``.
* ``DropoutRNG`` / ``dropout`` -- the training forward's random numbers;
  ``StepRandom`` / ``RandomLayout`` -- a train step's rows of them.

Tensor parallelism (the mesh's ``model`` axis, Megatron's layout;
``parallel.shard_model`` cuts a built model down to one process's slice).
A sharded attention holds its heads [m H/M, (m+1) H/M) of Q, K and V and
the matching input columns of ``fc``; a sharded FFN its d_inner / M slice
of ``w_1`` and the matching columns of ``w_2``.  Two operators join the
slices: f (``copy_to_model``) before the column-parallel projections, the
identity whose backward sums the input's gradient over the model group,
and g inside a row-parallel ``Dense``, which sums the f32 partial products
over the group, rounds once and adds the bias once.  Where JAX's rules
shard the projections but not the ``fc`` after them (the unidirectional
decoder's ``slf_attn_i`` / ``enc_attn_i``, whose paths its ``fc`` rule
does not match), the heads' context is gathered over the group
(``gather_heads``) and ``fc`` runs whole, as GSPMD gathers a sharded
operand for a replicated consumer.  Dropout after ``fc``
and ``w_2`` acts on whole activations, so every model process draws the
same mask from the same seed; the attention probabilities' masks are the
process's heads of the one-process masks (the kernels' head offset
``h0``).  ``cast_dense_weights`` runs the modules marked ``whole_in_eval``
(an SBL decoder under ``use_fused_decoder_layer``) on their weights
gathered over the group.

Numerics follow the JAX modules: parameters in f32, cast to the compute
dtype where they are used; matmuls in the compute dtype, rounded before the
bias is added; LayerNorm in f32 with flax's eps 1e-6 (torch's default is
1e-5); each sublayer's output rounded to the compute dtype.  Masks arrive as
additive f32 biases (``ops.mask_to_bias``).  A module runs deterministically
when its ``rng`` is None, and in training mode (dropout, the K3/K4
attention) when it is given one.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (BatchRows, cached_attention_step,
                             cached_attention_step_plain,
                             small_mha_dropout_flat, small_mha_flat,
                             small_mha_flat_plain)
from ..parallel.tensor import (copy_to_model, gather_from_model,
                               gather_heads, reduce_from_model)

LN_EPS = 1e-6  # flax nn.LayerNorm default


class RandomLayout(NamedTuple):
    """Where a training forward finds its random numbers in one step's row
    of seeds (``StepRandom``): entry 0 seeds the elementwise masks' generator,
    then ``direct`` seeds for the attentions of the encoder (and a
    unidirectional decoder), in call order, then ``children`` blocks of
    1 + ``child`` (an SBL decode step's: its masks' generator seed, then its
    attentions' seeds); ``coins`` teacher-forcing coins beside them."""
    direct: int
    children: int
    child: int
    coins: int

    @property
    def size(self) -> int:
        return 1 + self.direct + self.children * (1 + self.child)

    def child_base(self, j: int) -> int:
        return 1 + self.direct + j * (1 + self.child)


class StepRandom(NamedTuple):
    """One train step's random numbers: ``seeds`` (layout.size,) int64 and
    ``coins`` (layout.coins,) bool on the step's device, ``host`` the seeds
    on the host (they seed the mask generators, which are seeded on the
    host), and ``generators(index) -> torch.Generator``, the generator of the
    masks seeded from ``host[index]`` (``EagerGenerators``, or the pool of a
    CUDA graph's registered generators)."""
    seeds: torch.Tensor
    coins: torch.Tensor
    host: np.ndarray
    layout: RandomLayout
    generators: object


class EagerGenerators:
    """A new generator for each use, seeded with ``host[index]``."""

    def __init__(self, device, host: np.ndarray):
        self.device, self.host = torch.device(device), host

    def __call__(self, index: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            int(self.host[index]))


def draw_step_random(seed: int, layout: RandomLayout,
                     teacher_forcing_rate: float = 0.0):
    """The host rows of one step's random numbers, drawn from ``seed`` (the
    step's seed, drawn from the trainer's ``torch.Generator``): seeds
    (layout.size,) int64 below 2^62 and coins (layout.coins,) bool, each
    True with probability ``teacher_forcing_rate``."""
    host = torch.Generator().manual_seed(int(seed))
    seeds = torch.randint(0, 2 ** 62, (layout.size,), generator=host)
    coins = torch.rand(layout.coins, generator=host) < teacher_forcing_rate
    return seeds.numpy(), coins.numpy()


def step_random(seed: int, layout: RandomLayout, device,
                teacher_forcing_rate: float = 0.0) -> StepRandom:
    """One step's ``StepRandom`` drawn from ``seed`` (``draw_step_random``),
    uploaded to ``device``, its masks from ``EagerGenerators``."""
    seeds, coins = draw_step_random(seed, layout, teacher_forcing_rate)
    return StepRandom(torch.from_numpy(seeds).to(device),
                      torch.from_numpy(coins).to(device), seeds, layout,
                      EagerGenerators(device, seeds))


class DropoutRNG:
    """The random numbers of one training forward, read from a train step's
    rows (``StepRandom``), never from the global RNG: an attention kernel's
    seed is a view of one int64 of the row on the device (the kernels read
    it there), a teacher-forcing coin one bool of it, and the elementwise
    masks come from ``random.generators`` -- so nothing is drawn on the host
    inside the step, and a step captured as a CUDA graph draws each
    replay's numbers.  Built again from the same rows it reads the same
    numbers in the same order, which is what lets a checkpointed decode step
    recompute its masks.  ``block`` j: the numbers of child j (an SBL decode
    step, ``child``).

    ``rows`` (a ``BatchRows``) is set in a data-parallel process: its batch
    is a stripe of the whole batch, and it draws the masks of its rows of
    the one-process run.  Elementwise masks are drawn at the whole batch's
    shape and cut to the stripe; the attention kernels map their batch rows
    (``ops.attention.BatchRows``).  Seeds and coins are the same in every
    process.  Under tensor parallelism each attention passes the kernels
    its own head offset besides these rows (``attend``'s ``h0``), and the
    elementwise masks, on whole activations, are the same in every model
    process."""

    def __init__(self, random: StepRandom, device,
                 rows: Optional[BatchRows] = None, block: Optional[int] = None):
        self.device, self.rows, self.table = torch.device(device), rows, random
        lay = random.layout
        first = 0 if block is None else lay.child_base(block)
        self._next = first + 1
        self._end = first + 1 + (lay.direct if block is None else lay.child)
        self._children = lay.children if block is None else 0
        self._child = 0
        self.dev = random.generators(first)

    def seed(self) -> torch.Tensor:
        """A seed for one attention kernel launch: an int64 view of the
        step's row on the device."""
        if self._next >= self._end:
            raise ValueError("the forward draws more seeds than its step's "
                             "RandomLayout holds")
        self._next += 1
        return self.table.seeds[self._next - 1]

    def child(self):
        """The random numbers of the next SBL decode step, as a key
        (rows, block) from which the step, and its checkpointed recompute,
        build their ``DropoutRNG`` identically."""
        if self._child >= self._children:
            raise ValueError("the forward takes more decode steps than its "
                             "step's RandomLayout holds")
        self._child += 1
        return (self.table, self._child - 1)

    def coins(self, n: int, p: float) -> List[torch.Tensor]:
        """n teacher-forcing coins, 0-dim bool tensors on the device (drawn
        into the step's rows with the decoder's rate p)."""
        if n != self.table.layout.coins:
            raise ValueError(f"{n} coins asked, the step's rows hold "
                             f"{self.table.layout.coins}")
        return list(self.table.coins.unbind(0))

    def keep(self, shape, rate: float, batch_dim: int = 0) -> torch.Tensor:
        """Bool mask, True with probability 1 - rate.  ``batch_dim`` is the
        axis that holds the batch (its rows may each span several entries:
        the frontend folds frames into it)."""
        if self.rows is None:
            return torch.rand(shape, generator=self.dev,
                              device=self.device) >= rate
        first, local, total = self.rows
        per = shape[batch_dim] // local
        lead = math.prod(shape[:batch_dim])
        u = torch.rand((lead, total * per, math.prod(shape[batch_dim + 1:])),
                       generator=self.dev, device=self.device)
        return u[:, first * per:(first + local) * per].reshape(shape) >= rate


def dropout(x: torch.Tensor, rate: float, rng: Optional[DropoutRNG],
            batch_dim: int = 0) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate) in x's dtype; the identity without an rng or
    at rate 0.  ``batch_dim``: x's batch axis (``DropoutRNG.keep``)."""
    if rng is None or rate == 0.0:
        return x
    return torch.where(rng.keep(x.shape, rate, batch_dim), x / (1.0 - rate), 0.0)


def sinusoid_position_encoding(max_len: int, d_model: int) -> torch.Tensor:
    """(max_len, d_model) float32 sinusoidal table, computed in numpy exactly
    as the JAX package computes it (reference module.py:16-26)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe)


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x W^T + b with weight (out, in), or with
    ``dirs`` set, a per-direction stack (dirs, out, in) applied to inputs
    (dirs, ..., in), already in ``dtype``.  ``init`` names the JAX
    initializer it mirrors.  The parameters are f32; weight and bias are
    cast to ``dtype`` where they are used, as flax's ``dtype=`` casts
    them."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dirs: Optional[int] = None, dtype=torch.float32,
                 init: str = "xavier_uniform", std: float = 1.0):
        super().__init__()
        shape = (d_out, d_in) if dirs is None else (dirs, d_out, d_in)
        self.dirs, self.init, self.std, self.dtype = dirs, init, std, dtype
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(shape[:-1])) if bias else None
        self.cast = None    # (weight, bias) cast once, see cast_dense_weights
        # tensor parallelism: "column" (output rows sharded) or "row" (input
        # columns sharded), the mesh, and the whole f32 (weight, bias)
        # gathered over its model group while the module runs whole
        self.parallel, self.mesh, self.whole = None, None, None

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        w = torch.empty(self.weight.shape, dtype=torch.float32)
        for wi in (w if self.dirs is not None else [w]):
            if self.init == "normal":
                wi.normal_(0.0, self.std, generator=g)
            elif self.init == "xavier_normal":
                nn.init.xavier_normal_(wi, generator=g)
            else:
                nn.init.xavier_uniform_(wi, generator=g)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()

    def params(self):
        """The f32 (weight, bias) this layer computes with: its own, or the
        whole ones gathered while it runs whole."""
        return self.whole or (self.weight, self.bias)

    def cast_params(self):
        w, b = self.params()
        return w.to(self.dtype), None if b is None else b.to(self.dtype)

    @torch.no_grad()
    def shard_(self, mesh, kind: str) -> None:
        """Keep this process's slice: ``column`` its output rows (and bias),
        ``row`` its input columns.  The slices are new parameters, each
        marked with the mesh (``tp_mesh``) for the gradient norm."""
        dim = -2 if kind == "column" else -1
        M, m = mesh.model_size, mesh.model_rank
        self.weight = nn.Parameter(
            self.weight.chunk(M, dim)[m].contiguous())
        self.weight.tp_mesh = mesh
        if kind == "column" and self.bias is not None:
            self.bias = nn.Parameter(self.bias.chunk(M, -1)[m].contiguous())
            self.bias.tp_mesh = mesh
        self.parallel, self.mesh = kind, mesh

    def _product(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.dirs is None:
            return F.linear(x, w)
        y = torch.bmm(x.reshape(self.dirs, -1, x.shape[-1]), w.transpose(1, 2))
        return y.reshape(*x.shape[:-1], y.shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax rounds the product to the compute dtype, then adds the bias
        # (a fused addmm would round once, after the add)
        w, b = self.cast or self.cast_params()
        if self.parallel == "row" and self.whole is None:
            # g: the f32 partial products summed over the model group,
            # rounded once, the bias added once
            y = reduce_from_model(self._product(x.float(), w.float()),
                                  self.mesh).to(self.dtype)
            if b is None:
                return y
            return y + (b if self.dirs is None else
                        b.view(self.dirs, *(1,) * (y.dim() - 2), -1))
        if self.dirs is None:
            y = F.linear(x, w)
            return y if b is None else y + b
        x2 = x.reshape(self.dirs, -1, x.shape[-1])
        y = torch.bmm(x2, w.transpose(1, 2))
        if b is not None:
            y = y + b.unsqueeze(1)
        return y.reshape(*x.shape[:-1], y.shape[-1])


@contextlib.contextmanager
def cast_dense_weights(model: nn.Module):
    """Inside the block, every ``Dense`` of ``model`` uses its weight and
    bias cast to the compute dtype once, on entry, instead of at every call:
    recognize's decode loop calls each decoder ``Dense`` once per step, 16
    times per batch, which would otherwise add some 1,600 cast launches to
    each batch.  Only without autograd: the copies are not parameters and
    take no gradient."""
    if torch.is_grad_enabled():
        raise RuntimeError("cast_dense_weights needs torch.no_grad() or "
                           "torch.inference_mode()")
    dense = [m for m in model.modules() if isinstance(m, Dense)]
    whole = [m for m in model.modules() if getattr(m, "whole_in_eval", False)]
    with run_whole(whole):
        for m in dense:
            m.cast = m.cast_params()
        try:
            yield
        finally:
            for m in dense:
                m.cast = None


class _Sharded:
    """Tensor-parallel state of a module made of column-parallel ``Dense``
    layers (``COLUMN``) feeding row-parallel ones (``ROW``): once sharded,
    ``mesh``, the layers sharded and how (``tp_sharded``: every COLUMN one,
    and each ROW one whose rule shards it), and for an attention its head
    offset ``h0`` among the model's heads (its ``n_head`` becomes the local
    count)."""
    COLUMN: tuple = ()
    ROW: tuple = ()
    mesh = None
    h0 = 0
    tp_sharded: tuple = ()
    whole_in_eval = False   # gathered inside cast_dense_weights

    def tp_denses(self):
        return ([(n, "column") for n in self.COLUMN]
                + [(n, "row") for n in self.ROW])

    def shard_(self, mesh, kinds) -> None:
        """Keep this process's slice of the ``kinds`` ((name, "column" |
        "row")) layers."""
        for name, kind in kinds:
            getattr(self, name).shard_(mesh, kind)
        self.tp_sharded = tuple(kinds)
        if hasattr(self, "n_head"):
            self.n_head //= mesh.model_size
            self.h0 = mesh.model_rank * self.n_head
        self.mesh = mesh

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        """f: the identity forward, the input gradient summed over the
        model group."""
        return x if self.mesh is None else copy_to_model(x, self.mesh)

    def _exit(self, x: torch.Tensor) -> torch.Tensor:
        """The column-parallel output, gathered whole over the model group
        where the ROW layer after it runs whole."""
        if self.mesh is None or not self.ROW or any(
                k == "row" for _, k in self.tp_sharded):
            return x
        return gather_heads(x, self.mesh)


@contextlib.contextmanager
def run_whole(modules):
    """Inside the block, each sharded module of ``modules`` runs as the
    unsharded one: every ``Dense`` on its weight and bias gathered over the
    model group (once, on entry), all heads, no collective.  The f32
    copies take no gradient.  Modules already whole are left as they are."""
    todo = [m for m in modules if m.mesh is not None]
    saved = []
    with torch.no_grad():
        for m in todo:
            saved.append((m, m.mesh, getattr(m, "n_head", None), m.h0))
            for name, kind in m.tp_sharded:
                d = getattr(m, name)
                w = gather_from_model(d.weight, m.mesh, -2 if kind == "column" else -1)
                b = d.bias
                if b is not None and kind == "column":
                    b = gather_from_model(b, m.mesh, -1)
                d.whole = (w, b)
            if hasattr(m, "n_head"):
                m.n_head *= m.mesh.model_size
            m.mesh, m.h0 = None, 0
    try:
        yield
    finally:
        for m, mesh, n_head, h0 in saved:
            for name, _ in m.tp_sharded:
                getattr(m, name).whole = None
            if n_head is not None:
                m.n_head = n_head
            m.mesh, m.h0 = mesh, h0


class LayerNorm(nn.Module):
    """f32 LayerNorm (flax defaults: eps 1e-6, scale and bias), optionally
    with a leading direction axis on its parameters."""

    def __init__(self, d: int, dirs: Optional[int] = None, eps: float = LN_EPS):
        super().__init__()
        shape = (d,) if dirs is None else (dirs, d)
        self.d, self.dirs, self.eps = d, dirs, eps
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dirs is None:
            return F.layer_norm(x, (self.d,), self.weight, self.bias, self.eps)
        y = F.layer_norm(x, (self.d,), None, None, self.eps)
        shape = (self.dirs,) + (1,) * (x.dim() - 2) + (self.d,)
        return y * self.weight.view(shape) + self.bias.view(shape)


def attend(q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor, n_head: int,
           bias: Optional[torch.Tensor], scale: float, use_kernels: bool,
           rate: float = 0.0, rng: Optional[DropoutRNG] = None,
           h0: int = 0) -> torch.Tensor:
    """Flat attention over (..., T, H*d) projections: every leading axis
    (batch, and the decoder's direction axis) folds into the kernel's batch,
    so one launch covers both directions.  Deterministic (K1) without an
    rng; with one, the training attention (K3 forward, K4 backward) with
    dropout ``rate`` on the probabilities and a seed drawn from the rng
    (seed 0 and no draw at rate 0, as in JAX).  ``n_head`` is the heads
    this process holds and ``h0`` the first of them among the model's."""
    q3 = q2.reshape(-1, *q2.shape[-2:])
    k3 = k2.reshape(-1, *k2.shape[-2:])
    v3 = v2.reshape(-1, *v2.shape[-2:])
    if rng is None:
        fn = small_mha_flat if use_kernels else small_mha_flat_plain
        ctx = fn(q3, k3, v3, n_head, bias=bias, scale=scale)
    else:
        seed = rng.seed() if rate > 0.0 else 0
        ctx = small_mha_dropout_flat(q3, k3, v3, n_head, bias, seed, rate,
                                     scale, use_kernels, rng.rows, h0)
    return ctx.reshape(*q2.shape[:-1], ctx.shape[-1])


def _batch_dim(dense: Dense) -> int:
    """The batch axis of a module's activations: 1 behind the decoder's
    leading direction axis."""
    return 0 if dense.dirs is None else 1


def _post_ln(ln: Optional[LayerNorm], out: torch.Tensor, residual: torch.Tensor,
             dtype) -> torch.Tensor:
    """LayerNorm(out + residual) in f32, rounded to ``dtype``; without a
    LayerNorm (a pre-LN layer's sublayer, ``post_ln=False``) ``out`` alone,
    the caller adding the residual."""
    if ln is None:
        return out
    return ln(out.to(torch.float32) + residual.to(torch.float32)).to(dtype)


def _qk_std(d_model: int, d: int) -> float:
    # reference attention.py:19-21: N(0, 2/(d_model+d_k))
    return math.sqrt(2.0 / (d_model + d))


class MultiHeadAttention(_Sharded, nn.Module):
    """Post-LN multi-head attention; submodule names match the JAX module
    (w_qs/w_ks/w_vs/fc/layer_norm).  ``post_ln=False`` leaves out the
    LayerNorm and the residual (a pre-LN layer adds them itself)."""
    COLUMN, ROW = ("w_qs", "w_ks", "w_vs"), ("fc",)

    def __init__(self, d_model: int, n_head: int, d_k: int, d_v: int,
                 dtype=torch.float32, use_kernels: bool = True,
                 dirs: Optional[int] = None, dropout: float = 0.1,
                 post_ln: bool = True):
        super().__init__()
        if d_k != d_v:
            raise ValueError("flat attention needs d_k == d_v")
        self.n_head, self.dtype, self.use_kernels = n_head, dtype, use_kernels
        self.dropout = dropout
        self.scale = 1.0 / math.sqrt(d_k)
        kw = dict(dirs=dirs, dtype=dtype, init="normal")
        self.w_qs = Dense(d_model, n_head * d_k, std=_qk_std(d_model, d_k), **kw)
        self.w_ks = Dense(d_model, n_head * d_k, std=_qk_std(d_model, d_k), **kw)
        self.w_vs = Dense(d_model, n_head * d_v, std=_qk_std(d_model, d_v), **kw)
        self.fc = Dense(n_head * d_v, d_model, dirs=dirs, dtype=dtype,
                        init="xavier_normal")
        self.layer_norm = LayerNorm(d_model, dirs) if post_ln else None

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """q/k/v: (..., T, d_model); bias: additive (1|B, Tq, Tk) f32."""
        xq = self._enter(q)
        xk = xq if k is q else self._enter(k)
        xv = xk if v is k else self._enter(v)
        ctx = attend(self.w_qs(xq), self.w_ks(xk), self.w_vs(xv), self.n_head,
                     bias, self.scale, self.use_kernels, self.dropout, rng,
                     self.h0)
        out = dropout(self.fc(self._exit(ctx)), self.dropout, rng,
                      _batch_dim(self.fc))
        return _post_ln(self.layer_norm, out, q, self.dtype)

    def decode_step(self, x: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, step: int):
        """One autoregressive self-attention step with a K/V cache (JAX
        ``MultiHeadAttention.decode_step``; plain einsums there, plain
        torch here): projects only the new position and attends it against
        the flat (B, L, h*d) caches.

        x: (B, 1, d_model), the layer input at position ``step``;
        k_cache/v_cache: projected caches whose slots >= step are unset
        (this process's heads under tensor parallelism).
        Slot ``step`` is written IN PLACE (JAX returns updated copies; the
        callers here own their caches).  Returns (out (B, 1, d_model),
        k_cache, v_cache).  Deterministic path only.  The attention core is
        K13 (``ops.cached_attention_step``, plain on CPU tensors) with
        ``use_kernels``, its plain version (the JAX einsums) otherwise."""
        B, L, HD = k_cache.shape
        attend_step = (cached_attention_step if self.use_kernels
                       else cached_attention_step_plain)
        ctx = attend_step(self.w_qs(x)[:, 0], self.w_ks(x)[:, 0],
                          self.w_vs(x)[:, 0], k_cache, v_cache, step,
                          self.n_head)
        out = self.fc(self._exit(ctx.reshape(B, 1, HD)))
        return _post_ln(self.layer_norm, out, x, self.dtype), k_cache, v_cache


class CrossKV(_Sharded, nn.Module):
    """Cross-attention K/V projections, split out so the decoder projects
    the encoder sequence once per clip.  Returns FLAT (..., Tk, H*d)."""
    COLUMN = ("w_ks", "w_vs")

    def __init__(self, d_model: int, n_head: int, d_k: int, d_v: int,
                 dtype=torch.float32, dirs: Optional[int] = None):
        super().__init__()
        self.dirs, self.n_head = dirs, n_head
        kw = dict(dirs=dirs, dtype=dtype, init="normal")
        self.w_ks = Dense(d_model, n_head * d_k, std=_qk_std(d_model, d_k), **kw)
        self.w_vs = Dense(d_model, n_head * d_v, std=_qk_std(d_model, d_v), **kw)

    def forward(self, enc: torch.Tensor):
        """enc: (B, Tk, d_model), shared by every direction."""
        enc = self._enter(enc)
        x = enc if self.dirs is None else enc.expand(self.dirs, *enc.shape)
        return self.w_ks(x), self.w_vs(x)


class CachedCrossAttention(_Sharded, nn.Module):
    """Multi-head cross-attention over precomputed ``CrossKV`` outputs:
    ``MultiHeadAttention`` minus the per-call K/V projections (and, with
    ``post_ln=False``, minus its LayerNorm and residual)."""
    COLUMN, ROW = ("w_qs",), ("fc",)

    def __init__(self, d_model: int, n_head: int, d_k: int, d_v: int,
                 dtype=torch.float32, use_kernels: bool = True,
                 dirs: Optional[int] = None, dropout: float = 0.1,
                 post_ln: bool = True):
        super().__init__()
        if d_k != d_v:
            raise ValueError("flat attention needs d_k == d_v")
        self.n_head, self.dtype, self.use_kernels = n_head, dtype, use_kernels
        self.dropout = dropout
        self.scale = 1.0 / math.sqrt(d_k)
        self.w_qs = Dense(d_model, n_head * d_k, dirs=dirs, dtype=dtype,
                          init="normal", std=_qk_std(d_model, d_k))
        self.fc = Dense(n_head * d_v, d_model, dirs=dirs, dtype=dtype,
                        init="xavier_normal")
        self.layer_norm = LayerNorm(d_model, dirs) if post_ln else None

    def forward(self, q: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        ctx = attend(self.w_qs(self._enter(q)), k2, v2, self.n_head, bias,
                     self.scale, self.use_kernels, self.dropout, rng, self.h0)
        out = dropout(self.fc(self._exit(ctx)), self.dropout, rng,
                      _batch_dim(self.fc))
        return _post_ln(self.layer_norm, out, q, self.dtype)


class PositionwiseFeedForward(_Sharded, nn.Module):
    """w_2(relu(w_1(x))), dropout, post-LN residual."""
    COLUMN, ROW = ("w_1",), ("w_2",)

    def __init__(self, d_model: int, d_inner: int, dtype=torch.float32,
                 dirs: Optional[int] = None, dropout: float = 0.1):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.w_1 = Dense(d_model, d_inner, dirs=dirs, dtype=dtype)
        self.w_2 = Dense(d_inner, d_model, dirs=dirs, dtype=dtype)
        self.layer_norm = LayerNorm(d_model, dirs)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        h = self._exit(F.relu(self.w_1(self._enter(x))))
        h = dropout(self.w_2(h), self.dropout, rng, _batch_dim(self.w_2))
        return _post_ln(self.layer_norm, h, x, self.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_inner: int, n_head: int, d_k: int,
                 d_v: int, dtype=torch.float32, use_kernels: bool = True,
                 dropout: float = 0.1):
        super().__init__()
        self.slf_attn = MultiHeadAttention(d_model, n_head, d_k, d_v, dtype,
                                           use_kernels, dropout=dropout)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, dtype,
                                               dropout=dropout)

    def forward(self, x: torch.Tensor,
                non_pad_mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        x = self.slf_attn(x, x, x, bias=bias, rng=rng)
        if non_pad_mask is not None:
            x = x * non_pad_mask.to(x.dtype)
        x = self.pos_ffn(x, rng)
        if non_pad_mask is not None:
            x = x * non_pad_mask.to(x.dtype)
        return x


class DecoderLayer(nn.Module):
    """Self-attention, uncached cross-attention over the encoder output and
    FFN, each followed by the optional non-pad multiply (JAX
    ``DecoderLayer``; the decoders use the cached forms above)."""

    def __init__(self, d_model: int, d_inner: int, n_head: int, d_k: int,
                 d_v: int, dtype=torch.float32, use_kernels: bool = True,
                 dropout: float = 0.1):
        super().__init__()
        self.slf_attn = MultiHeadAttention(d_model, n_head, d_k, d_v, dtype,
                                           use_kernels, dropout=dropout)
        self.enc_attn = MultiHeadAttention(d_model, n_head, d_k, d_v, dtype,
                                           use_kernels, dropout=dropout)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, dtype,
                                               dropout=dropout)

    def forward(self, x: torch.Tensor, enc_output: torch.Tensor,
                non_pad_mask: Optional[torch.Tensor] = None,
                slf_bias: Optional[torch.Tensor] = None,
                dec_enc_bias: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        def keep(h):
            return h if non_pad_mask is None else h * non_pad_mask.to(h.dtype)
        x = keep(self.slf_attn(x, x, x, bias=slf_bias, rng=rng))
        x = keep(self.enc_attn(x, enc_output, enc_output, bias=dec_enc_bias,
                               rng=rng))
        return keep(self.pos_ffn(x, rng))
