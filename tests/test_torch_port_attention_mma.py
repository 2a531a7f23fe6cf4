"""The rounding points of K3/K4's bf16 (tensor-core) bodies, emulated on the
CPU and held against the plain versions, before any card run.

``csrc/attention_train.cu`` runs K3 on K1's body (``csrc/mma.cuh``) and K4
in two phases.  What decides their numbers is where they round:

* operands are bf16, every product is exact and accumulates in f32 (the
  ``mma.sync`` products);
* the softmax runs online over tiles of 32 keys; the forward takes the
  mask on exp(s - max) and scales the output by inv_keep / rowsum at the
  end;
* an f32 A operand (the forward's weights, the backward's P_drop and dS)
  is split into hi = bf16(x) and lo = bf16(x - hi), both products issued;
* the backward's D_i = rowsum(dP o P) is an f32 sum from the scores;
* each output is rounded once to bf16.

The emulation below follows those points with torch f32 matmuls and is
held against ``small_mha_dropout_flat_plain`` /
``small_mha_dropout_bwd_flat_plain`` (f32 from the upcast operands, one
rounding) on the same bf16 inputs and injected mask, at the five shapes of
``chip_smoke.py`` phase 3b scaled down (fewer rows and heads, d = 64), and
at lengths past one key tile, under the bf16 criterion of
``chip_smoke.TRAIN_TOL``: one bf16 ulp of the plain value plus a floor at
the tensor's scale.  Before the rounding to bf16 the emulation agrees with
the plain f32 values to ``SPLIT_TOL`` of the tensor's largest element: the
hi + lo split keeps an operand to about 2^-16 of itself.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu_torch import ops

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TRAIN_TOL = chip_smoke.TRAIN_TOL["bfloat16"]
KEY_TILE = 32
RATE = 0.1
# emulated f32 results against the plain f32 ones, relative to the
# tensor's largest element: the split leaves ~2^-16 of each operand (the
# readings at SHAPES are at most 5.9e-6, ~2^-17.4; with P_drop as one bf16
# operand dV is 2.6e-3 off)
SPLIT_TOL = 2.0 ** -15


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _split(x):
    """hi = bf16(x) and lo = bf16(x - hi), as f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_mm(a, b):
    """a @ b with a split into its bf16 hi and lo parts (b is bf16-exact)."""
    hi, lo = _split(a)
    return hi @ b + lo @ b


def _heads(x, H):
    B, T, D = x.shape
    return x.float().reshape(B, T, H, D // H).transpose(1, 2)


def _merge(x):
    B, H, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, H * d).to(torch.bfloat16)


def _logits(qh, kh, bias, scale):
    s = qh @ kh.transpose(-1, -2) * scale
    return s if bias is None else s + bias[:, None]


def _row_stats(x):
    """Row max and sum of exp(x - max), online over tiles of KEY_TILE keys."""
    m = torch.full(x.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    for k0 in range(0, x.shape[-1], KEY_TILE):
        xt = x[..., k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(xt - m_new).sum(-1, keepdim=True)
        m = m_new
    return m, l


def emulated_fwd(q, k, v, H, bias, keep, scale):
    """K3's bf16 body: online softmax over key tiles, keep * exp(s - max)
    split into P V, the output scaled by inv_keep / rowsum.  Returns the
    f32 output before its rounding to bf16."""
    qh, kh, vh = _heads(q, H), _heads(k, H), _heads(v, H)
    x = _logits(qh, kh, bias, scale)
    inv_keep = torch.tensor(1.0 / (1.0 - RATE), dtype=torch.float32)
    m = torch.full(x.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(qh.shape[:-1] + (vh.shape[-1],))
    for k0 in range(0, x.shape[-1], KEY_TILE):
        xt = x[..., k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        e = torch.exp(xt - m_new)
        l = l * corr + e.sum(-1, keepdim=True)
        w = torch.where(keep[..., k0:k0 + KEY_TILE], e, 0.0)
        o = o * corr + _split_mm(w, vh[..., k0:k0 + KEY_TILE, :])
        m = m_new
    return o * ((1.0 / l) * inv_keep)


def emulated_bwd(q, k, v, H, bias, keep, scale, dout):
    """K4's bf16 body: phase 1 (row statistics, D_i, dS, dQ from the
    registers) and phase 2 (dV, dK from P_drop^T and dS^T).  Returns the
    f32 (dq, dk, dv) before their rounding to bf16."""
    qh, kh, vh, gh = (_heads(t, H) for t in (q, k, v, dout))
    x = _logits(qh, kh, bias, scale)
    inv_keep = torch.tensor(1.0 / (1.0 - RATE), dtype=torch.float32)
    m, l = _row_stats(x)
    p = torch.exp(x - m) * (1.0 / l)
    dp = torch.where(keep, (gh @ vh.transpose(-1, -2)) * inv_keep, 0.0)
    d_row = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - d_row)
    pd = torch.where(keep, p * inv_keep, 0.0)
    dq = _split_mm(ds, kh) * scale
    dk = _split_mm(ds.transpose(-1, -2), qh) * scale
    dv = _split_mm(pd.transpose(-1, -2), gh)
    return dq, dk, dv


def _bias(kind, n, tq, tk):
    if kind is None:
        return None
    if kind == "causal":
        mask = torch.ones(tq, tk, dtype=torch.bool).triu(1)[None]
    elif kind == "prefix":   # the decode step's prefix bias: keys past 1
        mask = (torch.arange(tk) > 1)[None, None, :]
    elif kind == "masked row":   # one query row sees no key
        mask = torch.zeros(1, tq, tk, dtype=torch.bool)
        mask[0, 0] = True
    else:   # per batch row: keys past a random length
        lengths = torch.from_numpy(np.random.default_rng(7).integers(1, tk + 1, n))
        mask = (torch.arange(tk)[None, :] >= lengths[:, None])[:, None]
    return ops.mask_to_bias(mask, tq, tk)


# (name, rows, Tq, Tk, bias kind, H, d): chip_smoke.py phase 3b's five
# train-step shapes with fewer rows and heads, then lengths past one key tile
SHAPES = [
    ("encoder", 4, 30, 30, None, 2, 64),
    ("decoder self causal", 6, 17, 17, "causal", 2, 64),
    ("decoder self prefix", 6, 3, 3, "prefix", 2, 64),
    ("cross", 6, 17, 30, None, 2, 64),
    ("masked row", 6, 17, 17, "masked row", 2, 64),
    ("Tq=Tk=70 causal", 2, 70, 70, "causal", 2, 32),
    ("Tq=1 Tk=100 per-batch bias", 4, 1, 100, "per_batch", 2, 16),
]


def _inputs(n, tq, tk, H, d, seed):
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(torch.bfloat16)
    return bf16(n, tq, H * d), bf16(n, tk, H * d), bf16(n, tk, H * d), bf16(n, tq, H * d)


def _bf16_close(got, want):
    """chip_smoke's criterion: within one bf16 ulp of the plain value (2^-7
    relative) plus a floor at the tensor's scale."""
    got, want = got.float(), want.float()
    limit = want.abs() * TRAIN_TOL["rel"] + want.abs().max() * TRAIN_TOL["floor"]
    return bool(((got - want).abs() <= limit).all())


def _case(name):
    _, n, tq, tk, kind, H, d = next(s for s in SHAPES if s[0] == name)
    q, k, v, dout = _inputs(n, tq, tk, H, d, seed=sum(map(ord, name)))
    bias = _bias(kind, n, tq, tk)
    keep = ops.dropout_keep_mask_flat_plain(n, tq, tk, H, 1234, RATE, "cpu")
    return q, k, v, dout, H, bias, keep, d ** -0.5


@pytest.mark.parametrize("name", [s[0] for s in SHAPES])
def test_bf16_forward_rounding_stays_within_an_ulp_of_the_plain_version(name):
    q, k, v, _, H, bias, keep, scale = _case(name)
    emu = emulated_fwd(q, k, v, H, bias, keep, scale)
    want = ops.small_mha_dropout_flat_plain(q, k, v, H, bias, 0, RATE, scale,
                                            keep=keep)
    assert _bf16_close(_merge(emu), want)
    exact = ops.small_mha_dropout_flat_plain(q.float(), k.float(), v.float(), H,
                                             bias, 0, RATE, scale, keep=keep)
    err = (emu.transpose(1, 2).reshape(exact.shape) - exact).abs().max()
    assert err <= SPLIT_TOL * exact.abs().max()


@pytest.mark.parametrize("name", [s[0] for s in SHAPES])
def test_bf16_backward_rounding_stays_within_an_ulp_of_the_plain_version(name):
    q, k, v, dout, H, bias, keep, scale = _case(name)
    emu = emulated_bwd(q, k, v, H, bias, keep, scale, dout)
    wants = ops.small_mha_dropout_bwd_flat_plain(q, k, v, H, bias, 0, RATE, scale,
                                                 dout, keep=keep)
    exacts = ops.small_mha_dropout_bwd_flat_plain(
        q.float(), k.float(), v.float(), H, bias, 0, RATE, scale, dout.float(),
        keep=keep)
    for which, e, want, exact in zip("qkv", emu, wants, exacts):
        assert _bf16_close(_merge(e), want), which
        err = (e.transpose(1, 2).reshape(exact.shape) - exact).abs().max()
        assert err <= SPLIT_TOL * exact.abs().max(), which


def test_the_split_is_what_keeps_the_gradients_within_an_ulp():
    """Without the lo half (P_drop and dS as bf16 operands alone) the
    gradients leave the f32 tolerance the split meets: the split is needed,
    not decoration."""
    q, k, v, dout, H, bias, keep, scale = _case("encoder")
    exact = ops.small_mha_dropout_bwd_flat_plain(
        q.float(), k.float(), v.float(), H, bias, 0, RATE, scale, dout.float(),
        keep=keep)[2]
    gh = _heads(dout, H)
    x = _logits(_heads(q, H), _heads(k, H), bias, scale)
    m, l = _row_stats(x)
    pd = torch.where(keep, torch.exp(x - m) * (1.0 / l) / (1.0 - RATE), 0.0)
    hi_only = _split(pd)[0].transpose(-1, -2) @ gh
    err = (hi_only.transpose(1, 2).reshape(exact.shape) - exact).abs().max()
    assert err > SPLIT_TOL * exact.abs().max()
