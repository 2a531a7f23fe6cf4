"""The arithmetic of the bf16 (tensor-core) routes of K11 (the fused decoder
layer) and K10 (the fused ResNet block), emulated on the CPU and held
against their plain versions, before any card run.

``csrc/decoder_layer.cu`` spreads a tile of rows over a cluster of
``cluster_size(n_head)`` CTAs, each owning a slice of every GEMM's columns.
What decides its numbers:

* every GEMM takes bf16 operands and sums exact products in f32 (the
  ``mma.sync`` products);
* the attention's softmax runs online over passes of 64 keys, and P V takes
  P split into hi = bf16(P) and lo = bf16(P - hi), both products issued;
* the LayerNorm statistics (sum x, sum x^2) are summed per CTA over its
  column slice, then across the cluster in CTA order;
* the FFN's w2 product is summed in chunks of d_model columns of the
  intermediate, each added into the f32 residual (b2 with the first);
* q, k, v, both contexts, the LayerNorm outputs that feed a GEMM and the
  ReLU output are rounded to bf16 where the plain version rounds them.

``csrc/resblock.cu`` tiles (samples, row band) as ``pick_mma_tile`` says,
stages the x rows a band needs, computes conv1 over the h rows conv2 reads,
reads A through the band with a zero row for taps outside the plane, and
writes the output over the staged x it read as the residual.  The emulation
below follows that index arithmetic tile by tile (asserting that every tap
inside the plane lies inside the staged band) with bf16 operands and f32
sums over k = (tap, channel), channels padded to a multiple of 8.

Both emulations are held against ``fused_decoder_layer_plain`` /
``fused_resblock_plain`` on the same bf16 inputs under the unchanged
card tolerances of ``chip_smoke.py`` (``LAYER_TOL``, ``RESBLOCK_TOL``), at
the path-A shapes (fewer samples) and at the shapes that take the kernels'
other branches: a head width above 64 and one not a multiple of 16, more
than 64 cross keys, row bands, channels not a multiple of 8.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu_torch import ops
from sbl_for_multilingual_lip_reading_tpu_torch.ops import decoder_layer as DL
from sbl_for_multilingual_lip_reading_tpu_torch.ops import resblock as RB
from test_torch_port_kernel_shapes import SIZERS

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
LAYER_TOL = chip_smoke.LAYER_TOL["bfloat16"]
RESBLOCK_TOL = chip_smoke.RESBLOCK_TOL["bfloat16"]
KEY_PASS = 64  # keys per pass of K11's online softmax (kKeyPass)
F32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _r(t):
    """Rounded to bf16, as f32."""
    return t.to(torch.bfloat16).to(F32)


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)
                            ).to(torch.bfloat16)


def _f32(rng, shape, loc=0.0, scale=1.0):
    return torch.from_numpy((loc + rng.standard_normal(shape) * scale).astype(np.float32))


# ------------------------------------------------------------------- K11
def _attend(q, k, v, bias, scale):
    """softmax(q k^T * scale + bias) v as K11's warps take it: online over
    passes of KEY_PASS keys, P V with P split into bf16 hi + lo."""
    m_run = torch.full(q.shape[:-1] + (1,), -math.inf)
    l_run = torch.zeros_like(m_run)
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for kp0 in range(0, k.shape[-2], KEY_PASS):
        kk, vv = k[..., kp0:kp0 + KEY_PASS, :], v[..., kp0:kp0 + KEY_PASS, :]
        s = torch.matmul(q, kk.transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[..., kp0:kp0 + KEY_PASS]
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new)
        l_run = l_run * corr + p.sum(-1, keepdim=True)
        hi = _r(p)
        o = o * corr + torch.matmul(hi, vv) + torch.matmul(_r(p - hi), vv)
        m_run = m_new
    return o / l_run


def _cluster_ln(res, g, b, cs):
    """LayerNorm with its statistics summed per column slice of the cs
    CTAs, then across them in order; E[x^2] - mean^2, eps 1e-6."""
    D = res.shape[-1]
    dc = D // cs
    s = sum(res[..., r * dc:(r + 1) * dc].sum(-1, keepdim=True) for r in range(cs))
    s2 = sum((res[..., r * dc:(r + 1) * dc] ** 2).sum(-1, keepdim=True) for r in range(cs))
    mu = s / D
    var = s2 / D - mu * mu
    return ((res - mu) * (1.0 / torch.sqrt(var + DL.LN_EPS)) * g[:, None, None, :]
            + b[:, None, None, :])


def _k11_emulated(x, wq, bq, wk, bk, wv, bv, fc_w, fc_b, ln1_s, ln1_b, wq2,
                  bq2, fc2_w, fc2_b, ln2_s, ln2_b, w1, b1, w2, b2, ln3_s, ln3_b,
                  ck, cv, n_head, mask_bias):
    dirs, B, L, D = x.shape
    H, dk = n_head, D // n_head
    cs = DL.cluster_size(H)
    scale = 1.0 / math.sqrt(dk)

    def proj(h, w, bias):
        # the epilogue adds the bias to the f32 sum of bf16 products
        return torch.matmul(h.float(), w.float().transpose(1, 2)[:, None]) \
            + bias.float()[:, None, None]

    def heads(t):
        return t.reshape(dirs, B, t.shape[2], H, dk).permute(0, 1, 3, 2, 4)

    def unheads(c):
        return c.permute(0, 1, 3, 2, 4).reshape(dirs, B, c.shape[3], D)

    mb = None if mask_bias is None else mask_bias.float()
    q, k, v = (_r(proj(x, w, bias)) for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    ctx = _r(unheads(_attend(heads(q), heads(k), heads(v), mb, scale)))
    h1 = _cluster_ln(proj(ctx, fc_w, fc_b) + x.float(), ln1_s, ln1_b, cs)
    q2 = _r(proj(_r(h1), wq2, bq2))
    ctx2 = _r(unheads(_attend(heads(q2), heads(ck.float()), heads(cv.float()), None,
                              scale)))
    h2 = _cluster_ln(proj(ctx2, fc2_w, fc2_b) + h1, ln2_s, ln2_b, cs)
    h2c, res = _r(h2), h2
    for f0 in range(0, w1.shape[1], D):
        u = _r(torch.relu(proj(h2c, w1[:, f0:f0 + D], b1[:, f0:f0 + D])))
        part = torch.matmul(u, w2[:, :, f0:f0 + D].float().transpose(1, 2)[:, None])
        res = (part + b2.float()[:, None, None] if f0 == 0 else part) + res
    return _r(_cluster_ln(res, ln3_s, ln3_b, cs))


def _layer_inputs(seed, B, L, D, H, DI, Tk):
    rng = np.random.default_rng(seed)
    dirs = 2

    def w(o, i):
        return _bf16(rng, (dirs, o, i), 1.0 / math.sqrt(i))

    def bias(n):
        return _f32(rng, (dirs, n), 0.0, 0.05)

    def ln(n):
        return _f32(rng, (dirs, n), 1.0, 0.1), _f32(rng, (dirs, n), 0.0, 0.1)

    x = _bf16(rng, (dirs, B, L, D))
    args = (x, w(D, D), bias(D), w(D, D), bias(D), w(D, D), bias(D), w(D, D), bias(D),
            *ln(D), w(D, D), bias(D), w(D, D), bias(D), *ln(D), w(DI, D), bias(DI),
            w(D, DI), bias(D), *ln(D), _bf16(rng, (dirs, B, Tk, D)),
            _bf16(rng, (dirs, B, Tk, D)), H)
    return args


@pytest.mark.parametrize("B,L,D,H,DI,Tk,causal", [
    (3, 17, 512, 8, 2048, 30, True),    # path A's widest segment, its bias
    (3, 17, 512, 8, 2048, 30, False),
    (7, 3, 512, 8, 2048, 30, False),    # its narrowest
    (2, 17, 512, 4, 2048, 30, True),    # d_k = 128: two column tiles per head
    (4, 9, 64, 4, 128, 30, True),       # the tiny preset, d_k = 16
    (2, 17, 128, 2, 256, 100, True),    # two passes of the online softmax; 2 CTAs
    (2, 5, 96, 4, 192, 20, True),       # d_k = 24: head width padded to 32
    (2, 6, 48, 3, 96, 9, False),        # three heads: a cluster of 1
])
def test_k11_bf16_route_arithmetic_within_layer_tol(B, L, D, H, DI, Tk, causal):
    args = _layer_inputs(B * 100 + L, B, L, D, H, DI, Tk)
    mask = None
    if causal:
        mask = ops.mask_to_bias(torch.ones(L, L, dtype=torch.bool).triu(1)[None], L, L)[0]
    want = ops.fused_decoder_layer_plain(*args, mask_bias=mask)
    got = _k11_emulated(*args, mask)
    assert got.shape == want.shape
    err = (got - want.float()).abs().max().item()
    assert err <= LAYER_TOL, err


def test_k11_hi_lo_split_keeps_p_to_f32():
    """P V with P as one bf16 operand is off by ~2^-9 of the context; with
    hi + lo, by ~2^-17 (the operands are then f32 to 16 bits)."""
    rng = np.random.default_rng(3)
    q, k, v = (_r(_f32(rng, (4, 17, 64))) for _ in range(3))
    scale = 0.125
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s, -1)
    exact = torch.matmul(p, v)
    split = _attend(q, k, v, None, scale)
    single = torch.matmul(_r(p), v)
    top = exact.abs().max().item()
    assert (split - exact).abs().max().item() <= 2.0 ** -15 * top
    assert (single - exact).abs().max().item() > 2.0 ** -12 * top


# ------------------------------------------------------------------- K10
def _k10_emulated(x, w1, a1, b1, w2, a2, b2):
    """K10's bf16 route tile by tile: (samples, band) from pick_mma_tile,
    x rows xlo..xhi staged channels last (C padded to 8), conv1 over h rows
    hlo..hhi, conv2 over the band's output rows, A read through the staged
    band (a zero row for taps outside the plane), f32 sums of bf16
    products over k = (tap, channel), the output over the staged x."""
    N, C, S, _ = x.shape
    bt, bh = RB.pick_mma_tile(SIZERS, C, S)
    c8 = -(-C // 8) * 8

    def wmat(w):  # (out, in, 3, 3) -> (out, 9 * c8), k = tap * c8 + ci
        wk = torch.zeros(C, 9, c8)
        wk[:, :, :C] = w.float().permute(0, 2, 3, 1).reshape(C, 9, C)
        return wk.reshape(C, 9 * c8)

    W1, W2 = wmat(w1), wmat(w2)

    def patch(buf, row_lo, rows):
        """A of an implicit GEMM over plane rows `rows` of the staged buf
        (nbt, staged rows, S, c8) whose row 0 is plane row row_lo."""
        nbt, staged = buf.shape[:2]
        A = torch.zeros(nbt, len(rows), S, 9, c8)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            for i, prow in enumerate(rows):
                y = prow + ky - 1
                if not 0 <= y < S:
                    continue
                assert 0 <= y - row_lo < staged, "a tap inside the plane is outside the band"
                # the columns col with col + kx - 1 inside the plane
                lo, hi = max(0, 1 - kx), min(S, S + 1 - kx)
                A[:, i, lo:hi, tap] = buf[:, y - row_lo, lo + kx - 1:hi + kx - 1]
        return A.reshape(-1, 9 * c8)

    out = torch.empty_like(x)
    nbands = -(-S // bh)
    for tile in range(-(-N // bt) * nbands):
        band, n0 = tile % nbands, (tile // nbands) * bt
        nbt = min(bt, N - n0)
        r0 = band * bh
        no = min(bh, S - r0)
        hlo, hhi = max(r0 - 1, 0), min(r0 + bh, S - 1)
        xlo, xhi = max(hlo - 1, 0), min(hhi + 1, S - 1)
        assert xhi - xlo + 1 <= min(bh + 4, S) and hhi - hlo + 1 <= min(bh + 2, S)
        xs = torch.zeros(nbt, xhi - xlo + 1, S, c8)
        xs[..., :C] = x[n0:n0 + nbt, :, xlo:xhi + 1].float().permute(0, 2, 3, 1)
        acc = patch(xs, xlo, range(hlo, hhi + 1)) @ W1.t()
        hs = torch.zeros(nbt, hhi - hlo + 1, S, c8)
        hs[..., :C] = _r(torch.relu(acc * a1 + b1)).reshape(nbt, hhi - hlo + 1, S, C)
        acc = patch(hs, hlo, range(r0, r0 + no)) @ W2.t()
        res = xs[:, r0 - xlo:r0 - xlo + no, :, :C].reshape(-1, C)
        y = _r(torch.relu(acc * a2 + b2 + res)).reshape(nbt, no, S, C)
        out[n0:n0 + nbt, :, r0:r0 + no] = y.permute(0, 3, 1, 2).to(x.dtype)
    return out


@pytest.mark.parametrize("N,C,S", [
    (3, 64, 22),    # layer1: one whole 22 x 22 plane a block
    (4, 128, 11),   # layer2: 3 planes a block, a partial last tile
    (6, 256, 6),    # layer3: 5 planes
    (12, 512, 3),   # layer4: 10 planes, a partial last tile
    (9, 8, 8),      # the tiny preset's block
    (2, 8, 30),     # a plane past one GEMM pass: two row bands
    (3, 12, 9),     # channels not a multiple of 8
    (2, 16, 40),    # four row bands
])
def test_k10_bf16_route_arithmetic_within_resblock_tol(N, C, S):
    rng = np.random.default_rng(N * 1000 + C + S)
    x = torch.relu(_f32(rng, (N, C, S, S))).to(torch.bfloat16)
    w1, w2 = (_bf16(rng, (C, C, 3, 3), math.sqrt(2.0 / (9 * C))) for _ in range(2))
    a1, a2 = (_f32(rng, (C,), 1.0, 0.1) for _ in range(2))
    b1, b2 = (_f32(rng, (C,), 0.0, 0.1) for _ in range(2))
    want = ops.fused_resblock_plain(x, w1, a1, b1, w2, a2, b2).float()
    got = _k10_emulated(x, w1, a1, b1, w2, a2, b2).float()
    err = (got - want).abs()
    top = want.abs().max().item()
    assert bool((err <= want.abs() * RESBLOCK_TOL["rel"]
                 + top * RESBLOCK_TOL["floor"]).all()), err.max().item()
