"""K13, the cached self-attention step (``ops.cached_attention_step``,
``csrc/decode_attention.cu``), on the CPU.

* Its plain version is the einsums ``MultiHeadAttention.decode_step`` ran
  before the kernel (kept here as ``_einsum_step``): equal bit for bit,
  outputs and caches, at every step of L = 17 (8 heads, the ``lrw1000``
  decoder) and L = 33 (12 heads, Auto-AVSR's), f32 and bf16.
* The kernel's arithmetic, emulated in torch as the source computes it (a
  head's slots dealt to 32 / lanes slot groups, an online f32 softmax per
  group rescaled once a round of kUnroll passes, the groups merged by a
  butterfly, empty groups
  weighing nothing), against the plain version within chip_smoke's
  K1_TOL at every head width and both dtypes.  The card checks the kernel
  itself (``chip_smoke.py`` phase 3f).
* ``decode_step`` against JAX's at the decoders' head counts and width.
* The wrapper's refusals (the kernel's on its card branch, shapes and
  steps on any device), its counters (0 on the CPU, where it takes the
  plain version), its launch through a stand-in library on meta tensors,
  and ``ops.KERNELS`` without it.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu.models.layers import (
    MultiHeadAttention as JaxMHA)
from sbl_for_multilingual_lip_reading_tpu_torch import ops
from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import (
    MultiHeadAttention)
from sbl_for_multilingual_lip_reading_tpu_torch.ops import _build, attention
from sbl_for_multilingual_lip_reading_tpu_torch.ops.attention import (
    HEAD_DIMS, MASK_FILL, cached_attention_step, cached_attention_step_plain)
from sbl_for_multilingual_lip_reading_tpu_torch.utils import state_dict_from_jax

from test_torch_port_recognize import _perturbed

# chip_smoke.py's K1_TOL: f32 differs in summation order; in bf16 the kernel
# keeps the probabilities f32 where the plain version rounds them, so an
# output may sit one bf16 ulp away (2^-6 for |out| in [2, 4))
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the kernel's passes a round (csrc/decode_attention.cu kUnroll)
UNROLL = int(re.search(r"constexpr int kUnroll = (\d+);",
                       (_build.CSRC / "decode_attention.cu").read_text()).group(1))
SHAPES = ((17, 8), (33, 12))   # (L, heads) of the lrw1000 and Auto-AVSR decoders
D_HEAD = 64
ROWS = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def zero_counts():
    cached_attention_step.launches = cached_attention_step.slots = 0
    yield
    cached_attention_step.launches = cached_attention_step.slots = 0


def _einsum_step(q2, k_row, v_row, k_cache, v_cache, step, h, dtype):
    """``MultiHeadAttention.decode_step``'s attention before K13, as it was
    written there (q2 (B, 1, h*d), k_row/v_row (B, h*d))."""
    B, L, HD = k_cache.shape
    d = HD // h
    f32 = torch.float32
    k_cache[:, step] = k_row
    v_cache[:, step] = v_row
    qh = q2.reshape(B, h, d).to(f32)
    kh = k_cache.reshape(B, L, h, d).to(f32)
    vh = v_cache.reshape(B, L, h, d).to(f32)
    logits = torch.einsum("bhd,bkhd->bhk", qh, kh) / math.sqrt(d)
    invalid = torch.arange(L, device=q2.device) > step
    logits = torch.where(invalid[None, None, :], MASK_FILL, logits)
    attn = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhk,bkhd->bhd", attn.to(f32), vh).to(dtype)


def _operands(g, n, L, hd, dtype, q_scale=3.0):
    """q, k_new, v_new (n, hd) and caches (n, L, hd) full of values, so a
    slot past ``step`` that were read would show."""
    def draw(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g)).to(dtype)
    return (draw(n, hd, s=q_scale), draw(n, hd), draw(n, hd), draw(n, L, hd),
            draw(n, L, hd))


def _kernel_emulation(q, k_new, v_new, k_cache, v_cache, step, h, scale):
    """csrc/decode_attention.cu's arithmetic: the slot written, a head's row
    of a slot read by d / (16 / itemsize) lanes, so 32 / lanes slot groups,
    group g taking slots g, g + G, ... <= step with an online f32 softmax,
    rescaled once a round of kUnroll slots by the round's largest logit;
    the groups' (max, sum, output) merged by the xor butterfly
    (offsets 1, 2, ... groups), a group without slots (max -inf) weighing
    0; the output rounded once to q's dtype."""
    N, L, D = k_cache.shape
    d = D // h
    k_cache[:, step] = k_new
    v_cache[:, step] = v_new
    groups = 32 // (d // (16 // q.element_size()))
    s = torch.einsum("nhd,nlhd->nhl", q.float().view(N, h, d),
                     k_cache.float().view(N, L, h, d)) * scale
    vf = v_cache.float().view(N, L, h, d)
    inf = torch.tensor(-math.inf)
    states = []
    for g in range(groups):
        m, l, acc = torch.full((N, h), -math.inf), torch.zeros(N, h), torch.zeros(N, h, d)
        for j0 in range(0, step + 1, groups * UNROLL):
            # a round: the group's kUnroll slots, one rescale by their max
            js = [j for j in range(j0 + g, j0 + groups * UNROLL, groups) if j <= step]
            if not js:
                continue
            m_new = torch.maximum(m, s[..., js].amax(-1))
            corr = torch.where(m == inf, 0.0, torch.exp(m - m_new))
            l, acc = l * corr, acc * corr[..., None]
            for j in js:
                p = torch.exp(s[..., j] - m_new)
                l = l + p
                acc = acc + p[..., None] * vf[:, j]
            m = m_new
        states.append((m, l, acc))
    o = 1
    while o < groups:
        merged = []
        for g in range(groups):
            (m, l, acc), (mo, lo, acco) = states[g], states[g ^ o]
            m_new = torch.maximum(m, mo)
            a = torch.where(m == inf, 0.0, torch.exp(m - m_new))
            b = torch.where(mo == inf, 0.0, torch.exp(mo - m_new))
            merged.append((m_new, l * a + lo * b, acc * a[..., None] + acco * b[..., None]))
        states, o = merged, o * 2
    _, l, acc = states[0]
    return (acc / l[..., None]).to(q.dtype).reshape(N, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H", SHAPES)
def test_plain_is_the_einsum_step_at_every_step(L, H, dtype):
    """A whole decode, step by step on the same caches: the plain version
    and the einsums give the same bits, outputs and caches."""
    g = torch.Generator().manual_seed(L * H)
    hd = H * D_HEAD
    _, _, _, kc, vc = _operands(g, ROWS, L, hd, dtype)
    kc.zero_()
    vc.zero_()
    kc_old, vc_old = kc.clone(), vc.clone()
    for step in range(L):
        q, k_new, v_new, _, _ = _operands(g, ROWS, 1, hd, dtype)
        want = _einsum_step(q[:, None], k_new, v_new, kc_old, vc_old, step, H, dtype)
        got = cached_attention_step_plain(q, k_new, v_new, kc, vc, step, H)
        assert got.dtype == dtype and got.shape == (ROWS, hd)
        assert torch.equal(got, want.reshape(ROWS, hd))
        assert torch.equal(kc, kc_old) and torch.equal(vc, vc_old)
        assert torch.equal(kc[:, step], k_new) and torch.equal(vc[:, step], v_new)
        assert not kc[:, step + 1:].any() and not vc[:, step + 1:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H", SHAPES)
def test_the_wrapper_takes_the_plain_version_on_the_cpu(L, H, dtype):
    """On CPU tensors the wrapper is the plain version, writes the slot and
    leaves every other slot as it was, and counts nothing."""
    g = torch.Generator().manual_seed(7)
    q, k_new, v_new, kc, vc = _operands(g, ROWS, L, H * D_HEAD, dtype)
    kc2, vc2 = kc.clone(), vc.clone()
    for step in (0, L // 2, L - 1):
        kc_before = kc.clone()
        got = cached_attention_step(q, k_new, v_new, kc, vc, step, H)
        want = cached_attention_step_plain(q, k_new, v_new, kc2, vc2, step, H)
        assert torch.equal(got, want)
        assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
        assert torch.equal(kc[:, step], k_new)
        others = torch.arange(L) != step
        assert torch.equal(kc[:, others], kc_before[:, others])
    assert cached_attention_step.launches == 0 and cached_attention_step.slots == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_the_kernels_arithmetic_against_the_plain_version(d, dtype):
    """The emulated kernel within K1_TOL of the plain version at every head
    width (1 to 16 slot groups a warp), at the first steps (groups left
    empty), a middle one and the last, and slots past ``step`` holding
    values that would show if read."""
    L, H = 33, 3
    g = torch.Generator().manual_seed(d)
    q, k_new, v_new, kc, vc = _operands(g, ROWS, L, H * d, dtype)
    for step in (0, 1, 2, 5, 16, L - 1):
        kc2, vc2 = kc.clone(), vc.clone()
        want = cached_attention_step_plain(q, k_new, v_new, kc, vc, step, H)
        got = _kernel_emulation(q, k_new, v_new, kc2, vc2, step, H, 1.0 / math.sqrt(d))
        assert torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype], (step, err)
        assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


@pytest.mark.parametrize("L,H", SHAPES)
def test_decode_step_matches_jax_at_the_decoders_heads(L, H):
    """``MultiHeadAttention.decode_step`` (kernels on, so the CPU takes the
    plain version) against JAX's over a whole decode: outputs and caches."""
    D = 96
    jax_mha = JaxMHA(D, H, D_HEAD, D_HEAD, 0.0)
    rng = np.random.default_rng(L)
    xs = rng.standard_normal((L, ROWS, 1, D)).astype(np.float32)
    params = jax_mha.init(jax.random.PRNGKey(L), jnp.asarray(xs[0]),
                          jnp.asarray(xs[0]), jnp.asarray(xs[0]))
    params = _perturbed({"params": jax.device_get(params["params"])}, rng)
    port = MultiHeadAttention(D, H, D_HEAD, D_HEAD, dropout=0.0, use_kernels=True)
    port.load_state_dict(state_dict_from_jax(params["params"]))
    kc = vc = jnp.zeros((ROWS, L, H * D_HEAD))
    pk, pv = (torch.zeros((ROWS, L, H * D_HEAD)) for _ in range(2))
    step_fn = jax.jit(lambda p, x, k, v, s: jax_mha.apply(p, x, k, v, s,
                                                          method=jax_mha.decode_step))
    for step in range(L):
        want, kc, vc = step_fn(params, jnp.asarray(xs[step]), kc, vc, step)
        with torch.inference_mode():
            got, pk, pv = port.decode_step(torch.from_numpy(xs[step]), pk, pv, step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(pk.numpy(), np.asarray(kc), atol=1e-5)
        np.testing.assert_allclose(pv.numpy(), np.asarray(vc), atol=1e-5)
    assert cached_attention_step.launches == 0


class _FakeLibrary:
    """Stands in for the kernel library: records each entry point's
    arguments and reports a clean launch."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so the wrapper takes
    its card branch and the kernel's checks see real strides, dtypes and
    addresses."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _refused(match, q, k_new, v_new, kc, vc, step, n_head):
    kc_before, vc_before = kc.clone(), vc.clone()
    with pytest.raises(ValueError, match=match):
        cached_attention_step(q, k_new, v_new, kc, vc, step, n_head)
    assert torch.equal(kc, kc_before) and torch.equal(vc, vc_before)


def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Shapes and steps are refused on any device; the kernel's own limits
    (contiguity, head widths, dtypes) on the card branch, before a launch."""
    lib = _FakeLibrary()
    monkeypatch.setattr(attention._build, "library", lambda: lib)
    monkeypatch.setattr(attention, "_stream", lambda device: 0)
    g = torch.Generator().manual_seed(3)
    N, L, H = 4, 9, 2
    hd = H * D_HEAD
    cpu = _operands(g, N, L, hd, torch.bfloat16)
    q, k_new, v_new, kc, vc = (t.as_subclass(_OnCard) for t in cpu)
    # non-contiguous caches, and a non-contiguous q
    strided = kc.transpose(1, 2).contiguous().transpose(1, 2)
    _refused("contiguous", q, k_new, v_new, strided, vc, 3, H)
    _refused("contiguous", q, k_new, v_new, kc, strided, 3, H)
    _refused("contiguous", q.t().contiguous().t(), k_new, v_new, kc, vc, 3, H)
    # head widths the kernel is not built for
    _refused("head dim", q, k_new, v_new, kc, vc, 3, 16)    # d = 8
    # mixed and other dtypes
    _refused("dtypes", q.float(), k_new, v_new, kc, vc, 3, H)
    _refused("dtypes", q, k_new, v_new, kc.float(), vc, 3, H)
    half = [t.half() for t in (q, k_new, v_new, kc, vc)]
    _refused("dtypes", *half, 3, H)
    assert lib.calls == []
    for q, k_new, v_new, kc, vc in ((q, k_new, v_new, kc, vc), cpu):
        # a step outside the caches
        _refused("outside", q, k_new, v_new, kc, vc, L, H)
        _refused("outside", q, k_new, v_new, kc, vc, -1, H)
        # heads that do not split the width
        _refused("does not split", q, k_new, v_new, kc, vc, 3, 3)     # 128 / 3
        # shapes that do not match
        _refused(r"q/k_new/v_new", q[:-1], k_new[:-1], v_new[:-1], kc, vc, 3, H)
        _refused("caches", q, k_new, v_new, kc, vc[:, :-1], 3, H)
    assert lib.calls == []
    assert cached_attention_step.launches == 0


def test_the_cpu_takes_what_only_the_kernel_refuses():
    """CPU tensors the kernel would refuse (a head width outside HEAD_DIMS,
    non-contiguous caches) take the plain version, as K1's and K12's do, so
    ``decode_step`` chooses by ``use_kernels`` alone."""
    g = torch.Generator().manual_seed(4)
    N, L, H, d = 3, 6, 4, 8
    q, k_new, v_new, kc, vc = _operands(g, N, L, H * d, torch.float32)
    strided = kc.transpose(1, 2).contiguous().transpose(1, 2)
    kc2, vc2 = kc.clone(), vc.clone()
    for step in range(L):
        got = cached_attention_step(q, k_new, v_new, strided, vc, step, H)
        want = cached_attention_step_plain(q, k_new, v_new, kc2, vc2, step, H)
        assert torch.equal(got, want)
        assert torch.equal(strided, kc2) and torch.equal(vc, vc2)
    assert cached_attention_step.launches == 0 and cached_attention_step.slots == 0


@pytest.mark.parametrize("L,H", SHAPES)
def test_the_wrapper_launches_and_counts_on_the_card_branch(monkeypatch, L, H):
    """Meta tensors through the wrapper's card branch: one launch of
    ``sbl_cached_attention_step`` with the shapes, step, scale and dtype
    code, counted once, with N x (step + 1) slots; KERNELS' counts move
    not."""
    lib, checked = _FakeLibrary(), []
    monkeypatch.setattr(attention._build, "library", lambda: lib)
    monkeypatch.setattr(attention, "_stream", lambda device: 0)
    monkeypatch.setattr(attention, "_check_cuda",
                        lambda name, tensors, bias, d: checked.append((name, d, len(tensors))))
    ops.reset_launch_counts()
    N = 2560
    kc, vc = (torch.empty((N, L, H * D_HEAD), device="meta", dtype=torch.bfloat16)
              for _ in range(2))
    q = torch.empty((N, H * D_HEAD), device="meta", dtype=torch.bfloat16)
    for step in (0, L - 1):
        out = cached_attention_step(q, q, q, kc, vc, step, H)
        assert out.shape == q.shape and out.dtype == q.dtype
        name, args = lib.calls[-1]
        assert name == "sbl_cached_attention_step"
        assert args[6:11] == (N, L, H, D_HEAD, step)
        assert args[11] == pytest.approx(1.0 / math.sqrt(D_HEAD)) and args[12] == 1
    assert checked == [("cached_attention_step", D_HEAD, 5)] * 2
    assert cached_attention_step.launches == 2
    assert cached_attention_step.slots == N * (1 + L)
    assert not any(ops.launch_counts().values())


def test_kernels_leave_k13_out():
    """K13 keeps its counts outside ``ops.KERNELS``, so the launch counts
    the benchmark's path check sums do not name it."""
    assert cached_attention_step not in ops.KERNELS
    assert len(ops.KERNELS) == 17
    assert "cached_attention_step" not in ops.launch_counts()
