"""CPU parity of the port's attention layout twins and K12 against the JAX
package's Pallas kernels in interpret mode.

The JAX package kept, beside the flat (B, T, H*d) kernels the models call,
the (B, T, H, d) twins ``fused_small_mha``, ``small_mha_grad`` (with its
Pallas backward ``_small_mha_bwd``), ``fused_small_mha_dropout_fwd`` /
``_bwd``, ``small_mha_dropout_grad`` and ``dropout_keep_mask``, and the
head-major (B, H, T, d) ``fused_mha``.  The port launches the flat kernels
on views for the twins and K12 for ``fused_mha``; here their plain versions
(what the wrappers take on CPU tensors) meet JAX at the shapes of
``tests/test_pallas_attention.py``, with that file's f32 tolerances: 1e-5
forward, 1e-4 gradients.  JAX's dropout kernels draw the TPU's PRNG, which
runs nowhere else, so the dropout twins are held against the port's flat
plain versions on the same views and mask, bit for bit.  The wrappers'
launch glue (flat shapes, rate-0 backward, K12's bias strides, counts of
their own) is checked with a stand-in for the kernel library.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu.ops import attention as jax_attention
from sbl_for_multilingual_lip_reading_tpu_torch import ops
from sbl_for_multilingual_lip_reading_tpu_torch.ops import attention

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
TWINS = ("fused_small_mha", "small_mha_bwd", "small_mha_dropout_fwd",
         "small_mha_dropout_bwd", "dropout_keep_mask", "fused_mha")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _causal(T):
    return np.where(np.triu(np.ones((T, T), bool), 1), -1e9, 0.0).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_fused_small_mha_matches_jax():
    rng = np.random.default_rng(3)
    B, Tq, Tk, H, d = 4, 17, 30, 8, 16
    qh, kh, vh = _normal(rng, B, Tq, H, d), _normal(rng, B, Tk, H, d), \
        _normal(rng, B, Tk, H, d)
    want = jax_attention.fused_small_mha(*map(jnp.asarray, (qh, kh, vh)),
                                         interpret=True)
    got = ops.fused_small_mha(*_t(qh, kh, vh))
    assert got.shape == (B, Tq, H, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("per_batch", [False, True], ids=["broadcast", "per-batch"])
def test_fused_small_mha_bias_matches_jax(per_batch):
    rng = np.random.default_rng(4)
    B, T, H, d = 4, 9, 4, 16
    qh, kh, vh = (_normal(rng, B, T, H, d) for _ in range(3))
    bias = _causal(T)[None]
    if per_batch:
        bias = np.tile(bias, (B, 1, 1))
    want = jax_attention.fused_small_mha(*map(jnp.asarray, (qh, kh, vh, bias)),
                                         interpret=True)
    got = ops.fused_small_mha(*_t(qh, kh, vh, bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("with_bias", [True, False], ids=["causal", "no-bias"])
def test_small_mha_gradients_match_jax(with_bias):
    """``small_mha`` (forward ``fused_small_mha``, backward ``small_mha_bwd``)
    against JAX's ``small_mha_grad``, whose backward is the Pallas
    ``_small_mha_bwd``: the gradients of sum(out**2)."""
    rng = np.random.default_rng(5)
    B, T, H, d = 4, 9, 4, 16
    qh, kh, vh = (_normal(rng, B, T, H, d) for _ in range(3))
    bias = _causal(T)[None] if with_bias else None
    scale = 1.0 / np.sqrt(d)
    jb = None if bias is None else jnp.asarray(bias)
    want = jax.grad(lambda q, k, v: jnp.sum(
        jax_attention.small_mha_grad(q, k, v, jb, scale) ** 2),
        argnums=(0, 1, 2))(*map(jnp.asarray, (qh, kh, vh)))
    q, k, v = (t.requires_grad_(True) for t in _t(qh, kh, vh))
    tb = None if bias is None else torch.from_numpy(bias)
    (ops.small_mha(q, k, v, tb, scale) ** 2).sum().backward()
    for got, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=GRAD_ATOL)
    # the backward wrapper alone: the same formulas, K4's at rate 0
    q2, k2, v2 = _t(qh, kh, vh)
    out = ops.fused_small_mha(q2, k2, v2, tb, scale)
    grads = ops.small_mha_bwd(q2, k2, v2, tb, scale, 2 * out)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=GRAD_ATOL)


@pytest.mark.parametrize("bias_kind", ["none", "head-broadcast", "per-head"])
def test_fused_mha_matches_jax(bias_kind):
    rng = np.random.default_rng(1)
    B, H, T, d = 2, 4, 8, 16
    q, k, v = (_normal(rng, B, H, T, d) for _ in range(3))
    bias = None
    if bias_kind == "head-broadcast":
        bias = np.tile(_causal(T)[None, None], (B, 1, 1, 1))
    elif bias_kind == "per-head":
        # a causal mask plus a different random offset in every head
        bias = _causal(T)[None, None] + _normal(rng, B, H, T, T)
    jb = None if bias is None else jnp.asarray(bias)
    with jax.default_matmul_precision("highest"):
        want = jax_attention.fused_mha(*map(jnp.asarray, (q, k, v)), bias=jb,
                                       interpret=True)
    got = ops.fused_mha(*_t(q, k, v), bias=None if bias is None else
                        torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)
    if bias_kind == "head-broadcast":
        # causality: row 0 attends key 0 only
        np.testing.assert_allclose(got[:, :, 0].numpy(), v[:, :, 0], atol=FWD_ATOL)


@pytest.mark.parametrize("d", [16, 128])
def test_fused_mha_head_widths_match_jax(d):
    """K12's plain version against JAX's ``fused_mha`` at the narrowest and
    the widest head the kernel is built for, with a per-head bias and
    cross-attention lengths."""
    rng = np.random.default_rng(d)
    B, H, Tq, Tk = 2, 2, 5, 9
    q, k, v = (_normal(rng, B, H, T, d) for T in (Tq, Tk, Tk))
    bias = _normal(rng, B, H, Tq, Tk)
    with jax.default_matmul_precision("highest"):
        want = jax_attention.fused_mha(*map(jnp.asarray, (q, k, v)),
                                       bias=jnp.asarray(bias), interpret=True)
    got = ops.fused_mha(*_t(q, k, v, bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


def test_fused_mha_cross_attention_lengths_match_jax():
    rng = np.random.default_rng(2)
    q, k, v = _normal(rng, 1, 2, 5, 16), _normal(rng, 1, 2, 9, 16), \
        _normal(rng, 1, 2, 9, 16)
    want = jax_attention.fused_mha(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = ops.fused_mha(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)
    # the bias holds a batch of B, as JAX's does: a batch of 1 is refused
    qb, kb = _normal(rng, 3, 2, 5, 16), _normal(rng, 3, 2, 9, 16)
    with pytest.raises(ValueError, match="bias must be"):
        ops.fused_mha(*_t(qb, kb, kb, _normal(rng, 1, 2, 5, 9)))


@pytest.mark.parametrize("T,with_bias", [(9, True), (31, False), (32, True)],
                         ids=["T9-causal", "T31", "T32-causal"])
def test_dropout_twins_equal_the_flat_plain_versions(T, with_bias):
    """The dropout twins on (B, T, H, d) give, bit for bit, what the flat
    plain versions give on the (B, T, H*d) views with the same mask; the
    twins' mask is the flat one; the autograd twin's gradients are the
    backward's.  T = 31 is the classify encoder's length, 32 the kernels'
    limit."""
    rng = np.random.default_rng(T)
    B, H, d, rate, seed = 4, 4, 16, 0.3, 77
    qh, kh, vh, g = (_normal(rng, B, T, H, d) for _ in range(4))
    q, k, v, dout = _t(qh, kh, vh, g)
    bias = torch.from_numpy(_causal(T)[None]) if with_bias else None
    keep = ops.dropout_keep_mask(B, T, T, H, seed, rate, "cpu")
    assert torch.equal(keep, ops.dropout_keep_mask_flat(B, T, T, H, seed, rate,
                                                        "cpu"))
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.05
    flat = [x.reshape(B, T, H * d) for x in (q, k, v, dout)]

    out = ops.small_mha_dropout_fwd(q, k, v, bias, seed, None, rate)
    want = ops.small_mha_dropout_flat_plain(*flat[:3], H, bias, seed, rate,
                                            None, keep)
    assert torch.equal(out, want.view(B, T, H, d))
    assert torch.equal(out, ops.small_mha_dropout_fwd_plain(q, k, v, bias, seed,
                                                            None, rate, keep))
    grads = ops.small_mha_dropout_bwd(q, k, v, bias, seed, None, rate, dout)
    wants = ops.small_mha_dropout_bwd_flat_plain(*flat[:3], H, bias, seed, rate,
                                                 None, flat[3], keep)
    for a, b in zip(grads, wants):
        assert torch.equal(a, b.view(B, T, H, d))

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.small_mha_dropout(*leaves, bias, seed, None, rate).backward(dout)
    for leaf, b in zip(leaves, grads):
        assert torch.equal(leaf.grad, b)


def test_twin_wrappers_refuse_a_device_they_do_not_run_on():
    """A tensor off the CPU means the kernel: no twin falls back to its
    plain version."""
    meta = torch.zeros((2, 5, 2, 64), device="meta")
    head_major = torch.zeros((2, 2, 5, 64), device="meta")
    for call in (lambda: ops.fused_small_mha(meta, meta, meta),
                 lambda: ops.small_mha_bwd(meta, meta, meta, None, None, meta),
                 lambda: ops.small_mha_dropout_fwd(meta, meta, meta, None, 1,
                                                   None, 0.1),
                 lambda: ops.small_mha_dropout_bwd(meta, meta, meta, None, 1,
                                                   None, 0.1, meta),
                 lambda: ops.dropout_keep_mask(2, 5, 5, 2, 1, 0.1, "meta"),
                 lambda: ops.fused_mha(head_major, head_major, head_major)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


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


@pytest.fixture
def fake_launch(monkeypatch):
    """Meta tensors through the wrappers' card branch: the device check
    records what it was given (the wrappers' own tensors, not copies) and
    the library records the launches."""
    lib = _FakeLibrary()
    checked = []
    monkeypatch.setattr(attention._build, "library", lambda: lib)
    monkeypatch.setattr(attention, "_stream", lambda device: 0)
    monkeypatch.setattr(attention, "_check_cuda",
                        lambda name, tensors, bias, d, train=False:
                        checked.append((name, tensors, d, train)))
    ops.reset_launch_counts()
    yield lib, checked
    ops.reset_launch_counts()


def test_twins_launch_the_flat_kernels_on_views(fake_launch, monkeypatch):
    lib, checked = fake_launch
    # the kernels read the seed on the card: the wrapper passes the address
    # ``_seed_arg`` gives it (here a stand-in) for the seed it was given
    seeds = []
    monkeypatch.setattr(attention, "_seed_arg", lambda seed, device, drawn=True:
                        seeds.append((seed, drawn)) or 0x5EED0)
    B, Tq, Tk, H, d = 3, 17, 30, 8, 64
    q = torch.zeros((B, Tq, H, d), device="meta")
    kv = torch.zeros((B, Tk, H, d), device="meta")
    out = attention.fused_small_mha(q, kv, kv)
    assert out.shape == (B, Tq, H, d)
    assert checked[0][0] == "fused_small_mha" and checked[0][1][0] is q
    name, args = lib.calls[-1]
    assert name == "sbl_small_mha_flat" and args[5:11] == (B, Tq, Tk, H, d, 0)

    attention.small_mha_bwd(kv, kv, kv, None, None, kv)
    name, args = lib.calls[-1]
    # K4 at rate 0: threshold 0, nothing drawn (on = 0)
    assert name == "sbl_small_mha_dropout_bwd_flat"
    assert args[8:14] == (B, Tk, Tk, H, d, 0) and args[16] == 0 and args[18] == 0
    # checked against the training kernels' shapes (K3/K4's lengths)
    assert checked[-1][3] is True

    attention.small_mha_dropout_fwd(kv, kv, kv, None, 5, None, 0.1)
    name, args = lib.calls[-1]
    assert name == "sbl_small_mha_dropout_fwd_flat"
    assert (args[12], args[13], args[15]) == (0x5EED0, attention.dropout_threshold(0.1), 1)
    assert seeds[-1] == (5, True)
    attention.small_mha_dropout_bwd(kv, kv, kv, None, 5, None, 0.1, kv)
    assert lib.calls[-1][0] == "sbl_small_mha_dropout_bwd_flat"
    counts = ops.launch_counts()
    assert {k: counts[k] for k in TWINS} == dict(
        dict.fromkeys(TWINS, 1), dropout_keep_mask=0, fused_mha=0)
    # the flat kernels' own counts stay for the main paths
    assert counts["small_mha_flat"] == counts["small_mha_dropout_bwd_flat"] == 0


@pytest.mark.parametrize("bias_shape,strides", [
    (None, (0, 0)), ((3, 8, 17, 30), (8 * 17 * 30, 17 * 30)),
    ((3, 1, 17, 30), (17 * 30, 0)), ((1, 8, 17, 30), None)],
    ids=["no-bias", "per-head", "head-broadcast", "batch-broadcast-refused"])
def test_fused_mha_passes_the_bias_strides(fake_launch, bias_shape, strides):
    lib, _ = fake_launch
    q = torch.zeros((3, 8, 17, 64), device="meta")
    kv = torch.zeros((3, 8, 30, 64), device="meta")
    bias = None if bias_shape is None else torch.zeros(bias_shape, device="meta")
    if strides is None:
        with pytest.raises(ValueError, match="bias must be"):
            attention.fused_mha(q, kv, kv, bias)
        assert not lib.calls and ops.launch_counts()["fused_mha"] == 0
        return
    assert attention.fused_mha(q, kv, kv, bias).shape == q.shape
    name, args = lib.calls[-1]
    assert name == "sbl_fused_mha"
    assert args[5:10] == (3, 8, 17, 30, 64) and args[10:12] == strides
    assert ops.launch_counts()["fused_mha"] == 1
