"""CPU parity of the PyTorch port's ops against the JAX package.

Inputs come from a numpy seed and go through both sides in f32 (K1 in bf16
as well).  The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU.  On the CPU the port's kernel wrappers take their plain
PyTorch versions (the CUDA kernels are held against those on the card by
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu.data.pipeline import (
    device_ingest as jax_device_ingest)
from sbl_for_multilingual_lip_reading_tpu.models import decoder_sbl as jax_dec
from sbl_for_multilingual_lip_reading_tpu.models.layers import (
    sinusoid_position_encoding as jax_pe)
from sbl_for_multilingual_lip_reading_tpu.ops import attention as jax_attn
from sbl_for_multilingual_lip_reading_tpu.ops import masks as jax_masks
from sbl_for_multilingual_lip_reading_tpu.ops.stem import (
    stack_frames as jax_stack_frames)
from sbl_for_multilingual_lip_reading_tpu.vocab import IGNORE_ID
from sbl_for_multilingual_lip_reading_tpu_torch import ops
from sbl_for_multilingual_lip_reading_tpu_torch.data import device_ingest
from sbl_for_multilingual_lip_reading_tpu_torch.models import decoder_sbl
from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import (
    sinusoid_position_encoding)
from sbl_for_multilingual_lip_reading_tpu_torch.ops import masks

# f32 attention on both sides; only the summation order differs
ATTN_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bias(kind, B, Tq, Tk, rng):
    if kind is None:
        return None
    if kind == "causal":                       # batch 1, like the decoder
        m = np.triu(np.ones((Tq, Tk), bool), k=1)[None]
    elif kind == "key_pad":                    # batch B, like lengths masks
        lengths = rng.integers(1, Tk + 1, size=B)
        m = np.broadcast_to(np.arange(Tk)[None, None, :]
                            >= lengths[:, None, None], (B, Tq, Tk))
    elif kind == "masked_row":                 # row 0 masked everywhere
        m = np.zeros((1, Tq, Tk), bool)
        m[0, 0] = True
    else:
        raise ValueError(kind)
    return np.where(m, -1e9, 0.0).astype(np.float32)


@pytest.mark.parametrize("B,Tq,Tk,H,d,kind", [
    (4, 7, 7, 4, 16, None),
    (4, 7, 7, 4, 16, "causal"),
    (4, 7, 7, 4, 16, "key_pad"),
    (3, 5, 9, 2, 64, None),
    (3, 5, 9, 2, 64, "key_pad"),
    (2, 6, 6, 2, 32, "masked_row"),
    # the widest head the kernel is built for, and keys beyond two of its
    # 32-key tiles (the online softmax across tiles)
    (2, 5, 9, 2, 128, None),
    (2, 5, 9, 2, 128, "causal"),
    (2, 17, 70, 2, 64, "key_pad"),
    (2, 3, 150, 2, 16, None),
])
def test_small_mha_flat_matches_pallas(B, Tq, Tk, H, d, kind):
    rng = np.random.default_rng(B * 100 + Tq * 10 + Tk)
    q = rng.standard_normal((B, Tq, H * d)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H * d)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H * d)).astype(np.float32)
    bias = _bias(kind, B, Tq, Tk, rng)
    scale = 1.0 / np.sqrt(d)
    want = jax_attn.fused_small_mha_flat(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
        bias=None if bias is None else jnp.asarray(bias), scale=scale,
        interpret=True)
    before = ops.small_mha_flat.launches
    got = ops.small_mha_flat(_t(q), _t(k), _t(v), H,
                             bias=None if bias is None else _t(bias),
                             scale=scale)
    assert ops.small_mha_flat.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_TOL)
    if kind == "masked_row":
        # a fully masked row attends uniformly: the mean of V, not NaN
        np.testing.assert_allclose(got.numpy()[0, 0], v[0].mean(0),
                                   rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("kind", [None, "causal", "key_pad"])
def test_small_mha_flat_bf16_matches_pallas(kind):
    """bf16 operands: both sides upcast to f32 and round the output once, so
    they agree but for rare one-ulp flips where exp or a sum is computed in
    another order (at this seed: at most 1.2e-4 of the elements, by at most
    2^-10)."""
    B, Tq, Tk, H, d = 8, 17, 30, 8, 64   # cross-attention's shape at full width
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((B, T, H * d)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    bias = _bias(kind, B, Tq, Tk, rng)
    want = jax_attn.fused_small_mha_flat(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), H,
        bias=None if bias is None else jnp.asarray(bias), interpret=True)
    got = ops.small_mha_flat(*(_t(x).bfloat16() for x in (q, k, v)), H,
                             bias=None if bias is None else _t(bias))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    # one bf16 ulp at |out| < 4 is 2^-6
    assert diff.max() <= 2.0 ** -6
    assert (diff > 0).mean() <= 0.001


def test_small_mha_flat_default_scale_and_dtype():
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.standard_normal((2, 4, 32)).astype(np.float32))
               for _ in range(3))
    a = ops.small_mha_flat(q, k, v, 2)
    b = ops.small_mha_flat_plain(q, k, v, 2, scale=1.0 / 4.0)
    assert torch.equal(a, b)
    assert ops.small_mha_flat(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                              2).dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["n_head", "bias_shape", "kv_shape"])
def test_small_mha_flat_rejects_bad_input(bad):
    q = torch.zeros(2, 3, 8)
    k = v = torch.zeros(2, 4, 8)
    kwargs = {"n_head": 2}
    if bad == "n_head":
        kwargs["n_head"] = 3
    elif bad == "bias_shape":
        kwargs["bias"] = torch.zeros(2, 4, 3)
    else:
        k = torch.zeros(2, 4, 6)
    with pytest.raises(ValueError):
        ops.small_mha_flat(q, k, v, **kwargs)


def test_mask_to_bias_matches_jax():
    rng = np.random.default_rng(1)
    mask = rng.random((3, 1, 6)) < 0.4
    want = jax_attn.mask_to_bias(jnp.asarray(np.broadcast_to(mask, (3, 5, 6))))
    got = ops.mask_to_bias(_t(mask), 5, 6)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, 0])


@pytest.mark.parametrize("kt", [5, 3])
def test_stack_frames_matches_pallas(kt):
    rng = np.random.default_rng(kt)
    video = rng.standard_normal((3, 6, 16, 16)).astype(np.float32)
    want = jax_stack_frames(jnp.asarray(video), kt=kt, interpret=True)
    before = ops.stack_frames.launches
    got = ops.stack_frames(_t(video), kt)
    assert ops.stack_frames.launches == before
    assert got.shape == (3, 6, kt, 16, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stack_frames_plain_is_a_pure_copy():
    video = torch.arange(2 * 4 * 3 * 5, dtype=torch.int32).reshape(2, 4, 3, 5)
    out = ops.stack_frames_plain(video, 5)
    for t in range(4):
        for k in range(5):
            src = t + k - 2
            want = video[:, src] if 0 <= src < 4 else torch.zeros_like(video[:, 0])
            assert torch.equal(out[:, t, k], want)


def test_masks_match_jax():
    lengths = np.array([3, 6, 1], np.int32)
    np.testing.assert_array_equal(masks.causal_mask(5).numpy(),
                                  np.asarray(jax_masks.causal_mask(5)))
    np.testing.assert_array_equal(
        masks.key_pad_mask_from_lengths(_t(lengths), 6).numpy(),
        np.asarray(jax_masks.key_pad_mask_from_lengths(jnp.asarray(lengths), 6)))
    np.testing.assert_array_equal(
        masks.non_pad_mask_from_lengths(_t(lengths), 6).numpy(),
        np.asarray(jax_masks.non_pad_mask_from_lengths(jnp.asarray(lengths), 6)))


@pytest.mark.parametrize("with_n_frames", [False, True])
def test_device_ingest_matches_jax(with_n_frames):
    rng = np.random.default_rng(2)
    B, T, raw, crop = 3, 7, 40, 32
    clips = rng.integers(0, 256, size=(B, T, raw, raw), dtype=np.uint8)
    n_frames = np.array([7, 4, 1], np.int32) if with_n_frames else None
    want = jax_device_ingest(
        jnp.asarray(clips), None, None, None, crop, jnp.float32,
        n_frames=None if n_frames is None else jnp.asarray(n_frames))
    got = device_ingest(_t(clips), crop, torch.float32,
                        n_frames=None if n_frames is None else _t(n_frames))
    assert got.shape == (B, T, crop, crop)
    # the same f32 ops in the same order: at most an ulp apart
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if with_n_frames:
        assert not got[1, 4:].any() and not got[2, 1:].any()


def test_sinusoid_position_encoding_matches_jax():
    np.testing.assert_array_equal(sinusoid_position_encoding(40, 16).numpy(),
                                  jax_pe(40, 16))


@pytest.mark.parametrize("mode", ["symmetric", "reference_aliased"])
def test_fuse_dual_matches_jax(mode):
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 3, 7, 4)).astype(np.float32)
    for step in range(7):
        want = jax_dec._fuse_dual(jnp.asarray(h), jnp.asarray(step), mode)
        got = decoder_sbl._fuse_dual(_t(h), decoder_sbl._rev_index(7, step),
                                     mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_preprocess_targets_matches_jax():
    labels = np.array([[3, 4, IGNORE_ID, IGNORE_ID], [5, 6, 7, 8]], np.int32)
    for maxlen in (3, 6):
        want = jax_dec.preprocess_targets(jnp.asarray(labels), maxlen)
        got = decoder_sbl.preprocess_targets(_t(labels), maxlen)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("maxlen,segments", [(16, 8), (16, 4), (8, 4), (7, 3),
                                             (16, 1), (5, 9)])
def test_segments_match_jax(maxlen, segments):
    kw = dict(maxlen=maxlen, decode_segments=segments)
    jax_segments = jax_dec.SBLDecoder(**kw)._segments()
    port = decoder_sbl.SBLDecoder(d_model=8, n_layers=1, n_head=1, d_k=8,
                                  d_v=8, d_inner=8, pe_maxlen=20, **kw)
    assert port._segments() == jax_segments
    # every decode step runs exactly once, on a buffer wide enough for it
    steps = [s for a, b in port._segments() for s in range(a, b)]
    assert steps == list(range(maxlen))
