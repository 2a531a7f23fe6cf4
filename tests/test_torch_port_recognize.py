"""CPU parity of the PyTorch port's recognize slice against the JAX package.

The JAX variables of ``config.tiny_test("sbl")`` are built once per module,
moved off their initial values (biases, LayerNorm/BatchNorm scales and BN
running statistics, so that no layer sees an identity or a zero), carried
into the port with ``state_dict_from_jax``, and both sides run on the same
numpy-seeded clips.  The port takes its kernels' plain versions (CPU
tensors).

f32: the JAX model takes its XLA path (its Pallas kernels run only on a TPU).

bf16 (``config.sbl()``'s compute dtype): the JAX model runs its Pallas
attention and frame stack in interpret mode, the path it takes on the TPU,
and XLA is held to the roundings the program states
(``xla_allow_excess_precision`` off; by default XLA's CPU backend keeps f32
values it was told to round to bf16).  Both sides then round in the same
places, and the remaining differences are one-ulp flips where a sum or an
exp is computed in another order.  The tolerances below are set from the
readings recorded in PERF.md (PR 1).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sbl_for_multilingual_lip_reading_tpu import config as C
from sbl_for_multilingual_lip_reading_tpu.data.pipeline import (
    device_ingest as jax_device_ingest)
from sbl_for_multilingual_lip_reading_tpu.models import (
    build_model as build_jax_model)
from sbl_for_multilingual_lip_reading_tpu.models.encoder import (
    Encoder as JaxEncoder)
from sbl_for_multilingual_lip_reading_tpu.ops import attention as jax_attention
from sbl_for_multilingual_lip_reading_tpu.ops import stem as jax_stem
from sbl_for_multilingual_lip_reading_tpu_torch.data import device_ingest
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.models.encoder import Encoder
from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
    recognize_batch)
from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
    state_dict_from_jax)

# f32 on both sides; the convs and matmuls sum in another order
FEATURE_TOL = 1e-4
LOGIT_TOL = 1e-4
# bf16.  One ulp is 2^-6 for |x| in [2, 4) and 2^-5 in [4, 8); the encoder
# output stays below 4, the logits below 8.
BF16_ENCODER_TOL = 2.0 ** -6         # one ulp
BF16_ENCODER_MAX_DIFFERING = 0.005   # share of elements that may flip
BF16_DECODER_TOL = 2.0 ** -4         # two ulps
BF16_DECODER_MAX_DIFFERING = 0.15
BF16_FEATURE_TOL = 2.0 ** -5         # stem-conv flips carried through the trunk
BF16_FEATURE_MAX_DIFFERING = 0.02
BF16_FIRST_LOGIT_TOL = 2.0 ** -4     # end to end, the flips add up
BF16_MIN_TOKEN_AGREEMENT = 0.95
FUSION_MODES = ("symmetric", "reference_aliased")


def _perturbed(variables, rng):
    """Biases and LN/BN scales +N(0, 0.1), BN means +-0.2, variances x[0.5, 1.5]."""
    def move(path, a):
        if path[-1] in ("bias", "scale"):
            a = a + 0.1 * rng.standard_normal(a.shape)
        elif path[-1] == "mean":
            a = a + rng.uniform(-0.2, 0.2, a.shape)
        elif path[-1] == "var":
            a = a * rng.uniform(0.5, 1.5, a.shape)
        return a.astype(np.float32)
    return {col: traverse_util.unflatten_dict(
        {k: move(k, a) for k, a in traverse_util.flatten_dict(tree).items()})
        for col, tree in variables.items()}


@pytest.fixture(scope="module")
def tiny():
    cfg = C.tiny_test("sbl")
    model = build_jax_model(cfg)
    T, raw, crop = cfg.data.frames, cfg.data.raw_size, cfg.data.crop_size
    key = jax.random.PRNGKey(0)
    labels = jnp.zeros((2, cfg.decoder.target_pad_len), jnp.int32)
    variables = jax.device_get(jax.jit(lambda: model.init(
        {"params": key, "dropout": key, "teacher": key},
        jnp.zeros((2, T, crop, crop)), labels, labels, train=False))())
    rng = np.random.default_rng(0)
    variables = _perturbed(variables, rng)
    clips = rng.integers(0, 256, size=(3, T, raw, raw), dtype=np.uint8)
    video = jax_device_ingest(jnp.asarray(clips), None, None, None, crop,
                              jnp.float32)
    return dict(cfg=cfg, model=model, variables=variables, clips=clips,
                video=video)


def _port(cfg, variables):
    model = build_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    return model


def test_frontend_features_match_jax(tiny):
    model = tiny["model"]
    want = jax.jit(lambda v, x: model.apply(
        v, x[..., None], method=lambda m, x: m.frontend(x, train=False)))(
            tiny["variables"], tiny["video"])
    port = _port(tiny["cfg"], tiny["variables"])
    with torch.inference_mode():
        got = port.frontend(torch.from_numpy(np.array(tiny["video"])))
    assert got.shape == want.shape
    # the features tell the clips apart: the trunk is not saturated
    assert np.asarray(want).std(axis=0).mean() > 0.05
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FEATURE_TOL)


def test_encoder_output_matches_jax(tiny):
    model = tiny["model"]
    want = jax.jit(lambda v, x: model.apply(v, x, method=model.encode))(
        tiny["variables"], tiny["video"])
    port = _port(tiny["cfg"], tiny["variables"])
    with torch.inference_mode():
        got = port.encode(torch.from_numpy(np.array(tiny["video"])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FEATURE_TOL)


@pytest.mark.parametrize("fusion_mode,segments", [
    ("symmetric", 1), ("reference_aliased", 1), ("symmetric", 4)])
def test_recognize_matches_jax(tiny, fusion_mode, segments):
    cfg = tiny["cfg"]
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, fusion_mode=fusion_mode, decode_segments=segments))
    model = build_jax_model(cfg)
    labels = jnp.zeros((3, cfg.decoder.target_pad_len), jnp.int32)
    # the deterministic forward decodes greedily (no teacher forcing), so
    # its logits are the recognize path's per-step logits
    lg_l2r, _, lg_r2l, _ = jax.jit(lambda v, x: model.apply(
        v, x, labels, labels, train=False))(tiny["variables"], tiny["video"])
    ys_l2r, ys_r2l = jax.jit(lambda v, x: model.apply(
        v, x, method=model.recognize))(tiny["variables"], tiny["video"])

    port = _port(cfg, tiny["variables"])
    got = recognize_batch(port, torch.from_numpy(tiny["clips"]),
                          cfg.data.crop_size)
    maxlen, V = cfg.decoder.maxlen, cfg.decoder.vocab_size
    assert got.ys_l2r.shape == (3, maxlen + 1)
    assert got.logits_l2r.shape == (3, maxlen, V)
    np.testing.assert_array_equal(got.ys_l2r.numpy(), np.asarray(ys_l2r))
    np.testing.assert_array_equal(got.ys_r2l.numpy(), np.asarray(ys_r2l))
    np.testing.assert_allclose(got.logits_l2r.numpy(), np.asarray(lg_l2r),
                               rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got.logits_r2l.numpy(), np.asarray(lg_r2l),
                               rtol=0, atol=LOGIT_TOL)


def test_encoder_lengths_mask_matches_jax():
    dims = dict(d_input=24, n_layers=2, n_head=2, d_k=8, d_v=8, d_model=16,
                d_inner=32, pe_maxlen=50)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 6, 24)).astype(np.float32)
    lengths = np.array([6, 3, 1], np.int32)
    jax_enc = JaxEncoder(dropout=0.0, **dims)
    params = jax.device_get(jax_enc.init(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(lengths)))
    want = jax_enc.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    port = Encoder(**dims)
    port.load_state_dict(state_dict_from_jax(params["params"]))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FEATURE_TOL)
    assert not got[1, 3:].any() and not got[2, 1:].any()


def _assert_mapping_complete(cfg, variables):
    params = traverse_util.flatten_dict(variables["params"])
    stats = traverse_util.flatten_dict(variables["batch_stats"])
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    want = {k: tuple(v.shape) for k, v in build_model(cfg, "cpu").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    assert len(got) == len(params) + len(stats)
    assert sorted(got) == sorted(want), (
        sorted(set(want) ^ set(got))[:10])
    assert got == want


def test_state_dict_mapping_complete_tiny(tiny):
    variables = tiny["variables"]
    assert len(traverse_util.flatten_dict(variables["params"])) == 126
    assert len(traverse_util.flatten_dict(variables["batch_stats"])) == 24
    _assert_mapping_complete(tiny["cfg"], variables)


def test_bf16_recognize_runs_on_cpu(tiny):
    cfg = dataclasses.replace(tiny["cfg"], compute_dtype="bfloat16")
    port = _port(cfg, tiny["variables"])
    got = recognize_batch(port, torch.from_numpy(tiny["clips"]),
                          cfg.data.crop_size)
    V = cfg.decoder.vocab_size
    assert got.ys_l2r.shape == (3, cfg.decoder.maxlen + 1)
    for ys in (got.ys_l2r, got.ys_r2l):
        assert int(ys.min()) >= 0 and int(ys.max()) < V
    assert torch.isfinite(got.logits_l2r).all()
    assert torch.isfinite(got.logits_r2l).all()


def _jit_exact(fn, *args):
    """Compile ``fn`` with XLA held to the program's own roundings; run it."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(a):
    return torch.from_numpy(np.array(_f32(a))).to(torch.bfloat16)


def _assert_close_bf16(got, want, tol, max_differing):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= tol, f"max abs diff {diff.max()} > {tol}"
    differing = float((diff > 0).mean())
    assert differing <= max_differing, (
        f"{differing:.4f} of the elements differ (> {max_differing})")


@pytest.fixture(scope="module")
def tiny_bf16(tiny):
    """The JAX bf16 reference on its TPU kernel path: the frontend features,
    the encoder output from those features and, per fusion mode, the greedy
    decode (tokens and per-step logits) from that encoder output."""
    cfg = dataclasses.replace(tiny["cfg"], compute_dtype="bfloat16")
    variables = tiny["variables"]
    B = tiny["clips"].shape[0]
    labels = jnp.zeros((B, cfg.decoder.target_pad_len), jnp.int32)
    video = jax_device_ingest(jnp.asarray(tiny["clips"]), None, None, None,
                              cfg.data.crop_size, jnp.bfloat16)
    out = {"cfg": cfg}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_attention, "available", lambda: True)
        mp.setattr(jax_attention, "fused_small_mha_flat", functools.partial(
            jax_attention.fused_small_mha_flat, interpret=True))
        mp.setattr(jax_stem, "stack_frames", functools.partial(
            jax_stem.stack_frames, interpret=True))
        model = build_jax_model(cfg)
        out["feats"] = _jit_exact(lambda v, x: model.apply(
            v, x[..., None], method=lambda m, x: m.frontend(x, train=False)),
            variables, video)
        out["enc"] = _jit_exact(lambda v, f: model.apply(
            v, f, method=lambda m, f: m.encoder(f)), variables, out["feats"])
        for mode in FUSION_MODES:
            model = build_jax_model(dataclasses.replace(
                cfg, decoder=dataclasses.replace(cfg.decoder, fusion_mode=mode)))
            # the deterministic forward decodes greedily, as recognize does
            lg_l2r, _, lg_r2l, _ = _jit_exact(lambda v, e: model.apply(
                v, e, method=lambda m, e: m.decoder(labels, labels, e,
                                                    deterministic=True)),
                variables, out["enc"])
            ys_l2r, ys_r2l = _jit_exact(lambda v, e: model.apply(
                v, e, method=lambda m, e: m.decoder.recognize(e)),
                variables, out["enc"])
            out[mode] = dict(ys=(ys_l2r, ys_r2l), logits=(lg_l2r, lg_r2l))
    return out


def _port_bf16(tiny_bf16, variables, fusion_mode="symmetric"):
    cfg = tiny_bf16["cfg"]
    return _port(dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, fusion_mode=fusion_mode)), variables)


def test_bf16_frontend_matches_jax(tiny, tiny_bf16):
    port = _port_bf16(tiny_bf16, tiny["variables"])
    with torch.inference_mode():
        video = device_ingest(torch.from_numpy(tiny["clips"]),
                              tiny_bf16["cfg"].data.crop_size, torch.bfloat16)
        got = port.frontend(video)
    _assert_close_bf16(got, tiny_bf16["feats"], BF16_FEATURE_TOL,
                       BF16_FEATURE_MAX_DIFFERING)


def test_bf16_encoder_matches_jax(tiny, tiny_bf16):
    port = _port_bf16(tiny_bf16, tiny["variables"])
    with torch.inference_mode():
        got = port.encoder(_bf16(tiny_bf16["feats"]))
    assert got.dtype == torch.bfloat16
    _assert_close_bf16(got, tiny_bf16["enc"], BF16_ENCODER_TOL,
                       BF16_ENCODER_MAX_DIFFERING)


@pytest.mark.parametrize("fusion_mode", FUSION_MODES)
def test_bf16_decoder_matches_jax(tiny, tiny_bf16, fusion_mode):
    ref = tiny_bf16[fusion_mode]
    port = _port_bf16(tiny_bf16, tiny["variables"], fusion_mode)
    with torch.inference_mode():
        got = port.decoder.decode(_bf16(tiny_bf16["enc"]))
    for ys, want in zip(got[:2], ref["ys"]):
        np.testing.assert_array_equal(ys.numpy(), np.asarray(want))
    for lg, want in zip(got[2:], ref["logits"]):
        _assert_close_bf16(lg, want, BF16_DECODER_TOL,
                           BF16_DECODER_MAX_DIFFERING)


@pytest.mark.parametrize("fusion_mode", FUSION_MODES)
def test_bf16_recognize_matches_jax(tiny, tiny_bf16, fusion_mode):
    ref = tiny_bf16[fusion_mode]
    port = _port_bf16(tiny_bf16, tiny["variables"], fusion_mode)
    got = recognize_batch(port, torch.from_numpy(tiny["clips"]),
                          tiny_bf16["cfg"].data.crop_size)
    agree = np.mean([got.ys_l2r.numpy() == np.asarray(ref["ys"][0]),
                     got.ys_r2l.numpy() == np.asarray(ref["ys"][1])])
    assert agree >= BF16_MIN_TOKEN_AGREEMENT, agree
    for lg, want in zip((got.logits_l2r, got.logits_r2l), ref["logits"]):
        first = np.abs(_f32(lg[:, 0]) - _f32(want[:, 0])).max()
        assert first <= BF16_FIRST_LOGIT_TOL, first
