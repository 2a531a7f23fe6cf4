"""CPU parity of the port's three eval-side kernels' plain versions against
the JAX package's Pallas kernels in interpret mode, and of the modules that
switch them on against their module paths.

* K9 ``stack_frames_u8``: uint8 clips -> center crop -> ColorNormalize ->
  5-frame stack.  Both sides normalize as ``x * (1/(255 STD)) - MEAN/STD``;
  XLA's CPU backend may contract that into one FMA, so f32 agrees to one
  ulp (2^-22 for |x| in [2, 4)) and bf16 exactly (readings: 2.4e-7 and 0).
* K10 ``fused_resblock``: the JAX kernel takes NHWC/HWIO, the port
  NCHW/OIHW; same values, transposed on the way in and out of this test
  only.  f32 within 1e-5 of the tensor's largest element (readings
  <= 3.5e-7); bf16 within two bf16 ulps of each element plus 2^-8 of the
  largest for values near zero (both round one f32 result, and a one-ulp
  flip of the intermediate moves the output a fraction of an ulp more;
  reading: identical).
* K11 ``fused_decoder_layer``: f32 within 2e-5, the tolerance of the JAX
  package's own ``tests/test_fused_layer.py`` (readings <= 8.4e-7); bf16
  reading: identical; ``sbl`` recognize with
  ``use_fused_decoder_layer`` against JAX with it: f32 logits within 1e-4,
  tokens identical, both fusion modes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu import config as C
from sbl_for_multilingual_lip_reading_tpu.data.pipeline import (
    device_ingest as jax_device_ingest)
from sbl_for_multilingual_lip_reading_tpu.models import (
    build_model as build_jax_model)
from sbl_for_multilingual_lip_reading_tpu.models.decoder_sbl import (
    _SBLLayer as JaxSBLLayer)
from sbl_for_multilingual_lip_reading_tpu.models.sbl import (
    SBLTransformer as JaxSBLTransformer)
from sbl_for_multilingual_lip_reading_tpu.ops import decoder_layer as jax_layer
from sbl_for_multilingual_lip_reading_tpu.ops import resblock as jax_resblock
from sbl_for_multilingual_lip_reading_tpu.ops import stem as jax_stem
from sbl_for_multilingual_lip_reading_tpu_torch import ops
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.models.decoder_sbl import _SBLLayer
from sbl_for_multilingual_lip_reading_tpu_torch.models.frontend import (
    BasicBlock, ResNetTrunk, VisualFrontend)
from sbl_for_multilingual_lip_reading_tpu_torch.ops import _build
from sbl_for_multilingual_lip_reading_tpu_torch.ops import decoder_layer as port_layer
from sbl_for_multilingual_lip_reading_tpu_torch.ops import masks as M
from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
    expected_launches, fused_resblock_count, recognize_batch)
from sbl_for_multilingual_lip_reading_tpu_torch.utils import state_dict_from_jax

from test_torch_port_recognize import _perturbed

F32_ULP_AT_2 = 2.0 ** -22
RESBLOCK_F32_TOL = 1e-5
RESBLOCK_BF16 = dict(rel=2.0 ** -6, floor=2.0 ** -8)
LAYER_TOL = 2e-5
LOGIT_TOL = 1e-4
# (N, C, S): one shape per class the kernel tiles differently (whole small
# planes; a plane wider than the whole-plane limit), at narrow widths
RESBLOCK_SHAPES = ((4, 16, 10), (8, 8, 7), (2, 8, 22), (3, 32, 3))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------------- K9
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_frames_u8_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(1)
    B, T, raw, crop = 2, 5, 32, 24
    clips = rng.integers(0, 256, size=(B, T, raw, raw), dtype=np.uint8)
    # every uint8 value is in the crop at least once
    clips[0, 0].reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
    clips[0, 0] = np.roll(clips[0, 0], (4, 4), axis=(0, 1))
    want = jax_stem.stack_frames_u8(jnp.asarray(clips), crop,
                                    dtype=jnp.dtype(dtype), kt=5, interpret=True)
    got = ops.stack_frames_u8(torch.from_numpy(clips), crop,
                              getattr(torch, dtype))
    assert got.shape == (B, T, 5, crop, crop) and str(got.dtype) == f"torch.{dtype}"
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert diff <= (F32_ULP_AT_2 if dtype == "float32" else 0.0), diff
    # zero temporal padding, and the middle slot is the frame itself
    assert not got[:, 0, :2].any() and not got[:, -1, 3:].any()
    assert torch.equal(got[:, :, 2], ops.stack_frames_u8(
        torch.from_numpy(clips), crop, getattr(torch, dtype), kt=1)[:, :, 0])


def test_stack_frames_u8_matches_ingest_plus_stack():
    """JAX ``test_stack_frames_u8_matches_ingest_plus_stack``: the fused
    function against ``device_ingest`` then ``stack_frames``, whose
    normalization rounds differently (atol 2e-5 there; within two f32 ulps
    here), on both sides."""
    rng = np.random.default_rng(1)
    B, T, raw, crop = 2, 5, 32, 24
    clips = rng.integers(0, 256, size=(B, T, raw, raw), dtype=np.uint8)
    video = jax_device_ingest(jnp.asarray(clips), None, None, None, crop,
                              jnp.float32)
    want = jax_stem.stack_frames(video, kt=5, interpret=True)
    got = ops.stack_frames_u8(torch.from_numpy(clips), crop, torch.float32)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2 * F32_ULP_AT_2
    from sbl_for_multilingual_lip_reading_tpu_torch.data import device_ingest
    two_pass = ops.stack_frames(device_ingest(torch.from_numpy(clips), crop,
                                              torch.bfloat16))
    assert torch.equal(ops.stack_frames_u8(torch.from_numpy(clips), crop,
                                           torch.bfloat16), two_pass)


def test_stack_frames_u8_refuses_what_it_does_not_take():
    clips = torch.zeros((1, 2, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        ops.stack_frames_u8(clips.float(), 4)
    with pytest.raises(ValueError, match="center-crop"):
        ops.stack_frames_u8(clips, 12)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ops.stack_frames_u8(clips, 4, torch.float16)


def test_frontend_takes_the_stacked_input():
    """``forward_stacked`` on K9's output == ``forward`` on the ingested
    clip (bf16: the two ingests round alike)."""
    cfg = C.tiny_test("sbl")
    model = build_model(dataclasses.replace(cfg, compute_dtype="bfloat16"), "cpu")
    rng = np.random.default_rng(2)
    clips = torch.from_numpy(rng.integers(
        0, 256, size=(2, cfg.data.frames, cfg.data.raw_size, cfg.data.raw_size),
        dtype=np.uint8))
    from sbl_for_multilingual_lip_reading_tpu_torch.data import device_ingest
    with torch.inference_mode():
        want = model.frontend(device_ingest(clips, cfg.data.crop_size,
                                            torch.bfloat16))
        got = model.frontend.forward_stacked(ops.stack_frames_u8(
            clips, cfg.data.crop_size, torch.bfloat16))
    assert torch.equal(got, want)


# ------------------------------------------------------------------ K10
def _resblock_inputs(N, C_, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, S, S, C_)).astype(np.float32)       # NHWC
    w1, w2 = (0.2 * rng.standard_normal((3, 3, C_, C_)).astype(np.float32)
              for _ in range(2))                                    # HWIO
    a1, a2 = (rng.uniform(0.5, 1.5, C_).astype(np.float32) for _ in range(2))
    b1, b2 = (0.1 * rng.standard_normal(C_).astype(np.float32) for _ in range(2))
    return x, w1, a1, b1, w2, a2, b2


def _port_resblock(x, w1, a1, b1, w2, a2, b2, dtype):
    """The port's function on the JAX layouts' values."""
    out = ops.fused_resblock(
        _t(x, dtype).permute(0, 3, 1, 2).contiguous(),
        _t(w1, dtype).permute(3, 2, 0, 1).contiguous(), _t(a1), _t(b1),
        _t(w2, dtype).permute(3, 2, 0, 1).contiguous(), _t(a2), _t(b2))
    return out.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("shape", RESBLOCK_SHAPES, ids=str)
def test_fused_resblock_plain_matches_jax_kernel_f32(shape):
    args = _resblock_inputs(*shape, seed=shape[2])
    want = np.asarray(jax_resblock.fused_resblock(
        *(jnp.asarray(a) for a in args), interpret=True))
    got = _port_resblock(*args, torch.float32)
    assert np.abs(got - want).max() <= RESBLOCK_F32_TOL * np.abs(want).max()


@pytest.mark.parametrize("shape", RESBLOCK_SHAPES[:2], ids=str)
def test_fused_resblock_plain_matches_jax_kernel_bf16(shape):
    x, w1, a1, b1, w2, a2, b2 = _resblock_inputs(*shape, seed=shape[2])
    want = np.asarray(jax_resblock.fused_resblock(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1, jnp.bfloat16), a1, b1,
        jnp.asarray(w2, jnp.bfloat16), a2, b2, interpret=True), np.float32)
    got = _port_resblock(x, w1, a1, b1, w2, a2, b2, torch.bfloat16)
    limit = (np.abs(want) * RESBLOCK_BF16["rel"]
             + np.abs(want).max() * RESBLOCK_BF16["floor"])
    assert (np.abs(got - want) <= limit).all(), np.abs(got - want).max()


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(3)
    scale, bias, mean = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.1, 2.0, 8).astype(np.float32)
    want = jax_resblock.fold_bn(*(jnp.asarray(a) for a in (scale, bias, mean, var)),
                                1e-5)
    got = ops.fold_bn(_t(scale), _t(bias), _t(mean), _t(var), 1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _randomized_block(c_in, c_out, stride, switch, seed=4):
    block = BasicBlock(c_in, c_out, stride, use_pallas_resblock=switch)
    g = torch.Generator().manual_seed(seed)
    block.init_weights(g)
    with torch.no_grad():
        for name, buf in block.named_buffers():
            buf.add_(0.3 * torch.randn(buf.shape, generator=g) ** 2)
        for name, p in block.named_parameters():
            if "bn" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return block.eval()


def test_basic_block_with_the_switch_matches_the_module_path():
    """JAX ``test_basic_block_fused_eval_matches_module``: an eligible block
    in eval mode through K10's plain version == its module path, with
    randomized running statistics; in train mode it takes the module path
    and moves the statistics."""
    on = _randomized_block(16, 16, 1, True)
    off = _randomized_block(16, 16, 1, False)
    x = torch.randn((4, 16, 8, 8), generator=torch.Generator().manual_seed(5))
    assert on._fused_eligible(x) and not off._fused_eligible(x)
    with torch.inference_mode():
        np.testing.assert_allclose(on(x).numpy(), off(x).numpy(), atol=1e-4,
                                   rtol=1e-4)
    before = on.bn1.running_mean.clone()
    on.train()
    assert not on._fused_eligible(x)
    on(x)
    assert not torch.equal(before, on.bn1.running_mean)


@pytest.mark.parametrize("c_in,c_out,stride", [(8, 16, 2), (8, 16, 1), (16, 16, 2)])
def test_ineligible_blocks_take_the_module_path(monkeypatch, c_in, c_out, stride):
    """Stride 2 or a change of width: the module path, whatever the switch."""
    from sbl_for_multilingual_lip_reading_tpu_torch.models import frontend
    monkeypatch.setattr(frontend, "fused_resblock",
                        lambda *a, **k: pytest.fail("K10's wrapper was called"))
    block = _randomized_block(c_in, c_out, stride, True)
    x = torch.randn((2, c_in, 8, 8), generator=torch.Generator().manual_seed(6))
    assert not block._fused_eligible(x)
    with torch.inference_mode():
        want = _randomized_block(c_in, c_out, stride, False)(x)
        assert torch.equal(block(x), want)


def test_switch_reaches_five_of_resnet18s_blocks(monkeypatch):
    """The field goes VisualFrontend -> ResNetTrunk -> BasicBlock, defaults
    to False as in JAX, and at ResNet-18's layout K10's wrapper is called
    five times per eval forward."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
    from sbl_for_multilingual_lip_reading_tpu_torch.models import frontend
    assert not VisualFrontend().resnet.layer1_block0.use_pallas_resblock
    assert not ResNetTrunk(8).layer1_block0.use_pallas_resblock
    assert fused_resblock_count(port_config.sbl().frontend) == 5
    calls = []
    real = frontend.fused_resblock
    monkeypatch.setattr(frontend, "fused_resblock",
                        lambda *a: calls.append(a[0].shape[1]) or real(*a))
    fe = VisualFrontend(conv3d_channels=4, resnet_channels=(4, 8, 8, 16),
                        feature_dim=16, use_pallas_resblock=True).eval()
    plain = VisualFrontend(conv3d_channels=4, resnet_channels=(4, 8, 8, 16),
                           feature_dim=16).eval()
    plain.load_state_dict(fe.state_dict())
    x = torch.randn((1, 3, 16, 16), generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        np.testing.assert_allclose(fe(x).numpy(), plain(x).numpy(), atol=1e-5)
    assert calls == [4, 4, 8, 8, 16]
    cfg = port_config.tiny_test()
    assert expected_launches(cfg, use_pallas_resblock=True)["fused_resblock"] == 1
    assert expected_launches(cfg)["fused_resblock"] == 0


# ------------------------------------------------------------------ K11
def _jax_layer(B=4, L=5, Tk=7, D=32, H=2, dk=16, DI=64, seed=0):
    layer = JaxSBLLayer(D, H, dk, dk, DI, 0.0, jnp.float32)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    h = jax.random.normal(ks[0], (B, L, D), jnp.float32)
    kh = jax.random.normal(ks[1], (B, Tk, H, dk), jnp.float32)
    vh = jax.random.normal(ks[2], (B, Tk, H, dk), jnp.float32)
    params = layer.init(ks[3], h, kh, vh, None, True)["params"]
    rng = np.random.default_rng(seed)
    params = _perturbed({"params": jax.device_get(params)}, rng)["params"]
    return params, h, kh, vh


def _port_args(params):
    """JAX ``layer_params_to_args`` output as the port's direction-stacked
    arguments (dirs = 1): kernels (in, out) -> weights (1, out, in)."""
    out = []
    for a in jax_layer.layer_params_to_args(params):
        t = _t(a)
        out.append(t.t()[None].contiguous() if t.dim() == 2 else t[None])
    return out


def _masks(L):
    causal = np.triu(np.ones((L, L), bool), 1)
    beyond = np.broadcast_to(np.arange(L) > 2, (L, L))
    return {"unmasked": None, "causal": causal, "partial_prefix": beyond}


@pytest.mark.parametrize("mask", ["unmasked", "causal", "partial_prefix"])
def test_fused_decoder_layer_plain_matches_jax_kernel(mask):
    params, h, kh, vh = _jax_layer(seed=1)
    B, L, D = h.shape
    m = _masks(L)[mask]
    bias = None if m is None else np.where(m, -1e9, 0.0).astype(np.float32)
    want = np.asarray(jax_layer.fused_decoder_layer(
        h, *jax_layer.layer_params_to_args(params), ckh=kh, cvh=vh,
        mask_bias=None if bias is None else jnp.asarray(bias), interpret=True))
    got = ops.fused_decoder_layer(
        _t(h)[None], *_port_args(params), _t(kh).reshape(1, B, -1, D),
        _t(vh).reshape(1, B, -1, D), kh.shape[2],
        mask_bias=None if bias is None else _t(bias))
    assert got.shape == (1, B, L, D)
    np.testing.assert_allclose(got[0].numpy(), want, atol=LAYER_TOL, rtol=LAYER_TOL)


def test_fused_decoder_layer_plain_matches_jax_kernel_bf16():
    """bf16: both round q, k, v, the contexts, the LayerNorm outputs and the
    ReLU output in the same places; a flip of one of them moves the O(1)
    LayerNorm output by a few ulps (2^-7 for |x| in [1, 2))."""
    params, h, kh, vh = _jax_layer(seed=2)
    B, L, D = h.shape
    bf = jnp.bfloat16
    want = np.asarray(jax_layer.fused_decoder_layer(
        h.astype(bf), *jax_layer.layer_params_to_args(params), ckh=kh.astype(bf),
        cvh=vh.astype(bf), interpret=True), np.float32)
    args = [a.to(torch.bfloat16) if a.dim() == 3 else a for a in _port_args(params)]
    got = ops.fused_decoder_layer(
        _t(h, torch.bfloat16)[None], *args,
        _t(kh, torch.bfloat16).reshape(1, B, -1, D),
        _t(vh, torch.bfloat16).reshape(1, B, -1, D), kh.shape[2])
    diff = np.abs(got[0].float().numpy() - want)
    assert diff.max() <= 2.0 ** -4 and (diff > 2.0 ** -7).mean() <= 0.05, (
        diff.max(), (diff > 2.0 ** -7).mean())


def test_fused_layer_module_matches_its_module_path_and_directions():
    """A direction-stacked ``_SBLLayer`` with the switch == without it
    (tests/test_fused_layer.py's tolerance), each direction with its own
    weights; a training call (an rng) and mismatched heads keep the module
    path; a batch-variant mask is refused."""
    from sbl_for_multilingual_lip_reading_tpu_torch.models import init_weights
    from sbl_for_multilingual_lip_reading_tpu_torch.models import random_layout
    from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import (
        DropoutRNG, step_random)
    on = _SBLLayer(32, 2, 16, 16, 64, use_fused_layer=True, dropout=0.0)
    off = _SBLLayer(32, 2, 16, 16, 64, dropout=0.0)
    g = torch.Generator().manual_seed(8)
    init_weights(on, g)
    with torch.no_grad():
        for p in on.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    off.load_state_dict(on.state_dict())
    h = torch.randn((2, 3, 5, 32), generator=g)
    k2, v2 = (torch.randn((2, 3, 7, 32), generator=g) for _ in range(2))
    bias = ops.mask_to_bias(M.causal_mask(5)[None], 5, 5)
    assert on._fused_eligible(None) and not off._fused_eligible(None)
    with torch.inference_mode():
        got, want = on(h, k2, v2, bias), off(h, k2, v2, bias)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
        # the directions do not share weights: swapping them changes the result
        swapped = on(h.flip(0), k2.flip(0), v2.flip(0), bias).flip(0)
        assert (swapped - got).abs().max() > 1e-3
        with pytest.raises(AssertionError, match="batch-invariant"):
            on(h, k2, v2, bias.expand(3, 5, 5))
    assert not on._fused_eligible(
        DropoutRNG(step_random(0, random_layout(on), "cpu"), "cpu"))
    assert not _SBLLayer(32, 2, 8, 8, 64, use_fused_layer=True)._fused_eligible(None)


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
    return dict(cfg=cfg, variables=variables, clips=clips)


@pytest.mark.parametrize("fusion_mode", ["symmetric", "reference_aliased"])
def test_recognize_with_the_fused_layer_matches_jax(tiny, fusion_mode):
    """``sbl`` recognize with ``use_fused_decoder_layer`` on both sides: the
    JAX decoder runs its Pallas layer in interpret mode, the port K11's
    plain version."""
    cfg = dataclasses.replace(
        tiny["cfg"], use_fused_decoder_layer=True,
        decoder=dataclasses.replace(tiny["cfg"].decoder, fusion_mode=fusion_mode))
    jm = build_jax_model(cfg)
    jm = JaxSBLTransformer(jm.frontend, jm.encoder,
                           jm.decoder.clone(fused_interpret=True))
    video = jax_device_ingest(jnp.asarray(tiny["clips"]), None, None, None,
                              cfg.data.crop_size, jnp.float32)
    labels = jnp.zeros((3, cfg.decoder.target_pad_len), jnp.int32)
    lg_l, _, lg_r, _ = jax.jit(lambda v, x: jm.apply(
        v, x, labels, labels, train=False))(tiny["variables"], video)
    ys_l, ys_r = jax.jit(lambda v, x: jm.apply(v, x, method=jm.recognize))(
        tiny["variables"], video)
    port = build_model(cfg, "cpu")
    port.load_state_dict(state_dict_from_jax(tiny["variables"]["params"],
                                             tiny["variables"]["batch_stats"]))
    assert port.decoder.step.layer_0.use_fused_layer
    out = recognize_batch(port, torch.from_numpy(tiny["clips"]), cfg.data.crop_size)
    np.testing.assert_allclose(out.logits_l2r.numpy(), np.asarray(lg_l), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(out.logits_r2l.numpy(), np.asarray(lg_r), rtol=0,
                               atol=LOGIT_TOL)
    assert np.array_equal(out.ys_l2r.numpy(), np.asarray(ys_l))
    assert np.array_equal(out.ys_r2l.numpy(), np.asarray(ys_r))


def test_recognize_calls_the_fused_layer_as_counted(monkeypatch):
    """With the switch every decoder layer of every step goes through K11's
    wrapper and no decoder attention through K1's; ``layer_params_to_args``
    hands the weights in the compute dtype and the vectors in f32."""
    from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
    from sbl_for_multilingual_lip_reading_tpu_torch.models import decoder_sbl, layers
    cfg = dataclasses.replace(port_config.tiny_test(), use_fused_decoder_layer=True,
                              compute_dtype="bfloat16")
    calls = {"fused_decoder_layer": 0, "small_mha_flat": 0}
    dtypes = set()

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            if name == "fused_decoder_layer":
                dtypes.update((a.dim(), a.dtype) for a in args[1:23])
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    spy(decoder_sbl, "fused_decoder_layer")
    spy(layers, "small_mha_flat")
    clips = torch.zeros((2, cfg.data.frames, cfg.data.raw_size, cfg.data.raw_size),
                        dtype=torch.uint8)
    recognize_batch(build_model(cfg, "cpu"), clips, cfg.data.crop_size)
    expected = expected_launches(cfg)
    assert calls == {k: expected[k] for k in calls}
    assert calls["fused_decoder_layer"] == cfg.decoder.maxlen * cfg.dims.n_dec_layers
    assert calls["small_mha_flat"] == cfg.dims.n_enc_layers
    assert dtypes == {(3, torch.bfloat16), (2, torch.float32)}
    assert len(port_layer.layer_params_to_args(
        build_model(cfg, "cpu").decoder.step.layer_0)) == 22


def test_new_wrappers_raise_on_the_card_path_without_a_toolkit(monkeypatch, tmp_path):
    """A CUDA tensor means the kernel: nothing falls back to the plain
    version when the library cannot be built (here: no nvcc)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernels build for real")
    assert ops.KERNELS[8:11] == (ops.stack_frames_u8, ops.fused_resblock,
                                 ops.fused_decoder_layer)
    for name in ("sbl_stack_frames_u8", "sbl_fused_resblock",
                 "sbl_fused_decoder_layer"):
        assert name in _build._SIGNATURES
    assert len(_build._SIGNATURES["sbl_fused_decoder_layer"]) == 29
    x = torch.zeros((1, 4, 3, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_resblock(x, torch.zeros((4, 4, 3, 3), device="meta"),
                           *(torch.zeros(4, device="meta"),) * 2,
                           torch.zeros((4, 4, 3, 3), device="meta"),
                           *(torch.zeros(4, device="meta"),) * 2)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.stack_frames_u8(torch.zeros((1, 2, 8, 8), dtype=torch.uint8,
                                        device="meta"), 4)
