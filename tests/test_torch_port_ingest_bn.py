"""CPU parity of the port's train-path kernels K6 (``ops/ingest.py``) and
K7/K8 (``ops/batchnorm.py``, ``FastBatchNorm``) against the JAX package's
Pallas kernels in interpret mode, their switches (``PALLAS_INGEST``,
``PALLAS_BN``), and the default device of the entry points.

Tolerances:

* K6 f32: one f32 ulp (2^-22 for |x| < 4; every normalized pixel lies in
  [-2.44, 3.45]).  The port rounds ``x * (1/(255 STD))`` and then the
  subtraction, as the TPU kernel's two ops state; XLA's CPU backend
  contracts the two into one FMA in interpret mode, so half the pixels sit
  one ulp apart.  bf16: one bf16 ulp (2^-6 for |x| < 4), since an f32 ulp
  can carry a bf16 rounding across; the readings were bit-identical.
* ``bn_train`` f32: sums in another order, so 1e-5 on y and the statistics
  and 1e-4 relative on gradients; bf16 y one bf16 ulp of |y| <= 8 (2^-5).
* The frontend with ``use_pallas_bn`` (both sides on the kernel path):
  output 1e-4, gradients 1e-3 relative to each tensor's largest element,
  running statistics 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu.models import frontend as jax_frontend
from sbl_for_multilingual_lip_reading_tpu.ops.batchnorm import (
    bn_train as jax_bn_train)
from sbl_for_multilingual_lip_reading_tpu.ops.ingest import (
    ingest_train as jax_ingest_train)
from sbl_for_multilingual_lip_reading_tpu_torch import config as C
from sbl_for_multilingual_lip_reading_tpu_torch import ops
from sbl_for_multilingual_lip_reading_tpu_torch.data import (Batcher,
                                                              SyntheticLipDataset)
from sbl_for_multilingual_lip_reading_tpu_torch.data.transforms import (
    make_train_plans)
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.models import frontend
from sbl_for_multilingual_lip_reading_tpu_torch.ops import batchnorm
from sbl_for_multilingual_lip_reading_tpu_torch.training import steps
from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
    make_optimizer)
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (
    attach_plans)
from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
    state_dict_from_jax)

from test_torch_port_recognize import _perturbed

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # tiny shapes: one thread does the work, and the test workers that run
    # beside this one find the cores free
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_ULP_BELOW_4 = 2.0 ** -22
BF16_ULP_BELOW_4 = 2.0 ** -6


def _plans(seed=0, B=3, T=5, raw=20, crop=12):
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (B, T, raw, raw), dtype=np.uint8)
    offsets, flip, fmap = make_train_plans(rng, B, T, raw, crop, 0.3)
    return clips, offsets, flip, fmap, np.array([3, T, 1], np.int32)[:B]


@pytest.mark.parametrize("with_n_frames", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ingest_train_plain_matches_jax(dtype, with_n_frames):
    crop = 12
    clips, offsets, flip, fmap, nf = _plans()
    nf = nf if with_n_frames else None
    want = jax_ingest_train(
        jnp.asarray(clips), jnp.asarray(offsets), jnp.asarray(flip),
        jnp.asarray(fmap), crop, dtype=jnp.dtype(dtype),
        n_frames=None if nf is None else jnp.asarray(nf), interpret=True)
    got = ops.ingest_train(
        torch.from_numpy(clips), torch.from_numpy(offsets),
        torch.from_numpy(flip), torch.from_numpy(fmap), crop,
        getattr(torch, dtype), None if nf is None else torch.from_numpy(nf))
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 5, crop, crop)
    tol = F32_ULP_BELOW_4 if dtype == "float32" else BF16_ULP_BELOW_4
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    if with_n_frames:
        assert not got[0, 3:].any() and not got[2, 1:].any()


def test_ingest_train_clamps_plans_into_the_frame():
    clips, offsets, flip, fmap, _ = _plans(1)
    wild = [torch.from_numpy(clips), torch.from_numpy(offsets * 9 - 40),
            torch.from_numpy(flip), torch.from_numpy(fmap * 7 - 3)]
    got = ops.ingest_train_plain(*wild, 12, torch.float32)
    clamped = [wild[0], wild[1].clamp(0, 8), wild[2], wild[3].clamp(0, 4)]
    assert torch.equal(got, ops.ingest_train_plain(*clamped, 12, torch.float32))
    with pytest.raises(ValueError, match="offsets"):
        ops.ingest_train_plain(torch.from_numpy(clips), torch.zeros(3, 5, 2),
                               *wild[2:], 10, torch.float32)


def _bn_inputs(dtype, shape=(6, 16, 5, 5), seed=2):
    rng = np.random.default_rng(seed)
    C_ = shape[1]
    x = (rng.standard_normal(shape) * 2 + 0.7).astype(np.float32)
    x = torch.from_numpy(x).to(getattr(torch, dtype))
    scale = torch.from_numpy((rng.standard_normal(C_) * 0.2 + 1).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(C_) * 0.1).astype(np.float32))
    return x, scale, bias


def _nhwc(t):
    return jnp.asarray(t.float().permute(0, 2, 3, 1).numpy()).astype(
        {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[t.dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_train_forward_matches_jax(dtype):
    x, scale, bias = _bn_inputs(dtype)
    y, mean, var = ops.bn_train(x, scale, bias, 1e-5)
    yj, mj, vj = jax_bn_train(_nhwc(x), jnp.asarray(scale.numpy()),
                              jnp.asarray(bias.numpy()), 1e-5, True)
    assert y.dtype == x.dtype and mean.dtype == var.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    np.testing.assert_allclose(y.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(yj.astype(jnp.float32)), atol=tol)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(vj), atol=1e-5)


def test_bn_train_gradients_and_stat_cotangents_match_jax():
    """dx, d_scale and d_bias for a random output cotangent and random
    cotangents on the returned mean and var, against JAX's custom VJP."""
    x, scale, bias = _bn_inputs("float32", (4, 8, 3, 3), seed=3)
    rng = np.random.default_rng(4)
    w = rng.standard_normal(tuple(x.shape)).astype(np.float32)
    wm, wv = (rng.standard_normal(8).astype(np.float32) for _ in range(2))

    xt, st, bt = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    y, m, v = ops.bn_train(xt, st, bt, 1e-5)
    ((y * torch.from_numpy(w)).sum() + (m * torch.from_numpy(wm)).sum()
     + (v * torch.from_numpy(wv)).sum()).backward()

    def loss(xj, sj, bj):
        yj, mj, vj = jax_bn_train(xj, sj, bj, 1e-5, True)
        return (jnp.sum(yj * jnp.asarray(w.transpose(0, 2, 3, 1)))
                + jnp.sum(mj * wm) + jnp.sum(vj * wv))
    gx, gs, gb = jax.grad(loss, argnums=(0, 1, 2))(
        _nhwc(x), jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()))
    for got, want in ((xt.grad.permute(0, 2, 3, 1), gx), (st.grad, gs),
                      (bt.grad, gb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())


def test_bn_train_without_stat_cotangents_equals_plain_autograd():
    # unused mean/var get zero cotangents: the gradients are those of the
    # batch-statistics formula, written in plain torch
    x, scale, bias = _bn_inputs("float32", (5, 4, 6, 6), seed=5)
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    grads = []
    for fn in ("bn_train", "plain"):
        xt, st, bt = (t.clone().requires_grad_(True) for t in (x, scale, bias))
        if fn == "bn_train":
            y = ops.bn_train(xt, st, bt, 1e-5)[0]
        else:
            mean = xt.mean(dim=(0, 2, 3))
            var = (xt * xt).mean(dim=(0, 2, 3)) - mean * mean
            y = ((xt - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
                 * st[:, None, None] + bt[:, None, None])
        (y * w).sum().backward()
        grads.append([t.grad for t in (xt, st, bt)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_channel_sums_plain_versions():
    x, _, _ = _bn_inputs("float32", (3, 5, 4, 4), seed=6)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    s, q = ops.channel_sums(x)
    torch.testing.assert_close(s, x.double().sum((0, 2, 3)).float())
    torch.testing.assert_close(q, (x.double() ** 2).sum((0, 2, 3)).float())
    mean, inv = s / 48, torch.rand(5) + 0.5
    sd, sx = ops.channel_sums_pair(dy, x, mean, inv)
    xhat = (x.double() - mean.double()[:, None, None]) * inv.double()[:, None, None]
    torch.testing.assert_close(sd, dy.double().sum((0, 2, 3)).float())
    torch.testing.assert_close(sx, (dy.double() * xhat).sum((0, 2, 3)).float())


@pytest.mark.parametrize("shape", [(7200, 64, 44, 44), (7200, 64, 22, 22),
                                   (7200, 128, 11, 11), (7200, 256, 6, 6),
                                   (7200, 512, 3, 3), (16, 512, 3, 3),
                                   (3, 1, 45, 45)])
def test_channel_sums_tiling_covers_every_channel_once(shape):
    """The launch geometry of K7/K8 at the train path's BN shapes, on a
    card of 132 SMs holding 3 blocks each: each block's run of channels
    fits its 2048 position slots and is a whole number of 16-byte pieces
    where the row is (so every piece starts 16-byte aligned), the groups
    cover the channels, the chunks cover the samples, none empty, and one
    wave of blocks fills the card where the shape has the samples for it."""
    N, C_, H, W = shape
    HW, capacity = H * W, 132 * 3
    for dtype in (torch.float32, torch.bfloat16):
        epv = batchnorm.PIECE_BYTES // dtype.itemsize
        if C_ * HW % epv:      # rows of odd length: the scalar route
            epv = 1
        cg, phases, chunks = batchnorm.tiling(N, C_, HW, epv, capacity)
        groups = -(-C_ // cg)
        assert cg * HW * phases <= batchnorm.MAX_RUN < cg * HW * (phases + 1)
        assert cg * HW % epv == 0 and C_ * HW % epv == 0
        # every run (sample n, group g) starts on a whole piece: 16 bytes
        starts = {(n * C_ * HW + g * cg * HW) * dtype.itemsize
                  for n in range(min(N, 9)) for g in range(groups)}
        assert all(a % (epv * dtype.itemsize) == 0 for a in starts)
        assert (groups - 1) * cg < C_ <= groups * cg
        assert 1 <= chunks <= min(N, batchnorm.MAX_CHUNKS)
        sizes = [(k + 1) * N // chunks - k * N // chunks for k in range(chunks)]
        assert sum(sizes) == N and min(sizes) >= 1
        assert groups * chunks <= max(capacity, groups)
        if N >= capacity * phases:
            assert groups * chunks > capacity - groups


def _jax_frontend_pair(use_pallas_bn):
    return jax_frontend.VisualFrontend(
        conv3d_channels=8, resnet_channels=(8, 12), resnet_blocks=(1, 1),
        feature_dim=12, dtype=jnp.float32, use_pallas_bn=use_pallas_bn)


def test_frontend_fast_bn_train_matches_jax(monkeypatch):
    """The frontend in train mode with ``use_pallas_bn``: JAX with its TPU
    gate forced on (FastBatchNorm, Pallas reductions in interpret mode, as
    ``tests/test_batchnorm.py`` wires it) against the port's FastBatchNorm:
    output, every parameter gradient of sum(y^2), and the running
    statistics after the step."""
    monkeypatch.setattr(jax_frontend, "_use_fast_bn", lambda: True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    m_jax = _jax_frontend_pair(True)
    variables = jax.device_get(jax.jit(m_jax.init)(jax.random.PRNGKey(1),
                                                   jnp.asarray(x[..., None])))
    variables = _perturbed(variables, np.random.default_rng(7))

    def loss(p):
        y, upd = m_jax.apply({**variables, "params": p}, jnp.asarray(x[..., None]),
                             train=True, deterministic=True,
                             mutable=["batch_stats"])
        return jnp.sum(y * y), (y, upd)
    (_, (yj, upd)), gj = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])

    port = frontend.VisualFrontend(conv3d_channels=8, resnet_channels=(8, 12),
                                   resnet_blocks=(1, 1), feature_dim=12,
                                   use_pallas_bn=True)
    assert isinstance(port.bn3d, frontend.FastBatchNorm)
    assert all(isinstance(m, frontend.FastBatchNorm) for n, m in port.named_modules()
               if n.endswith(("bn1", "bn2", "downsample_bn")))
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    port.train()
    y = port(torch.from_numpy(x))
    (y * y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), atol=1e-4)
    want = state_dict_from_jax(jax.device_get(gj))
    for name, p in port.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)
    stats = state_dict_from_jax({}, jax.device_get(upd["batch_stats"]))
    for name, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), atol=1e-5,
                                   err_msg=name)


def test_fast_bn_eval_uses_running_statistics_and_no_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(batchnorm, "channel_sums",
                        lambda *a: calls.append(1) or ops.channel_sums_plain(*a))
    fast = frontend.FastBatchNorm(4)
    plain = frontend.BatchNorm(4)
    for m in (fast, plain):
        m.running_mean.copy_(torch.arange(4.0))
        m.running_var.copy_(torch.arange(1.0, 5.0))
    x = torch.randn(3, 4, 5, 5, generator=torch.Generator().manual_seed(2))
    assert torch.equal(fast.eval()(x), plain.eval()(x))
    assert not calls
    fast.train()(x)
    assert calls == [1]


def test_pallas_bn_switch_builds_fast_bn_with_the_same_state(monkeypatch):
    cfg = C.tiny_test()
    monkeypatch.delenv("PALLAS_BN", raising=False)
    plain = build_model(cfg, "cpu")
    monkeypatch.setenv("PALLAS_BN", "1")
    fast = build_model(cfg, "cpu")
    kinds = {type(m) for m in fast.modules() if isinstance(m, frontend.BatchNorm)}
    assert kinds == {frontend.FastBatchNorm}
    n_bn = sum(isinstance(m, frontend.BatchNorm) for m in plain.modules())
    assert n_bn == steps.frontend_bn_count(cfg.frontend) == 12
    assert steps.frontend_bn_count(C.sbl().frontend) == 20
    a, b = plain.state_dict(), fast.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("raw", [40, 44])
def test_pallas_ingest_switch_routes_by_shape(monkeypatch, raw):
    """PALLAS_INGEST sends the train ingest to K6 when the frames are at
    most 8 pixels wider than the crop (tiny: 40 -> 32), and to
    device_ingest otherwise, as JAX's ``_ingest_train`` does."""
    cfg = C.tiny_test()
    data = SyntheticLipDataset(size=2, frames=cfg.data.frames, raw_size=raw)
    batch = attach_plans(next(iter(Batcher(data, 2))),
                         np.random.default_rng(0), cfg)
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    calls = []
    monkeypatch.setattr(steps, "ingest_train",
                        lambda *a, **k: calls.append(1) or ops.ingest_train(*a, **k))
    monkeypatch.delenv("PALLAS_INGEST", raising=False)
    off = steps.ingest_train_batch(batch, cfg.data.crop_size, torch.float32)
    assert not calls
    monkeypatch.setenv("PALLAS_INGEST", "1")
    on = steps.ingest_train_batch(batch, cfg.data.crop_size, torch.float32)
    assert calls == ([1] if raw - cfg.data.crop_size <= 8 else [])
    # the two normalizations round differently: the readings sit at most
    # two f32 ulps apart
    torch.testing.assert_close(on, off, rtol=0, atol=2 * F32_ULP_BELOW_4)


def test_train_step_with_both_switches_calls_each_wrapper_as_counted(monkeypatch):
    """With PALLAS_INGEST and PALLAS_BN set, one train step goes through
    the K6 wrapper once and the K7/K8 wrappers once per frontend BatchNorm,
    as ``expected_launches`` (and chip_smoke.py) count them."""
    monkeypatch.setenv("PALLAS_INGEST", "1")
    monkeypatch.setenv("PALLAS_BN", "1")
    cfg = C.tiny_test()
    calls = dict.fromkeys(("ingest_train", "channel_sums", "channel_sums_pair"), 0)

    def spy(module, name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    spy(steps, "ingest_train", ops.ingest_train)
    spy(batchnorm, "channel_sums", ops.channel_sums)
    spy(batchnorm, "channel_sums_pair", ops.channel_sums_pair)
    model = build_model(cfg, "cpu")
    data = SyntheticLipDataset(size=2, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size)
    batch = attach_plans(next(iter(Batcher(data, 2))), np.random.default_rng(0),
                         cfg)
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    step = steps.make_sbl_train_step(model, make_optimizer(model, cfg.optim), cfg)
    loss = step(batch, torch.Generator().manual_seed(0))["loss"]
    assert torch.isfinite(loss)
    expected = steps.expected_launches(cfg)
    assert calls == {k: expected[k] for k in calls} == {
        "ingest_train": 1, "channel_sums": 12, "channel_sums_pair": 12}
    # the plain path calls no wrapper
    calls.update(dict.fromkeys(calls, 0))
    plain = dataclasses.replace(cfg, use_pallas_attention=False)
    model = build_model(plain, "cpu")
    step = steps.make_sbl_train_step(model, make_optimizer(model, plain.optim), plain)
    step(batch, torch.Generator().manual_seed(0))
    assert not any(calls.values()), calls


def test_entry_points_default_to_the_card():
    """With no device the model and K5 go to CUDA, so without a card they
    raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(C.tiny_test())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.dropout_keep_mask_flat(2, 3, 3, 2, 1, 0.1)
    assert build_model(C.tiny_test(), "cpu").frontend.conv3d_weight.device.type == "cpu"
