"""CPU parity of the PyTorch port's training ops against the JAX package.

Inputs come from a numpy seed and go through both sides in f32.  The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU; the port's kernel wrappers take their plain versions (CPU
tensors), which chip_smoke.py holds the CUDA kernels against on the card.
The dropout masks cannot match JAX's (the TPU's in-kernel PRNG has no GPU
counterpart), so at rate > 0 both sides get the port's mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from sbl_for_multilingual_lip_reading_tpu import config as C
from sbl_for_multilingual_lip_reading_tpu.data import synthetic as jax_synthetic
from sbl_for_multilingual_lip_reading_tpu.data import transforms as jax_transforms
from sbl_for_multilingual_lip_reading_tpu.data.pipeline import (
    device_ingest as jax_device_ingest)
from sbl_for_multilingual_lip_reading_tpu.ops import attention as jax_attn
from sbl_for_multilingual_lip_reading_tpu.ops.maxpool import stem_max_pool
from sbl_for_multilingual_lip_reading_tpu.training import loss as jax_loss
from sbl_for_multilingual_lip_reading_tpu.training import schedule as jax_schedule
from sbl_for_multilingual_lip_reading_tpu.training.trainer import (
    attach_plans as jax_attach_plans)
from sbl_for_multilingual_lip_reading_tpu.vocab import IGNORE_ID
from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
from sbl_for_multilingual_lip_reading_tpu_torch import ops
from sbl_for_multilingual_lip_reading_tpu_torch.data import (
    SyntheticLipDataset, device_ingest, make_train_plans)
from sbl_for_multilingual_lip_reading_tpu_torch.models.frontend import BatchNorm
from sbl_for_multilingual_lip_reading_tpu_torch.ops.attention import philox4x32_10
from sbl_for_multilingual_lip_reading_tpu_torch.training import loss, schedule
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (
    attach_plans)

# f32 on both sides, summation order only (the JAX package's own test of
# its kernel against an einsum uses the same bounds)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(B, Tq, Tk, H, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H * d)).astype(np.float32)
            for T in (Tq, Tk, Tk)]


def _bias(kind, B, T):
    if kind is None:
        return None
    causal = np.where(np.triu(np.ones((T, T), bool), k=1), -1e9, 0.0)[None]
    causal = causal.astype(np.float32)
    return causal if kind == "shared" else np.tile(causal, (B, 1, 1))


def _port_grads(q, k, v, H, bias, seed, rate, scale, weight):
    """Forward and (dq, dk, dv) of sum(out * weight) through the port's
    autograd.Function."""
    q, k, v = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = ops.small_mha_dropout_flat(q, k, v, H, None if bias is None else _t(bias),
                                     seed, rate, scale)
    (out * _t(weight)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


@pytest.mark.parametrize("kind", [None, "shared", "per_row"])
def test_dropout_attention_rate0_matches_jax(kind):
    """Rate 0: forward and all three gradients against JAX's custom-VJP
    flat kernel pair (interpret mode), as tests/test_pallas_attention.py
    holds it against an einsum."""
    B, T, H, d = 4, 9, 4, 16
    q, k, v = _qkv(B, T, T, H, d, 11)
    w = np.random.default_rng(1).standard_normal((B, T, H * d)).astype(np.float32)
    bias = _bias(kind, B, T)
    scale = 1.0 / np.sqrt(d)
    jb = None if bias is None else jnp.asarray(bias)
    seed = jnp.zeros((1,), jnp.int32)

    def f(q, k, v):
        return jax_attn.small_mha_dropout_grad_flat(q, k, v, jb, seed, H,
                                                    scale, 0.0)

    want = f(*(jnp.asarray(x) for x in (q, k, v)))
    want_g = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(w)),
                      argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    got, got_g = _port_grads(q, k, v, H, bias, 0, 0.0, scale, w)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FWD_TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("d,Tq,Tk,kind", [
    (32, 9, 9, "shared"), (128, 9, 9, None), (64, 40, 40, "per_row"),
    (16, 5, 70, None)])
def test_dropout_attention_head_widths_and_lengths_match_jax(d, Tq, Tk, kind):
    """Rate 0, as above, at the other head widths K3/K4 are built for and
    past one tile of 32 keys: forward and gradients against JAX's
    custom-VJP flat kernel pair (interpret mode)."""
    B, H = 2, 2
    q, k, v = _qkv(B, Tq, Tk, H, d, d + Tk)
    w = np.random.default_rng(3).standard_normal((B, Tq, H * d)).astype(np.float32)
    bias = _bias(kind, B, Tq)
    scale = 1.0 / np.sqrt(d)
    jb = None if bias is None else jnp.asarray(bias)
    seed = jnp.zeros((1,), jnp.int32)

    def f(q, k, v):
        return jax_attn.small_mha_dropout_grad_flat(q, k, v, jb, seed, H,
                                                    scale, 0.0)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    with jax.default_matmul_precision("highest"):
        want = f(jq, jk, jv)
        want_g = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(w)),
                          argnums=(0, 1, 2))(jq, jk, jv)
    got, got_g = _port_grads(q, k, v, H, bias, 0, 0.0, scale, w)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FWD_TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("kind,Tq,Tk", [(None, 9, 9), ("shared", 9, 9),
                                        (None, 5, 12)])
def test_dropout_attention_masked_matches_reference(kind, Tq, Tk):
    """Rate > 0: the port's forward and gradients against a JAX einsum
    reference given the same keep mask (the one K5 draws for the seed)."""
    B, H, d, rate, seed = 4, 4, 16, 0.3, 77
    q, k, v = _qkv(B, Tq, Tk, H, d, 12)
    w = np.random.default_rng(2).standard_normal((B, Tq, H * d)).astype(np.float32)
    bias = _bias(kind, B, Tq)
    scale = 1.0 / np.sqrt(d)
    keep = ops.dropout_keep_mask_flat(B, Tq, Tk, H, seed, rate, device="cpu").numpy()
    assert 0.5 < keep.mean() < 0.9

    def ref(q, k, v):
        qh, kh, vh = (x.reshape(B, -1, H, d) for x in (q, k, v))
        s = jnp.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
        if bias is not None:
            s = s + jnp.asarray(bias)[:, None]
        p = jnp.where(keep, jax.nn.softmax(s, -1), 0.0) / (1 - rate)
        return jnp.einsum("bhqk,bkhd->bqhd", p, vh).reshape(B, Tq, H * d)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want_g = jax.grad(lambda *a: jnp.sum(ref(*a) * jnp.asarray(w)),
                      argnums=(0, 1, 2))(jq, jk, jv)
    got, got_g = _port_grads(q, k, v, H, bias, seed, rate, scale, w)
    np.testing.assert_allclose(got, np.asarray(ref(jq, jk, jv)), rtol=0,
                               atol=FWD_TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=GRAD_TOL)
    # the injected-mask plain versions agree with the seeded ones
    args = (_t(q), _t(k), _t(v), H, None if bias is None else _t(bias), seed,
            rate, scale)
    assert torch.equal(ops.small_mha_dropout_flat_plain(*args),
                       ops.small_mha_dropout_flat_plain(*args, keep=_t(keep)))


@pytest.mark.parametrize("rate,kind", [(0.0, "per_row"), (0.3, None),
                                       (0.3, "shared")])
def test_dropout_attention_gradcheck(rate, kind):
    """The autograd.Function's explicit backward (the plain version of K4)
    against finite differences, in f64."""
    B, T, H, d = 2, 5, 2, 4
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H * d)))
               .requires_grad_(True) for _ in range(3))
    bias = _bias(kind, B, T)
    bias = None if bias is None else _t(bias).double()
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.small_mha_dropout_flat(q, k, v, H, bias, 5, rate),
        (q, k, v))


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for ctr, key, want in cases:
        got = philox4x32_10(tuple(torch.tensor([c]) for c in ctr),
                            key[0] | key[1] << 32)
        assert tuple(int(x) for x in got) == want


def test_keep_mask_fraction_and_determinism():
    B, Tq, Tk, H = 480, 17, 17, 8          # the decoder's self-attention
    a = ops.dropout_keep_mask_flat(B, Tq, Tk, H, 1234, 0.1, device="cpu")
    assert a.shape == (B, H, Tq, Tk) and a.dtype == torch.bool
    assert abs(a.float().mean().item() - 0.9) < 0.005
    assert torch.equal(a, ops.dropout_keep_mask_flat(B, Tq, Tk, H, 1234, 0.1, device="cpu"))
    assert not torch.equal(a, ops.dropout_keep_mask_flat(B, Tq, Tk, H, 1235, 0.1, device="cpu"))
    # the counter holds the batch row: the decoder's two directions (rows b
    # and B/2 + b) get different masks
    assert not torch.equal(a[:B // 2], a[B // 2:])
    # a mask is a function of (seed, b, h, i, j), not of the launch's shape
    assert torch.equal(ops.dropout_keep_mask_flat(B // 2, 9, 5, H, 1234, 0.1, device="cpu"),
                       a[:B // 2, :, :9, :5])
    assert ops.dropout_keep_mask_flat(4, 3, 3, 2, 9, 0.0, device="cpu").all()
    # the JAX threshold: keep <=> bits >= uint32(rate * 2^32)
    assert ops.attention.dropout_threshold(0.1) == int(np.uint32(0.1 * 2 ** 32))


def test_dropout_wrappers_take_plain_on_cpu_and_refuse_bad_input():
    q, k, v = (_t(x) for x in _qkv(2, 3, 4, 2, 8, 4))
    before = ops.launch_counts()
    out = ops.small_mha_dropout_fwd_flat(q, k, v, 2, None, 3, 0.2)
    assert torch.equal(out, ops.small_mha_dropout_flat_plain(q, k, v, 2, None, 3, 0.2))
    grads = ops.small_mha_dropout_bwd_flat(q, k, v, 2, None, 3, 0.2, None, out)
    want = ops.small_mha_dropout_bwd_flat_plain(q, k, v, 2, None, 3, 0.2, None, out)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    ops.dropout_keep_mask_flat(2, 3, 4, 2, 3, 0.2, device="cpu")
    assert ops.launch_counts() == before
    with pytest.raises(ValueError):
        ops.small_mha_dropout_fwd_flat(q, k, v, 2, None, 3, 1.0)
    with pytest.raises(ValueError):
        ops.small_mha_dropout_fwd_flat(q, k, v, 2, None, -1, 0.1)
    with pytest.raises(ValueError):
        ops.small_mha_dropout_bwd_flat(q, k, v, 2, None, 3, 0.2, None, k)


def test_batchnorm_train_matches_flax():
    """Train mode: output, input and affine gradients, and the running
    update against flax nn.BatchNorm (momentum 0.9, biased variance)."""
    rng = np.random.default_rng(5)
    N, Cc, Hh, Ww = 6, 4, 5, 5
    x = (rng.standard_normal((N, Cc, Hh, Ww)) * 2 + 1).astype(np.float32)
    w = rng.standard_normal((N, Cc, Hh, Ww)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(Cc)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(Cc)).astype(np.float32)
    ra_mean = rng.uniform(-0.2, 0.2, Cc).astype(np.float32)
    ra_var = rng.uniform(0.5, 1.5, Cc).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean),
                                 "var": jnp.asarray(ra_var)}}
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))          # flax is channels-last
    wh = jnp.asarray(w.transpose(0, 2, 3, 1))

    def f(params, xh):
        y, mut = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xh,
                          mutable=["batch_stats"])
        return jnp.sum(y * wh), (y, mut["batch_stats"])

    (gp, gx), (want, stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], xh)

    port = BatchNorm(Cc, 1e-5, 0.9).train()
    with torch.no_grad():
        port.weight.copy_(_t(scale))
        port.bias.copy_(_t(bias))
        port.running_mean.copy_(_t(ra_mean))
        port.running_var.copy_(_t(ra_var))
    xt = _t(x).requires_grad_(True)
    got = port(xt)
    (got * _t(w)).sum().backward()
    nchw = (0, 3, 1, 2)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want).transpose(nchw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx).transpose(nchw),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.weight.grad.numpy(), np.asarray(gp["scale"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(gp["bias"]),
                               rtol=0, atol=1e-4)


def test_max_pool_tie_gradients_match_stem_max_pool():
    """F.max_pool2d's CPU backward against JAX's stem_max_pool VJP on a
    post-ReLU bf16 input full of ties (exact zeros and small integers):
    both give a window's gradient to its row-major-first maximum."""
    rng = np.random.default_rng(6)
    x = np.maximum(rng.integers(-6, 6, size=(3, 5, 16, 16)), 0).astype(np.float32)
    dy = rng.integers(-8, 8, size=(3, 5, 8, 8)).astype(np.float32)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16)
    y, vjp = jax.vjp(stem_max_pool, xh)
    want = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1), jnp.bfloat16))[0]
    xt = _t(x).bfloat16().requires_grad_(True)
    got = torch.nn.functional.max_pool2d(xt, 3, 2, 1)
    got.backward(_t(dy).bfloat16())
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(y, np.float32).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want, np.float32).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_matches_jax(smoothing):
    rng = np.random.default_rng(7)
    pred = rng.standard_normal((3, 6, 11)).astype(np.float32) * 3
    gold = rng.integers(0, 11, size=(3, 6)).astype(np.int32)
    gold[1, 3:] = IGNORE_ID
    gold[2, 0] = np.argmax(pred[2, 0])      # at least one correct token
    want, want_n = jax_loss.cal_performance(jnp.asarray(pred), jnp.asarray(gold),
                                            smoothing)
    got, got_n = loss.cal_performance(_t(pred), _t(gold).long(), smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert int(got_n) == int(want_n) >= 1
    np.testing.assert_allclose(
        loss.label_smoothed_ce(_t(pred), _t(gold).long(), smoothing).item(),
        float(jax_loss.label_smoothed_ce(jnp.asarray(pred), jnp.asarray(gold),
                                         smoothing)), rtol=1e-6)


@pytest.mark.parametrize("preset", ["sbl", "tiny_test"])
def test_noam_matches_jax(preset):
    c = (C.tiny_test("sbl") if preset == "tiny_test" else C.sbl()).optim
    sched = jax_schedule.noam_schedule(c.k, c.warmup_steps, c.lr_base_dim)
    for step in (0, 1, 2, 19, 20, 21, 3999, 4000, 10 ** 5):
        want = float(sched(jnp.asarray(step, jnp.int32)))
        got = schedule.noam_lr(step, c.k, c.warmup_steps, c.lr_base_dim)
        np.testing.assert_allclose(got, want, rtol=1e-7)


def test_adam_updates_match_optax():
    """Two updates of torch.optim.Adam with the Noam lr set per step, as
    TrainState.apply_gradients does, against optax's Adam + Noam on the
    same gradients (including a zero gradient, a frozen parameter's)."""
    cfg = C.tiny_test("sbl")
    rng = np.random.default_rng(8)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32), np.zeros((4, 3), np.float32)]
    tx = jax_schedule.make_optimizer(cfg.optim)
    params = {"w": jnp.asarray(p0)}
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = optax.apply_updates(params, updates)

    from sbl_for_multilingual_lip_reading_tpu_torch.training.state import TrainState
    model = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        model.weight.copy_(_t(p0))
    state = TrainState(model, schedule.make_optimizer(model, port_config.tiny_test().optim),
                       port_config.tiny_test().optim)
    for g in grads:
        model.weight.grad = _t(g)
        state.apply_gradients()
    assert state.step == 2
    np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(params["w"]),
                               rtol=0, atol=1e-7)
    # the zero gradient still moved the weight: Adam's momentum, as optax
    assert not np.array_equal(np.asarray(params["w"]), p0)


def test_grad_clip_is_not_ported():
    # grad_clip is ported: the optimizer builds, and the clip is optax's
    # clip_by_global_norm on the same gradients, both when it acts and when
    # the norm is below the limit
    import dataclasses
    c = dataclasses.replace(port_config.sbl().optim, grad_clip=1.0)
    layer = torch.nn.Linear(3, 2)
    assert isinstance(schedule.make_optimizer(layer, c), torch.optim.Adam)
    rng = np.random.default_rng(0)
    for scale, max_norm in ((1.0, 0.5), (0.01, 0.5)):
        grads = {"w": rng.standard_normal((2, 3)).astype(np.float32) * scale,
                 "b": rng.standard_normal(2).astype(np.float32) * scale}
        want, _ = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in grads.items()}, None)
        layer.weight.grad = torch.from_numpy(grads["w"].copy())
        layer.bias.grad = torch.from_numpy(grads["b"].copy())
        norm = schedule.clip_by_global_norm_(layer.parameters(), max_norm)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in grads.items()})), rtol=1e-6)
        np.testing.assert_allclose(layer.weight.grad.numpy(), want["w"],
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(layer.bias.grad.numpy(), want["b"],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("variant", ["sbl", "mixed", "random_drop"])
def test_make_train_plans_matches_jax(variant):
    B, T, raw, crop = 5, 30, 96, 88
    kw = {}
    if variant != "sbl":
        lang = np.array([0, 1, 0, 1, 1])
        kw = dict(per_frame_mask=lang == 0,
                  clip_hi=np.where(lang == 0, raw - crop, (raw - crop) // 2))
    if variant == "random_drop":
        kw["random_drop_p"] = 0.2
    want = jax_transforms.make_train_plans(np.random.default_rng(9), B, T, raw,
                                           crop, 0.3, **kw)
    got = make_train_plans(np.random.default_rng(9), B, T, raw, crop, 0.3, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_attach_plans_and_synthetic_dataset_match_jax():
    cfg = C.tiny_test("sbl")
    kw = dict(size=6, frames=cfg.data.frames, raw_size=cfg.data.raw_size, seed=3)
    theirs = jax_synthetic.SyntheticLipDataset(**kw)
    mine = SyntheticLipDataset(**kw)
    batch = {}
    for key in ("clip_u8", "labels", "labels_reverse", "lang_id", "n_frames"):
        batch[key] = np.stack([mine[i][key] for i in range(6)])
        np.testing.assert_array_equal(
            batch[key], np.stack([theirs[i][key] for i in range(6)]))
    want = jax_attach_plans(batch, np.random.default_rng(4), cfg, train=True)
    got = attach_plans(batch, np.random.default_rng(4), port_config.tiny_test())
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("with_n_frames", [False, True])
def test_device_ingest_train_matches_jax(with_n_frames):
    rng = np.random.default_rng(10)
    B, T, raw, crop = 4, 7, 40, 32
    clips = rng.integers(0, 256, size=(B, T, raw, raw), dtype=np.uint8)
    offsets, flip, fmap = make_train_plans(rng, B, T, raw, crop, 0.3)
    assert flip.any() and not flip.all() and (fmap != np.arange(T)).any()
    n_frames = np.array([7, 4, 1, 6], np.int32) if with_n_frames else None
    want = jax_device_ingest(jnp.asarray(clips), jnp.asarray(offsets),
                             jnp.asarray(flip), jnp.asarray(fmap), crop,
                             jnp.float32,
                             n_frames=None if n_frames is None else jnp.asarray(n_frames))
    got = device_ingest(_t(clips), crop, torch.float32,
                        n_frames=None if n_frames is None else _t(n_frames),
                        offsets=_t(offsets), flip=_t(flip), frame_map=_t(fmap))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
