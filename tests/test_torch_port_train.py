"""CPU parity of the PyTorch port's SBL train step against the JAX package.

``config.tiny_test("sbl")`` with dropout 0 (the masks cannot match: JAX
draws them from its own PRNG), its variables moved off their initial
values and carried into the port with ``state_dict_from_jax``, the same
synthetic batches and augmentation plans on both sides, and the
teacher-forcing coins injected: JAX's ``use_gold`` is derived from the step
rng exactly as ``training/steps.py`` and ``SBLDecoder.__call__`` derive it,
and handed to the port.  Both sides run in f32; the JAX model takes its XLA
path on the CPU (its Pallas kernels need a TPU or interpret mode), the
port its kernels' plain versions.

Tolerances, from the readings in PERF.md.  The loss agrees to a relative
1.2e-6 over three steps, the BN statistics to 1e-5.  Parameters move by
Adam's lr * m / (sqrt(v) + eps), about lr per step whatever the gradient's
size, so an element whose gradient is rounding noise (the key projections'
biases, whose gradient is zero in exact arithmetic since a softmax does not
see a shift of all its scores, and a few others near zero) takes a step of
up to lr in a sign that differs between the two frameworks; once such a
step lands in the frontend, later gradients differ a little everywhere.  So
every element must lie within 2 * (sum of the lrs), plus 1e-6 for
rounding, and 99% of them within
PARAM_P99_ATOL (readings: 99th percentile at most 5.4e-6 at step 3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu import config as C
from sbl_for_multilingual_lip_reading_tpu.data.synthetic import (
    SyntheticLipDataset)
from sbl_for_multilingual_lip_reading_tpu.models import (
    build_model as build_jax_model)
from sbl_for_multilingual_lip_reading_tpu.training import schedule as jax_schedule
from sbl_for_multilingual_lip_reading_tpu.training.state import (
    TrainState as JaxTrainState)
from sbl_for_multilingual_lip_reading_tpu.training.steps import (
    make_sbl_train_step as make_jax_step)
from sbl_for_multilingual_lip_reading_tpu.training.trainer import (
    attach_plans as jax_attach_plans)
from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
    make_optimizer, noam_lr)
from sbl_for_multilingual_lip_reading_tpu_torch.training.state import TrainState
from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
    make_sbl_train_step)
from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
    state_dict_from_jax)

from test_torch_port_recognize import _perturbed

N_STEPS = 3
BATCH = 3
LOSS_RTOL = 1e-5
PARAM_P99_ATOL = 1e-5
STAT_ATOL = 5e-5
FUSION_MODES = ("symmetric", "reference_aliased")
FROZEN = ("frontend", "encoder")


def _cfg(fusion_mode="symmetric", **kw):
    cfg = C.tiny_test("sbl")
    return dataclasses.replace(
        cfg, dims=dataclasses.replace(cfg.dims, dropout=0.0),
        frontend=dataclasses.replace(cfg.frontend, dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, fusion_mode=fusion_mode), **kw)


def _setup():
    """Perturbed tiny variables and N_STEPS batches with their plans."""
    cfg = _cfg()
    T, raw, crop = cfg.data.frames, cfg.data.raw_size, cfg.data.crop_size
    key = jax.random.PRNGKey(0)
    labels = jnp.zeros((2, cfg.decoder.target_pad_len), jnp.int32)
    variables = jax.device_get(jax.jit(lambda: build_jax_model(cfg).init(
        {"params": key, "dropout": key, "teacher": key},
        jnp.zeros((2, T, crop, crop)), labels, labels, train=False))())
    variables = _perturbed(variables, np.random.default_rng(1))
    data = SyntheticLipDataset(size=N_STEPS * BATCH, frames=T, raw_size=raw,
                               seed=2)
    plan_rng = np.random.default_rng(3)
    batches = []
    for s in range(N_STEPS):
        samples = [data[i] for i in range(s * BATCH, (s + 1) * BATCH)]
        batch = {k: np.stack([x[k] for x in samples]) for k in samples[0]}
        batches.append(jax_attach_plans(batch, plan_rng, cfg, train=True))
    return dict(variables=variables, batches=batches)


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _jax_coins(model, cfg, rng, step):
    """The step's teacher-forcing coins, derived as JAX's train step and
    decoder derive them."""
    _, teach = jax.random.split(jax.random.fold_in(rng, step))
    return np.asarray(model.apply(
        {}, rngs={"teacher": teach}, method=lambda m: jax.random.bernoulli(
            m.decoder.make_rng("teacher"), cfg.decoder.teacher_forcing_rate,
            (cfg.decoder.maxlen,))))


@functools.lru_cache(maxsize=None)
def _jax_step(cfg):
    """(model, jitted train step) per config: each compiles once."""
    model = build_jax_model(cfg)
    return model, make_jax_step(model, jax_schedule.make_optimizer(cfg.optim), cfg)


def _jax_steps(cfg, state, batches, rng=jax.random.PRNGKey(5)):
    """Run JAX's jitted train step over ``batches``; per step the coins,
    loss and the params/batch_stats after it (in the port's naming)."""
    model, step = _jax_step(cfg)
    out = []
    for batch in batches:
        coins = _jax_coins(model, cfg, rng, int(state.step))
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              rng)
        out.append(dict(coins=coins, loss=float(metrics["loss"]),
                        sd=state_dict_from_jax(*jax.device_get(
                            (state.params, state.batch_stats)))))
    return state, out


def _jax_state(cfg, variables):
    tx = jax_schedule.make_optimizer(cfg.optim)
    return JaxTrainState.create(variables["params"], variables["batch_stats"], tx)


def _port(cfg, variables):
    model = build_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    return model, make_optimizer(model, cfg.optim)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_step_matches(model, got_loss, want, lr_sum):
    np.testing.assert_allclose(got_loss, want["loss"], rtol=LOSS_RTOL)
    sd = model.state_dict()
    diffs = []
    for name, w in want["sd"].items():
        d = np.abs(sd[name].numpy() - w.numpy())
        if "running" in name:
            assert d.max() <= STAT_ATOL, (name, d.max())
        else:
            assert d.max() <= 2 * lr_sum + 1e-6, (name, d.max())
            diffs.append(d.ravel())
    assert np.percentile(np.concatenate(diffs), 99) <= PARAM_P99_ATOL


@pytest.fixture(scope="module", params=FUSION_MODES)
def three_steps(request, setup):
    cfg = _cfg(request.param)
    _, want = _jax_steps(cfg, _jax_state(cfg, setup["variables"]),
                         setup["batches"])
    return cfg, want


def test_three_train_steps_match_jax(setup, three_steps):
    cfg, want = three_steps
    # the coins differ between steps: teacher forcing is exercised both ways
    coins = np.stack([w["coins"] for w in want])
    assert coins.any() and not coins.all()
    model, opt = _port(cfg, setup["variables"])
    step = make_sbl_train_step(model, opt, cfg)
    lr_sum = 0.0
    for i, (batch, w) in enumerate(zip(setup["batches"], want)):
        lr_sum += noam_lr(i, cfg.optim.k, cfg.optim.warmup_steps,
                          cfg.optim.lr_base_dim)
        metrics = step(_torch_batch(batch), torch.Generator().manual_seed(i),
                       use_gold=w["coins"])
        _assert_step_matches(model, metrics["loss"].item(), w, lr_sum)
    assert step.state.step == N_STEPS


def test_frozen_prefix_step_matches_jax(setup):
    """One unfrozen step, then one with frontend and encoder frozen: their
    gradients are zeroed (not dropped), so Adam's momentum still moves
    them, on both sides."""
    cfg = _cfg()
    frozen_cfg = dataclasses.replace(cfg, freeze_prefixes=FROZEN)
    state = _jax_state(cfg, setup["variables"])
    state, want = _jax_steps(cfg, state, setup["batches"][:1])
    _, want_frozen = _jax_steps(frozen_cfg, state, setup["batches"][1:2])

    model, opt = _port(cfg, setup["variables"])
    make_sbl_train_step(model, opt, cfg)(
        _torch_batch(setup["batches"][0]), torch.Generator(),
        use_gold=want[0]["coins"])
    step = make_sbl_train_step(model, opt, frozen_cfg)
    step.state.step = 1
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = step(_torch_batch(setup["batches"][1]), torch.Generator(),
                   use_gold=want_frozen[0]["coins"])
    lr_sum = sum(noam_lr(i, cfg.optim.k, cfg.optim.warmup_steps,
                         cfg.optim.lr_base_dim) for i in range(2))
    _assert_step_matches(model, metrics["loss"].item(), want_frozen[0], lr_sum)
    for name, p in model.named_parameters():
        if name.split(".")[0] in FROZEN:
            assert not p.grad.any(), name
        assert not torch.equal(before[name], p.detach()), name


def test_parameters_stay_f32_and_take_sub_ulp_updates():
    """At bf16 compute every parameter and BN statistic is stored in f32,
    as flax stores them, and casts where it is used: an Adam update far
    below one bf16 ulp of the weight (the Noam lr of step 1 is ~3.5e-8)
    moves it as optax moves JAX's."""
    cfg = dataclasses.replace(port_config.tiny_test(), compute_dtype="bfloat16")
    model = build_model(cfg, "cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    w = model.encoder.linear_in.weight
    before = w.detach().clone()
    grad = np.random.default_rng(9).standard_normal(tuple(w.shape)).astype(np.float32)
    optim = port_config.sbl().optim
    tx = jax_schedule.make_optimizer(C.sbl().optim)
    updates, _ = tx.update({"w": jnp.asarray(grad)},
                           tx.init({"w": jnp.asarray(before.numpy())}))
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    w.grad = torch.from_numpy(grad)
    TrainState(model, make_optimizer(model, optim), optim).apply_gradients()
    got = w.detach().numpy()
    want = np.asarray(optax.apply_updates({"w": jnp.asarray(before.numpy())},
                                          updates)["w"])
    # the same f32 weights, but for a last-bit rounding of the update
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    # every update is far below half a bf16 ulp of its weight, so a bf16
    # parameter would not have moved at all; this f32 one moved everywhere
    moved = got - before.numpy()
    assert (moved != 0).all()
    assert (np.abs(moved) < np.abs(before.numpy()) * 2.0 ** -9).all()
