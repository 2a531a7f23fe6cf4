"""CPU parity of one bf16 SBL train step (``config.sbl()``'s compute dtype)
of the PyTorch port against the JAX package.

The setup of ``test_torch_port_train.py`` (tiny dims, dropout 0, the same
weights, batch, plans and teacher-forcing coins) at bf16.  The JAX step
runs its Pallas training attention and frame stack in interpret mode, the
path it takes on the TPU, and XLA is held to the roundings the program
states (``xla_allow_excess_precision`` off), as in
``test_torch_port_recognize.py``.  Where the two round the same values in
another order, bf16 flips one ulp, and the flips spread through the
backward; the tolerances are set from the readings recorded in PERF.md.
The port runs on JAX's ReLU routing, as in ``test_torch_port_train.py``
(``jax_routing_by_value``): in bf16 a ReLU input near 0 may round to the
other side of the kink in one framework, and the step would then compare
two routings as well as two roundings.  The elements on which the port's
own sign disagrees must lie within BF16_FLIP_MARGIN of 0.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu.models import (
    build_model as build_jax_model)
from sbl_for_multilingual_lip_reading_tpu.ops import attention as jax_attention
from sbl_for_multilingual_lip_reading_tpu.ops import stem as jax_stem
from sbl_for_multilingual_lip_reading_tpu.training import schedule as jax_schedule
from sbl_for_multilingual_lip_reading_tpu.training.steps import (
    make_sbl_train_body)
from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import noam_lr
from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
    make_sbl_train_step)
from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
    state_dict_from_jax)

from test_torch_port_train import (JaxReluTap, _assert_flips_within_margin,
                                   _cfg, _jax_coins, _jax_state, _port,
                                   _setup, _torch_batch, jax_routing_by_value)

# readings (PERF.md): the loss 9.9e-4 relative apart, the BN statistics
# 3.4e-4.  Adam's first step moves an element by lr * sign(gradient), so
# an element whose bf16 gradient is near zero may step the other way on one
# side: 1.16% of the elements differ (by 2 lr), the rest by at most 1e-6.
LOSS_RTOL = 5e-3
STAT_ATOL = 2e-3
FLIPPED_MAX = 0.02
# a port ReLU input and the JAX input it is matched with differ by the
# two bf16 forwards' difference, a few bf16 roundings of values up to ~10
# (readings at perturbation seeds 1-24, PERF.md: up to 0.3125); an element
# on which the two disagree in sign (or a max-pool window whose maximum
# they place differently, by the gap between its two candidates) lies
# within that difference of 0 (readings: up to 0.172).  A match with
# another call site, decode step or direction would flip elements far
# from 0.
MATCH_ATOL = 0.5
BF16_FLIP_MARGIN = 0.25


def _bf16_reference():
    """One JAX train step at bf16 on its TPU kernel path, and its inputs."""
    setup = _setup()
    # the production adam_eps: FLIPPED_MAX counts full steps of lr
    cfg = _cfg(compute_dtype="bfloat16", adam_eps=1e-9)
    batch = {k: jnp.asarray(v) for k, v in setup["batches"][0].items()}
    rng = jax.random.PRNGKey(5)
    state = _jax_state(cfg, setup["variables"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_attention, "available", lambda: True)
        for name in ("fused_small_mha_dropout_fwd_flat",
                     "fused_small_mha_dropout_bwd_flat"):
            mp.setattr(jax_attention, name, functools.partial(
                getattr(jax_attention, name), interpret=True))
        mp.setattr(jax_stem, "stack_frames", functools.partial(
            jax_stem.stack_frames, interpret=True))
        model = build_jax_model(cfg)
        body = make_sbl_train_body(model, jax_schedule.make_optimizer(cfg.optim),
                                   cfg)
        tap = JaxReluTap()
        with tap.tracing():
            step = jax.jit(body).lower(state, batch, rng).compile(
                {"xla_allow_excess_precision": False})
        coins = _jax_coins(model, cfg, rng, 0)
        new_state, metrics = step(state, batch, rng)
    want = state_dict_from_jax(*jax.device_get(
        (new_state.params, new_state.batch_stats)))
    return dict(setup=setup, cfg=cfg, coins=coins, loss=float(metrics["loss"]),
                want=want, relu=tap.take_every())


@pytest.fixture(scope="module")
def bf16_step():
    return _bf16_reference()


def test_bf16_train_step_matches_jax(bf16_step):
    cfg = bf16_step["cfg"]
    model, opt = _port(cfg, bf16_step["setup"]["variables"])
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    step = make_sbl_train_step(model, opt, cfg)
    flips = []
    with jax_routing_by_value(bf16_step["relu"], flips, MATCH_ATOL):
        metrics = step(_torch_batch(bf16_step["setup"]["batches"][0]),
                       torch.Generator(), use_gold=bf16_step["coins"])
    _assert_flips_within_margin(flips, BF16_FLIP_MARGIN)
    np.testing.assert_allclose(metrics["loss"].item(), bf16_step["loss"],
                               rtol=LOSS_RTOL)
    lr = noam_lr(0, cfg.optim.k, cfg.optim.warmup_steps, cfg.optim.lr_base_dim)
    sd = model.state_dict()
    diffs = []
    for name, w in bf16_step["want"].items():
        d = np.abs(sd[name].numpy() - w.numpy())
        if "running" in name:
            assert d.max() <= STAT_ATOL, (name, d.max())
        else:
            assert d.max() <= 2 * lr + 1e-6, (name, d.max())
            diffs.append(d.ravel())
    assert (np.concatenate(diffs) > 1e-6).mean() <= FLIPPED_MAX
