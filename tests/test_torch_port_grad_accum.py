"""CPU parity of the SBL decoder's ``grad_accum_bf16`` (the decode steps'
parameter gradients summed in bf16 within each decode segment) against the
JAX package's, at the dims of JAX's own test
(``tests/test_decoder_sbl.py::test_grad_accum_bf16_parity``) and through
one tiny ``make_sbl_train_step`` step.

The decoder cases run the loss mean(logits_l2r^2) + mean(logits_r2l^2) of
a deterministic forward, as JAX's test does.  Tolerances:

* at init in bf16, the switch changes no forward value (the LayerNorm
  weights lie on the bf16 grid), so the logits equal the default's bit for
  bit; every gradient comes back f32, within JAX's bound of the default's
  (||g - g_default|| <= 0.05 ||g_default|| + 1e-6 per leaf);
* against JAX's ``grad_accum_bf16`` decoder in bf16 at init (JAX compiled
  with ``xla_allow_excess_precision`` off, so that it rounds where the
  program says): the two forwards round the same values in another order,
  so bf16 flips an ulp here and there and the flips spread through the
  backward; each leaf within BF16_GRAD_RTOL of JAX's by relative L2.
  Readings: at most 0.103 (layer 0's query projection), as the default
  decoders of the two packages differ (0.102 there);
* with the LayerNorm weights moved off the bf16 grid the switch rounds
  them, as JAX does: in bf16 the logits equal those of the default decoder
  given the rounded LayerNorm weights, bit for bit, and not those of the
  default;
* leaves whose gradient is zero in exact arithmetic (the key projections'
  biases: a softmax does not see a shift of all its scores) hold rounding
  noise only; a leaf under 1e-3 of the largest leaf's norm is left out of
  the relative comparisons;
* the train step (f32, where the switch rounds every weight of a decode
  step to bf16, the LayerNorms' among them, which the test's perturbed
  weights put off the bf16 grid): the port's ``make_sbl_train_step`` step
  against JAX's loss and gradients of that step (its train body's ingest,
  rngs and loss, one compile): the loss within the f32 step test's
  LOSS_RTOL and the gradients within STEP_GRAD_RTOL of JAX's per tensor by
  relative L2 (readings: at most 5.7e-4, the last layer's w_2 bias; an f32
  difference may flip a bf16 rounding of the sums); on JAX's ReLU routing,
  as ``test_torch_port_train.py``.  Adam's update is the default's, held
  by the f32 step tests there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu.models.decoder_sbl import (
    SBLDecoder as JaxSBLDecoder)
from sbl_for_multilingual_lip_reading_tpu.vocab import IGNORE_ID
from sbl_for_multilingual_lip_reading_tpu_torch.models.decoder_sbl import (
    SBLDecoder)
from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
    make_sbl_train_step)
from sbl_for_multilingual_lip_reading_tpu_torch.utils import state_dict_from_jax

from sbl_for_multilingual_lip_reading_tpu.models import (
    build_model as build_jax_model)
from sbl_for_multilingual_lip_reading_tpu.training.loss import (
    cal_performance as jax_cal_performance)
from sbl_for_multilingual_lip_reading_tpu.training.steps import (
    _ingest_train as jax_ingest_train)
from test_torch_port_train import (LOSS_RTOL, _assert_flips_within_margin,
                                   _cfg, _compiled, _jax_coins, _port, _setup,
                                   _torch_batch, jax_routing_by_value)

V, DM, T_ENC, MAXLEN = 12, 32, 5, 6
KW = dict(vocab_size=V, d_model=DM, n_layers=2, n_head=4, d_k=8, d_v=8,
          d_inner=64, dropout=0.0, maxlen=MAXLEN, fusion_mode="symmetric",
          teacher_forcing_rate=1.0, decode_segments=4)
DEFAULT_RTOL = 0.05
BF16_GRAD_RTOL = 0.15
BF16_LOGIT_ATOL = 0.0625
STEP_GRAD_RTOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ln_off_grid(params, rng):
    """LayerNorm scales and biases moved by N(0, 0.1): f32 values off the
    bf16 grid."""
    def move(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = move(v, path + (k,))
            elif "layer_norm" in path:
                out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out
    return move(params)


def _jax_side():
    """JAX's inputs, init parameters (and a copy with the LayerNorm weights
    off the bf16 grid), and its grad_accum_bf16 decoder's logits and
    gradients in bf16 on the init parameters."""
    key = jax.random.PRNGKey(0)
    enc = jax.random.normal(key, (2, T_ENC, DM))
    labels = jnp.array([[3, 4, 5, IGNORE_ID], [6, 7, IGNORE_ID, IGNORE_ID]], jnp.int32)
    labels_r = jnp.array([[5, 4, 3, IGNORE_ID], [7, 6, IGNORE_ID, IGNORE_ID]],
                         jnp.int32)
    init = jax.jit(lambda: JaxSBLDecoder(dtype=jnp.bfloat16, **KW).init(
        {"params": key, "dropout": key, "teacher": key}, labels, labels_r, enc,
        deterministic=True))()
    params = {"init": jax.device_get(init["params"])}
    params["off_grid"] = _ln_off_grid(params["init"], np.random.default_rng(3))
    out = {}
    for name, dtype, case in (("bfloat16", jnp.bfloat16, "init"),):
        dec = JaxSBLDecoder(grad_accum_bf16=True, dtype=dtype, **KW)

        def loss(p, dec=dec):
            lg_l2r, _, lg_r2l, _ = dec.apply({"params": p}, labels, labels_r,
                                             enc, deterministic=True)
            return jnp.mean(lg_l2r ** 2) + jnp.mean(lg_r2l ** 2), lg_l2r
        p = params[case]
        fn = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(p).compile(
            {"xla_allow_excess_precision": False})
        (_, lg), g = fn(p)
        out[name] = dict(case=case, logits=np.asarray(lg.astype(jnp.float32)),
                         grads=state_dict_from_jax(jax.device_get(g)))
    return dict(enc=np.array(enc), labels=np.array(labels),
                labels_r=np.array(labels_r), params=params, out=out)


@pytest.fixture(scope="module")
def jax_side():
    return _jax_side()


def _decoder(params, grad_accum, remat=True, round_ln=False,
             dtype=torch.bfloat16):
    dec = SBLDecoder(dtype=dtype, use_kernels=False, remat=remat,
                     grad_accum_bf16=grad_accum, **KW)
    sd = state_dict_from_jax(params)
    if round_ln:
        sd = {k: v.to(torch.bfloat16).float() if "layer_norm" in k else v
              for k, v in sd.items()}
    dec.load_state_dict(sd)
    return dec


def _run(dec, side):
    lg_l2r, _, lg_r2l, _ = dec(torch.from_numpy(side["enc"]),
                               torch.from_numpy(side["labels"]).long(),
                               torch.from_numpy(side["labels_r"]).long())
    loss = (lg_l2r ** 2).mean() + (lg_r2l ** 2).mean()
    loss.backward()
    return lg_l2r.detach(), {n: p.grad for n, p in dec.named_parameters()}


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


def test_at_init_logits_equal_the_default_and_gradients_are_f32(jax_side):
    lg1, g1 = _run(_decoder(jax_side["params"]["init"], True), jax_side)
    lg0, g0 = _run(_decoder(jax_side["params"]["init"], False), jax_side)
    assert torch.equal(lg1, lg0)
    assert set(g1) == set(g0)
    for name in g0:
        assert g1[name].dtype == torch.float32
        assert ((g1[name] - g0[name]).norm()
                <= DEFAULT_RTOL * g0[name].norm() + 1e-6), name
    # the bf16 sums are not the default's f32 ones
    assert any(not torch.equal(g1[n], g0[n]) for n in g0)


def _leaf_errors(got, want):
    """Per leaf ||got - want|| / ||want||, leaving out the leaves under 1e-3
    of the largest leaf's norm."""
    floor = 1e-3 * max(w.norm().item() for w in want.values())
    return {n: _rel(g, want[n]) for n, g in got.items()
            if want[n].norm().item() >= floor}


@pytest.mark.parametrize("dtype,rtol,logit_atol", [
    ("bfloat16", BF16_GRAD_RTOL, BF16_LOGIT_ATOL)])
def test_gradients_match_jax_grad_accum(jax_side, dtype, rtol, logit_atol):
    want = jax_side["out"][dtype]
    lg, grads = _run(_decoder(jax_side["params"][want["case"]], True,
                              dtype=getattr(torch, dtype)), jax_side)
    np.testing.assert_allclose(lg.float().numpy(), want["logits"], atol=logit_atol)
    assert set(grads) == set(want["grads"])
    errs = _leaf_errors(grads, want["grads"])
    assert len(errs) >= len(grads) - 6
    worst = max(errs, key=errs.get)
    assert errs[worst] <= rtol, (worst, errs[worst])


def test_layer_norm_weights_are_rounded_as_jax_rounds_them(jax_side):
    params = jax_side["params"]["off_grid"]
    with torch.no_grad():
        side = {k: torch.from_numpy(jax_side[k]) for k in ("enc", "labels", "labels_r")}
        args = (side["enc"], side["labels"].long(), side["labels_r"].long())
        default = _decoder(params, False)(*args)[0]
        rounded = _decoder(params, False, round_ln=True)(*args)[0]
    with torch.enable_grad():
        switched = _decoder(params, True)(*args)[0].detach()
    assert torch.equal(switched, rounded)
    assert not torch.equal(switched, default)


def test_remat_on_equals_remat_off(jax_side):
    params = jax_side["params"]["off_grid"]
    lg_on, g_on = _run(_decoder(params, True, remat=True), jax_side)
    lg_off, g_off = _run(_decoder(params, True, remat=False), jax_side)
    assert torch.equal(lg_on, lg_off)
    assert all(torch.equal(g_on[n], g_off[n]) for n in g_on)


def _jax_loss_and_grads(cfg, variables, batch, rng=jax.random.PRNGKey(5)):
    """The loss of JAX's train step 0 and its gradients, as
    ``make_sbl_train_body`` forms them, in the port's naming, with its ReLU
    inputs and the step's coins."""
    model = build_jax_model(cfg)
    drop_rng, teach_rng = jax.random.split(jax.random.fold_in(rng, 0))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        video = jax_ingest_train(batch, cfg.data.crop_size,
                                 jnp.dtype(cfg.compute_dtype))
        out, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            video, batch["labels"], batch["labels_reverse"], train=True,
            rngs={"dropout": drop_rng, "teacher": teach_rng},
            mutable=["batch_stats"])
        p_l2r, g_l2r, p_r2l, g_r2l = out
        smoothing = cfg.optim.label_smoothing
        return 0.5 * (jax_cal_performance(p_l2r, g_l2r, smoothing)[0]
                      + jax_cal_performance(p_r2l, g_r2l, smoothing)[0])

    compiled, tap = _compiled(jax.jit(jax.value_and_grad(loss_fn)),
                              (cfg, "loss_and_grads"), variables["params"])
    loss, grads = jax.device_get(compiled(variables["params"]))
    return dict(loss=float(loss), grads=state_dict_from_jax(grads),
                relu=tap.take_every(), coins=_jax_coins(model, cfg, rng, 0))


@pytest.fixture(scope="module")
def step_side():
    setup = _setup()
    base = _cfg()
    cfg = dataclasses.replace(base, decoder=dataclasses.replace(
        base.decoder, grad_accum_bf16=True))
    return dict(setup=setup, cfg=cfg, **_jax_loss_and_grads(
        cfg, setup["variables"], setup["batches"][0]))


def test_train_step_matches_jax(step_side):
    """One f32 ``sbl`` train step with ``cfg.decoder.grad_accum_bf16``,
    dropout 0 and JAX's coins: its loss and step-0 gradients against
    JAX's."""
    cfg, setup = step_side["cfg"], step_side["setup"]
    model, opt = _port(cfg, setup["variables"])
    assert model.decoder.grad_accum_bf16
    step = make_sbl_train_step(model, opt, cfg)
    flips = []
    with jax_routing_by_value(step_side["relu"], flips):
        metrics = step(_torch_batch(setup["batches"][0]), torch.Generator(),
                       use_gold=step_side["coins"])
    _assert_flips_within_margin(flips)
    np.testing.assert_allclose(metrics["loss"].item(), step_side["loss"],
                               rtol=LOSS_RTOL)
    errs = _leaf_errors({n: p.grad for n, p in model.named_parameters()},
                        step_side["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STEP_GRAD_RTOL, (worst, errs[worst])
