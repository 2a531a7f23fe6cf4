"""CPU parity of the port's unidirectional training (``lrw``, ``lrw1000``)
against the JAX package: the train step, the dropout of the training
forward, ``Trainer.fit`` and ``cli train`` / ``cli test``.

``config.tiny_test("lrw1000")`` / ``("lrw")`` with dropout 0 (JAX draws its
masks from its own PRNG), variables moved off their initial values and
carried into the port with ``state_dict_from_jax``, the same synthetic
batches and augmentation plans on both sides (the LRW protocol for ``lrw``:
per-clip crops and RandomDrop, no FrameRemoval).  As in
``test_torch_port_train.py``, every JAX train step is compiled with
``xla_cpu_use_fusion_emitters=False`` and both sides run with
``adam_eps=1e-6`` (see that file for why), and the tolerances are its own:
the loss within 1e-5 relative, the BN statistics within 5e-5, 99% of the
parameters within 1e-5 and every one within 2 x (sum of lrs) + 1e-6, the
gradients of step 0 within 5e-5 x max|g| + 1e-7 per tensor.  Readings are
in PERF.md ("CPU readings").

The ReLUs' kinks.  The two frameworks' f32 forwards differ by up to
~2.6e-5 at the ReLU inputs (BatchNorm's batch statistics in another
summation order), and an element that close to 0 can take the ReLU's other
branch on one side: that routes one token's gradient differently and moves
the encoder's and the frontend's gradients by 1-4% of their largest
element.  Which elements flip depends on the CPU's summation order, so the
step and gradient tests run the port on JAX's routing (``jax_routing``:
each ReLU passes x where JAX's input was > 0, JAX's inputs carried out of
its compiled step by ``JaxReluTap``) and check that every element on which
the two disagree at step 0 lies within FLIP_MARGIN of 0 (later steps start
from weights that differ within the parameter tolerance, which their own
checks bound).  With that, perturbation seeds 1-24 all pass (readings in
PERF.md).  The Trainer runs 2 epochs x 2 steps with a validation after
each: epoch losses within 1e-5 relative, WER/PER equal.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu import config as C
from sbl_for_multilingual_lip_reading_tpu.data.synthetic import (
    SyntheticLipDataset as JaxSynthetic)
from sbl_for_multilingual_lip_reading_tpu.models import (
    build_model as build_jax_model)
from sbl_for_multilingual_lip_reading_tpu.training import schedule as jax_schedule
from sbl_for_multilingual_lip_reading_tpu.training import steps as jax_steps
from sbl_for_multilingual_lip_reading_tpu.training import trainer as jax_trainer
from sbl_for_multilingual_lip_reading_tpu.training.loss import (
    cal_performance as jax_cal_performance)
from sbl_for_multilingual_lip_reading_tpu.training.state import (
    TrainState as JaxTrainState)
from sbl_for_multilingual_lip_reading_tpu_torch import cli, ops
from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
from sbl_for_multilingual_lip_reading_tpu_torch.models import (
    build_model, layers, random_layout)
from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import (
    DropoutRNG, step_random)
from sbl_for_multilingual_lip_reading_tpu_torch.training import checkpoint as ckpt
from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
    make_optimizer, noam_lr)
from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
    expected_launches, make_uni_train_step)
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
from sbl_for_multilingual_lip_reading_tpu_torch.utils import state_dict_from_jax

from test_torch_port_recognize import _perturbed
from test_torch_port_train import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL,
                                   TEST_ADAM_EPS, XLA_OPTIONS, JaxReluTap,
                                   _assert_flips_within_margin,
                                   _assert_step_matches, _torch_batch,
                                   jax_routing)

BATCH = 3
STEPS = {"lrw1000": 3, "lrw": 1}
EPOCHS, EPOCH_STEPS = 2, 2
DROPOUT = 0.3
PERTURB_SEED = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _deterministic(cfg, **dims):
    return dataclasses.replace(
        cfg, dims=dataclasses.replace(cfg.dims, dropout=0.0, **dims),
        frontend=dataclasses.replace(cfg.frontend, dropout=0.0),
        optim=dataclasses.replace(cfg.optim, adam_eps=TEST_ADAM_EPS))


def _init_variables(cfg, seed):
    T, crop = cfg.data.frames, cfg.data.crop_size
    key = jax.random.PRNGKey(0)
    labels = jnp.zeros((2, cfg.decoder.target_pad_len), jnp.int32)
    variables = jax.device_get(jax.jit(lambda: build_jax_model(cfg).init(
        {"params": key, "dropout": key}, jnp.zeros((2, T, crop, crop)), labels,
        train=False))())
    return _perturbed(variables, np.random.default_rng(seed))


def _batches(cfg, name, n):
    data = JaxSynthetic(size=n * BATCH, frames=cfg.data.frames,
                        raw_size=cfg.data.raw_size, kind=name, vocab=name, seed=2)
    plan_rng = np.random.default_rng(3)
    out = []
    for s in range(n):
        samples = [data[i] for i in range(s * BATCH, (s + 1) * BATCH)]
        batch = {k: np.stack([x[k] for x in samples]) for k in samples[0]}
        out.append(jax_trainer.attach_plans(batch, plan_rng, cfg, train=True))
    return out


def _port(cfg, variables):
    model = build_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    return model, make_optimizer(model, cfg.optim)


@pytest.fixture(scope="module", params=list(STEPS))
def jax_steps_run(request):
    """JAX's uni train step over the workload's batches (one compile); per
    step the loss and the variables after it, in the port's naming."""
    name = request.param
    cfg = _deterministic(C.tiny_test(name))
    variables = _init_variables(cfg, PERTURB_SEED)
    batches = _batches(cfg, name, STEPS[name])
    tx = jax_schedule.make_optimizer(cfg.optim)
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
    step = jax_steps.make_uni_train_step(build_jax_model(cfg), tx, cfg)
    rng = jax.random.PRNGKey(5)
    compiled, want, tap = None, [], JaxReluTap()
    for batch in batches:
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        if compiled is None:
            with tap.tracing():
                compiled = step.lower(state, batch, rng).compile(XLA_OPTIONS)
        state, metrics = compiled(state, batch, rng)
        want.append(dict(loss=float(metrics["loss"]),
                         n_correct=int(metrics["n_correct"]),
                         relu=tap.take(),
                         sd=state_dict_from_jax(*jax.device_get(
                             (state.params, state.batch_stats)))))
    return dict(name=name, cfg=cfg, variables=variables, batches=batches,
                want=want)


def test_uni_train_steps_match_jax(jax_steps_run):
    """Three ``lrw1000`` steps and one ``lrw`` step: loss, BN statistics and
    parameters after each, against JAX's ``make_uni_train_step``, each step
    on JAX's ReLU routing (``jax_routing``)."""
    cfg, want = jax_steps_run["cfg"], jax_steps_run["want"]
    model, opt = _port(cfg, jax_steps_run["variables"])
    step = make_uni_train_step(model, opt, cfg)
    lr_sum, flips = 0.0, []
    for i, (batch, w) in enumerate(zip(jax_steps_run["batches"], want)):
        lr_sum += noam_lr(i, cfg.optim.k, cfg.optim.warmup_steps,
                          cfg.optim.lr_base_dim)
        flips.append([])
        with jax_routing(w["relu"], flips[-1]):
            metrics = step(_torch_batch(batch), torch.Generator().manual_seed(i))
        assert set(metrics) == {"loss", "n_correct"}
        assert int(metrics["n_correct"]) == w["n_correct"]
        _assert_step_matches(model, metrics["loss"].item(), w, lr_sum)
    assert step.state.step == len(want)
    _assert_flips_within_margin(flips[0])


def test_uni_step_gradients_match_jax(jax_steps_run):
    """The backward itself: every parameter's gradient of step 0 against
    JAX's gradient of the loss ``make_uni_train_body`` forms, per tensor,
    on JAX's ReLU routing."""
    cfg, variables = jax_steps_run["cfg"], jax_steps_run["variables"]
    batch = {k: jnp.asarray(v) for k, v in jax_steps_run["batches"][0].items()}
    model = build_jax_model(cfg)

    def loss_fn(params):
        video = jax_steps._ingest_train(batch, cfg.data.crop_size, jnp.float32)
        (pred, gold), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            video, batch["labels"], train=True,
            rngs={"dropout": jax.random.PRNGKey(5)}, mutable=["batch_stats"])
        return jax_cal_performance(pred, gold, cfg.optim.label_smoothing)[0]

    tap, flips = JaxReluTap(), []
    with tap.tracing():
        grad = jax.jit(jax.grad(loss_fn)).lower(variables["params"]).compile(
            XLA_OPTIONS)
    want = state_dict_from_jax(jax.device_get(grad(variables["params"])))
    port, opt = _port(cfg, variables)
    with jax_routing(tap.take(), flips):
        make_uni_train_step(port, opt, cfg)(
            _torch_batch(jax_steps_run["batches"][0]), torch.Generator())
    _assert_flips_within_margin(flips)
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(grads) == set(want)
    for n, g in grads.items():
        w = want[n].numpy()
        bound = GRAD_RTOL * np.abs(w).max() + GRAD_ATOL
        assert np.abs(g - w).max() <= bound, (n, np.abs(g - w).max(), bound)


def test_uni_step_calls_the_training_kernels_as_counted(monkeypatch):
    """On the kernel path every attention of the step (encoder layers, and
    the decoder's self and cross attention per layer, in one parallel pass)
    goes through the K3 and K4 wrappers, as ``expected_launches`` counts."""
    from sbl_for_multilingual_lip_reading_tpu_torch.ops import attention
    cfg = port_config.tiny_test("lrw1000")
    calls = dict.fromkeys(expected_launches(cfg), 0)
    for module, name in ((attention, "small_mha_dropout_fwd_flat"),
                         (attention, "small_mha_dropout_bwd_flat"),
                         (layers, "small_mha_flat")):
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    model = build_model(cfg, "cpu")
    batch = _torch_batch(_batches(cfg, "lrw1000", 1)[0])
    make_uni_train_step(model, make_optimizer(model, cfg.optim), cfg)(
        batch, torch.Generator().manual_seed(0))
    want = expected_launches(cfg)
    for name in ("small_mha_dropout_fwd_flat", "small_mha_dropout_bwd_flat",
                 "small_mha_flat"):
        assert calls[name] == want[name], name
    assert want["small_mha_dropout_fwd_flat"] == (cfg.dims.n_enc_layers
                                                  + 2 * cfg.dims.n_dec_layers)


def test_decoder_dropout_is_drawn_as_in_jax():
    """``UniDecoder.forward`` with the step's random numbers drops as JAX's
    does with ``deterministic=False``: every elementwise mask (embedding,
    each attention's output, each FFN) keeps 1 - rate of its elements; each
    attention draws one seed for its probabilities; the same seed gives the
    same logits, another seed others; without an rng the forward is
    deterministic and equals the one at rate 0 with an rng."""
    cfg = port_config.tiny_test("lrw1000")
    cfg = dataclasses.replace(cfg, dims=dataclasses.replace(cfg.dims,
                                                            dropout=DROPOUT))
    dec = build_model(cfg, "cpu").decoder.train()
    rng = np.random.default_rng(4)
    labels = torch.from_numpy(rng.integers(2, 48, size=(32, 14)).astype(np.int64))
    enc = torch.from_numpy(rng.standard_normal((32, 30, 64)).astype(np.float32))
    kept, seeds = [], []
    keep, seed = DropoutRNG.keep, DropoutRNG.seed

    def rng_of(s):
        return DropoutRNG(step_random(s, random_layout(dec), "cpu"), "cpu")

    def spy_keep(self, shape, rate, *batch_dim):
        mask = keep(self, shape, rate, *batch_dim)
        kept.append((rate, mask.float().mean().item(), mask.numel()))
        return mask

    def spy_seed(self):
        seeds.append(seed(self))
        return seeds[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DropoutRNG, "keep", spy_keep)
        mp.setattr(DropoutRNG, "seed", spy_seed)
        a, gold = dec(labels, enc, rng=rng_of(7))
    L = cfg.dims.n_dec_layers
    # embedding, then per layer the self and cross attention outputs and FFN
    assert len(kept) == 1 + 3 * L and {r for r, _, _ in kept} == {DROPOUT}
    total = sum(n for _, _, n in kept)
    frac = sum(f * n for _, f, n in kept) / total
    assert abs(frac - (1 - DROPOUT)) < 4 * np.sqrt(DROPOUT * (1 - DROPOUT) / total)
    assert len(seeds) == 2 * L and len({int(s) for s in seeds}) == 2 * L
    b, _ = dec(labels, enc, rng=rng_of(7))
    c, _ = dec(labels, enc, rng=rng_of(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    d1, g1 = dec(labels, enc)
    d2, _ = dec(labels, enc)
    assert torch.equal(d1, d2) and torch.equal(gold, g1)
    dec.dropout = 0.0
    for m in dec.modules():
        if hasattr(m, "dropout") and isinstance(m.dropout, float):
            m.dropout = 0.0
    e, _ = dec(labels, enc, rng=rng_of(7))
    np.testing.assert_allclose(e.detach().numpy(), d1.detach().numpy(), atol=1e-6)


# ------------------------------------------------- the slice as a whole
class _ExactStep:
    """A jitted JAX step compiled with XLA_OPTIONS where the JAX Trainer
    compiles it (``GuardedTrainStep`` lowers and compiles it itself)."""

    def __init__(self, jitted):
        self.jitted = jitted

    def lower(self, *args):
        lowered = self.jitted.lower(*args)
        return types.SimpleNamespace(compile=lambda: lowered.compile(XLA_OPTIONS))

    def __call__(self, *args):
        return self.lower(*args).compile()(*args)


def _trainer_cfg(name="lrw1000"):
    # one encoder and one decoder layer: half the JAX step to compile
    return _deterministic(C.tiny_test(name), n_enc_layers=1, n_dec_layers=1)


def _trainer_data(cls, name):
    kw = dict(frames=30, raw_size=40, kind=name, vocab=name)
    return cls(size=5, seed=2, **kw), {name: cls(size=4, seed=4, **kw)}


@pytest.fixture(scope="module")
def jax_fit():
    """Two epochs of two steps of JAX's Trainer on ``lrw1000``, each
    followed by a validation; its starting variables."""
    cfg = _trainer_cfg()
    train, valid = _trainer_data(JaxSynthetic, "lrw1000")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "make_uni_train_step",
                   lambda *a, **k: _ExactStep(jax_steps.make_uni_train_step(*a, **k)))
        tr = jax_trainer.Trainer(cfg, train, valid)
    variables = _perturbed({"params": jax.device_get(tr.state.params),
                            "batch_stats": jax.device_get(tr.state.batch_stats)},
                           np.random.default_rng(11))
    tr.state = tr.state.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"])
    losses, evals = [], []
    for epoch in range(EPOCHS):
        losses.append(tr.train_epoch(epoch, max_steps=EPOCH_STEPS))
        evals.append({k: tr.validate_seq2seq(ds) for k, ds in valid.items()})
    return dict(variables=variables, losses=losses, evals=evals)


def test_trainer_fit_matches_jax(jax_fit):
    """``Trainer.fit`` over 2 epochs x 2 steps: each epoch's mean loss, and
    WER/PER after each epoch (``fit`` returns the last), against JAX's."""
    cfg = _trainer_cfg()
    train, valid = _trainer_data(SyntheticLipDataset, "lrw1000")
    tr = Trainer(cfg, train, valid, device="cpu")
    tr.model.load_state_dict(state_dict_from_jax(
        jax_fit["variables"]["params"], jax_fit["variables"]["batch_stats"]))
    for epoch in range(EPOCHS):
        out = tr.fit(epoch + 1, max_steps_per_epoch=EPOCH_STEPS, start_epoch=epoch)
        np.testing.assert_allclose(out["train_loss"], jax_fit["losses"][epoch],
                                   rtol=LOSS_RTOL)
        assert {k: v for k, v in out.items() if k != "train_loss"} == \
            jax_fit["evals"][epoch]
    assert tr.state.step == EPOCHS * EPOCH_STEPS


def test_cli_train_then_test_a_unidirectional_workload(tmp_path, monkeypatch):
    """``cli train --cpu --workload lrw1000`` (2 steps, a validation, the
    checkpoint and its _best mirror), a resume that takes one more step,
    then ``cli test`` on the checkpoint: its WER/PER equal the trained
    model's own validation of the test split."""
    monkeypatch.setitem(port_config.PRESETS, "lrw1000",
                        lambda: port_config.tiny_test("lrw1000"))
    save = str(tmp_path / "ckpt")
    common = ["--cpu", "--workload", "lrw1000", "--synthetic",
              "--synthetic-size", "4", "--max-eval-batches", "1"]
    ops.reset_launch_counts()
    tr, out = cli.run_train(common + ["--epochs", "1", "--max-steps-per-epoch",
                                      "2", "--save-dir", save])
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    assert tr.state.step == 2 and np.isfinite(out["train_loss"])
    assert set(out) == {"lrw1000", "train_loss"}
    assert set(out["lrw1000"]) == {"l2r_wer", "l2r_per"}
    payload = ckpt.load(save)
    assert payload["step"] == 2 and ckpt.load(save + "_best")["step"] == 2
    tr2, _ = cli.run_train(common + ["--epochs", "2", "--max-steps-per-epoch",
                                     "1", "--save-dir", save, "--checkpoint", save])
    assert tr2.state.step == 3
    got = cli.run_test(common + ["--checkpoint", save])
    _, test_sets = cli.make_datasets(tr2.cfg, cli.build_argparser().parse_args(
        common), "test")
    want = {k: tr2.validate_seq2seq(ds, 1) for k, ds in test_sets.items()}
    assert got == want


def test_uni_train_forward_goes_through_the_dropout_layers(monkeypatch):
    """With dropout on, the train step's decoder calls ``layers.dropout``
    with the step's rng for the embedding, each attention output and each
    FFN: the count of a forward with an rng, none without."""
    cfg = port_config.tiny_test("lrw")
    model = build_model(cfg, "cpu")
    calls = []
    real = layers.dropout
    from sbl_for_multilingual_lip_reading_tpu_torch.models import decoder_uni

    def spy(x, rate, rng, *batch_dim):
        calls.append(rng is not None)
        return real(x, rate, rng, *batch_dim)
    monkeypatch.setattr(decoder_uni, "dropout", spy)
    monkeypatch.setattr(layers, "dropout", spy)
    batch = _torch_batch(_batches(cfg, "lrw", 1)[0])
    make_uni_train_step(model, make_optimizer(model, cfg.optim), cfg)(
        batch, torch.Generator().manual_seed(0))
    assert all(calls)
    # the decoder's embedding and, per decoder layer, its two attention
    # outputs and its FFN; per encoder layer its attention output and FFN
    # (the encoder's input and the frontend's dropout sit in their own
    # modules, not spied here)
    assert len(calls) == 1 + 3 * cfg.dims.n_dec_layers + 2 * cfg.dims.n_enc_layers
    calls.clear()
    with torch.no_grad():
        model.eval()
        model(torch.zeros((1, 30, 32, 32)), batch["labels"][:1])
    assert not any(calls)
