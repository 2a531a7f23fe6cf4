"""CPU parity of the port's ``classify`` workload and the three-stage recipe
against the JAX package.

``config.tiny_test("classify")`` (31 frames, the language slot the last),
its JAX variables moved off their initial values and carried into the port
with ``state_dict_from_jax``, the same synthetic clips and augmentation
plans on both sides, f32.  The model's logits agree within 1e-4 (as the
seq2seq models' do).  The train steps take dropout 0 and
``test_torch_port_train.py``'s conditions and tolerances (JAX compiled with
``xla_cpu_use_fusion_emitters=False``, ``adam_eps=1e-6`` on both sides;
loss 1e-5 relative, BN 5e-5, parameters p99 1e-5, gradients 5e-5 x max|g|
+ 1e-7).  As there, the step and gradient tests run the port on JAX's ReLU
routing (``test_torch_port_uni_train.jax_routing``): a ReLU input within
the frameworks' ~1e-5 forward difference of its kink would otherwise route
a gradient differently on the two sides, at CPU-dependent elements (4 of
perturbation seeds 1-24 exceeded a tolerance that way; the frontend's stem
gradient 3-11x its bound).  Accuracies of ``validate_classify`` and ``cli
test`` are equal to JAX's.  The recipe runs one step per stage on both
sides: the stage names, the classify stage's loss (its one step's forward,
from JAX's initial weights) and the transferred parameter counts equal
JAX's, and the frozen frontend and encoder stay bit-identical through
stage 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sbl_for_multilingual_lip_reading_tpu import cli as jax_cli
from sbl_for_multilingual_lip_reading_tpu import config as C
from sbl_for_multilingual_lip_reading_tpu.data.synthetic import (
    SyntheticLipDataset as JaxSynthetic)
from sbl_for_multilingual_lip_reading_tpu.models import (
    build_model as build_jax_model)
from sbl_for_multilingual_lip_reading_tpu.training import recipe as jax_recipe
from sbl_for_multilingual_lip_reading_tpu.training import schedule as jax_schedule
from sbl_for_multilingual_lip_reading_tpu.training import steps as jax_steps
from sbl_for_multilingual_lip_reading_tpu.training import trainer as jax_trainer
from sbl_for_multilingual_lip_reading_tpu.training.loss import (
    classify_loss as jax_classify_loss)
from sbl_for_multilingual_lip_reading_tpu.training.state import (
    TrainState as JaxTrainState)
from sbl_for_multilingual_lip_reading_tpu_torch import cli
from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
from sbl_for_multilingual_lip_reading_tpu_torch.models import (
    ClassifyTransformer, build_model)
from sbl_for_multilingual_lip_reading_tpu_torch.training import checkpoint as ckpt
from sbl_for_multilingual_lip_reading_tpu_torch.training import trainer as port_trainer
from sbl_for_multilingual_lip_reading_tpu_torch.training.loss import classify_loss
from sbl_for_multilingual_lip_reading_tpu_torch.training.recipe import (
    run_three_stage_recipe)
from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
    make_optimizer, noam_lr)
from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
    expected_launches, make_classify_eval_step, make_classify_train_step)
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
from sbl_for_multilingual_lip_reading_tpu_torch.utils import state_dict_from_jax

from test_torch_port_recognize import _perturbed
from test_torch_port_train import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL,
                                   TEST_ADAM_EPS, XLA_OPTIONS,
                                   _assert_step_matches, _torch_batch)
from test_torch_port_uni_train import (JaxReluTap, _assert_flips_within_margin,
                                       _ExactStep, jax_routing)

LOGIT_TOL = 1e-4
BATCH = 3
N_STEPS = 3
PERTURB_SEED = 22


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


def _jax_init(cfg, key=jax.random.PRNGKey(0)):
    T, crop = cfg.data.frames, cfg.data.crop_size
    return jax.device_get(jax.jit(lambda: build_jax_model(cfg).init(
        {"params": key, "dropout": key}, jnp.zeros((2, T, crop, crop)),
        train=False))())


def _port(cfg, variables):
    model = build_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    return model


def _batches(cfg, n, seed=2):
    data = JaxSynthetic(size=n * BATCH, frames=cfg.data.frames,
                        raw_size=cfg.data.raw_size, seed=seed)
    plan_rng = np.random.default_rng(3)
    out = []
    for s in range(n):
        samples = [data[i] for i in range(s * BATCH, (s + 1) * BATCH)]
        batch = {k: np.stack([x[k] for x in samples]) for k in samples[0]}
        out.append(jax_trainer.attach_plans(batch, plan_rng, cfg, train=True))
    return out


# ------------------------------------------------------------- config, model
@pytest.mark.parametrize("preset", ["classify", "tiny_classify"])
def test_classify_config_matches_jax(preset):
    from test_torch_port_package import _assert_fields_match
    if preset == "classify":
        mine, theirs = port_config.PRESETS["classify"](), C.PRESETS["classify"]()
        assert (mine.num_word_classes, mine.num_languages, mine.language_loss_weight,
                mine.data.frames, mine.batch_size, mine.decoder) == (
                    1500, 2, 0.1, 31, 120, None)
    else:
        mine, theirs = port_config.tiny_test("classify"), C.tiny_test("classify")
    _assert_fields_match(mine, theirs)


@pytest.mark.parametrize("dims", ["tiny", "full"])
def test_classify_state_dict_mapping_complete(dims):
    """Every JAX variable of the classify model, ``fc_word`` and ``fc_lang``
    among them, has its port key and shape, at tiny and at full dims."""
    cfg = C.tiny_test("classify") if dims == "tiny" else C.classify()
    model = build_jax_model(cfg)
    T, crop = cfg.data.frames, cfg.data.crop_size
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key}, jnp.zeros((2, T, crop, crop)),
        train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), shapes)
    n_leaves = (len(traverse_util.flatten_dict(zeros["params"]))
                + len(traverse_util.flatten_dict(zeros["batch_stats"])))
    got = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        zeros["params"], zeros["batch_stats"]).items()}
    port = build_model(cfg, "cpu")
    assert isinstance(port, ClassifyTransformer)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert len(got) == n_leaves and got == want
    d = cfg.dims.d_model
    assert want["fc_word.weight"] == (cfg.num_word_classes, d)
    assert want["fc_lang.weight"] == (cfg.num_languages, d)
    assert port.language_slot == cfg.data.frames - 1


@pytest.fixture(scope="module")
def tiny():
    cfg = _deterministic(C.tiny_test("classify"))
    variables = _perturbed(_jax_init(cfg), np.random.default_rng(PERTURB_SEED))
    return dict(cfg=cfg, variables=variables, batches=_batches(cfg, N_STEPS))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train-mode-bn"])
def test_classify_logits_match_jax(tiny, train):
    """Word and language logits, f32, from identical clips: eval mode (the
    running statistics) and train mode (batch statistics, dropout 0)."""
    cfg, variables = tiny["cfg"], tiny["variables"]
    batch = tiny["batches"][0]
    video = jax_steps._ingest_train({k: jnp.asarray(v) for k, v in batch.items()},
                                    cfg.data.crop_size, jnp.float32)
    model = build_jax_model(cfg)
    out = model.apply(variables, video, train=train, mutable=["batch_stats"],
                      rngs={"dropout": jax.random.PRNGKey(1)})
    want = out[0] if train else model.apply(variables, video, train=False)
    port = _port(cfg, variables).train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(video)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=LOGIT_TOL)
    assert got[0].shape == (BATCH, 1500) and got[1].shape == (BATCH, 2)


def test_classify_loss_matches_jax():
    """Word CE + 0.1 x language CE with labels below 0 left out, the
    correct counts, and a batch whose labels are all invalid."""
    rng = np.random.default_rng(6)
    word = rng.standard_normal((8, 1500)).astype(np.float32) * 3
    lang = rng.standard_normal((8, 2)).astype(np.float32)
    word_id = rng.integers(0, 1500, 8).astype(np.int32)
    word_id[[1, 5]] = -1
    word_id[2] = int(np.argmax(word[2]))
    lang_id = rng.integers(0, 2, 8).astype(np.int32)
    lang_id[3] = -1
    for wid, lid in ((word_id, lang_id), (np.full(8, -1, np.int32), lang_id)):
        want = jax_classify_loss(jnp.asarray(word), jnp.asarray(wid),
                                 jnp.asarray(lang), jnp.asarray(lid), 0.1)
        got = classify_loss(*(torch.from_numpy(a) for a in (word, wid, lang, lid)),
                            language_weight=0.1)
        np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-6)
        assert (int(got[1]), int(got[2])) == (int(want[1]), int(want[2]))


# ---------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def jax_three_steps(tiny):
    cfg, variables = tiny["cfg"], tiny["variables"]
    tx = jax_schedule.make_optimizer(cfg.optim)
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
    step = jax_steps.make_classify_train_step(build_jax_model(cfg), tx, cfg)
    rng = jax.random.PRNGKey(5)
    compiled, want, tap = None, [], JaxReluTap()
    for batch in tiny["batches"]:
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        if compiled is None:
            with tap.tracing():
                compiled = step.lower(state, batch, rng).compile(XLA_OPTIONS)
        state, metrics = compiled(state, batch, rng)
        want.append(dict(loss=float(metrics["loss"]),
                         correct=(int(metrics["word_correct"]),
                                  int(metrics["lang_correct"])),
                         relu=tap.take(),
                         sd=state_dict_from_jax(*jax.device_get(
                             (state.params, state.batch_stats)))))
    return want


def test_three_classify_train_steps_match_jax(tiny, jax_three_steps):
    """Three steps against JAX's ``make_classify_train_step``, each on JAX's
    ReLU routing (``jax_routing``)."""
    cfg = tiny["cfg"]
    model = _port(cfg, tiny["variables"])
    step = make_classify_train_step(model, make_optimizer(model, cfg.optim), cfg)
    lr_sum, flips = 0.0, []
    for i, (batch, w) in enumerate(zip(tiny["batches"], jax_three_steps)):
        lr_sum += noam_lr(i, cfg.optim.k, cfg.optim.warmup_steps,
                          cfg.optim.lr_base_dim)
        flips.append([])
        with jax_routing(w["relu"], flips[-1]):
            metrics = step(_torch_batch(batch), torch.Generator().manual_seed(i))
        assert set(metrics) == {"loss", "word_correct", "lang_correct"}
        assert (int(metrics["word_correct"]), int(metrics["lang_correct"])) == \
            w["correct"]
        _assert_step_matches(model, metrics["loss"].item(), w, lr_sum)
    _assert_flips_within_margin(flips[0])


def test_classify_step_gradients_match_jax(tiny):
    cfg, variables = tiny["cfg"], tiny["variables"]
    batch = {k: jnp.asarray(v) for k, v in tiny["batches"][0].items()}
    model = build_jax_model(cfg)

    def loss_fn(params):
        video = jax_steps._ingest_train(batch, cfg.data.crop_size, jnp.float32)
        (word, lang), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, video,
            train=True, rngs={"dropout": jax.random.PRNGKey(5)},
            mutable=["batch_stats"])
        return jax_classify_loss(word, batch["word_id"], lang, batch["lang_id"],
                                 cfg.language_loss_weight)[0]

    tap, flips = JaxReluTap(), []
    with tap.tracing():
        grad = jax.jit(jax.grad(loss_fn)).lower(variables["params"]).compile(
            XLA_OPTIONS)
    want = state_dict_from_jax(jax.device_get(grad(variables["params"])))
    port = _port(cfg, variables)
    with jax_routing(tap.take(), flips):
        make_classify_train_step(port, make_optimizer(port, cfg.optim), cfg)(
            _torch_batch(tiny["batches"][0]), torch.Generator())
    _assert_flips_within_margin(flips)
    for n, p in port.named_parameters():
        g, w = p.grad.numpy(), want[n].numpy()
        bound = GRAD_RTOL * np.abs(w).max() + GRAD_ATOL
        assert np.abs(g - w).max() <= bound, (n, np.abs(g - w).max(), bound)


def test_classify_step_calls_the_training_kernels_as_counted(monkeypatch):
    """K2 once and K3/K4 once per encoder layer (no decoder), as
    ``expected_launches`` counts for the classify workload."""
    from sbl_for_multilingual_lip_reading_tpu_torch.ops import attention
    cfg = port_config.tiny_test("classify")
    calls = {"small_mha_dropout_fwd_flat": 0, "small_mha_dropout_bwd_flat": 0}
    for name in calls:
        fn = getattr(attention, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(attention, name, wrapped)
    model = build_model(cfg, "cpu")
    make_classify_train_step(model, make_optimizer(model, cfg.optim), cfg)(
        _torch_batch(_batches(cfg, 1)[0]), torch.Generator().manual_seed(0))
    want = expected_launches(cfg)
    assert calls == {k: want[k] for k in calls} == dict.fromkeys(
        calls, cfg.dims.n_enc_layers)


# ----------------------------------------------- validation, CLI, the recipe
@pytest.fixture(scope="module")
def jax_classify_trainer():
    """One JAX classify Trainer (one encoder layer: half the compile), its
    variables moved off their initial values, on the synthetic data `cli`
    builds."""
    cfg = _deterministic(C.tiny_test("classify"), n_enc_layers=1)
    args = jax_cli.build_argparser().parse_args(["--synthetic", "--synthetic-size",
                                                 "8"])
    train, valid = jax_cli.make_datasets(cfg, args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "make_classify_train_step", lambda *a, **k:
                   _ExactStep(jax_steps.make_classify_train_step(*a, **k)))
        tr = jax_trainer.Trainer(cfg, train, valid)
    variables = _perturbed({"params": jax.device_get(tr.state.params),
                            "batch_stats": jax.device_get(tr.state.batch_stats)},
                           np.random.default_rng(12))
    tr.state = tr.state.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"])
    return dict(cfg=cfg, tr=tr, variables=variables, valid=valid, args=args)


def test_validate_classify_and_fit_match_jax(jax_classify_trainer):
    """``validate_classify`` on the same weights, then one epoch of two
    steps and its validation through ``fit`` (the best model = the highest
    sum of word accuracies): JAX's accuracies and epoch loss."""
    j = jax_classify_trainer
    cfg, jtr = j["cfg"], j["tr"]
    want = {k: jtr.validate_classify(ds) for k, ds in j["valid"].items()}
    train, valid = cli.make_datasets(cfg, j["args"])
    tr = Trainer(cfg, train, valid, device="cpu", model=_port(cfg, j["variables"]))
    got = {k: tr.validate_classify(ds) for k, ds in valid.items()}
    assert set(got) == {"lrw", "lrw1000"}
    assert got == want
    assert all(set(v) == {"word_acc", "lang_acc"} for v in got.values())
    jax_loss = jtr.train_epoch(0, max_steps=2)
    want_after = {k: jtr.validate_classify(ds) for k, ds in j["valid"].items()}
    out = tr.fit(1, max_steps_per_epoch=2)
    np.testing.assert_allclose(out["train_loss"], jax_loss, rtol=LOSS_RTOL)
    assert {k: v for k, v in out.items() if k != "train_loss"} == want_after
    assert tr.best_metric == -sum(v["word_acc"] for v in want_after.values())


def test_cli_train_and_test_classify(jax_classify_trainer, tmp_path, monkeypatch):
    """``cli train --cpu --workload classify`` (2 steps, a validation, the
    checkpoint), then ``cli test --workload classify`` on a checkpoint of
    JAX's weights: equal to JAX's accuracies on the test split."""
    j = jax_classify_trainer
    monkeypatch.setitem(port_config.PRESETS, "classify", lambda: j["cfg"])
    common = ["--cpu", "--workload", "classify", "--synthetic",
              "--synthetic-size", "8"]
    tr, out = cli.run_train(common + ["--epochs", "1", "--max-steps-per-epoch",
                                      "2", "--save-dir", str(tmp_path / "run")])
    assert tr.state.step == 2 and np.isfinite(out["train_loss"])
    assert set(out) == {"lrw", "lrw1000", "train_loss"}
    assert ckpt.load(str(tmp_path / "run"))["step"] == 2

    _, test_sets = jax_cli.make_datasets(j["cfg"], j["args"], eval_split="test")
    want = {k: j["tr"].validate_classify(ds) for k, ds in test_sets.items()}
    save = str(tmp_path / "jax_weights")
    Trainer(j["cfg"], [], device="cpu",
            model=_port(j["cfg"], jax.device_get(
                {"params": j["tr"].state.params,
                 "batch_stats": j["tr"].state.batch_stats}))).save(save)
    got = cli.run_test(common + ["--checkpoint", save])
    assert got == want


def test_classify_eval_step_is_deterministic(tiny):
    cfg = tiny["cfg"]
    model = _port(cfg, tiny["variables"])
    batch = _torch_batch(tiny["batches"][0])
    step = make_classify_eval_step(model, cfg)
    a, b = step(batch), step(batch)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not model.training


def _recipe_cfgs(cfg_fn):
    """classify and sbl configs sharing frontend and encoder dims (one
    encoder and one decoder layer), dropout 0 in classify."""
    classify = _deterministic(cfg_fn("classify"), n_enc_layers=1, n_dec_layers=1)
    sbl = cfg_fn("sbl")
    sbl = dataclasses.replace(sbl, dims=dataclasses.replace(
        sbl.dims, n_enc_layers=1, n_dec_layers=1))
    return classify, sbl


def _recipe_data(cls):
    kw = dict(raw_size=40)
    return (cls(size=4, frames=31, **kw), cls(size=4, frames=30, **kw),
            cls(size=2, frames=30, seed=1, **kw))


def test_three_stage_recipe_matches_jax(tmp_path, monkeypatch):
    """One step per stage on both sides: the stages, the classify loss and
    the transferred counts equal JAX's; the frozen frontend and encoder
    parameters stay bit-identical from the classify checkpoint through both
    frozen stages, and the finetune moves them."""
    jc, js = _recipe_cfgs(C.tiny_test)
    want = jax_recipe.run_three_stage_recipe(
        jc, js, *_recipe_data(JaxSynthetic), str(tmp_path / "jax"),
        classify_steps=1, stage_steps=1)
    jax_init = jax.device_get(jax_trainer.init_state(
        build_jax_model(jc), jc, jax.random.PRNGKey(jc.seed))[0])
    build = port_trainer.build_model

    def from_jax_init(cfg, device=None, **kw):
        """The classify stage starts where JAX's Trainer starts."""
        model = build(cfg, device, **kw)
        if cfg.name == "classify":
            model.load_state_dict(state_dict_from_jax(jax_init.params,
                                                      jax_init.batch_stats))
        return model
    monkeypatch.setattr(port_trainer, "build_model", from_jax_init)
    pc, ps = _recipe_cfgs(port_config.tiny_test)
    work = tmp_path / "port"
    got = run_three_stage_recipe(pc, ps, *_recipe_data(SyntheticLipDataset),
                                 str(work), classify_steps=1, stage_steps=1,
                                 device="cpu")
    assert [r["stage"] for r in got] == [r["stage"] for r in want] == [
        "classify", "stage2_tf05_frozen", "stage2_tf01_frozen", "stage3_finetune"]
    assert all(set(g) == set(w) for g, w in zip(got, want))
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=LOSS_RTOL)
    assert [r["transferred"] for r in got[1:]] == \
        [r["transferred"] for r in want[1:]]
    stage1 = ckpt.load(str(work / "stage1_classify"))["model"]
    n_fe = sum(1 for k in stage1 if k.startswith(("frontend.", "encoder."))
               and "running" not in k)
    assert got[1]["transferred"] == n_fe
    frozen = [k for k in ckpt.load(str(work / "stage2_tf05_frozen"))["model"]
              if k.startswith(("frontend.", "encoder.")) and "running" not in k]
    assert len(frozen) == n_fe
    stages = [ckpt.load(str(work / s))["model"] for s in
              ("stage2_tf05_frozen", "stage2_tf01_frozen", "stage3_finetune")]
    for k in frozen:
        assert torch.equal(stages[0][k], stage1[k]), k
        assert torch.equal(stages[1][k], stage1[k]), k
    assert any(not torch.equal(stages[2][k], stage1[k]) for k in frozen)
