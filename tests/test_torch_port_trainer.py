"""CPU checks of the port's training entry point: the ``Trainer`` against
the JAX package's over 2 epochs x 2 steps with validation, the device
cache against the host batch path, checkpoint round trip and resume,
the partial transfer, and the CLI.

The JAX side: ``config.tiny_test("sbl")`` with dropout 0 and teacher
forcing 1.0, so every decode step feeds the gold token on both sides and
no random number reaches the loss; its variables are moved off their
initial values and carried into the port with ``state_dict_from_jax``.
Both trainers draw the same batch order and augmentation plans from
``cfg.seed``.  Tolerances: each epoch's mean loss within 1e-5 relative (the
readings of ``test_torch_port_train.py``: 1.2e-6 over three steps); the
trained model's encoder output on an eval batch within 1e-5 of its largest
element (readings: losses 3.5e-7 apart, the encoder output 1.2e-6); the
greedy decode's tokens, WER and PER equal.
One JAX Trainer serves the file.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu import config as JC
from sbl_for_multilingual_lip_reading_tpu.data import pipeline as jax_pipeline
from sbl_for_multilingual_lip_reading_tpu.data.synthetic import (
    SyntheticLipDataset as JaxSynthetic)
from sbl_for_multilingual_lip_reading_tpu.training import trainer as jax_trainer
from sbl_for_multilingual_lip_reading_tpu_torch import cli
from sbl_for_multilingual_lip_reading_tpu_torch import config as C
from sbl_for_multilingual_lip_reading_tpu_torch.data import (SyntheticLipDataset,
                                                              device_ingest)
from sbl_for_multilingual_lip_reading_tpu_torch.recognize import recognize_batch
from sbl_for_multilingual_lip_reading_tpu_torch.training import checkpoint as ckpt
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (
    Trainer, decode_to_phonemes, train_steps)
from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
    state_dict_from_jax)

from test_torch_port_recognize import _perturbed

EPOCHS, STEPS = 2, 2
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # tiny shapes: one thread does the work, and the test workers that run
    # beside this one find the cores free
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
ENC_ATOL = 1e-5


def _deterministic(cfg):
    # one encoder and one decoder layer: half the JAX step to compile
    return dataclasses.replace(
        cfg, dims=dataclasses.replace(cfg.dims, dropout=0.0, n_enc_layers=1,
                                      n_dec_layers=1),
        frontend=dataclasses.replace(cfg.frontend, dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, teacher_forcing_rate=1.0))


def _data(cls, cfg):
    kw = dict(frames=cfg.data.frames, raw_size=cfg.data.raw_size)
    return (cls(size=5, **kw),
            {"lrw": cls(size=4, kind="lrw", seed=1, **kw),
             "lrw1000": cls(size=4, kind="lrw1000", seed=2, **kw)})


@pytest.fixture(scope="module")
def jax_run():
    """Two epochs of two steps of the JAX Trainer, each followed by a
    validation of both eval sets; the starting variables."""
    cfg = _deterministic(JC.tiny_test("sbl"))
    train, valid = _data(JaxSynthetic, cfg)
    tr = jax_trainer.Trainer(cfg, train, valid)
    variables = _perturbed({"params": jax.device_get(tr.state.params),
                            "batch_stats": jax.device_get(tr.state.batch_stats)},
                           np.random.default_rng(11))
    tr.state = tr.state.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"])
    batch = next(iter(jax_pipeline.Batcher(valid["lrw1000"], 4, shuffle=False)))
    losses, evals, tokens = [], [], []
    for epoch in range(EPOCHS):
        losses.append(tr.train_epoch(epoch, max_steps=STEPS))
        evals.append({k: tr.validate_seq2seq(ds) for k, ds in valid.items()})
        tokens.append(np.stack(jax.device_get(tr.eval_step(tr.state, batch))))
    encoded = np.asarray(jax.jit(lambda v, x: tr.model.apply(
        v, x, method=tr.model.encode))(
        {"params": tr.state.params, "batch_stats": tr.state.batch_stats},
        jax_trainer._eval_video(batch, cfg)))
    return dict(variables=variables, losses=losses, evals=evals, tokens=tokens,
                batch=batch, encoded=encoded)


def _port_trainer(variables=None, **kw):
    cfg = kw.pop("cfg", _deterministic(C.tiny_test()))
    train, valid = _data(SyntheticLipDataset, cfg)
    tr = Trainer(cfg, train, valid, device="cpu", **kw)
    if variables is not None:
        tr.model.load_state_dict(state_dict_from_jax(variables["params"],
                                                     variables["batch_stats"]))
    return tr


def test_trainer_matches_jax_over_two_epochs(jax_run):
    """Epoch losses, WER/PER of both eval sets, and the greedy tokens of an
    eval batch (both directions) after each epoch."""
    tr = _port_trainer(jax_run["variables"])
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in jax_run["batch"].items()}
    for epoch in range(EPOCHS):
        loss = tr.train_epoch(epoch, max_steps=STEPS)
        np.testing.assert_allclose(loss, jax_run["losses"][epoch], rtol=LOSS_RTOL)
        got = {k: tr.validate_seq2seq(ds) for k, ds in tr.valid_datasets.items()}
        assert got == jax_run["evals"][epoch]
        out = recognize_batch(tr.model, batch["clip_u8"], tr.cfg.data.crop_size,
                              n_frames=batch["n_frames"])
        tokens = np.stack([out.ys_l2r.numpy(), out.ys_r2l.numpy()])
        assert np.array_equal(tokens, jax_run["tokens"][epoch])
    assert tr.state.step == EPOCHS * STEPS
    # the trained frontend (eval mode, on its running statistics) and encoder
    tr.model.eval()
    with torch.no_grad():
        video = device_ingest(batch["clip_u8"], tr.cfg.data.crop_size,
                              n_frames=batch["n_frames"])
        encoded = tr.model.encode(video).numpy()
    want = jax_run["encoded"]
    np.testing.assert_allclose(encoded, want, atol=ENC_ATOL * np.abs(want).max())


def test_cache_on_device_equals_host_path():
    """The device cache gathers each batch by index from the resident
    uint8 dataset, in the Batcher's order with the same plans: the same
    loss sequence, bit for bit."""
    cfg = dataclasses.replace(C.tiny_test(), batch_size=2)
    runs = []
    for cache in (False, True):
        tr = _port_trainer(cfg=cfg, cache_on_device=cache)
        history = []
        for epoch in range(EPOCHS):
            tr.train_epoch(epoch, history=history)
        runs.append([h["loss"] for h in history])
    assert len(runs[0]) == EPOCHS * 2 and all(np.isfinite(runs[0]))
    assert runs[0] == runs[1]
    tr = _port_trainer(cfg=dataclasses.replace(cfg, secondary_batch_size=1),
                       cache_on_device=True)
    with pytest.raises(ValueError, match="TwoStreamBatchSampler"):
        tr.train_epoch(0)


def _state_equal(a: Trainer, b: Trainer):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys()
    for k in oa:
        assert all(torch.equal(oa[k][n], ob[k][n]) for n in oa[k])
    assert a.state.step == b.state.step


def test_checkpoint_round_trip_and_resume_equal_an_uninterrupted_run(tmp_path):
    whole = _port_trainer()
    want = [whole.train_epoch(e, max_steps=STEPS) for e in range(EPOCHS)]

    first = _port_trainer()
    first.train_epoch(0, max_steps=STEPS)
    first.best_metric = 0.5
    path = str(tmp_path / "ckpt")
    first.save(path, epoch=0, is_best=True)
    assert os.path.isfile(os.path.join(path, ckpt.FILE))
    assert os.path.isfile(os.path.join(path + "_best", ckpt.FILE))

    resumed = _port_trainer()
    assert resumed.restore(path + "_best") == 0
    _state_equal(resumed, first)
    assert resumed.best_metric == 0.5
    loss = resumed.train_epoch(1, max_steps=STEPS)
    assert loss == want[1]
    _state_equal(resumed, whole)


def test_fit_checkpoints_the_best_epoch(tmp_path):
    path = str(tmp_path / "run")
    tr = _port_trainer(checkpoint_dir=path)
    out = tr.fit(1, max_steps_per_epoch=1, max_eval_batches=1)
    assert set(out) == {"lrw", "lrw1000", "train_loss"}
    assert tr.best_metric == out["lrw"]["l2r_wer"] + out["lrw1000"]["l2r_wer"]
    saved = ckpt.load(path + "_best")
    assert saved["epoch"] == 0 and saved["step"] == 1
    assert saved["best_metric"] == pytest.approx(tr.best_metric)


def test_restore_for_transfer_takes_jax_prefixes(tmp_path):
    src = _port_trainer()
    src.train_epoch(0, max_steps=1)
    path = str(tmp_path / "ckpt")
    src.save(path)
    for prefixes, heads in ((["decoder/step/layer_0", "encoder"],
                             ("decoder.step.layer_0.", "encoder.")),
                            (["frontend"], ("frontend.",)),
                            (None, ("",))):
        dst = _port_trainer(cfg=dataclasses.replace(C.tiny_test(), seed=3))
        before = {k: v.clone() for k, v in dst.model.state_dict().items()}
        loaded = ckpt.restore_for_transfer(path, dst.model, prefixes)
        assert loaded and all(k.startswith(heads) for k in loaded)
        after, want = dst.model.state_dict(), src.model.state_dict()
        for k in after:
            assert torch.equal(after[k], want[k] if k in loaded else before[k]), k
    assert any(k.startswith("decoder.step.layer_0.") for k in
               ckpt.restore_for_transfer(path, dst.model, ["decoder/step/layer_0"]))
    merged, loaded, missed = ckpt.partial_merge(
        {"a": torch.zeros(2), "b": torch.zeros(3)},
        {"a": torch.ones(2), "b": torch.ones(4), "c": torch.ones(1)})
    assert loaded == ["a"] and missed == ["b"] and merged["a"].sum() == 2


@pytest.fixture
def tiny_presets(monkeypatch):
    """The CLI's presets at ``tiny_test`` size (the frontend has no flags),
    stage 2 with its teacher forcing of 0.1."""
    def preset(rate):
        def make():
            cfg = C.tiny_test()
            return dataclasses.replace(cfg, decoder=dataclasses.replace(
                cfg.decoder, teacher_forcing_rate=rate))
        return make
    monkeypatch.setitem(C.PRESETS, "sbl", preset(0.5))
    monkeypatch.setitem(C.PRESETS, "sbl_stage2", preset(0.1))


def test_cli_train_test_transfer_and_resume(tmp_path, tiny_presets):
    """`cli train --cpu`, then `cli test --cpu` on its checkpoint (the WER
    and PER of the in-memory model on the test split), a stage-2 transfer
    with frontend and encoder frozen (they stay bit-identical, the decoder
    moves), and a resume that runs the next epoch."""
    save = str(tmp_path / "stage1")
    tiny = ["--cpu", "--synthetic", "--synthetic-size", "4", "--batch-size", "2",
            "--d_model", "16", "--n_head", "2", "--d_inner", "32",
            "--n_layers_enc", "1", "--n_layers_dec", "1", "--max-eval-batches", "1"]
    tr, _ = cli.run_train(["--epochs", "1", "--max-steps-per-epoch", "1",
                        "--save-dir", save] + tiny)
    assert tr.state.step == 1 and os.path.isdir(save + "_best")
    out = cli.run_test(["--checkpoint", save] + tiny)
    _, test_sets = cli.make_datasets(tr.cfg, cli.build_argparser().parse_args(tiny),
                                     "test")
    assert out == {k: tr.validate_seq2seq(ds, 1) for k, ds in test_sets.items()}

    stage2, _ = cli.run_train(["--workload", "sbl_stage2", "--epochs", "1",
                            "--max-steps-per-epoch", "1", "--transfer-from", save,
                            "--freeze", "frontend,encoder",
                            "--save-dir", str(tmp_path / "stage2")] + tiny)
    assert stage2.cfg.decoder.teacher_forcing_rate == 0.1
    assert stage2.state.step == 1
    start = ckpt.load(save)["model"]
    for name, p in stage2.model.named_parameters():
        same = torch.equal(p.detach(), start[name])
        assert same == name.startswith(("frontend.", "encoder.")), name

    resumed, _ = cli.run_train(["--epochs", "2", "--max-steps-per-epoch", "1",
                             "--checkpoint", save, "--save-dir", save] + tiny)
    assert resumed.state.step == 2 and ckpt.load(save)["epoch"] == 1


def test_trainer_halts_on_a_non_finite_loss():
    tr = _port_trainer()
    with torch.no_grad():
        tr.model.decoder.step.tgt_word_prj.weight.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tr.train_epoch(0, max_steps=1)


def test_train_steps_runs_on_the_trainer():
    cfg = C.tiny_test()
    data = SyntheticLipDataset(size=3, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size)
    result = train_steps(cfg, data, 3, "cpu", seed=0)
    assert len(result.history) == 3
    assert all(np.isfinite(h["loss"]) for h in result.history)
    with pytest.raises(ValueError, match="no full batch"):
        train_steps(cfg, SyntheticLipDataset(size=1, frames=2, raw_size=40), 1,
                    "cpu")


def test_unported_paths_raise(monkeypatch):
    # every workload trains, with grad_clip too (which the reference never
    # sets), and a tensor-parallel config asks for its data x model grid
    # (the grid's runs: test_torch_port_tp.py)
    from sbl_for_multilingual_lip_reading_tpu_torch import parallel
    asked = []
    monkeypatch.setattr(parallel, "make_mesh",
                        lambda *a: asked.append(a) or None)
    for name in ("sbl", "lrw", "classify"):
        cfg = JC.tiny_test(name)
        Trainer(cfg, [], device="cpu")
        clipped = dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, grad_clip=1.0))
        assert Trainer(clipped, [], device="cpu").state.optim_cfg.grad_clip == 1.0
        sharded = dataclasses.replace(cfg, mesh=JC.MeshConfig(model=2))
        Trainer(sharded, [], device="cpu")
        assert asked.pop() == (1, 2, "cpu") and not asked


def test_decode_protocol_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(50):
        pred = rng.integers(-1, 58, size=17)
        gold = np.where(rng.random(14) < 0.3, -1, rng.integers(0, 58, size=14))
        assert decode_to_phonemes(pred, gold) == \
            jax_trainer.decode_to_phonemes(pred, gold)
