"""Path E's single-process pieces on the CPU: ``grad_clip`` and
``remat_frontend`` in the train step against JAX, remat on against off,
the K7/K8 wrapper counts with remat, the first step's memory guard, the
``cli train`` trace and scalar log against JAX's tags, the reference
checkpoint import, the learnable synthetic set and the convergence tool.

JAX's steps compile with ``xla_cpu_use_fusion_emitters=False`` and run the
port on JAX's ReLU routing, as ``test_torch_port_train.py`` does (its
helpers and tolerances).  Torch runs on one thread.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu import cli as jax_cli
from sbl_for_multilingual_lip_reading_tpu import config as JC
from sbl_for_multilingual_lip_reading_tpu.data.synthetic import (
    SyntheticPatternDataset as JaxPatterns)
from sbl_for_multilingual_lip_reading_tpu.training.trainer import (
    Trainer as JaxTrainer)
from sbl_for_multilingual_lip_reading_tpu.utils.torch_import import (
    import_sbl_model as jax_import_sbl_model)
from sbl_for_multilingual_lip_reading_tpu_torch import cli, convergence_check
from sbl_for_multilingual_lip_reading_tpu_torch import config as PC
from sbl_for_multilingual_lip_reading_tpu_torch.data import (
    SyntheticLipDataset, SyntheticPatternDataset)
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.ops import batchnorm
from sbl_for_multilingual_lip_reading_tpu_torch.training import memguard
from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import noam_lr
from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
    expected_launches, frontend_bn_count, make_sbl_train_step)
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
    state_dict_from_jax, torch_import)

from test_torch_port_train import (_assert_flips_within_margin,
                                   _assert_step_matches, _cfg, _jax_grads,
                                   _jax_state, _jax_steps, _port, _setup,
                                   _torch_batch, jax_routing_by_value)
from test_torch_port_train_remat import _step_grads

# a global norm below these steps' gradients' (~2-4): the clip acts
GRAD_CLIP = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _clipped_remat_cfg():
    cfg = _cfg(remat_frontend=True)
    return dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, grad_clip=GRAD_CLIP))


def test_grad_clip_and_remat_steps_match_jax(setup):
    """Two steps with grad_clip set and remat_frontend on, against JAX's
    make_sbl_train_body with both (optax.clip_by_global_norm chained before
    Adam, nn.remat(BasicBlock)); and the clipped gradients of step 0
    against JAX's gradients clipped by optax."""
    cfg = _clipped_remat_cfg()
    _, want = _jax_steps(cfg, _jax_state(cfg, setup["variables"]),
                         setup["batches"][:2])
    model, opt = _port(cfg, setup["variables"])
    assert model.frontend.resnet.remat
    step = make_sbl_train_step(model, opt, cfg)
    lr_sum, flips = 0.0, []
    for i, (batch, w) in enumerate(zip(setup["batches"], want)):
        lr_sum += noam_lr(i, cfg.optim.k, cfg.optim.warmup_steps,
                          cfg.optim.lr_base_dim)
        flips.append([])
        with jax_routing_by_value(w["relu"], flips[-1]):
            metrics = step(_torch_batch(batch), torch.Generator().manual_seed(i),
                           use_gold=w["coins"])
        _assert_step_matches(model, metrics["loss"].item(), w, lr_sum)
    _assert_flips_within_margin(flips[0])

    raw, relu = _jax_grads(cfg, setup["variables"], setup["batches"][0])
    norm = float(optax.global_norm({k: jnp.asarray(v.numpy())
                                    for k, v in raw.items()}))
    assert norm > GRAD_CLIP
    clipped, _ = optax.clip_by_global_norm(GRAD_CLIP).update(
        {k: jnp.asarray(v.numpy()) for k, v in raw.items()}, None)
    model, opt = _port(cfg, setup["variables"])
    with jax_routing_by_value(relu, []):
        make_sbl_train_step(model, opt, cfg)(
            _torch_batch(setup["batches"][0]), torch.Generator(),
            use_gold=want[0]["coins"])
    for name, p in model.named_parameters():
        w = np.asarray(clipped[name])
        bound = 5e-5 * np.abs(w).max() + 1e-7
        assert np.abs(p.grad.numpy() - w).max() <= bound, name


@pytest.mark.parametrize("pallas_bn", [False, True], ids=["plain_bn", "kernel_bn"])
def test_remat_frontend_equals_no_remat(monkeypatch, pallas_bn):
    """Dropout on: loss, every gradient and the running statistics are the
    same with the frontend recomputed, bit for bit, and the running
    statistics moved once (the recompute leaves them alone); on the kernel
    route K7's wrapper runs once more per recomputed BatchNorm (every one
    but the stem's), as ``expected_launches`` counts, and K8's once per
    BatchNorm."""
    if pallas_bn:
        monkeypatch.setenv("PALLAS_BN", "1")
    else:
        monkeypatch.delenv("PALLAS_BN", raising=False)
    calls = {"channel_sums": 0, "channel_sums_pair": 0}

    def spy(name):
        fn = getattr(batchnorm, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(batchnorm, name, wrapped)
    spy("channel_sums")
    spy("channel_sums_pair")
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(PC.tiny_test(), remat_frontend=remat)
        calls.update(dict.fromkeys(calls, 0))
        model = build_model(cfg, "cpu", seed=0)
        init = {k: v.clone() for k, v in model.state_dict().items()
                if "running" in k}
        metrics, grads = _step_grads(cfg, model=model)
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
        runs[remat] = metrics, grads, stats, dict(calls)
        want = expected_launches(cfg)
        assert calls == {k: want[k] for k in calls}
    bns = frontend_bn_count(PC.tiny_test().frontend)
    assert runs[True][3] == ({"channel_sums": 2 * bns - 1,
                              "channel_sums_pair": bns} if pallas_bn else
                             {"channel_sums": 0, "channel_sums_pair": 0})
    (m_off, g_off, s_off, _), (m_on, g_on, s_on, _) = runs[False], runs[True]
    assert torch.equal(m_on["loss"], m_off["loss"])
    for name in g_on:
        assert torch.equal(g_on[name], g_off[name]), name
    for k, v in s_on.items():
        assert torch.equal(v, s_off[k]), k
        # once: momentum 0.9 of the initial statistics, 0.1 of the batch's
        if "running_mean" in k:
            assert not torch.equal(v, init[k]), k


# ---------------------------------------------------------------------------
# the memory guard
# ---------------------------------------------------------------------------

class _FakeStep:
    """A train step that runs out of memory on its first ``fails`` calls
    (after drawing from the generator, as a real step does)."""

    def __init__(self, fails, state, during_update=False):
        self.fails, self.calls, self.seen = fails, 0, []
        self.state, self.during_update = state, during_update
        self.updating = False

    def __call__(self, batch, generator):
        self.calls += 1
        self.seen.append(int(torch.randint(0, 2 ** 30, (1,), generator=generator)))
        if self.calls <= self.fails:
            self.updating = self.during_update
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                              "allocate 2.00 GiB")
        return {"loss": torch.tensor(1.0)}


def _state():
    model = torch.nn.Linear(2, 2)
    return type("S", (), {"model": model,
                          "optimizer": torch.optim.Adam(model.parameters())})()


def _numbers():
    return 75 * 2 ** 30, 80 * 2 ** 30


def test_memguard_rebuilds_once_then_raises_naming_the_numbers():
    # one OOM: the rebuild runs once, the step retries on the same random
    # state and its result comes back
    first = _FakeStep(1, _state())
    cheaper = _FakeStep(0, first.state)
    rebuilds = []
    guard = memguard.GuardedTrainStep(
        first, rebuild=lambda: rebuilds.append(1) or cheaper, memory=_numbers)
    gen = torch.Generator().manual_seed(3)
    assert guard(None, gen)["loss"].item() == 1.0
    assert rebuilds == [1] and guard.rebuilt and first.calls == 1
    assert cheaper.seen == first.seen
    # later steps run unguarded
    guard(None, gen)
    assert cheaper.calls == 2 and rebuilds == [1]
    # the rebuilt step runs out too: MemoryError with the peak and capacity
    first, cheaper = _FakeStep(1, _state()), _FakeStep(1, _state())
    guard = memguard.GuardedTrainStep(first, rebuild=lambda: cheaper,
                                      memory=_numbers)
    with pytest.raises(MemoryError, match=r"peak 75\.00 GiB .* 80\.00 GiB"):
        guard(None, torch.Generator())
    assert first.calls == cheaper.calls == 1
    # no rebuild left, or an OOM inside the update: no retry
    for step, rebuild in ((_FakeStep(1, _state()), None),
                          (_FakeStep(1, _state(), during_update=True),
                           lambda: pytest.fail("retried an update"))):
        guard = memguard.GuardedTrainStep(step, rebuild=rebuild, memory=_numbers)
        with pytest.raises(MemoryError, match="75.00 GiB"):
            guard(None, torch.Generator())
        assert step.calls == 1


def test_trainer_guard_turns_remat_frontend_on(monkeypatch):
    """The Trainer's rebuild is JAX's: the same model, optimizer and update
    count, with the frontend's blocks recomputed; the run goes on."""
    cfg = dataclasses.replace(PC.tiny_test(), batch_size=2)
    ds = SyntheticLipDataset(size=4, frames=cfg.data.frames,
                             raw_size=cfg.data.raw_size)
    tr = Trainer(cfg, ds, device="cpu")
    real = tr.train_step.step
    fails = [1]

    def flaky(batch, generator, *a, **kw):
        if fails:
            fails.pop()
            torch.randint(0, 2, (1,), generator=generator)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return real(batch, generator, *a, **kw)
    flaky.state = real.state
    tr.train_step.step = flaky
    monkeypatch.setattr(memguard, "card_memory", lambda device: _numbers())
    tr.train_epoch(0, max_steps=2)
    assert tr.train_step.rebuilt and tr.cfg.remat_frontend
    assert tr.model.frontend.resnet.remat and tr.state.step == 2
    # a config that already recomputes has nothing to rebuild
    tr = Trainer(dataclasses.replace(cfg, remat_frontend=True), ds, device="cpu")
    assert tr.train_step._rebuild is None


# ---------------------------------------------------------------------------
# cli train: trace and scalar log against JAX's tags
# ---------------------------------------------------------------------------

TINY = ["--cpu", "--synthetic", "--synthetic-size", "4", "--batch-size", "2",
        "--d_model", "16", "--n_head", "2", "--d_inner", "32",
        "--n_layers_enc", "1", "--n_layers_dec", "1", "--epochs", "2",
        "--max-steps-per-epoch", "4", "--max-eval-batches", "1"]


def _tags(path):
    return [(r["tag"], r["step"]) for r in
            map(json.loads, open(path).read().splitlines())]


def test_cli_train_trace_and_scalar_log_match_jax(monkeypatch, tmp_path):
    # neither writer finds its TensorBoard library: both log JSONL
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(PC.PRESETS, "sbl", PC.tiny_test)
    argv = TINY + ["--remat-frontend", "--profile-dir", str(tmp_path / "trace"),
                   "--tensorboard-dir", str(tmp_path / "port"),
                   "--save-dir", str(tmp_path / "ckpt")]
    tr, out = cli.run_train(["--mesh-data", "1"] + argv)
    assert tr.cfg.remat_frontend and tr.state.step == 4
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("small_mha_dropout" in str(n) or "aten::" in str(n)
               for n in names)

    monkeypatch.setitem(JC.PRESETS, "sbl", lambda: JC.tiny_test("sbl"))
    jargv = [a for a in argv if a not in ("--tensorboard-dir", str(tmp_path / "port"),
                                          "--profile-dir", str(tmp_path / "trace"))]
    jargs = jax_cli.build_argparser().parse_args(jargv)
    jcfg = jax_cli.config_from_args(jargs)
    train_ds, valid_ds = jax_cli.make_datasets(jcfg, jargs)
    jtr = JaxTrainer(jcfg, train_ds, valid_ds,
                     tensorboard_dir=str(tmp_path / "jax"))
    jtr.fit(2, max_steps_per_epoch=4, max_eval_batches=1)
    mine, theirs = _tags(tmp_path / "port" / "metrics.jsonl"), _tags(
        tmp_path / "jax" / "metrics.jsonl")
    assert mine == theirs
    assert [s for t, s in mine if t == "train/loss"] == list(range(1, 5))
    assert {t for t, _ in mine} >= {"lrw/l2r_wer", "lrw1000/r2l_per"}


# ---------------------------------------------------------------------------
# reference checkpoints, the learnable synthetic set, the convergence tool
# ---------------------------------------------------------------------------

def _reference_state_dict(rng, d, inner, n_enc, n_dec, vocab, conv3d, chans,
                          blocks):
    """A state dict under the reference's names with the shapes of a model
    of these widths (as ``tests/test_torch_parity.py`` builds one)."""
    sd = {}

    def put(prefix, **arrays):
        for k, v in arrays.items():
            sd[f"{prefix}.{k}"] = v

    def lin(prefix, d_in, d_out, bias=True):
        put(prefix, weight=rng.standard_normal((d_out, d_in)).astype(np.float32))
        if bias:
            put(prefix, bias=rng.standard_normal(d_out).astype(np.float32))

    def norm(prefix, c, stats=False):
        put(prefix, weight=rng.standard_normal(c).astype(np.float32),
            bias=rng.standard_normal(c).astype(np.float32))
        if stats:
            put(prefix, running_mean=rng.standard_normal(c).astype(np.float32),
                running_var=rng.uniform(0.5, 2, c).astype(np.float32))

    sd["visual_frontend.frontend3D.0.weight"] = rng.standard_normal(
        (conv3d, 1, 5, 7, 7)).astype(np.float32)
    norm("visual_frontend.frontend3D.1", conv3d, True)
    c_in = conv3d
    for stage, (c, nb) in enumerate(zip(chans, blocks)):
        for b in range(nb):
            t = f"visual_frontend.resnet18.layer{stage + 1}.{b}"
            i = c_in if b == 0 else c
            sd[f"{t}.conv1.weight"] = rng.standard_normal((c, i, 3, 3)).astype(np.float32)
            sd[f"{t}.conv2.weight"] = rng.standard_normal((c, c, 3, 3)).astype(np.float32)
            norm(f"{t}.bn1", c, True)
            norm(f"{t}.bn2", c, True)
            if b == 0 and (stage > 0 or c_in != c):
                sd[f"{t}.downsample.0.weight"] = rng.standard_normal(
                    (c, c_in, 1, 1)).astype(np.float32)
                norm(f"{t}.downsample.1", c, True)
        c_in = c
    lin("encoder.linear_in", chans[-1], d)
    norm("encoder.layer_norm_in", d)
    for i in range(n_enc):
        t = f"encoder.layer_stack.{i}"
        for sub in ("w_qs", "w_ks", "w_vs", "fc"):
            lin(f"{t}.slf_attn.{sub}", d, d)
        norm(f"{t}.slf_attn.layer_norm", d)
        lin(f"{t}.pos_ffn.w_1", d, inner)
        lin(f"{t}.pos_ffn.w_2", inner, d)
        norm(f"{t}.pos_ffn.layer_norm", d)
    sd["decoder.tgt_word_emb.weight"] = rng.standard_normal(
        (vocab, d)).astype(np.float32)
    for side in ("l2r", "r2l"):
        for i in range(n_dec):
            t = (f"decoder.layer_first_{side}" if i == 0
                 else f"decoder.layer_stack_{side}.{i - 1}")
            for att in ("slf_attn", "enc_attn"):
                for sub in ("w_qs", "w_ks", "w_vs", "fc"):
                    lin(f"{t}.{att}.{sub}", d, d)
                norm(f"{t}.{att}.layer_norm", d)
            lin(f"{t}.pos_ffn.w_1", d, inner)
            lin(f"{t}.pos_ffn.w_2", inner, d)
            norm(f"{t}.pos_ffn.layer_norm", d)
        lin(f"decoder.tgt_word_prj_{side}", d, vocab, bias=False)
    return sd


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_torch_import_equals_the_jax_route(size):
    """The direct import of a reference state dict equals
    state_dict_from_jax(import_sbl_model(sd)) key for key, and loads into
    the port's model of those widths."""
    cfg = PC.tiny_test() if size == "tiny" else PC.sbl()
    fe, dims = cfg.frontend, cfg.dims
    sd = _reference_state_dict(
        np.random.default_rng(0), dims.d_model, dims.d_inner, dims.n_enc_layers,
        dims.n_dec_layers, cfg.decoder.vocab_size, fe.conv3d_channels,
        fe.resnet_channels, fe.resnet_blocks)
    got = torch_import.import_sbl_model(sd, dims.n_enc_layers,
                                        dims.n_dec_layers, fe.resnet_blocks)
    want = state_dict_from_jax(*jax_import_sbl_model(
        sd, dims.n_enc_layers, dims.n_dec_layers, fe.resnet_blocks))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and torch.equal(got[k], v.float()), k
    model = build_model(cfg, "cpu")
    model.load_state_dict(got)


def test_load_torch_file_takes_raw_state_dicts(tmp_path):
    sd = {"a.weight": torch.randn(3, 2), "a.bias": torch.randn(3)}
    torch.save(sd, tmp_path / "raw.pt")
    torch.save({"model": sd, "epoch": 3}, tmp_path / "ckpt.tar")
    for name in ("raw.pt", "ckpt.tar"):
        got = torch_import.load_torch_file(str(tmp_path / name))
        assert set(got) == set(sd)
        for k in sd:
            assert np.array_equal(got[k], sd[k].numpy())
    torch.save({"model": "a pickled module", "epoch": 3}, tmp_path / "bad.tar")
    with pytest.raises(ValueError, match="raw state dict"):
        torch_import.load_torch_file(str(tmp_path / "bad.tar"))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_pattern_dataset_is_byte_equal_to_jax(seed):
    kw = dict(n_words=10, samples_per_word=3, frames=5, raw_size=24, seed=seed)
    for split in ("train", "heldout"):
        mine, theirs = SyntheticPatternDataset(split=split, **kw), JaxPatterns(
            split=split, **kw)
        assert len(mine) == len(theirs) == 30
        assert np.array_equal(mine.lang_ids(),
                              [theirs[i]["lang_id"] for i in range(30)])
        for i in range(len(mine)):
            a, b = mine[i], theirs[i]
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (k, i)
    # the splits share each word's pattern and labels, never a clip
    train, held = (SyntheticPatternDataset(split=s, **kw)
                   for s in ("train", "heldout"))
    clips = {train[i]["clip_u8"].tobytes() for i in range(30)}
    assert not clips & {held[i]["clip_u8"].tobytes() for i in range(30)}
    for i in range(30):
        assert np.array_equal(train[i]["labels"], held[i]["labels"])
    with pytest.raises(ValueError):
        SyntheticPatternDataset(split="test")


def test_convergence_check_default_mode_loss_falls():
    """The default mode's first steps: the loss of the last steps is well
    below the first.  (The whole memorisation takes several hundred steps,
    a number that depends on the coin stream: chip_smoke.py phase E6 runs
    it on the card.)"""
    out = convergence_check.memorize(40, "cpu", eval_every=1000)
    losses = out["losses"]
    assert not out["memorized"] and len(losses) == 40
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])
