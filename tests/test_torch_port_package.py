"""Package-level checks of the PyTorch port: it never loads JAX or the JAX
package, its copies of the config and vocabulary agree with the JAX
package's, its weight mapping covers the full-size model, its kernel build
and launch accounting behave, and chip_smoke.py refuses to run without a
CUDA card."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sbl_for_multilingual_lip_reading_tpu import config as C
from sbl_for_multilingual_lip_reading_tpu import vocab as jax_vocab
from sbl_for_multilingual_lip_reading_tpu.models import (
    build_model as build_jax_model)
from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
from sbl_for_multilingual_lip_reading_tpu_torch import ops
from sbl_for_multilingual_lip_reading_tpu_torch import vocab as port_vocab
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.models import frontend, layers
from sbl_for_multilingual_lip_reading_tpu_torch.ops import _build, attention
from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
    expected_launches, recognize_batch)
from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
    state_dict_from_jax)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sbl_for_multilingual_lip_reading_tpu_torch"

_NO_JAX_SCRIPT = """
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import sbl_for_multilingual_lip_reading_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from sbl_for_multilingual_lip_reading_tpu_torch import config as C
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.recognize import recognize_batch
from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
from sbl_for_multilingual_lip_reading_tpu_torch.training import (
    loss, schedule, state, steps, trainer)
cfg = C.tiny_test()
clips = torch.randint(0, 256, (2, cfg.data.frames, cfg.data.raw_size,
                               cfg.data.raw_size), dtype=torch.uint8)
r = recognize_batch(build_model(cfg, "cpu"), clips, cfg.data.crop_size)
assert r.ys_l2r.shape == (2, cfg.decoder.maxlen + 1)
data = SyntheticLipDataset(size=2, frames=cfg.data.frames,
                           raw_size=cfg.data.raw_size)
result = trainer.train_steps(cfg, data, 1, "cpu", seed=0)
assert len(result.history) == 1 and result.history[0]["loss"] > 0
from sbl_for_multilingual_lip_reading_tpu_torch import cli
C.PRESETS["sbl"] = C.tiny_test        # the CLI at tiny size
save = sys.argv[1]
tiny = ["--cpu", "--synthetic", "--synthetic-size", "4", "--batch-size", "2",
        "--d_model", "16", "--n_head", "2", "--d_inner", "32",
        "--n_layers_enc", "1", "--n_layers_dec", "1", "--max-eval-batches", "1"]
tr, _ = cli.run_train(["--epochs", "1", "--max-steps-per-epoch", "1",
                    "--save-dir", save] + tiny)
assert tr.state.step == 1
out = cli.run_test(["--checkpoint", save] + tiny)
assert set(out) == {"lrw", "lrw1000"}
# the unidirectional eval path: a checkpoint, then beam search with the LM
C.PRESETS["lrw1000"] = lambda: C.tiny_test("lrw1000")
uni = ["--workload", "lrw1000"] + tiny
trainer.Trainer(cli.config_from_args(cli.build_argparser().parse_args(uni)),
                [], {}, device="cpu").save(save + "_uni")
out = cli.run_test(["--checkpoint", save + "_uni", "--beam-size", "2",
                    "--bigram-lm"] + uni)
assert set(out) == {"lrw1000"} and set(out["lrw1000"]) == {"l2r_wer", "l2r_per"}
# the last slice: both BatchNorm variants with grad_accum_bf16 in a step,
# the audio stream, the manifest tools, the native runtime, topk_accuracy
import dataclasses, os
import numpy as np
from sbl_for_multilingual_lip_reading_tpu_torch.data import audio, manifest
from sbl_for_multilingual_lip_reading_tpu_torch.utils import metrics, native
acc = dataclasses.replace(cfg, decoder=dataclasses.replace(
    cfg.decoder, grad_accum_bf16=True))
for switch in ("FUSED_BN_ACT", "DOT_BN"):
    os.environ[switch] = "1"
    result = trainer.train_steps(acc, data, 1, "cpu", seed=0)
    assert result.history[0]["loss"] > 0
    del os.environ[switch]
feat = audio.build_lfr_features(audio.extract_fbank(
    np.sin(np.arange(4000) / 7.0).astype(np.float32)))
assert feat.shape[1] == 320 and manifest.wav_is_silent(save + "_none.wav")
assert metrics.topk_accuracy(np.eye(3), np.arange(3)) == 100.0
assert native.levenshtein_native([1, 2], [2]) in (1, None)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "sbl_for_multilingual_lip_reading_tpu"))
assert not loaded, loaded
print("NO_JAX_OK")
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_never_imports_jax(tmp_path):
    # every module of the port, recognize, a train step, a tiny
    # `cli train --cpu` then `cli test --cpu`, and
    # `cli test --cpu --workload lrw1000 --beam-size 2 --bigram-lm`; a
    # step with each BatchNorm variant and grad_accum_bf16, the audio
    # stream, the manifest tools, the native runtime, topk_accuracy
    res = _run([sys.executable, "-c", _NO_JAX_SCRIPT, str(tmp_path / "ckpt")],
               REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_OK" in res.stdout


def test_port_sources_have_no_jax_import():
    # neither JAX nor the JAX package, in the port or in chip_smoke.py
    pattern = re.compile(r"^\s*(import|from) (jax|flax|"
                         r"sbl_for_multilingual_lip_reading_tpu)\b(?!_torch)")
    sources = [p for p in PORT.rglob("*.py")
               if "_build" not in p.relative_to(PORT).parts]
    sources.append(REPO / "chip_smoke.py")
    offenders = [f"{p}:{i}" for p in sources
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pattern.match(line)]
    assert sources
    assert not offenders


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    # without a CUDA device it must refuse; alone, the package is missing too
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real")
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    res = _run([sys.executable, str(script)], cwd)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _assert_fields_match(port_cfg, jax_cfg, path="cfg"):
    """Every field of the port's dataclass equals the JAX one's."""
    for f in dataclasses.fields(port_cfg):
        mine, theirs = getattr(port_cfg, f.name), getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(mine):
            _assert_fields_match(mine, theirs, f"{path}.{f.name}")
        else:
            assert mine == theirs, f"{path}.{f.name}: {mine!r} != {theirs!r}"


@pytest.mark.parametrize("preset", ["sbl", "sbl_stage2", "lrw", "lrw1000",
                                    "tiny_test", "tiny_lrw", "tiny_lrw1000"])
def test_port_config_matches_jax(preset):
    if preset == "tiny_test":
        mine, theirs = port_config.tiny_test(), C.tiny_test("sbl")
    elif preset.startswith("tiny_"):
        name = preset[len("tiny_"):]
        mine, theirs = port_config.tiny_test(name), C.tiny_test(name)
    else:
        mine, theirs = port_config.PRESETS[preset](), C.PRESETS[preset]()
    _assert_fields_match(mine, theirs)


def test_port_config_has_the_training_fields():
    names = {f.name for f in dataclasses.fields(port_config.WorkloadConfig)}
    assert {"optim", "batch_size", "remat_decoder", "freeze_prefixes"} <= names
    cfg = port_config.sbl()
    assert (cfg.dims.dropout, cfg.frontend.dropout, cfg.frontend.bn_momentum,
            cfg.decoder.teacher_forcing_rate, cfg.batch_size) == (0.1, 0.5, 0.9,
                                                                  0.5, 240)
    assert port_config.sbl_stage2().decoder.teacher_forcing_rate == 0.1
    assert {f.name for f in dataclasses.fields(port_config.DataConfig)} >= {
        "frame_removal_p", "max_crop_offset", "random_drop_p", "per_clip_crop"}


def test_port_vocab_word_tables_match_jax():
    assert all(port_vocab.encode_english_word(w) == jax_vocab.encode_english_word(w)
               for w in jax_vocab.lrw_words())
    assert port_vocab.lrw_words() == jax_vocab.lrw_words()
    assert port_vocab.lrw1000_words() == jax_vocab.lrw1000_words()
    assert port_vocab.words_1500() == jax_vocab.words_1500()
    assert port_vocab.chinese_phoneme_map() == jax_vocab.chinese_phoneme_map()
    for w in jax_vocab.lrw1000_words():
        syl = w.split(" ")
        if all(x in jax_vocab.chinese_phoneme_map() for x in syl):
            assert port_vocab.encode_pinyin_seq(syl) == jax_vocab.encode_pinyin_seq(syl)


def test_port_vocab_matches_jax():
    assert port_vocab.TOTAL_PHONEMES == jax_vocab.TOTAL_PHONEMES
    assert ((port_vocab.SOS_ID, port_vocab.EOS_ID, port_vocab.IGNORE_ID)
            == (jax_vocab.SOS_ID, jax_vocab.EOS_ID, jax_vocab.IGNORE_ID))
    ids = [0, 5, 57, 1, -1, 58, 12]
    assert port_vocab.decode_ids(ids) == jax_vocab.decode_ids(ids)
    assert (port_vocab.decode_ids(ids, strip_special=False)
            == jax_vocab.decode_ids(ids, strip_special=False))


def test_port_config_builds_the_same_model_as_jax_config():
    # either package's config drives build_model to the same weights
    a = build_model(port_config.tiny_test(), "cpu").state_dict()
    b = build_model(C.tiny_test("sbl"), "cpu").state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_profile_recognize_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the profile runs for real")
    res = _run([sys.executable, "-m",
                "sbl_for_multilingual_lip_reading_tpu_torch.profile_recognize",
                "--batch", "2"], REPO)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr


@pytest.mark.parametrize("name", ["classify"])
def test_build_model_refuses_unported_workloads(name):
    # every workload is ported: classify builds without a decoder, and a
    # decoder-less config of any other workload is refused
    from sbl_for_multilingual_lip_reading_tpu_torch.models import (
        ClassifyTransformer)
    assert isinstance(build_model(C.tiny_test(name), "cpu"), ClassifyTransformer)
    with pytest.raises(ValueError, match="no decoder"):
        build_model(dataclasses.replace(C.tiny_test(name), name="sbl"), "cpu")


def test_state_dict_mapping_complete_full_dims():
    cfg = C.sbl()
    model = build_jax_model(cfg)
    key = jax.random.PRNGKey(0)
    labels = jnp.zeros((2, cfg.decoder.target_pad_len), jnp.int32)
    T, crop = cfg.data.frames, cfg.data.crop_size
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key, "teacher": key},
        jnp.zeros((2, T, crop, crop)), labels, labels, train=False))
    # zero-stride views: the full-size shapes without their memory
    zeros = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), shapes)
    n_leaves = (len(traverse_util.flatten_dict(zeros["params"]))
                + len(traverse_util.flatten_dict(zeros["batch_stats"])))
    got = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        zeros["params"], zeros["batch_stats"]).items()}
    want = {k: tuple(v.shape) for k, v in build_model(cfg, "cpu").state_dict().items()}
    assert len(got) == n_leaves
    assert sorted(set(want) ^ set(got)) == []
    assert got == want


def test_recognize_calls_each_kernel_wrapper_as_counted(monkeypatch):
    """On the kernel path every attention goes through the K1 wrapper and
    the stem through the K2 wrapper, as many times as chip_smoke.py expects
    launches, and none through the training kernels; on the plain path no
    wrapper is called."""
    cfg = C.tiny_test("sbl")
    calls = dict.fromkeys(expected_launches(cfg), 0)

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    spy(layers, "small_mha_flat")
    spy(frontend, "stack_frames")
    spy(attention, "small_mha_dropout_fwd_flat")
    spy(attention, "small_mha_dropout_bwd_flat")
    spy(attention, "dropout_keep_mask_flat")
    clips = torch.randint(0, 256, (2, cfg.data.frames, cfg.data.raw_size,
                                   cfg.data.raw_size), dtype=torch.uint8)
    recognize_batch(build_model(cfg, "cpu"), clips, cfg.data.crop_size)
    assert calls == expected_launches(cfg)
    assert calls["small_mha_flat"] == (cfg.dims.n_enc_layers
                                       + 2 * cfg.decoder.maxlen
                                       * cfg.dims.n_dec_layers)

    calls.update(dict.fromkeys(calls, 0))
    plain = dataclasses.replace(cfg, use_pallas_attention=False)
    recognize_batch(build_model(plain, "cpu"), clips, cfg.data.crop_size)
    assert not any(calls.values()), calls


def test_launch_counts_reset_and_read():
    names = ("small_mha_flat", "stack_frames", "small_mha_dropout_fwd_flat",
             "small_mha_dropout_bwd_flat", "dropout_keep_mask_flat",
             "ingest_train", "channel_sums", "channel_sums_pair",
             "stack_frames_u8", "fused_resblock", "fused_decoder_layer",
             "fused_small_mha", "small_mha_bwd", "small_mha_dropout_fwd",
             "small_mha_dropout_bwd", "dropout_keep_mask", "fused_mha")
    for i, fn in enumerate(ops.KERNELS):
        fn.launches = i + 1
    assert ops.launch_counts() == {n: i + 1 for i, n in enumerate(names)}
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(names, 0)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.library()
    finally:
        _build.library.cache_clear()
    assert not list(tmp_path.rglob("*.so"))


def test_kernel_library_is_keyed_by_its_sources(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// one")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path()
    assert first == _build.library_path()
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    (csrc / "a.cu").write_text("// two")
    assert _build.library_path() != first
    # the port's own sources: every .cu under csrc/ is in the build
    monkeypatch.undo()
    names = {p.name for p in _build.sources()}
    assert {"attention.cu", "attention_train.cu", "stem.cu", "ingest.cu",
            "batchnorm.cu", "resblock.cu", "decoder_layer.cu", "common.cuh",
            "gemm_tile.cuh"} <= names
