"""CPU checks of the port's host-side training modules against the JAX
package's: ``Batcher``, ``background_iter``, ``TwoStreamBatchSampler``,
the manifest reader, the LRW / LRW-1000 datasets (tiny trees in tmp_path),
WER/PER, the CLI's argument handling, and ``prefetch_to_device``.  These
are copies or re-implementations of code that needs no JAX, so every
comparison is exact."""
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu import cli as jax_cli
from sbl_for_multilingual_lip_reading_tpu.data import datasets as jax_datasets
from sbl_for_multilingual_lip_reading_tpu.data import manifest as jax_manifest
from sbl_for_multilingual_lip_reading_tpu.data import pipeline as jax_pipeline
from sbl_for_multilingual_lip_reading_tpu.data import sampler as jax_sampler
from sbl_for_multilingual_lip_reading_tpu.data.synthetic import (
    SyntheticLipDataset as JaxSynthetic)
from sbl_for_multilingual_lip_reading_tpu.utils import metrics as jax_metrics
from sbl_for_multilingual_lip_reading_tpu_torch import cli
from sbl_for_multilingual_lip_reading_tpu_torch.data import (
    Batcher, Lrw1000Dataset, LrwDataset, MixedBilingualDataset,
    SyntheticLipDataset, TwoStreamBatchSampler, background_iter,
    prefetch_to_device)
from sbl_for_multilingual_lip_reading_tpu_torch.data import manifest
from sbl_for_multilingual_lip_reading_tpu_torch.utils import metrics
from sbl_for_multilingual_lip_reading_tpu_torch.vocab import (
    word_class_id, words_1500)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # tiny shapes: one thread does the work, and the test workers that run
    # beside this one find the cores free
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False),
                                               (True, False)])
def test_batcher_matches_jax(shuffle, drop_last):
    mine = SyntheticLipDataset(size=11, frames=2, raw_size=8, seed=3)
    theirs = JaxSynthetic(size=11, frames=2, raw_size=8, seed=3)
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, drop_last=drop_last)
    a, b = Batcher(mine, **kw), jax_pipeline.Batcher(theirs, **kw)
    assert len(a) == len(b)
    _same_batches(a, b)


def test_batcher_multihost_stripes_match_jax():
    """Each process's stripe of every global batch, the ragged tail
    included; together they hold every sample once."""
    mine = SyntheticLipDataset(size=10, frames=2, raw_size=8)
    theirs = JaxSynthetic(size=10, frames=2, raw_size=8)
    seen = []
    for p in range(2):
        kw = dict(batch_size=4, shuffle=True, seed=1, drop_last=False,
                  process_index=p, process_count=2)
        a = list(Batcher(mine, **kw))
        _same_batches(a, jax_pipeline.Batcher(theirs, **kw))
        seen += [int(w) for batch in a for w in batch["word_id"]]
    assert sorted(seen) == sorted(int(mine[i]["word_id"]) for i in range(10))


def test_two_stream_sampler_matches_jax():
    primary, secondary = list(range(10)), list(range(100, 104))
    a = TwoStreamBatchSampler(primary, secondary, 5, 2, seed=3)
    b = jax_sampler.TwoStreamBatchSampler(primary, secondary, 5, 2, seed=3)
    assert len(a) == len(b) == 3
    got, want = list(a), list(b)
    assert got == want
    assert all(sum(i >= 100 for i in batch) == 2 for batch in got)
    with pytest.raises(ValueError):
        TwoStreamBatchSampler(primary, secondary, 4, 4)


def test_batcher_with_sampler_matches_jax():
    mine = SyntheticLipDataset(size=12, frames=2, raw_size=8)
    theirs = JaxSynthetic(size=12, frames=2, raw_size=8)
    assert mine.stream_indices() == theirs.stream_indices()
    s = dict(batch_size=4, secondary_batch_size=1, seed=2)
    _same_batches(
        Batcher(mine, 4, sampler=TwoStreamBatchSampler(*mine.stream_indices(), **s)),
        jax_pipeline.Batcher(theirs, 4, sampler=jax_sampler.TwoStreamBatchSampler(
            *theirs.stream_indices(), **s)))


def test_background_iter_order_exception_and_close():
    assert list(background_iter(iter(range(20)), depth=3)) == list(range(20))
    assert list(background_iter(iter([]))) == []

    def boom():
        yield 1
        yield 2
        raise ValueError("producer failed")
    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for x in background_iter(boom()):
            got.append(x)
    assert got == [1, 2]
    # the JAX one behaves the same on the same source
    assert list(jax_pipeline.background_iter(iter(range(20)), depth=3)) == \
        list(background_iter(iter(range(20)), depth=3))

    closed = []

    def src():
        try:
            for i in range(1000):
                yield i
        finally:
            closed.append(True)
    it = background_iter(src(), depth=1)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 5.0
    while not closed and time.monotonic() < deadline:
        time.sleep(0.02)
    assert closed


def test_background_iter_early_close_leaks_no_thread():
    def src():
        i = 0
        while True:
            yield i
            i += 1
    t0 = time.monotonic()
    for _ in range(20):
        it = background_iter(src(), depth=1)
        assert next(it) is not None
        it.close()
    assert time.monotonic() - t0 < 10.0
    deadline = time.monotonic() + 5.0
    alive = True
    while alive and time.monotonic() < deadline:
        alive = any(t.name == "batch-producer" and t.is_alive()
                    for t in threading.enumerate())
        time.sleep(0.02)
    assert not alive


def test_prefetch_to_device_yields_every_batch_as_tensors():
    ds = SyntheticLipDataset(size=8, frames=2, raw_size=8)
    want = list(Batcher(ds, 2, shuffle=False))
    got = list(prefetch_to_device(Batcher(ds, 2, shuffle=False), "cpu", size=3))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in g.values())
        assert all(np.array_equal(g[k].numpy(), w[k]) for k in w)
    assert list(prefetch_to_device(iter([]), "cpu")) == []


def _random_phonemes(rng, n):
    pool = ["a", "b", "ch", "sh", "ii", "ng"]
    return [list(rng.choice(pool, size=rng.integers(1, 7))) for _ in range(n)]


def test_metrics_match_jax_on_random_strings():
    rng = np.random.default_rng(0)
    pred, gold = _random_phonemes(rng, 40), _random_phonemes(rng, 40)
    pred_txt = ["".join(p) for p in pred]
    gold_txt = ["".join(g) for g in gold]
    # spaces make multi-word strings, where WER differs from exact match
    pred_txt += [" ".join(p) for p in pred[:10]]
    gold_txt += [" ".join(g) for g in gold[:10]]
    assert metrics.wer_compute(pred_txt, gold_txt) == \
        jax_metrics.wer_compute(pred_txt, gold_txt)
    assert metrics.per_compute(pred, gold) == jax_metrics.per_compute(pred, gold)
    for p, g in zip(pred, gold):
        assert metrics.levenshtein(p, g) == jax_metrics.levenshtein(p, g)
    assert np.isnan(metrics.wer_compute([], [])) and np.isnan(metrics.per_compute([], []))
    a, b = metrics.AverageMeter(), jax_metrics.AverageMeter()
    for v, n in ((1.5, 1), (2.0, 3), (0.25, 2)):
        a.update(v, n)
        b.update(v, n)
    assert (a.val, a.avg, a.sum, a.count) == (b.val, b.avg, b.sum, b.count)


def test_manifest_parsing_matches_jax(tmp_path):
    lines = ["dir1,wav1,x,ni hao,0.0,0.4",
             "dir2,wav2,x,C,0.0,0.4",
             "dir3,7.31d3e1f43d431cecda814ff8ab3a4b437d,x,ma,0,0.2",
             "dir4,wav4,x,zhong guo,1.0,1.48",
             "dir5,wav5,x,notapinyin,0.0,0.4",
             "short,row"]
    p = tmp_path / "trn1.txt"
    p.write_text("\n".join(lines) + "\n")
    mine = manifest.read_manifest(str(p))
    theirs = jax_manifest.read_manifest(str(p))
    assert [(e.img_dir, e.wav_id, e.pinyins, e.start_frame, e.end_frame,
             e.label_ids) for e in mine] == \
        [(e.img_dir, e.wav_id, e.pinyins, e.start_frame, e.end_frame,
          e.label_ids) for e in theirs]
    assert len(mine) == 2 and manifest.read_manifest(str(p), limit=1)[0] == mine[0]


def _lrw_tree(root, splits=(("train", 2), ("val", 1))):
    rng = np.random.default_rng(1)
    for word in ["ABOUT", "WORLD"]:
        for split, n in splits:
            d = root / word / split
            d.mkdir(parents=True)
            for k in range(n):
                np.save(d / f"{word}_{k:05d}.npy",
                        rng.integers(0, 255, (5, 16, 16)).astype(np.uint8))
    # a float clip in [0, 1], as some LRW exports store them
    np.save(root / "WORLD" / "train" / "WORLD_00009.npy",
            rng.random((7, 16, 16)).astype(np.float32))


def _lrw1000_tree(tmp_path):
    imroot = tmp_path / "images"
    rng = np.random.default_rng(2)
    for d, frames in (("dir1", range(1, 6)), ("dir2", range(26, 29))):
        (imroot / d).mkdir(parents=True)
        for fr in frames:
            cv2.imwrite(str(imroot / d / f"{fr}.jpg"),
                        rng.integers(0, 255, (24, 20, 3)).astype(np.uint8))
    man = tmp_path / "m.txt"
    man.write_text("dir1,w1,x,ni hao,0.0,0.4\ndir2,w2,x,zhong guo,1.0,1.48\n"
                   "dir9,w9,x,ma,0.0,0.1\n")
    return imroot, man


def _same_samples(a, b, n):
    assert len(a) == len(b) == n
    for i in range(n):
        x, y = a[i], b[i]
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k]) and x[k].dtype == y[k].dtype, (i, k)


def test_datasets_from_tiny_trees_match_jax(tmp_path):
    _lrw_tree(tmp_path / "lrw")
    imroot, man = _lrw1000_tree(tmp_path)
    for split, n in (("train", 5), ("val", 2)):
        _same_samples(LrwDataset(str(tmp_path / "lrw"), split, frames=6),
                      jax_datasets.LrwDataset(str(tmp_path / "lrw"), split,
                                              frames=6), n)
    half = LrwDataset(str(tmp_path / "lrw"), "train", frames=6, data_fraction=0.5)
    assert len(half) == 2
    a = Lrw1000Dataset(str(imroot), str(man), frames=4, raw_size=16)
    b = jax_datasets.Lrw1000Dataset(str(imroot), str(man), frames=4, raw_size=16)
    _same_samples(a, b, 3)
    assert [int(a[i]["n_frames"]) for i in range(3)] == [4, 3, 0]
    mixed = MixedBilingualDataset(LrwDataset(str(tmp_path / "lrw")), a)
    assert mixed.stream_indices() == (list(range(5)), [5, 6, 7])
    assert np.array_equal(mixed[6]["labels"], a[1]["labels"])
    assert np.array_equal(mixed.labels_only(6), a.labels_only(1))
    assert words_1500()[int(a[1]["word_id"])] == "zhong guo"
    assert word_class_id("not a real word") == -1


def test_lrw1000_dataset_without_opencv_raises_clearly(tmp_path, monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("no module named cv2")
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="cv2 required"):
        Lrw1000Dataset(str(tmp_path), str(tmp_path / "m.txt"))


ARGVS = [
    [],
    ["--workload", "sbl_stage2", "--d_model", "256", "--n_head", "4",
     "--dropout", "0.2", "--k", "0.5", "--warmup_steps", "100",
     "--teacher_forcing_rate", "0.3", "--freeze", "frontend, encoder",
     "--batch-size", "16", "--compute-dtype", "float32",
     "--lrw-path", "/data/lrw", "--lrw1000-images", "/data/img",
     "--data-fraction", "0.5", "--secondary-batch-size", "3",
     "--label_smoothing", "0.2", "--n_layers_enc", "3", "--n_layers_dec", "2",
     "--d_inner", "512", "--pe_maxlen", "100"],
    ["--cache-on-device", "--compile-cache", "none", "--cpu"],
]


def _assert_fields_match(mine, theirs, path="cfg"):
    import dataclasses
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            _assert_fields_match(a, b, f"{path}.{f.name}")
        else:
            assert a == b, f"{path}.{f.name}: {a!r} != {b!r}"


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "overrides", "flags"])
def test_config_from_args_matches_jax(argv):
    mine = cli.config_from_args(cli.build_argparser().parse_args(argv))
    theirs = jax_cli.config_from_args(jax_cli.build_argparser().parse_args(argv))
    _assert_fields_match(mine, theirs)


@pytest.mark.parametrize("argv", [
    ["--workload", "lrw", "--mesh-model", "2"],
    ["--workload", "classify", "--profile-dir", "/tmp/p"],
    ["--mesh-data", "2"], ["--no-sync-batchnorm"],
    ["--remat-frontend"], ["--profile-dir", "/tmp/p"]])
def test_unported_flags_raise_with_their_roadmap_item(argv):
    # no flag is left unported: tensor parallelism (--mesh-model), data
    # parallelism, per-process BatchNorm, remat and the trace parse into
    # the config as JAX's CLI parses them
    args = cli.build_argparser().parse_args(argv + ["--cpu"])
    mine = cli.config_from_args(args)
    assert (mine.mesh.data, mine.mesh.model) == (
        args.mesh_data, args.mesh_model)
    theirs = jax_cli.config_from_args(jax_cli.build_argparser().parse_args(
        argv + ["--cpu"]))
    _assert_fields_match(mine, theirs)


def test_cli_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--cpu"):
        cli.run_train(["--synthetic"])
    assert cli.main([]) == 2


def test_make_datasets_synthetic_matches_jax():
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    argv = ["--synthetic", "--synthetic-size", "8"]
    cfg = C.tiny_test()
    for split in ("val", "test"):
        train, valid = cli.make_datasets(cfg, cli.build_argparser().parse_args(argv),
                                         split)
        jtrain, jvalid = jax_cli.make_datasets(
            cfg, jax_cli.build_argparser().parse_args(argv), split)
        _same_samples(train, jtrain, 8)
        assert valid.keys() == jvalid.keys() == {"lrw", "lrw1000"}
        for k in valid:
            _same_samples(valid[k], jvalid[k], 4)
