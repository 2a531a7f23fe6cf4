"""The port's native host runtime (``utils/native.py``, ``csrc/sbl_native.cc``)
against the JAX package's, and ``utils/metrics.py::topk_accuracy``.

The library is built with g++ from the port's own copy of the source (the
tests skip only where there is no g++; a build that fails fails them), and
never loaded from the JAX package's ``native/``.  ``levenshtein_native``
must equal JAX's Python ``levenshtein``, and ``load_clip_batch`` JAX's
``load_clip_batch`` and ``np.load`` on ``tests/test_native.py``'s three
cases (uint8, float scaling, a bad path) and on a clip the library refuses
(int16), which is retried in numpy.
"""
import shutil
import threading

import numpy as np
import pytest

from sbl_for_multilingual_lip_reading_tpu.utils import metrics as jax_metrics
from sbl_for_multilingual_lip_reading_tpu.utils import native as jax_native
from sbl_for_multilingual_lip_reading_tpu_torch.utils import metrics, native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native runtime")


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.build(verbose=True), "the native runtime did not build"


def test_library_is_built_from_the_ports_own_source():
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.SOURCE.parent.name == "csrc"
    assert native.available() and native._lib._name == str(path)
    assert "-march=native" not in native.CXX_FLAGS


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    target = native.library_path()
    errors = []

    def build():
        try:
            native._compile(target)
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [target.name]
    assert native._bind(target).sbl_levenshtein is not None


def test_levenshtein_native_matches_jax():
    rng = np.random.default_rng(0)
    pairs = [([], []), ([1, 2], []), ([], [3])]
    for _ in range(300):
        pairs.append((rng.integers(0, 10, rng.integers(0, 15)).tolist(),
                      rng.integers(0, 10, rng.integers(0, 15)).tolist()))
    for a, b in pairs:
        want = jax_metrics.levenshtein(a, b)
        assert native.levenshtein_native(a, b) == want == metrics.levenshtein(a, b)


def _both(paths, **kw):
    got = native.load_clip_batch(paths, **kw)
    want = jax_native.load_clip_batch(paths, **kw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    return got


def test_clip_batch_uint8_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    paths, clips = [], []
    for i in range(3):
        clip = rng.integers(0, 255, (29, 16, 16)).astype(np.uint8)
        np.save(tmp_path / f"c{i}.npy", clip)
        paths.append(str(tmp_path / f"c{i}.npy"))
        clips.append(clip)
    out = _both(paths, frames=30, h=16, w=16)
    assert out.shape == (3, 30, 16, 16)
    for i in range(3):
        np.testing.assert_array_equal(out[i, :29], clips[i])
        assert out[i, 29].sum() == 0


def test_clip_batch_float_scaling_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    clip01 = rng.random((5, 8, 8)).astype(np.float32)
    clip255 = (rng.random((5, 8, 8)) * 255).astype(np.float32)
    clip64 = rng.random((5, 8, 8))
    for name, clip in (("a", clip01), ("b", clip255), ("c", clip64)):
        np.save(tmp_path / f"{name}.npy", clip)
    out = _both([str(tmp_path / f"{n}.npy") for n in "abc"], frames=5, h=8, w=8)
    np.testing.assert_allclose(out[0], np.clip(clip01 * 255, 0, 255).astype(np.uint8),
                               atol=1)
    np.testing.assert_allclose(out[1], np.clip(clip255, 0, 255).astype(np.uint8),
                               atol=1)
    np.testing.assert_allclose(out[2], np.clip(clip64 * 255, 0, 255).astype(np.uint8),
                               atol=1)


def test_clip_batch_bad_path_and_refused_dtype(tmp_path):
    rng = np.random.default_rng(3)
    clip = rng.integers(0, 255, (4, 8, 8)).astype(np.uint8)
    wide = rng.integers(0, 255, (4, 8, 8)).astype(np.int16)
    np.save(tmp_path / "ok.npy", clip)
    np.save(tmp_path / "wide.npy", wide)
    out = _both([str(tmp_path / "ok.npy"), str(tmp_path / "missing.npy"),
                 str(tmp_path / "wide.npy")], frames=4, h=8, w=8, nthreads=2)
    np.testing.assert_array_equal(out[0], clip)
    assert out[1].sum() == 0
    # the library refuses int16; numpy's retry fills the slot
    np.testing.assert_array_equal(out[2], wide.astype(np.uint8))


@pytest.mark.parametrize("k", [1, 2, 5])
def test_topk_accuracy_matches_jax(k):
    rng = np.random.default_rng(k)
    scores = rng.standard_normal((40, 12))
    targets = rng.integers(0, 12, 40)
    got = metrics.topk_accuracy(scores, targets, k)
    assert got == jax_metrics.topk_accuracy(scores, targets, k)
    assert 0.0 <= got <= 100.0
