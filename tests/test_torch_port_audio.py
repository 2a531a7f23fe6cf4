"""CPU parity of the port's LRW-1000 audio stream against the JAX package:
``data/audio.py`` function by function on seeded waveforms,
``Lrw1000Dataset(wav_root=...)`` item by item on a tiny tree (jpgs through
OpenCV, 16-bit wavs through ``wave``, one wav missing), and the manifest
tools (``wav_is_silent``, ``build_clean_manifest``, ``build_vocab_pickle``)
with one silent wav.  The port's copy is the same numpy code, so every
result must be bit-identical.  OpenCV is installed here and not on the
card's machine, so the jpg-based dataset is checked on the CPU only.
"""
import json
import wave

import cv2
import numpy as np
import pytest

from sbl_for_multilingual_lip_reading_tpu.data import audio as jax_audio
from sbl_for_multilingual_lip_reading_tpu.data import datasets as jax_datasets
from sbl_for_multilingual_lip_reading_tpu.data import manifest as jax_manifest
from sbl_for_multilingual_lip_reading_tpu_torch.data import audio, manifest
from sbl_for_multilingual_lip_reading_tpu_torch.data import Lrw1000Dataset

SR = 16000


def _waveform(seed, seconds=0.6, silence=0.15):
    """A seeded waveform: silence, two tones with noise, silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    tone = (0.3 * np.sin(2 * np.pi * rng.uniform(150, 900) * t)
            + 0.2 * np.sin(2 * np.pi * rng.uniform(900, 3000) * t)
            + 0.02 * rng.standard_normal(t.shape))
    pad = np.zeros(int(SR * silence))
    return np.concatenate([pad, tone, pad]).astype(np.float32)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_audio_functions_match_jax(seed):
    y = _waveform(seed)
    for fn, args in (("peak_normalize", (y,)), ("peak_normalize", (np.zeros(8),)),
                     ("energy_trim", (y, SR)), ("energy_trim", (y[:100], SR)),
                     ("hz_to_mel", (np.linspace(0, 8000, 33),)),
                     ("mel_to_hz", (np.linspace(0, 40, 33),)),
                     ("mel_filterbank", (SR, 400, 80)),
                     ("stft_power", (y, 400, 160)),
                     ("stft_power", (y[:150], 400, 160)),
                     ("extract_fbank", (y,)),
                     ("extract_mfcc", (y,))):
        _equal(getattr(audio, fn)(*args), getattr(jax_audio, fn)(*args))
    for kw in (dict(dim=40, cmvn=False), dict(trim=False, window_ms=20, stride_ms=8)):
        _equal(audio.extract_fbank(y, **kw), jax_audio.extract_fbank(y, **kw))
    feat = audio.extract_fbank(y)
    for m, n in ((4, 3), (1, 1), (5, 2)):
        _equal(audio.build_lfr_features(feat, m, n),
               jax_audio.build_lfr_features(feat, m, n))


def _write_wav(path, y):
    pcm = np.clip(y * 32767, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def _tree(tmp_path):
    """Two jpg clips and a third without frames; wavs for w1 (voiced), w2
    (a header and no samples: silent), none for w9."""
    imroot, wavroot = tmp_path / "images", tmp_path / "wav"
    rng = np.random.default_rng(2)
    for d, frames in (("dir1", range(1, 6)), ("dir2", range(26, 29))):
        (imroot / d).mkdir(parents=True)
        for fr in frames:
            cv2.imwrite(str(imroot / d / f"{fr}.jpg"),
                        rng.integers(0, 255, (24, 20, 3)).astype(np.uint8))
    wavroot.mkdir()
    _write_wav(wavroot / "w1.wav", _waveform(5, seconds=1.2))
    _write_wav(wavroot / "w2.wav", np.zeros(0, np.float32))
    man = tmp_path / "m.txt"
    man.write_text("dir1,w1,x,ni hao,0.0,0.4\ndir2,w2,x,zhong guo,1.0,1.48\n"
                   "dir9,w9,x,ma,0.0,0.1\ndir3,w3,x,C,0.0,0.4\n")
    return imroot, wavroot, man


@pytest.mark.parametrize("kw", [{}, dict(audio_dim=40, lfr_m=3, lfr_n=2,
                                         audio_pad_frames=20)])
def test_lrw1000_audio_items_match_jax(tmp_path, kw):
    imroot, wavroot, man = _tree(tmp_path)
    args = (str(imroot), str(man))
    opts = dict(frames=4, raw_size=16, wav_root=str(wavroot), **kw)
    mine, theirs = Lrw1000Dataset(*args, **opts), jax_datasets.Lrw1000Dataset(
        *args, **opts)
    assert len(mine) == len(theirs) == 3
    for i in range(3):
        a, b = mine[i], theirs[i]
        assert a.keys() == b.keys() and "audio" in a
        for k in a:
            _equal(a[k], b[k])
    dim = opts.get("audio_dim", 80) * opts.get("lfr_m", 4)
    assert mine[0]["audio"].shape == (opts.get("audio_pad_frames", 88), dim)
    assert mine[0]["audio"].any()
    # the silent wav and the missing one give zeros
    assert not mine[1]["audio"].any() and not mine[2]["audio"].any()
    assert "audio" not in Lrw1000Dataset(*args, frames=4, raw_size=16)[0]


def test_manifest_tools_match_jax(tmp_path):
    _, wavroot, man = _tree(tmp_path)
    (wavroot / "bad.wav").write_bytes(b"RIFX" + bytes(40))
    for name in ("w1", "w2", "w9", "bad"):
        path = str(wavroot / f"{name}.wav")
        assert manifest.wav_is_silent(path) == jax_manifest.wav_is_silent(path)
    assert not manifest.wav_is_silent(str(wavroot / "w1.wav"))
    assert manifest.wav_is_silent(str(wavroot / "w2.wav"))
    for check_audio in (True, False):
        outs = [tmp_path / f"{who}_{check_audio}.txt" for who in ("port", "jax")]
        kept = [fn(str(man), str(o), str(wavroot), check_audio)
                for fn, o in zip((manifest.build_clean_manifest,
                                  jax_manifest.build_clean_manifest), outs)]
        assert kept[0] == kept[1] == (1 if check_audio else 3)
        assert outs[0].read_text() == outs[1].read_text()
    labels = ["ni hao", "zhong guo", "abc"]
    got = manifest.build_vocab_pickle(labels, str(tmp_path / "port.json"))
    want = jax_manifest.build_vocab_pickle(labels, str(tmp_path / "jax.json"))
    assert got == want
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))
