"""Real-data datasets of every workload: LRW npy clips, LRW-1000 jpg frame
directories, and their bilingual mix (counterpart of the JAX package's
``data/datasets.py``; the same files give the same samples).

Samples are dicts of numpy arrays in the form of ``SyntheticLipDataset``'s
(``word_id`` and ``lang_id`` are the ``classify`` labels): clips stay uint8
on the host, and crop, flip and normalization run on the device.  ``vocab``
names the labels' token table ('sbl', 'lrw' or 'lrw1000', as in JAX).
``Lrw1000Dataset(wav_root=...)`` adds LRW-1000's audio stream (the
reference's audio-visual variants): each sample's ``audio`` is its wav's
80-dim log-mel fbank with LFR stacking (``data/audio.py``), zero-padded to
``audio_pad_frames`` frames; a wav that is missing or unreadable gives
zeros.  No workload of either package reads it.
OpenCV decodes the LRW-1000 jpgs and is imported only when such a dataset
is built, so the rest of the port runs without it.
"""
from __future__ import annotations

import glob
import os
import wave
from typing import Dict, List, Optional

import numpy as np

from ..vocab import encode_pinyin_ids, encode_word_ids, word_class_id
from .audio import build_lfr_features, extract_fbank
from .manifest import Lrw1000Entry, read_manifest
from .synthetic import _pad_labels


class LrwDataset:
    """LRW word clips stored as (29, 96, 96) uint8-convertible .npy files,
    one directory per word with train/val/test splits
    (``<root>/<WORD>/<split>/<WORD>_*.npy``, reference data_gen.py:137-151)."""

    def __init__(self, root: str, split: str = "train", frames: int = 30,
                 pad_len: int = 14, data_fraction: float = 1.0,
                 vocab: str = "sbl"):
        self.frames = frames
        self.pad_len = pad_len
        self.samples: List[tuple] = []
        label_cache: Dict[str, tuple] = {}
        for fold in sorted(glob.glob(os.path.join(root, "*"))):
            files = sorted(glob.glob(os.path.join(fold, split, "*.npy")))
            files = files[:int(len(files) * data_fraction)]
            for f in files:
                word = os.path.basename(f).split("_")[0]
                if word not in label_cache:
                    ids = encode_word_ids(word, vocab)
                    label_cache[word] = (
                        _pad_labels(ids, pad_len),
                        _pad_labels(ids[::-1], pad_len),
                        np.int32(word_class_id(word)))
                self.samples.append((f, word))
        self._labels = label_cache

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        path, word = self.samples[i]
        arr = np.load(path)
        if arr.dtype != np.uint8:
            # stored floats in [0, 1] or [0, 255]
            arr = (arr * 255.0).astype(np.uint8) if arr.max() <= 1.0 \
                else arr.astype(np.uint8)
        clip = np.zeros((self.frames,) + arr.shape[1:], dtype=np.uint8)
        n = min(len(arr), self.frames)
        clip[:n] = arr[:self.frames]
        labels, labels_rev, word_id = self._labels[word]
        return {"clip_u8": clip, "labels": labels,
                "labels_reverse": labels_rev, "lang_id": np.int32(0),
                "word_id": word_id, "n_frames": np.int32(n)}

    def labels_only(self, i: int) -> np.ndarray:
        """Label ids without reading the clip."""
        return self._labels[self.samples[i][1]][0]

    def lang_ids(self) -> np.ndarray:
        """Every sample's lang_id (0) without reading a clip."""
        return np.zeros(len(self), np.int32)


class Lrw1000Dataset:
    """LRW-1000 clips as jpg frame directories + a (clean) manifest
    (reference load_images, data_gen.py:59-97): frames ``{st..ed}.jpg``
    resized to raw_size, at most ``frames`` of them, zero-padded."""

    def __init__(self, images_root: str, manifest_path: str,
                 frames: int = 30, raw_size: int = 96, pad_len: int = 14,
                 limit: Optional[int] = None, wav_root: Optional[str] = None,
                 audio_dim: int = 80, lfr_m: int = 4, lfr_n: int = 3,
                 audio_pad_frames: int = 88, vocab: str = "sbl"):
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("cv2 required for LRW-1000 jpg decoding") from e
        self._cv2 = cv2
        self.images_root = images_root
        self.frames = frames
        self.raw = raw_size
        self.pad_len = pad_len
        self.wav_root = wav_root
        self.audio_dim = audio_dim
        self.lfr_m, self.lfr_n = lfr_m, lfr_n
        self.audio_pad_frames = audio_pad_frames
        self.vocab = vocab
        self.entries: List[Lrw1000Entry] = read_manifest(manifest_path,
                                                         limit=limit)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        cv2 = self._cv2
        e = self.entries[i]
        st, ed = e.start_frame, e.end_frame
        if ed > st + self.frames:
            ed = st + self.frames
        if st == ed:
            ed = st + 1
        clip = np.zeros((self.frames, self.raw, self.raw), dtype=np.uint8)
        t = 0
        for fr in range(st, ed):
            path = os.path.join(self.images_root, e.img_dir, f"{fr}.jpg")
            if not os.path.exists(path):
                continue
            img = cv2.imread(path)
            if img is None:
                continue
            img = cv2.resize(img, (self.raw, self.raw))
            clip[t] = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            t += 1
        ids = encode_pinyin_ids(e.pinyins, self.vocab)
        out = {"clip_u8": clip, "labels": _pad_labels(ids, self.pad_len),
               "labels_reverse": _pad_labels(ids[::-1], self.pad_len),
               "lang_id": np.int32(1),
               "word_id": np.int32(word_class_id(" ".join(e.pinyins))),
               "n_frames": np.int32(t)}
        if self.wav_root is not None:
            out["audio"] = self._load_audio(e)
        return out

    def labels_only(self, i: int) -> np.ndarray:
        """Label ids without decoding any jpg."""
        return _pad_labels(encode_pinyin_ids(self.entries[i].pinyins, self.vocab),
                           self.pad_len)

    def lang_ids(self) -> np.ndarray:
        """Every sample's lang_id (1) without decoding a jpg."""
        return np.ones(len(self), np.int32)

    def _load_audio(self, e: Lrw1000Entry) -> np.ndarray:
        """(audio_pad_frames, audio_dim * lfr_m) f32 fbank + LFR features of
        ``<wav_root>/<wav_id>.wav`` (16-bit PCM), zeros where it is missing,
        unreadable or empty."""
        d = self.audio_dim * self.lfr_m
        out = np.zeros((self.audio_pad_frames, d), dtype=np.float32)
        path = os.path.join(self.wav_root, e.wav_id + ".wav")
        try:
            with wave.open(path, "rb") as w:
                sr = w.getframerate()
                raw = w.readframes(w.getnframes())
            y = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
            if len(y) == 0:
                return out
            feat = extract_fbank(y, sr=sr, dim=self.audio_dim)
            feat = build_lfr_features(feat, self.lfr_m, self.lfr_n)
            n = min(len(feat), self.audio_pad_frames)
            out[:n] = feat[:n]
        except (OSError, wave.Error):
            pass
        return out


class MixedBilingualDataset:
    """LRW + LRW-1000 concatenation (the SBL 'all' kind, data_gen.py:128)."""

    def __init__(self, lrw: LrwDataset, lrw1000: Lrw1000Dataset):
        self.lrw = lrw
        self.lrw1000 = lrw1000

    def __len__(self):
        return len(self.lrw) + len(self.lrw1000)

    def __getitem__(self, i: int):
        if i < len(self.lrw):
            return self.lrw[i]
        return self.lrw1000[i - len(self.lrw)]

    def labels_only(self, i: int) -> np.ndarray:
        if i < len(self.lrw):
            return self.lrw.labels_only(i)
        return self.lrw1000.labels_only(i - len(self.lrw))

    def lang_ids(self) -> np.ndarray:
        """Every sample's lang_id without reading a clip."""
        return np.concatenate([self.lrw.lang_ids(), self.lrw1000.lang_ids()])

    def stream_indices(self):
        """(LRW indices, LRW-1000 indices) for ``TwoStreamBatchSampler``
        (reference train.py:83-90)."""
        n = len(self.lrw)
        return list(range(n)), list(range(n, n + len(self.lrw1000)))
