"""LRW-1000 annotation manifests: reading them, and the offline tools that
write a clean one (counterpart of the JAX package's ``data/manifest.py``).

The reference reads ``trn1.txt`` / ``val1.txt`` / ``tst1.txt`` rows of the
form (SBL data_gen.py:159-177)

    img_dir,wav_id,<unused>,pinyins,start_sec,end_sec

with frame indices ``int(t * 25) + 1``, and drops a known-corrupt clip and
the bogus labels 'C' and 'n'; rows whose pinyin the phoneme map lacks are
dropped too.  ``build_clean_manifest`` also drops rows whose wav is silent
(``wav_is_silent``: no 16-bit sample on disk), so that training reads the
clean manifest without probing audio; ``build_vocab_pickle`` writes the
character-level VOCAB/IVOCAB tables as JSON.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Optional

from ..vocab import chinese_phoneme_map, encode_pinyin_seq

CORRUPT_IDS = ("7.31d3e1f43d431cecda814ff8ab3a4b437d",)
BAD_LABELS = ("C", "n")
FPS = 25


@dataclasses.dataclass(frozen=True)
class Lrw1000Entry:
    img_dir: str
    wav_id: str
    pinyins: List[str]
    start_frame: int
    end_frame: int

    @property
    def label_ids(self) -> List[int]:
        return encode_pinyin_seq(self.pinyins)


def parse_manifest_line(line: str) -> Optional[Lrw1000Entry]:
    """One manifest row -> entry, or None if filtered (bad label, corrupt
    clip, unknown pinyin)."""
    if any(c in line for c in CORRUPT_IDS):
        return None
    items = line.strip(" ").split(",")
    if len(items) < 6 or items[3] in BAD_LABELS:
        return None
    pinyins = items[3].split(" ")
    cmap = chinese_phoneme_map()
    if any(p not in cmap for p in pinyins):
        return None
    st = int(float(items[4]) * FPS) + 1
    ed = int(float(items[5]) * FPS) + 1
    return Lrw1000Entry(img_dir=items[0], wav_id=items[1], pinyins=pinyins,
                        start_frame=st, end_frame=ed)


def read_manifest(path: str, limit: Optional[int] = None) -> List[Lrw1000Entry]:
    out = []
    with open(path, "r") as f:
        for line in f.read().splitlines():
            e = parse_manifest_line(line)
            if e is not None:
                out.append(e)
            if limit is not None and len(out) >= limit:
                break
    return out


def wav_is_silent(path: str) -> bool:
    """Offline replacement for the reference's librosa silence probe
    (data_gen.py:175-177: keep iff len(librosa.load(wav)) > 0).  Walks the
    RIFF chunk list and checks the ``data`` chunk holds >=1 sample that is
    actually present in the file (no audio decode): a wav with a valid
    header but a truncated or empty payload is silent, like the
    reference's decode-based probe would find."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            hdr = f.read(12)
            if len(hdr) < 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
                return True
            pos = 12
            while pos + 8 <= size:
                f.seek(pos)
                chunk = f.read(8)
                if len(chunk) < 8:
                    return True
                cid = chunk[:4]
                clen = int.from_bytes(chunk[4:8], "little")
                if cid == b"data":
                    # payload must exist on disk, not just in the header
                    avail = max(0, min(clen, size - (pos + 8)))
                    return avail < 2  # < one 16-bit sample
                pos += 8 + clen + (clen & 1)  # chunks are word-aligned
            return True  # no data chunk
    except OSError:
        return True


def build_clean_manifest(raw_path: str, out_path: str, wav_root: str,
                         check_audio: bool = True) -> int:
    """Filter a raw manifest (bad labels, corrupt ids, silent wavs) into a
    clean one the training job can mmap-read without audio probing."""
    kept = 0
    with open(raw_path, "r") as f, open(out_path, "w") as out:
        for line in f.read().splitlines():
            e = parse_manifest_line(line)
            if e is None:
                continue
            if check_audio and wav_is_silent(
                    os.path.join(wav_root, e.wav_id + ".wav")):
                continue
            out.write(line.rstrip("\n") + "\n")
            kept += 1
    return kept


def build_vocab_pickle(sample_labels: Iterable[str], out_path: str) -> dict:
    """Character-level VOCAB/IVOCAB builder (pre_process.py equivalent),
    emitted as JSON rather than pickle."""
    vocab = {"<sos>": 0, "<eos>": 1}
    for label in sample_labels:
        for ch in label:
            if ch not in vocab:
                vocab[ch] = len(vocab)
    ivocab = {v: k for k, v in vocab.items()}
    data = {"VOCAB": vocab, "IVOCAB": ivocab}
    with open(out_path, "w") as f:
        json.dump(data, f, ensure_ascii=False)
    return data
