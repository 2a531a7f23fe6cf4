"""LRW-1000 annotation manifests (the reading half of the JAX package's
``data/manifest.py``; its offline manifest writers stay there).

The reference reads ``trn1.txt`` / ``val1.txt`` / ``tst1.txt`` rows of the
form (SBL data_gen.py:159-177)

    img_dir,wav_id,<unused>,pinyins,start_sec,end_sec

with frame indices ``int(t * 25) + 1``, and drops a known-corrupt clip and
the bogus labels 'C' and 'n'; rows whose pinyin the phoneme map lacks are
dropped too.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

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
