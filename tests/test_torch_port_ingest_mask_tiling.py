"""The geometry and the arithmetic of K6 (``ingest_train``) and K5
(``dropout_keep_mask_flat``), emulated on the CPU before any card run.

K6 (``csrc/ingest.cu``): a block of 256 threads owns one frame; a thread owns
the output pieces threadIdx.x, + 256, ... of a frame (16 bytes: 8 bf16 or 4
f32 outputs of one row on the vector route, one output on the scalar
route), found by one division a thread and then carries.  A piece's source
bytes come from two aligned words of its source row, a funnel shift and a
byte selector that also reverses a flipped piece; ``0x4B0000vv - 2^23``
turns a byte into an f32 without I2F; the normalization rounds twice; bf16
pairs round to nearest even.  The emulation repeats that word by word and
shows that every output is written once, that every load and store of the
vector route is aligned and inside its tensor, and that the result equals
the plain version bit for bit (and JAX's Pallas kernel in interpret mode
within the tolerances of ``test_ingest_train_plain_matches_jax``).

K5 (``csrc/attention_train.cu``): a thread owns 16 consecutive flat
elements of the (B, H, Tq, Tk) mask, decomposes the first by three
multiply-high divisions (``FastDiv``) and steps the rest by carries, and
stores them with one 16-byte store (singly past the last whole 16).  The
emulation shows that every element is written once and that the mask
equals the plain Philox bit for bit, at the train step's shapes and at
awkward ones.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu.ops.ingest import (
    ingest_train as jax_ingest_train)
from sbl_for_multilingual_lip_reading_tpu_torch import ops
from sbl_for_multilingual_lip_reading_tpu_torch.ops import _build, attention, ingest

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

INGEST_SRC = (_build.CSRC / "ingest.cu").read_text()
MASK_SRC = (_build.CSRC / "attention_train.cu").read_text()
M32 = 0xFFFFFFFF


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


THREADS = _constant(INGEST_SRC, "kThreads")
MASK_THREADS = _constant(MASK_SRC, "kMaskThreads")
MASK_RUN = _constant(MASK_SRC, "kMaskRun")


def test_the_emulation_takes_the_sources_constants():
    assert (THREADS, _constant(INGEST_SRC, "kPieceBytes")) == (256, ingest.PIECE_BYTES)
    assert (MASK_THREADS, MASK_RUN) == (128, 16)
    # U pieces a round: 32 / epv on the vector route, 8 on the scalar one
    assert "launch<T, epv, 32 / epv>" in INGEST_SRC and "launch<T, 1, 8>" in INGEST_SRC
    assert "crop % epv == 0 && W % epv == 0 && aligned16(clips) && aligned16(out)" in INGEST_SRC
    assert attention.MAX_MASK_ELEMENTS == 2 ** 31
    assert "n >= (1LL << 31)" in MASK_SRC
    assert chip_smoke.K5_RUN == MASK_RUN


def _philox_word0_needs(rounds=10):
    """(products, XORs) word 0 of Philox4x32 after ``rounds`` rounds needs,
    found by walking the round's data flow back from it: a product counts
    once whether one or both of its halves are used."""
    need = {"c0"}  # the words the round after needs
    products = xors = 0
    for _ in range(rounds):
        before, uses = set(), {"p0": False, "p1": False}
        for word in need:
            if word == "c0":    # hi1 ^ c1 ^ k0
                uses["p1"], xors = True, xors + 1
                before.add("c1")
            elif word == "c1":  # lo1
                uses["p1"] = True
            elif word == "c2":  # hi0 ^ c3 ^ k1
                uses["p0"], xors = True, xors + 1
                before.add("c3")
            else:               # c3 = lo0
                uses["p0"] = True
        before |= {"c0"} if uses["p0"] else set()
        before |= {"c2"} if uses["p1"] else set()
        products += uses["p0"] + uses["p1"]
        need = before
    return products, xors


def test_k5_bound_counts_what_one_philox_word_needs():
    """chip_smoke bounds K5 by its function, not its kernel's SASS: the
    products and XORs of word 0 of Philox4x32-10 (19 and 18), and three
    ALU instructions an element (the counter's step, the compare, the
    OR into the packed word)."""
    assert _philox_word0_needs() == (chip_smoke.K5_IMAD, chip_smoke.K5_ALU - 3) == (19, 18)
    n = 480 * 8 * 17 * 17
    ms, by = chip_smoke.k5_bound(n)
    assert by == "operations"
    assert ms == pytest.approx(n * 21 / chip_smoke.INT32_OPS * 1e3)
    assert 0.00139 < ms < 0.00140


def test_chip_smoke_ingest_cases_take_the_routes_they_expect():
    """chip_smoke.py phase 3c's cases off the train step's shape, each on
    the route it checks, as ``route`` sees the tensors it builds."""
    for name, (B, T, raw, crop), offset, out_offset, expect in chip_smoke.INGEST_CASES:
        clips = torch.zeros(B * T * raw * raw + offset, dtype=torch.uint8)[offset:]
        for dtype in (torch.float32, torch.bfloat16):
            out = torch.zeros(B * T * crop * crop + out_offset, dtype=dtype)[out_offset:]
            got = "vector" if ingest.route(clips.view(B, T, raw, raw), out, crop) > 1 else "scalar"
            assert got == expect, (name, dtype)


def test_sass_counts_sorts_instructions_by_pipe(monkeypatch):
    """chip_smoke.sass_counts on a cuobjdump listing: IMAD on the FMA pipe,
    logic, compare and select on the ALU, F* arithmetic apart; NOPs,
    uniform-datapath instructions and the self-branch after EXIT not
    issued; predicated instructions counted."""
    text = """
        Function : _ZN12_GLOBAL__N_124dropout_keep_mask_kernelEPhj
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   UIADD3 UR8, UR6, -0x61c88647, URZ ;
        /*0020*/                   IMAD.WIDE.U32 R6, R28, -0x2daee0ad, RZ ;
        /*0030*/                   LOP3.LUT R18, R7, R26, R3, 0x96, !PT ;
        /*0040*/               @P0 IMAD.MOV R14, RZ, RZ, R26 ;
        /*0050*/                   ISETP.NE.AND P0, PT, R28, R21, PT ;
        /*0060*/                   SEL R24, R24, RZ, P0 ;
        /*0070*/                   FADD R2, R3, -8388608 ;
        /*0080*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
        /*00b0*/                   NOP;
        Function : _Z5otherv
        /*0000*/                   IMAD R1, R1, R1, RZ ;
"""
    monkeypatch.setitem(chip_smoke._SASS, "text", text)
    found = chip_smoke.sass_counts(r"(dropout_keep_mask_kernel)")
    assert found == {("dropout_keep_mask_kernel",): dict(imad=2, alu=3, f32=1, issue=9)}


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _byte_perm(x, y, s):
    """__byte_perm(x, y, s): result byte n is byte (s >> 4n) & 7 of the
    eight bytes x (0-3) and y (4-7)."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    s = np.asarray(s, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for n in range(4):
        sel = (s >> np.uint64(4 * n)) & np.uint64(7)
        out |= ((both >> (sel * np.uint64(8))) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _funnelshift_r(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh): the low 32 bits of (hi:lo) >> (sh & 31)."""
    both = np.asarray(lo, np.uint64) | (np.asarray(hi, np.uint64) << np.uint64(32))
    return ((both >> (np.asarray(sh, np.uint64) & np.uint64(31))) & np.uint64(M32)).astype(
        np.uint32)


def _byte_as_f32(word, sel):
    bits = _byte_perm(word, 0x4B000000, 0x7540 | np.asarray(sel, np.uint32))
    return bits.view(np.float32) - np.float32(8388608.0)


def _normalize(v):
    return (v * np.float32(ingest.INV_STD)).astype(np.float32) - np.float32(ingest.SHIFT)


def _to_bits(f, itemsize):
    """f32 -> its bits, or bf16 round to nearest even (no NaN here)."""
    b = f.astype(np.float32).view(np.uint32).astype(np.uint64)
    if itemsize == 4:
        return b.astype(np.uint32)
    return ((b + np.uint64(0x7FFF) + ((b >> np.uint64(16)) & np.uint64(1)))
            >> np.uint64(16)).astype(np.uint16)


class Ingest:
    """K6 over one launch, thread by thread as csrc/ingest.cu computes it:
    the output's bits, each output's write count, and every load and store
    (byte address, width)."""

    def __init__(self, clips, offsets, flip, fmap, n_frames, crop, itemsize, epv,
                 clips_base=0, out_base=0):
        B, T, H, W = clips.shape
        self.flat = clips.reshape(-1)
        self.crop, self.itemsize, self.epv = crop, itemsize, epv
        U = 32 // epv if epv > 1 else 8
        self.out = np.zeros(B * T * crop * crop, np.uint16 if itemsize == 2 else np.uint32)
        self.writes = np.zeros(self.out.size, np.int64)
        self.loads, self.stores = [], []
        self.clips_base, self.out_base = clips_base, out_base
        ppr = crop // epv
        tid = np.arange(THREADS)
        r0, c0 = tid // ppr, tid - (tid // ppr) * ppr
        dr, dc = THREADS // ppr, THREADS % ppr
        for bt in range(B * T):      # one block a frame
            b, t = divmod(bt, T)
            o = bt * crop * crop
            r, c = r0.copy(), c0.copy()
            if n_frames is not None and t >= n_frames[b]:
                while (r < crop).any():
                    on = r < crop
                    self._store(o + r[on] * crop + c[on] * epv, np.zeros((on.sum(), max(epv, 1))))
                    r, c = self._step(r, c, dr, dc, ppr)
                continue
            src = min(max(int(fmap[b, t]), 0), T - 1)
            oy = min(max(int(offsets[b, t, 0]), 0), H - crop)
            ox = min(max(int(offsets[b, t, 1]), 0), W - crop)
            fl = bool(flip[b])
            frame = ((b * T + src) * H + oy) * W
            s0, ds = (ox + crop - epv, -epv) if fl else (ox, epv)
            rev = 3 if fl else 0
            while (r < crop).any():
                pieces = []
                for _ in range(U):           # the round's loads first
                    on = r < crop
                    at = o + r[on] * crop + c[on] * epv
                    row = frame + r[on] * W
                    pieces.append((at, self._load(row, s0 + ds * c[on])))
                    r, c = self._step(r, c, dr, dc, ppr)
                for at, words in pieces:     # then the conversions and stores
                    self._store(at, self._convert(words, rev))

    @staticmethod
    def _step(r, c, dr, dc, ppr):
        c, r = c + dc, r + dr
        wrap = c >= ppr
        return r + wrap, c - ppr * wrap

    def _word(self, addr, width):
        self.loads.append((addr, width))
        b = self.flat[addr[:, None] + np.arange(width)].astype(np.uint64)
        return (b << (np.uint64(8) * np.arange(width, dtype=np.uint64))).sum(1, dtype=np.uint64)

    def _load(self, row, s):
        epv = self.epv
        if epv == 1:
            return self._word(row + s, 1), s
        w0 = self._word(row + (s // epv) * epv, epv)
        w1 = self._word(row + ((s + epv - 1) // epv) * epv, epv)
        return (w0, w1), s

    def _convert(self, loaded, rev):
        words, s = loaded
        epv = self.epv
        if epv == 1:
            f = _byte_as_f32(words.astype(np.uint32), 0)[:, None]
        elif epv == 4:
            w = _funnelshift_r(words[0], words[1], 8 * (s & 3))
            f = np.stack([_byte_as_f32(w, e ^ rev) for e in range(4)], 1)
        else:
            (w0, w1), upper, sh = words, (s & 4) != 0, 8 * (s & 3)
            x0, y0 = w0 & np.uint64(M32), w0 >> np.uint64(32)
            x1, y1 = w1 & np.uint64(M32), w1 >> np.uint64(32)
            a, b, c = np.where(upper, y0, x0), np.where(upper, x1, y0), np.where(upper, y1, x1)
            lo, hi = _funnelshift_r(a, b, sh), _funnelshift_r(b, c, sh)
            first, second = (hi, lo) if rev else (lo, hi)
            f = np.stack([_byte_as_f32(first, e ^ rev) for e in range(4)]
                         + [_byte_as_f32(second, e ^ rev) for e in range(4)], 1)
        return _normalize(f.astype(np.float32))

    def _store(self, at, values):
        n = values.shape[1]
        self.stores.append((at, n))
        idx = at[:, None] + np.arange(n)
        self.out[idx] = _to_bits(values, self.itemsize)
        np.add.at(self.writes, idx.reshape(-1), 1)

    def check_addresses(self, n_clip):
        """Every access lies inside its tensor; on the vector route every
        load is word-aligned and every store 16-byte aligned (relative to
        16-byte aligned bases)."""
        for addr, width in self.loads:
            assert (addr >= 0).all() and (addr + width <= n_clip).all()
            if self.epv > 1:
                assert ((self.clips_base + addr) % width == 0).all()
        for at, n in self.stores:
            assert (at >= 0).all() and (at + n <= self.out.size).all()
            if self.epv > 1:
                assert ((self.out_base + at * self.itemsize) % ingest.PIECE_BYTES == 0).all()


def _plain_bits(clips, offsets, flip, fmap, nf, crop, dtype):
    got = ops.ingest_train_plain(
        torch.from_numpy(clips), torch.from_numpy(offsets), torch.from_numpy(flip),
        torch.from_numpy(fmap), crop, dtype, None if nf is None else torch.from_numpy(nf))
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    return got.view(view).numpy().reshape(-1).view(
        np.uint16 if dtype == torch.bfloat16 else np.uint32)


def _all_offset_plans():
    """Plan sets at (2, 3, 96, 96) -> 88 covering every (oy, ox) in 0..8 in
    an unflipped and a flipped clip, source frames drawn with repeats; then
    sets with padded slots."""
    rng = np.random.default_rng(7)
    combos = [(oy, ox) for oy in range(9) for ox in range(9)]
    sets = []
    for k in range(0, len(combos), 3):
        offsets = np.array([combos[k:k + 3]] * 2, np.int32)
        sets.append((offsets, np.array([0, 1], np.uint8),
                     rng.integers(0, 3, (2, 3)).astype(np.int32), None))
    for nf in ((1, 2), (3, 0), (2, 3)):
        offsets = rng.integers(0, 9, (2, 3, 2)).astype(np.int32)
        sets.append((offsets, np.array([1, 0], np.uint8),
                     rng.integers(0, 3, (2, 3)).astype(np.int32), np.array(nf, np.int32)))
    return sets


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_vector_route_writes_every_output_once_and_equals_the_plain_version(dtype):
    clips = np.random.default_rng(3).integers(0, 256, (2, 3, 96, 96), dtype=np.uint8)
    itemsize = torch.empty((), dtype=dtype).element_size()
    epv = ingest.route(torch.zeros(clips.shape, dtype=torch.uint8),
                       torch.empty(2, 3, 88, 88, dtype=dtype), 88)
    assert epv == 16 // itemsize
    seen = set()
    for offsets, flip, fmap, nf in _all_offset_plans():
        k = Ingest(clips, offsets, flip, fmap, nf, 88, itemsize, epv)
        assert (k.writes == 1).all()
        k.check_addresses(clips.size)
        np.testing.assert_array_equal(k.out, _plain_bits(clips, offsets, flip, fmap, nf,
                                                         88, dtype))
        seen |= {(int(offsets[b, t, 0]), int(offsets[b, t, 1]), int(flip[b]))
                 for b in range(2) for t in range(3)}
    assert seen >= {(oy, ox, f) for oy in range(9) for ox in range(9) for f in (0, 1)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_vector_route_matches_jax_interpret(dtype):
    """Within the tolerances of test_ingest_train_plain_matches_jax (XLA's
    CPU backend contracts the TPU kernel's multiply and subtract)."""
    clips = np.random.default_rng(4).integers(0, 256, (2, 3, 96, 96), dtype=np.uint8)
    itemsize = torch.empty((), dtype=dtype).element_size()
    tol = 2.0 ** -22 if dtype == torch.float32 else 2.0 ** -6
    sets = _all_offset_plans()
    for offsets, flip, fmap, nf in (sets[13], sets[-3]):
        k = Ingest(clips, offsets, flip, fmap, nf, 88, itemsize, 16 // itemsize)
        got = torch.from_numpy(k.out.view(np.int16 if itemsize == 2 else np.int32)).view(
            dtype).float().numpy().reshape(2, 3, 88, 88)
        want = jax_ingest_train(
            jnp.asarray(clips), jnp.asarray(offsets), jnp.asarray(flip), jnp.asarray(fmap),
            88, dtype=jnp.bfloat16 if itemsize == 2 else jnp.float32,
            n_frames=None if nf is None else jnp.asarray(nf), interpret=True)
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("shape,crop", [((3, 5, 20, 20), 12), ((2, 3, 96, 96), 89),
                                        ((2, 3, 94, 94), 88)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_scalar_route_equals_the_plain_version(shape, crop, dtype):
    rng = np.random.default_rng(crop)
    B, T, H, W = shape
    clips = rng.integers(0, 256, shape, dtype=np.uint8)
    offsets = np.stack([rng.integers(0, H - crop + 1, (B, T)),
                        rng.integers(0, W - crop + 1, (B, T))], -1).astype(np.int32)
    flip = (np.arange(B) % 2).astype(np.uint8)
    fmap = rng.integers(0, T, (B, T)).astype(np.int32)
    nf = np.maximum(T - np.arange(B), 0).astype(np.int32)
    itemsize = torch.empty((), dtype=dtype).element_size()
    k = Ingest(clips, offsets, flip, fmap, nf, crop, itemsize, 1)
    assert (k.writes == 1).all()
    k.check_addresses(clips.size)
    np.testing.assert_array_equal(k.out, _plain_bits(clips, offsets, flip, fmap, nf, crop,
                                                     dtype))


def test_route_takes_the_scalar_route_off_whole_pieces():
    """The vector route needs whole pieces in a crop row, source rows of
    whole words and 16-byte aligned pointers; else the scalar route."""
    def route(shape, crop, dtype, clips_offset=0, out_offset=0):
        buf = torch.zeros(int(np.prod(shape)) + clips_offset, dtype=torch.uint8)
        clips = buf[clips_offset:].view(shape)
        n = shape[0] * shape[1] * crop * crop
        out = torch.zeros(n + out_offset, dtype=dtype)[out_offset:]
        return ingest.route(clips, out, crop)
    bf16, f32 = torch.bfloat16, torch.float32
    for dtype, epv in ((bf16, 8), (f32, 4)):
        assert route((2, 3, 96, 96), 88, dtype) == epv      # the train step
        assert route((2, 3, 40, 40), 32, dtype) == epv      # the tiny presets
        assert route((2, 3, 96, 96), 89, dtype) == 1        # an odd crop
        assert route((2, 3, 96, 96), 90, dtype) == 1        # no whole pieces
        assert route((2, 3, 94, 94), 88, dtype) == 1        # rows of no whole words
        assert route((2, 3, 96, 96), 88, dtype, clips_offset=1) == 1
        assert route((2, 3, 96, 96), 88, dtype, out_offset=1) == 1
    # the CPU tests' 20 -> 12 crop: 12 bf16 are no whole piece, 12 f32 are
    # three; 92-byte rows are whole 4-byte words, not 8-byte ones
    assert route((3, 5, 20, 20), 12, bf16) == 1 and route((3, 5, 20, 20), 12, f32) == 4
    assert route((2, 3, 92, 92), 88, bf16) == 1 and route((2, 3, 92, 92), 88, f32) == 4


def test_u8_to_f32_without_i2f_is_exact():
    v = np.arange(256, dtype=np.uint32)
    np.testing.assert_array_equal(_byte_as_f32(v, 0), v.astype(np.float32))
    # the selector picks any byte of the word, and e ^ 3 reverses a word
    word = np.uint32(0x04030201)
    assert [float(_byte_as_f32(word, e)) for e in range(4)] == [1.0, 2.0, 3.0, 4.0]
    assert [float(_byte_as_f32(word, e ^ 3)) for e in range(4)] == [4.0, 3.0, 2.0, 1.0]


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def _fast_div(d):
    """csrc/attention_train.cu::FastDiv: (d, m, s)."""
    s = 0
    while s < 31 and (1 << s) < d:
        s += 1
    return d, ((1 << 32) * ((1 << s) - d)) // d + 1, s


def _div(n, fd):
    d, m, s = fd
    n = np.asarray(n, np.uint64)
    t = (n * np.uint64(m)) >> np.uint64(32)
    assert (t + n < 2 ** 32).all()       # the 32-bit add does not carry out
    return ((t + n) >> np.uint64(s)).astype(np.int64)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 17, 30, 31, 240, 480, 1000, 65537,
                               2 ** 30 + 1, 2 ** 31 - 1])
def test_fast_div_is_exact_below_2_31(d):
    fd = _fast_div(d)
    assert 0 < fd[1] < 2 ** 32
    rng = np.random.default_rng(d)
    n = np.concatenate([np.arange(70000), rng.integers(0, 2 ** 31, 200000),
                        np.arange(2 ** 31 - 5000, 2 ** 31), d * np.arange(1, 1000) - 1,
                        d * np.arange(1, 1000)])
    n = n[(n >= 0) & (n < 2 ** 31)]
    np.testing.assert_array_equal(_div(n, fd), n // d)


def _mask_emulated(B, H, Tq, Tk, seed, rate, capacity=132 * 16):
    """K5's output bytes and each byte's write count, over the grid-stride
    loop of one wave."""
    n = B * H * Tq * Tk
    runs = -(-n // MASK_RUN)
    blocks = min(-(-n // (MASK_RUN * MASK_THREADS)), capacity)
    out = np.full(n, 7, np.uint8)
    writes = np.zeros(n, np.int64)
    thresh = attention.dropout_threshold(rate)
    for first in range(0, runs, blocks * MASK_THREADS):
        g = np.arange(first, min(first + blocks * MASK_THREADS, runs))
        e0 = g * MASK_RUN
        row = _div(e0, _fast_div(Tk))
        head = _div(row, _fast_div(Tq))
        j, i = e0 - row * Tk, row - head * Tq
        b = _div(head, _fast_div(H))
        h = head - b * H
        counters = []
        for _ in range(MASK_RUN):
            counters.append((j.copy(), i.copy(), h.copy(), b.copy()))
            j = j + 1
            wj = j == Tk
            j[wj], i[wj] = 0, i[wj] + 1
            wi = i == Tq
            i[wi], h[wi] = 0, h[wi] + 1
            wh = h == H
            h[wh], b[wh] = 0, b[wh] + 1
        ctr = [torch.from_numpy(np.stack([c[k] for c in counters], 1)) for k in range(4)]
        bits = attention.philox4x32_10(ctr, seed)[0].numpy()
        keep = (bits >= thresh).astype(np.uint8)         # (threads, 16)
        whole = e0 + MASK_RUN <= n
        assert (e0[whole] % 16 == 0).all()              # one aligned 16-byte store
        idx = e0[:, None] + np.arange(MASK_RUN)
        on = whole[:, None] | (idx < n)                 # the tail stored singly
        out[idx[on]] = keep[on]
        np.add.at(writes, idx[on], 1)
    return out, writes


@pytest.mark.parametrize("shape", [(240, 8, 30, 30), (480, 8, 17, 17), (480, 8, 17, 30),
                                   (3, 5, 7, 11), (4, 3, 5, 1), (7, 1, 9, 13), (1, 1, 1, 1),
                                   (2, 3, 1, 17), (1, 1, 1, 17)],
                         ids=lambda s: "x".join(map(str, s)))
def test_mask_walk_writes_every_element_once_and_equals_the_plain_philox(shape):
    B, H, Tq, Tk = shape
    seed = 0x1234_5678_9ABC_DEF0 + B * Tk
    out, writes = _mask_emulated(B, H, Tq, Tk, seed, 0.1)
    assert (writes == 1).all()
    want = ops.dropout_keep_mask_flat_plain(B, Tq, Tk, H, seed, 0.1, "cpu")
    np.testing.assert_array_equal(out, want.numpy().reshape(-1).astype(np.uint8))


def test_mask_grid_stride_loop_covers_more_runs_than_one_wave():
    out, writes = _mask_emulated(5, 2, 31, 29, 99, 0.3, capacity=3)
    assert (writes == 1).all()
    want = ops.dropout_keep_mask_flat_plain(5, 31, 29, 2, 99, 0.3, "cpu")
    np.testing.assert_array_equal(out, want.numpy().reshape(-1).astype(np.uint8))


def test_mask_wrappers_refuse_2_31_elements(monkeypatch):
    """K5 indexes in 32 bits: on a CUDA device both wrappers refuse a mask
    of 2^31 or more elements before allocating it; the CPU's plain version
    takes any size."""
    monkeypatch.setattr(attention, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    for fn in (ops.dropout_keep_mask_flat, ops.dropout_keep_mask):
        with pytest.raises(ValueError, match="exceeds"):  # exactly 2^31
            fn(2 ** 13, 2 ** 9, 2 ** 9, 1, 0, 0.1)
        with pytest.raises(ValueError, match="exceeds"):
            fn(2 ** 16, 2 ** 8, 2 ** 8, 2, 0, 0.1)
    monkeypatch.undo()
    monkeypatch.setattr(attention, "dropout_keep_mask_flat_plain",
                        lambda *args: "plain")
    for fn in (ops.dropout_keep_mask_flat, ops.dropout_keep_mask):
        assert fn(2 ** 13, 2 ** 9, 2 ** 9, 1, 0, 0.1, "cpu") == "plain"
