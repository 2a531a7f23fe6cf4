"""The geometry and the order of the sums of K7 (``channel_sums``) and K8
(``channel_sums_pair``), emulated on the CPU before any card run.

``csrc/batchnorm.cu`` gives a block of 256 threads a group of ``cg``
adjacent channels and a chunk of samples; its 2048 position slots hold
``phases`` copies of the group's run, one per sample phase, as pieces of
``epv`` contiguous elements (16 bytes on the vector route, one element on
the scalar route).  The emulation below repeats the kernel's index
arithmetic slot by slot (phase, piece, samples per phase, first address,
the two register stages of the sample loop) and its sums in float64 in the
kernel's order: per position over the samples (K7's sum of squares as a
compensated f32 pair, TwoSum, folded into double once), per channel through the
block's shared buffer (lanes over (phase, position), a butterfly of
shuffles, lane 0's sum), then the last block to arrive at its group (an
integer counter it resets) over the chunks in chunk order.  It shows that

* every (sample, channel, position) is read exactly once and summed into
  its own channel, on both routes, at the frontend's five BatchNorm shapes
  (fewer samples), the card check's layer4 shape and shapes whose rows are
  not a whole number of pieces;
* every piece of the vector route is 16-byte aligned;
* the finish sums the chunks in a fixed order whichever block arrives last,
  and leaves every counter at 0;
* the emulated results equal the plain versions' bit for bit (each term in
  f32, every sum in double, rounded once to f32).
"""
import math
import re

import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu_torch import ops
from sbl_for_multilingual_lip_reading_tpu_torch.ops import _build, batchnorm

THREADS, POSITIONS = 256, 8
CAPACITY = 132 * 3      # an H100 holding 3 blocks an SM
LANES = 32

# (shape, element size): the frontend's BatchNorms with fewer samples, the
# B=16 check's layer4, and rows that are no whole number of pieces
SHAPES = [((7, 64, 44, 44), "stem"), ((9, 64, 22, 22), "layer1"),
          ((11, 128, 11, 11), "layer2"), ((23, 256, 6, 6), "layer3"),
          ((37, 512, 3, 3), "layer4"), ((16, 512, 3, 3), "check layer4"),
          ((3, 1, 45, 45), "unaligned 45x45"), ((480, 5, 11, 11), "unaligned 5x11x11")]
CASES = [pytest.param(shape, itemsize, id=f"{name}-{'f32' if itemsize == 4 else 'bf16'}")
         for shape, name in SHAPES for itemsize in (4, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (_build.CSRC / "batchnorm.cu").read_text()).group(1))


def _epv(shape, itemsize):
    """The route the wrapper takes for a 16-byte aligned tensor."""
    x = torch.empty(shape, dtype=torch.float32 if itemsize == 4 else torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    return batchnorm.route(x)


def _stage_samples(pair, epv):
    """csrc/batchnorm.cu::stage_samples."""
    if epv == 1:
        return 1
    return 2 * epv // POSITIONS if pair else (4 if epv == 8 else 3)


class Block:
    """Block (g, k) of a launch, its slots as the kernel computes them."""

    def __init__(self, N, C, HW, epv, geo, g, k):
        S = POSITIONS // epv
        self.run = geo.cg * HW
        self.phases = batchnorm.MAX_RUN // self.run
        self.pieces = self.run // epv
        self.c0 = g * geo.cg
        self.n_ch = min(geo.cg, C - self.c0)
        live = self.n_ch * HW // epv
        self.row = C * HW
        self.n_lo, self.n_hi = k * N // geo.chunks, (k + 1) * N // geo.chunks
        self.step = self.phases * self.row
        # slot f = thread + j * THREADS, piece j of its thread
        t, j = np.meshgrid(np.arange(THREADS), np.arange(S), indexing="ij")
        self.f = (t + j * THREADS).reshape(-1)
        self.ph = self.f // self.pieces
        self.v = self.f - self.ph * self.pieces
        on = (self.ph < self.phases) & (self.v < live)
        self.cnt = np.where(on, np.maximum(
            0, (self.n_hi - self.n_lo - self.ph + self.phases - 1) // self.phases), 0)
        self.at = (self.n_lo + self.ph) * self.row + self.c0 * HW + self.v * epv
        self.iters = (self.n_hi - self.n_lo + self.phases - 1) // self.phases
        self.epv, self.HW, self.k = epv, HW, k

    def stage_order(self, U):
        """The iterations the sample loop adds, in order, each checked to
        sit in the register stage it was loaded into."""
        stages, order = {}, []
        stages["a"] = 0
        for i0 in range(0, self.iters, 2 * U):
            stages["b"] = i0 + U
            assert stages["a"] == i0
            order += range(i0, i0 + U)
            stages["a"] = i0 + 2 * U
            assert stages["b"] == i0 + U
            order += range(i0 + U, i0 + 2 * U)
        return order

    def reads(self, U):
        """(iteration, slot index, element addresses (slots, epv)) of every
        load the block makes, in the order its adds take them."""
        for i in self.stage_order(U):
            sel = np.nonzero(i < self.cnt)[0]
            if sel.size:
                yield i, sel, (self.at[sel] + i * self.step)[:, None] + np.arange(self.epv)

    def channel_of(self, sel):
        """The channel each (slot, element) of the selected slots adds into."""
        q = self.v[sel][:, None] * self.epv + np.arange(self.epv)
        return self.c0 + q // self.HW


def _blocks(N, C, HW, epv, geo):
    groups = -(-C // geo.cg)
    return [Block(N, C, HW, epv, geo, g, k) for g in range(groups) for k in range(geo.chunks)]


def _butterfly(lanes):
    """__shfl_xor_sync's tree over 32 lanes; lane 0's value."""
    v = lanes.copy()
    idx = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., idx ^ o]
    return v[..., 0]


def _lane_sums(items):
    """Lane l sums items l, l + 32, ... in order from 0.0 (rows of
    ``items`` are independent sums)."""
    rows, n = items.shape
    pad = np.zeros((rows, -(-n // LANES) * LANES))
    pad[:, :n] = items
    acc = np.zeros((rows, LANES))
    for r in range(pad.shape[1] // LANES):
        acc = acc + pad[:, r * LANES:(r + 1) * LANES]
    return acc


def _two_sum_add(hi, lo, t):
    """csrc/batchnorm.cu::two_sum_add in f32: (hi, lo) += t."""
    s = hi + t
    tp = s - hi
    return s, lo + ((hi - (s - tp)) + (t - tp))


def _emulate(x, pair, dy=None, mean=None, inv=None, arrival_seed=0, capacity=CAPACITY):
    """The kernel's output bits, (2, C) f32, with the tiling and the
    piece width it took; blocks arrive in a seeded random order."""
    N, C = x.shape[:2]
    HW = math.prod(x.shape[2:])
    epv = batchnorm.route(x) if dy is None else batchnorm.route(dy, x)
    geo = batchnorm.tiling(N, C, HW, epv, capacity)
    U = _stage_samples(pair, epv)
    xs = x.float().reshape(-1).numpy()
    gs = dy.float().reshape(-1).numpy() if pair else None
    blocks = _blocks(N, C, HW, epv, geo)
    part = np.full((2, geo.chunks, C), np.nan)
    for b in blocks:
        acc = np.zeros((2, b.f.size, epv))
        hi, lo = np.zeros((2, b.f.size, epv), np.float32)
        if pair:
            ch = b.channel_of(np.arange(b.f.size)).clip(max=C - 1)
            m, iv = mean.numpy()[ch], inv.numpy()[ch]
        for _, sel, addr in b.reads(U):
            v = xs[addr]
            if pair:
                g = gs[addr]
                t1 = g * ((v - m[sel]) * iv[sel])    # f32: sub, mul, mul
                acc[0, sel] += g.astype(np.float64)
                acc[1, sel] += t1.astype(np.float64)
            else:
                acc[0, sel] += v.astype(np.float64)
                hi[sel], lo[sel] = _two_sum_add(hi[sel], lo[sel], v * v)
        if not pair:
            acc[1] = hi.astype(np.float64) + lo.astype(np.float64)
        for q in range(2):
            red = np.full(batchnorm.MAX_RUN, np.nan)
            used = b.f < b.phases * b.pieces
            red[(b.f[used][:, None] * epv + np.arange(epv)).reshape(-1)] = acc[q, used].reshape(-1)
            i = np.arange(b.phases * HW)
            items = np.stack([red[(i // HW) * b.run + c * HW + i % HW] for c in range(b.n_ch)])
            assert not np.isnan(items).any()
            part[q, b.k, b.c0:b.c0 + b.n_ch] = _butterfly(_lane_sums(items))
    # blocks arrive in any order; the last of each group sums its chunks
    counters = np.zeros(-(-C // geo.cg), np.int64)
    out = np.full((2, C), np.nan, np.float32)
    finishes = 0
    for idx in np.random.default_rng(arrival_seed).permutation(len(blocks)):
        b = blocks[idx]
        g = b.c0 // geo.cg
        counters[g] += 1
        if counters[g] - 1 == geo.chunks - 1:
            finishes += 1
            for q in range(2):
                sums = _butterfly(_lane_sums(part[q, :, b.c0:b.c0 + b.n_ch].T))
                out[q, b.c0:b.c0 + b.n_ch] = sums.astype(np.float32)
            counters[g] = 0
    assert finishes == len(counters) and not counters.any()
    return out, geo, epv


def test_the_emulation_takes_the_sources_constants():
    """The block, its slots and the route's piece are those of
    csrc/batchnorm.cu."""
    assert _constant("kThreads") == THREADS and _constant("kPositions") == POSITIONS
    assert THREADS * POSITIONS == batchnorm.MAX_RUN
    assert batchnorm.PIECE_BYTES == 16


@pytest.mark.parametrize("shape,itemsize", CASES)
def test_every_element_is_summed_once_into_its_channel(shape, itemsize):
    N, C, H, W = shape
    HW = H * W
    epv = _epv(shape, itemsize)
    assert epv == (16 // itemsize if C * HW % (16 // itemsize) == 0 else 1)
    geo = batchnorm.tiling(N, C, HW, epv, CAPACITY)
    seen = np.zeros(N * C * HW, np.int64)
    for b in _blocks(N, C, HW, epv, geo):
        for pair in (False, True):
            order = [i for i, _, _ in b.reads(_stage_samples(pair, epv))]
            assert order == sorted(set(order))           # ascending, once each
        for i, sel, addr in b.reads(_stage_samples(False, epv)):
            seen += np.bincount(addr.reshape(-1), minlength=seen.size)
            n = addr // b.row
            assert ((n >= b.n_lo) & (n < b.n_hi)).all()
            assert (n == (b.n_lo + b.ph[sel] + i * b.phases)[:, None]).all()
            assert ((addr % b.row) // HW == b.channel_of(sel)).all()
            if epv > 1:
                assert (addr[:, 0] * itemsize % 16 == 0).all()
    assert (seen == 1).all()


@pytest.mark.parametrize("shape,itemsize", CASES)
@pytest.mark.parametrize("pair", [False, True], ids=["K7", "K8"])
def test_emulated_sums_equal_the_plain_versions(shape, itemsize, pair):
    """Each term in f32, every sum in double in the kernel's order: the
    exact sum rounded once to f32, as the plain versions give it."""
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    rng = np.random.default_rng(sum(shape) + itemsize)
    C = shape[1]
    shift = rng.standard_normal((1, C, 1, 1))
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + shift).astype(np.float32)).to(dtype)
    if not pair:
        got, _, _ = _emulate(x, False)
        want = ops.channel_sums_plain(x)
    else:
        dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        mean = torch.from_numpy(rng.standard_normal(C).astype(np.float32))
        inv = torch.from_numpy((rng.random(C) + 0.5).astype(np.float32))
        got, _, _ = _emulate(x, True, dy, mean, inv)
        want = ops.channel_sums_pair_plain(dy, x, mean, inv)
    np.testing.assert_array_equal(got, torch.stack(want).numpy())


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("pair", [False, True], ids=["K7", "K8"])
def test_long_chains_stay_exact(itemsize, pair):
    """600 samples on each position (a card holding one block): K7's sum of
    squares of O(1e4) terms, as a compensated f32 pair, and the double sums
    still give the exact sum rounded once to f32 (a plain f32 chain would
    sit several ulps off)."""
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    rng = np.random.default_rng(11)
    shape = (600, 8, 16, 16)
    x = torch.from_numpy((rng.standard_normal(shape) * 3 + 100).astype(np.float32)).to(dtype)
    assert batchnorm.tiling(600, 8, 256, batchnorm.route(x), 1) == (8, 1, 1)
    if not pair:
        got, _, _ = _emulate(x, False, capacity=1)
        want = ops.channel_sums_plain(x)
    else:
        dy = torch.from_numpy((rng.standard_normal(shape) + 5).astype(np.float32)).to(dtype)
        mean = torch.full((8,), 100.0)
        inv = torch.full((8,), 0.3)
        got, _, _ = _emulate(x, True, dy, mean, inv, capacity=1)
        want = ops.channel_sums_pair_plain(dy, x, mean, inv)
    np.testing.assert_array_equal(got, torch.stack(want).numpy())


@pytest.mark.parametrize("shape", [(37, 512, 3, 3), (7, 64, 44, 44), (480, 5, 11, 11)])
def test_the_finish_is_the_same_whichever_block_arrives_last(shape):
    """The last block of a group sums the chunks' partials in chunk order,
    so every order of arrival gives the same bits (and resets the
    counters)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    first, geo, _ = _emulate(x, False, arrival_seed=0)
    assert geo.chunks > 1
    for seed in (1, 2, 3):
        np.testing.assert_array_equal(_emulate(x, False, arrival_seed=seed)[0], first)


def test_route_takes_the_scalar_route_off_16_bytes():
    """The vector route needs whole 16-byte pieces in every row and 16-byte
    aligned pointers; otherwise the scalar route."""
    for dtype, epv in ((torch.float32, 4), (torch.bfloat16, 8)):
        x = torch.zeros((4, 64, 22, 22), dtype=dtype)
        assert batchnorm.route(x) == epv
        assert batchnorm.route(x, x) == epv
        off = torch.zeros(x.numel() + 1, dtype=dtype)[1:].view(x.shape)
        assert off.data_ptr() % 16 and batchnorm.route(off) == 1
        assert batchnorm.route(off, x) == 1 and batchnorm.route(x, off) == 1
        assert batchnorm.route(torch.zeros((4, 5, 11, 11), dtype=dtype)) == 1
    assert batchnorm.route(torch.zeros((4, 8, 11, 11), dtype=torch.bfloat16)) == 8


class _FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("shape,epv", [((7200, 64, 44, 44), 8), ((7200, 512, 3, 3), 8),
                                       ((480, 5, 11, 11), 1)])
def test_the_wrappers_launch_one_kernel_with_their_tiling(monkeypatch, shape, epv):
    """On a card tensor (meta tensors here, through the card branch) each
    wrapper launches its kernel once, with the route and the tiling above
    and arrival counters, and counts the launch."""
    lib = _FakeLibrary()
    monkeypatch.setattr(batchnorm._build, "library", lambda: lib)
    monkeypatch.setattr(batchnorm, "capacity", lambda *a: CAPACITY)
    monkeypatch.setattr(batchnorm, "_stream", lambda device: 7)
    monkeypatch.setattr(batchnorm, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(batchnorm, "_ARRIVALS", {})
    ops.reset_launch_counts()
    x = torch.zeros(shape, dtype=torch.bfloat16, device="meta")
    N, C, H, W = shape
    geo = batchnorm.tiling(N, C, H * W, epv, CAPACITY)
    s, q = ops.channel_sums(x)
    assert s.shape == q.shape == (C,)
    name, args = lib.calls[-1]
    assert name == "sbl_channel_sums"
    assert args[4:12] == (N, C, H * W, geo.cg, geo.chunks, int(epv > 1), 1, None)
    mean = torch.zeros(C, device="meta")
    ops.channel_sums_pair(x, x, mean, mean)
    name, args = lib.calls[-1]
    assert name == "sbl_channel_sums_pair"
    assert args[7:15] == (N, C, H * W, geo.cg, geo.chunks, int(epv > 1), 1, None)
    assert batchnorm._ARRIVALS[(None, 7)].numel() >= -(-C // geo.cg)
    counts = ops.launch_counts()
    assert counts["channel_sums"] == counts["channel_sums_pair"] == 1
    ops.reset_launch_counts()
