"""Which shapes the port's kernels take, the configuration check that
refuses the others before anything runs on the card, and whether the
ctypes signatures match the CUDA sources.

The attention kernels (K1/K12, K3/K4) are built for head widths
``HEAD_DIMS``; K3/K4 bound their lengths by the shared memory a block
takes (``train_smem_bytes``), K11 its segment length and FFN width
(``decoder_layer_fits``).  ``models.check_kernel_shapes`` holds a config to
them, and ``build_model`` calls it for the card.  The model's attention
then launches the kernels for every shape it gives them: it is driven here
with meta tensors, whose device is neither the CPU nor a card, through the
wrappers' card branch, with a stand-in library that records the launches.
The card itself runs the tiny preset (d_k = 16) through recognize and a
train step in ``chip_smoke.py`` phase 4b.

The bf16 routes of K10/K11 pick their tiles with the library's shared-
memory sizers; with no library here, ``SourceSizers`` stands in for them
(the layouts of the sources, on the sources' constants), so the pickers
are checked at every path-A shape and tiny preset.

The ctypes argument lists in ``ops/_build.py`` must match the ``extern
"C"`` declarations of ``csrc/*.cu`` one for one: a mismatch (a pointer
passed as an int, a missing argument) would otherwise show only on the
card.
"""
import ctypes
import dataclasses
import re

import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
from sbl_for_multilingual_lip_reading_tpu_torch import models, ops
from sbl_for_multilingual_lip_reading_tpu_torch.models import layers
from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import (
    DropoutRNG, RandomLayout, step_random)
from sbl_for_multilingual_lip_reading_tpu_torch.ops import (
    _build, attention, decoder_layer, resblock)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_attention_head_widths():
    assert attention.HEAD_DIMS == (16, 32, 64, 128)


@pytest.mark.parametrize("d,tq,tk,fits", [
    (16, 9, 30, True), (64, 17, 30, True), (64, 31, 31, True),
    (64, 1, 1, True), (32, 40, 70, True), (128, 30, 30, True),
    # the longest equal lengths each width takes in 227 KB
    (16, 153, 153, True), (16, 154, 154, False), (32, 139, 139, True),
    (32, 140, 140, False), (64, 116, 116, True), (64, 117, 117, False),
    (128, 84, 84, True), (128, 85, 85, False),
    # widths the kernels are not built for
    (8, 9, 9, False), (48, 17, 17, False), (256, 4, 4, False)])
def test_train_kernels_fit_head_widths_and_lengths(d, tq, tk, fits):
    """K3/K4: d in HEAD_DIMS, and both kernels' shared memory within the
    227 KB a block may take."""
    assert ops.train_kernels_fit(d, tq, tk) is fits


def test_train_smem_bytes_counts_the_staged_buffers():
    """K4 at Tq = Tk = 32, d = 64: Q, dO, K, V as f32 rows of 65, dS and
    the dropped P (32 x 32 each) and a row of 32 per warp; K3: K, V, a
    query row and a probability row per warp."""
    assert attention.train_smem_bytes(32, 32, 64, True) == 4 * (
        4 * 32 * 65 + 2 * 32 * 32 + 4 * 32)
    assert attention.train_smem_bytes(32, 32, 64, False) == 4 * (
        2 * 32 * 65 + 4 * 64 + 4 * 32)
    # one query row (the cached cross-attention's shape): the forward's
    # per-warp query rows outweigh the backward's one Q and dO row
    assert (attention.train_smem_bytes(1, 30, 128, False)
            > attention.train_smem_bytes(1, 30, 128, True))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_the_bf16_train_bodies_fit_every_admitted_length(d):
    """K3/K4's tensor-core bodies take every (Tq, Tk) that the f32 route's
    shared memory admits (``train_kernels_fit``): for each Tq, at the
    longest Tk admitted (their shared memory grows with both), the bf16
    route's blocks fit the 227 KB too."""
    tq = 1
    while attention.train_kernels_fit(d, tq, 1):
        lo, hi = 1, 4096   # the longest admitted Tk at this Tq
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if attention.train_kernels_fit(d, tq, mid) else (lo, mid - 1)
        for bwd in (False, True):
            assert attention.train_mma_smem_bytes(tq, lo, d, bwd) <= _build.MAX_SMEM_BYTES
        tq += 1
    assert tq > 84


@pytest.mark.parametrize("tq,tk,d,fwd,bwd", [
    # encoder: 2 warps; Q, dO as 32 rows and K, V as one 32-key tile of
    # d + 8 bf16, 32 rows of three f32 statistics and one keep word, and
    # P_drop and dS (hi and lo) as 32 rows of 40 bf16
    (30, 30, 64, 2 * (64 + 32) * 72,
     2 * (2 * 32 + 2 * 32) * 72 + 4 * 32 * 4 + 4 * 32 * 40 * 2),
    # the decoder's 17 rows: 2 m16 tiles; the cached cross-attention's 1 row
    (17, 17, 64, 2 * (64 + 32) * 72,
     2 * (2 * 32 + 2 * 32) * 72 + 4 * 32 * 4 + 4 * 32 * 40 * 2),
    (1, 30, 128, 2 * (64 + 16) * 136,
     2 * (2 * 16 + 2 * 32) * 136 + 4 * 16 * 4 + 4 * 16 * 40 * 2),
    # past one key tile no P_drop / dS tiles; K3's block stops growing at 4
    # warps, K4's key tiles and words do not
    (17, 33, 64, 2 * (64 + 32) * 72, 2 * (2 * 32 + 2 * 64) * 72 + 4 * 32 * 5),
    (116, 116, 64, 2 * (64 + 64) * 72, 2 * (2 * 128 + 2 * 128) * 72 + 4 * 128 * 7)])
def test_train_mma_smem_bytes_counts_the_staged_buffers(tq, tk, d, fwd, bwd):
    assert attention.train_mma_smem_bytes(tq, tk, d, False) == fwd
    assert attention.train_mma_smem_bytes(tq, tk, d, True) == bwd


def test_the_smem_mirrors_take_the_sources_constants():
    """The tile constants ``ops/attention.py`` mirrors are those of
    csrc/mma.cuh (key tile, warps of a tensor-core block) and
    csrc/attention_train.cu (warps of an f32 block, the card's limit)."""
    def constant(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             (_build.CSRC / src).read_text()).group(1))
    assert constant("mma.cuh", "kKeyTile") == attention._KEY_TILE
    assert constant("mma.cuh", "kMaxMmaWarps") == attention._MAX_MMA_WARPS
    assert constant("attention_train.cu", "kWarps") == attention._TRAIN_WARPS
    assert constant("attention_train.cu", "kMaxSmem") == _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("L,D,DI,fits", [
    (17, 512, 2048, True), (9, 64, 128, True), (64, 512, 2048, True),
    (65, 512, 2048, False), (17, 1024, 4096, True), (17, 512, 700, False)])
def test_decoder_layer_fits_segment_and_ffn(L, D, DI, fits):
    """K11: a segment of at most 64 positions, d_inner a multiple of
    d_model, any head width."""
    assert ops.decoder_layer_fits(L, D, DI) is fits


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (_build.CSRC / src).read_text()).group(1))


def _up16(v):
    return (v + 15) // 16 * 16


class SourceSizers:
    """The library's two bf16-route sizers, for the tile pickers where no
    library is built: ``make_mma_layout`` (csrc/decoder_layer.cu) and
    ``make_conv_layout`` (csrc/resblock.cu) in Python, each buffer 16-byte
    aligned, on the sources' own constants (the ring: kRingStages stages of
    BN rows of kRingBK bf16, + 2 KB of barriers and alignment).  The
    wrappers call the library's sizers; only these tests use this copy."""

    def __init__(self):
        self.ring_stages = _constant("gemm_ring.cuh", "kRingStages")
        self.ring_bk = _constant("gemm_ring.cuh", "kRingBK")
        self.layer_bn = _constant("decoder_layer.cu", "kLayerBN")
        self.max_cluster = _constant("decoder_layer.cu", "kMaxCluster")
        self.conv_bn = _constant("resblock.cu", "kConvBN")

    def _ring(self, bn):
        return self.ring_stages * bn * self.ring_bk * 2 + 2048

    def sbl_decoder_layer_mma_smem_bytes(self, bt, L, D, H, dk, Tk, cs):
        """A and U as bf16 rows of the padded width, the CTA's f32
        residual columns, the LayerNorm partials, the ring or a sample's
        cross K/V."""
        hc = H // cs
        dp, mp, dkp, tkp = _up16(D), _up16(bt * L), _up16(dk), _up16(Tk)
        lda, ldu, ldr = dp + 8, max(dp, 3 * hc * dkp) + 8, hc * dk + 8
        kv = 2 * (2 * hc * tkp * (dkp + 8))
        off = 0
        for size in (2 * mp * lda, 2 * mp * ldu, 4 * mp * ldr,
                     8 * self.max_cluster * mp, max(self._ring(self.layer_bn), kv)):
            off = _up16(off + size)
        return off

    def sbl_resblock_mma_smem_bytes(self, C, S, bt, bh):
        """The x and h bands channels last (pixels of C rounded up to 16
        plus 8 channels), a zero row, the four f32 affine vectors, the
        ring."""
        cp = _up16(C) + 8
        off = 0
        for size in (2 * bt * min(bh + 4, S) * S * cp,
                     2 * bt * min(bh + 2, S) * S * cp, 2 * cp, 16 * C):
            off = _up16(off + size)
        return off + self._ring(self.conv_bn)


SIZERS = SourceSizers()


def test_the_bf16_layouts_mirror_the_sources_constants():
    """The constants ``ops/decoder_layer.py`` and ``ops/resblock.py`` keep
    are the tensor-core bodies' (decoder_layer.cu's tile and cluster,
    resblock.cu's pass, gemm_ring.cuh's block), and the sizers' copy reads
    a ring of 3 stages of k 64."""
    assert _constant("decoder_layer.cu", "kMaxCluster") == decoder_layer.MAX_CLUSTER
    assert _constant("decoder_layer.cu", "kMmaRows") == decoder_layer.MAX_ROWS
    # a pass: two warpgroups of kConvMaxMB tiles of 64 rows
    assert 2 * _constant("resblock.cu", "kConvMaxMB") * 64 == resblock.PASS_PIXELS
    assert _constant("gemm_ring.cuh", "kRingThreads") == 256
    assert (SIZERS.ring_stages, SIZERS.ring_bk, SIZERS.layer_bn, SIZERS.conv_bn) == (
        3, 64, 128, 64)


@pytest.mark.parametrize("n_head,cs", [(8, 4), (4, 4), (16, 4), (2, 2), (6, 2),
                                       (1, 1), (3, 1)])
def test_decoder_layer_cluster_size(n_head, cs):
    """Each CTA of a cluster owns whole heads: 4 CTAs where n_head allows."""
    assert decoder_layer.cluster_size(n_head) == cs


def test_decoder_layer_mma_smem_counts_the_buffers():
    """Path A's widest segment, 3 samples of 17 rows (64 rows padded): A
    and U as 64 bf16 rows of 520, the f32 residual of 128 columns (+8),
    the (sum, sum of squares) of 4 CTAs, a ring of 3 stages of 128 x 64
    bf16 with its barriers and alignment slack (2 KB), more than one
    sample's K and V of 2 heads (2 x 2 x 32 x 72)."""
    assert SIZERS.sbl_decoder_layer_mma_smem_bytes(3, 17, 512, 8, 64, 30, 4) == (
        2 * 64 * 520 + 2 * 64 * 520 + 4 * 64 * 136 + 8 * 4 * 64 + 3 * 128 * 64 * 2 + 2048)
    # 100 cross keys at d_k = 128, one head a CTA: a sample's K and V (112
    # rows of 136 each) outgrow the ring
    assert SIZERS.sbl_decoder_layer_mma_smem_bytes(1, 17, 512, 4, 128, 100, 4) == (
        2 * 32 * 520 + 2 * 32 * 520 + 4 * 32 * 136 + 8 * 4 * 32 + 2 * 112 * 136 * 2)


@pytest.mark.parametrize("B,L,D,H,dk,Tk,want", [
    (512, 17, 512, 8, 64, 30, (3, 4)),    # path A, widest segment
    (512, 3, 512, 8, 64, 30, (21, 4)),    # path A, narrowest
    (512, 1, 512, 8, 64, 30, (64, 4)),
    (64, 17, 512, 4, 128, 30, (3, 4)),    # d_k = 128 (phase 3d)
    (8, 9, 64, 4, 16, 30, (7, 4)),        # the tiny preset
    (2, 9, 64, 4, 16, 30, (2, 4)),        # fewer samples than a tile takes
    (512, 64, 512, 8, 64, 30, (1, 4))])   # the longest segment K11 takes
def test_decoder_layer_mma_tiles(B, L, D, H, dk, Tk, want):
    assert decoder_layer.pick_mma_tile(SIZERS, B, L, D, H, dk, Tk) == want
    bt, cs = want
    assert SIZERS.sbl_decoder_layer_mma_smem_bytes(bt, L, D, H, dk, Tk, cs) <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("preset", ["sbl", "tiny"])
def test_every_admitted_segment_has_a_bf16_tile(preset):
    """Every segment length ``decoder_layer_fits`` admits at the preset's
    widths gets a tile within the shared memory: the bf16 route takes all
    that the check admits, up to 64 rows at d_model 512."""
    cfg = port_config.sbl() if preset == "sbl" else port_config.tiny_test("sbl")
    d, frames = cfg.dims, cfg.data.frames
    for L in range(1, decoder_layer.MAX_ROWS + 1):
        assert ops.decoder_layer_fits(L, d.d_model, d.d_inner)
        bt, cs = decoder_layer.pick_mma_tile(SIZERS, 512, L, d.d_model, d.n_head, d.d_k, frames)
        assert bt * L <= decoder_layer.MAX_ROWS and cs == 4


def test_resblock_mma_smem_counts_the_buffers():
    """layer1: one 22 x 22 plane, x and h bands of 22 rows of 22 pixels of
    64 + 8 channels, a zero row, the four f32 affine vectors, a ring of 3
    stages of 64 x 64 bf16, its barriers and the slack that aligns it (2 KB)."""
    assert SIZERS.sbl_resblock_mma_smem_bytes(64, 22, 1, 22) == (
        2 * 22 * 22 * 72 * 2 + 2 * 72 + 16 * 64 + 3 * 64 * 64 * 2 + 2048)
    # a band of 15 rows of a 30-wide plane: 19 x rows, 17 h rows (the zero
    # row of 48 bytes padded to 16 bytes)
    assert SIZERS.sbl_resblock_mma_smem_bytes(8, 30, 1, 15) == (
        2 * 19 * 30 * 24 + 2 * 17 * 30 * 24 + 48 + 16 * 8 + 3 * 64 * 64 * 2 + 2048)


@pytest.mark.parametrize("C,S,want", [
    (64, 22, (1, 22)),    # layer1: one whole plane a block
    (128, 11, (3, 11)),   # layer2
    (256, 6, (5, 6)),     # layer3
    (512, 3, (10, 3)),    # layer4
    (8, 8, (8, 8)),       # the tiny preset's block
    (8, 30, (1, 15)),     # past one pass: two bands
    (16, 40, (1, 10))])   # four bands
def test_resblock_mma_tiles(C, S, want):
    assert resblock.pick_mma_tile(SIZERS, C, S) == want
    assert SIZERS.sbl_resblock_mma_smem_bytes(C, S, *want) <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("preset", ["sbl", "tiny"])
def test_every_eligible_block_has_a_bf16_tile(preset):
    """Every stride-1 block of equal widths the frontend sends to K10 (the
    first block of each stage after the first has stride 2) gets a tile."""
    cfg = port_config.sbl() if preset == "sbl" else port_config.tiny_test("sbl")
    f = cfg.frontend
    side = cfg.data.crop_size // 4   # the stem's stride 2 and the max pool's
    for i, (c, n) in enumerate(zip(f.resnet_channels, f.resnet_blocks)):
        if i:
            side = (side + 1) // 2
        if n > (1 if i else 0):
            bt, bh = resblock.pick_mma_tile(SIZERS, c, side)
            assert SIZERS.sbl_resblock_mma_smem_bytes(c, side, bt, bh) <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("preset", sorted(port_config.PRESETS))
@pytest.mark.parametrize("fused", [False, True])
def test_every_preset_passes_the_kernel_shape_check(preset, fused):
    cfg = dataclasses.replace(port_config.PRESETS[preset](),
                              use_fused_decoder_layer=fused)
    models.check_kernel_shapes(cfg)


@pytest.mark.parametrize("name", ["sbl", "lrw", "lrw1000", "classify"])
def test_tiny_presets_pass_the_kernel_shape_check(name):
    """The tiny presets' d_k = 16 is a width the kernels are built for."""
    cfg = port_config.tiny_test(name)
    assert cfg.dims.d_k == 16
    models.check_kernel_shapes(dataclasses.replace(cfg, use_fused_decoder_layer=True))


def _dims(cfg, **kw):
    return dataclasses.replace(cfg, dims=dataclasses.replace(cfg.dims, **kw))


@pytest.mark.parametrize("change,match", [
    (lambda c: _dims(c, d_model=64, n_head=8, d_k=8, d_v=8), "head widths"),
    (lambda c: _dims(c, d_model=96, n_head=2, d_k=48, d_v=48), "head widths"),
    (lambda c: dataclasses.replace(
        c, data=dataclasses.replace(c.data, frames=200)), "shared memory"),
    (lambda c: dataclasses.replace(
        c, use_fused_decoder_layer=True,
        decoder=dataclasses.replace(c.decoder, maxlen=70)), "at most 64"),
    (lambda c: dataclasses.replace(c, use_fused_decoder_layer=True,
                                   dims=dataclasses.replace(c.dims, d_inner=100)),
     "multiple of d_model")])
def test_the_kernel_shape_check_refuses_what_no_kernel_takes(change, match):
    with pytest.raises(ValueError, match=match):
        models.check_kernel_shapes(change(port_config.tiny_test("sbl")))


def test_the_kernel_shape_check_leaves_the_plain_path_alone():
    """With the attention kernels off, any head width runs (their plain
    versions), on the card as on the CPU."""
    cfg = _dims(port_config.tiny_test("sbl"), d_model=64, n_head=8, d_k=8, d_v=8)
    models.check_kernel_shapes(dataclasses.replace(cfg, use_pallas_attention=False))
    # on the CPU the config is not checked: the wrappers take their plain versions
    models.build_model(cfg, "cpu")


class _FakeLibrary:
    """Stands in for the kernel library: records each entry point's
    arguments and reports a clean launch."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def meta_as_card(monkeypatch):
    """Meta tensors through the wrappers' card branch: the device check
    records the head width and whether the shapes fit, and the library
    records the launches."""
    lib, checked = _FakeLibrary(), []

    def check(name, tensors, bias, d, train=False):
        fit = (d in attention.HEAD_DIMS and not train) or attention.train_kernels_fit(
            d, tensors[0].shape[1], tensors[1].shape[1])
        checked.append((name, d, train, fit))
    monkeypatch.setattr(attention._build, "library", lambda: lib)
    monkeypatch.setattr(attention, "_stream", lambda device: 0)
    monkeypatch.setattr(attention, "_check_cuda", check)
    ops.reset_launch_counts()
    yield lib, checked
    ops.reset_launch_counts()


def _one_seed_rng():
    """A training forward's random numbers holding one attention's seed, its
    seeds on the stand-in card (its mask generators, unused, on the CPU)."""
    random = step_random(0, RandomLayout(1, 0, 0, 0), "cpu")
    return DropoutRNG(random._replace(seeds=random.seeds.to("meta")), "meta")


def test_attend_launches_the_kernels_at_the_tiny_preset(meta_as_card):
    """At the tiny preset's d_k = 16 the deterministic attention launches K1
    and the training attention K3 forward and K4 backward, each counted
    once, at d = 16."""
    lib, checked = meta_as_card
    cfg = port_config.tiny_test("sbl")
    H, d = cfg.dims.n_head, cfg.dims.d_k
    # the decoder's (dirs, B, L, H*d) projections, both directions per call
    q = torch.zeros((2, 3, 9, H * d), device="meta")
    causal = torch.zeros((1, 9, 9), device="meta")
    out = layers.attend(q, q, q, H, causal, d ** -0.5, use_kernels=True)
    assert out.shape == q.shape
    assert lib.calls[-1][0] == "sbl_small_mha_flat"
    assert lib.calls[-1][1][5:10] == (6, 9, 9, H, d)
    assert ops.launch_counts()["small_mha_flat"] == 1

    leaf = torch.zeros((6, 9, H * d), device="meta", requires_grad=True)
    out = layers.attend(leaf, leaf, leaf, H, causal, d ** -0.5, use_kernels=True,
                        rate=0.1, rng=_one_seed_rng())
    assert out.shape == leaf.shape
    assert lib.calls[-1][0] == "sbl_small_mha_dropout_fwd_flat"
    assert lib.calls[-1][1][5:10] == (6, 9, 9, H, d)
    out.sum().backward()
    assert lib.calls[-1][0] == "sbl_small_mha_dropout_bwd_flat"
    assert lib.calls[-1][1][8:13] == (6, 9, 9, H, d)
    counts = ops.launch_counts()
    assert counts["small_mha_dropout_fwd_flat"] == counts["small_mha_dropout_bwd_flat"] == 1
    assert all(fit for *_, fit in checked) and {c[1] for c in checked} == {d}

    # kernels off: the plain versions, no launch
    calls = len(lib.calls)
    layers.attend(q, q, q, H, causal, d ** -0.5, use_kernels=False)
    layers.attend(q, q, q, H, causal, d ** -0.5, use_kernels=False, rate=0.1,
                  rng=_one_seed_rng())
    assert len(lib.calls) == calls


@pytest.mark.parametrize("d,T", [(16, 30), (32, 17), (128, 30), (64, 70),
                                 (16, 150)])
def test_attend_launches_k3_k4_at_every_width_and_length(meta_as_card, d, T):
    """The training attention launches K3 and K4 at every head width the
    kernels are built for, and past one tile of 32 keys."""
    lib, checked = meta_as_card
    q = torch.zeros((4, T, 4 * d), device="meta", requires_grad=True)
    out = layers.attend(q, q, q, 4, None, d ** -0.5, use_kernels=True, rate=0.1,
                        rng=_one_seed_rng())
    out.sum().backward()
    assert [c[0] for c in lib.calls] == ["sbl_small_mha_dropout_fwd_flat",
                                         "sbl_small_mha_dropout_bwd_flat"]
    assert all(fit and train for _, _, train, fit in checked)


# C type of a declared argument -> the ctypes type ``_build`` must give it
_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "float": ctypes.c_float,
            "unsigned long long": ctypes.c_ulonglong,
            "unsigned int": ctypes.c_uint}


def _declarations():
    """{entry point: (C return type, [C argument types])} of every
    ``extern "C"`` function in csrc/*.cu."""
    out = {}
    for src in _build.sources():
        for m in re.finditer(r'extern\s+"C"\s+(int|long long)\s+(\w+)\s*\(([^)]*)\)',
                             src.read_text()):
            args = []
            for arg in m.group(3).split(","):
                arg = re.sub(r"\bconst\b", "", " ".join(arg.replace("*", "* ").split()))
                args.append(" ".join(arg.split()).rsplit(" ", 1)[0].replace(" *", "*"))
            out[m.group(2)] = (m.group(1), args)
    return out


def test_ctypes_signatures_match_the_cuda_sources():
    decls = _declarations()
    assert set(decls) == set(_build._SIGNATURES) | set(_build._SIZERS)
    for name, (ret, args) in decls.items():
        want = _build._SIGNATURES.get(name, _build._SIZERS.get(name))
        assert ret == ("int" if name in _build._SIGNATURES else "long long"), name
        assert [_C_TYPES[a] for a in args] == want, name
