"""The frozen arithmetic: model FLOPs, roofline bounds, and the trace
reductions on a hand-made trace."""
from types import SimpleNamespace

import pytest

from port_bench.core import trace as T
from port_bench.reference import flops as F
from port_bench.reference import roofline as RL


@pytest.mark.parametrize("preset,infer,train", [("sbl", 32.624144384, 97.872433152),
                                                ("lrw1000_seq2seq", 20.627877888, 62.96150016)])
def test_flops_pinned(preset, infer, train):
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    cfg = getattr(C, preset)()
    assert F.inference_flops_per_clip(cfg) / 1e9 == pytest.approx(infer, abs=1e-6)
    assert F.train_flops_per_clip(cfg) / 1e9 == pytest.approx(train, abs=1e-6)


def test_beam_flops_and_peak():
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    cfg = C.lrw1000_seq2seq()
    dec = F.uni_decoder_fwd_flops(cfg, teacher_forced=False)
    assert F.beam_flops_per_clip(cfg, 1) == pytest.approx(F.inference_flops_per_clip(cfg))
    assert F.beam_flops_per_clip(cfg, 5) == pytest.approx(F.inference_flops_per_clip(cfg) + 4 * dec)
    assert F.mfu(1000.0, 989e6) == pytest.approx(1e-3)


def test_the_peak_is_not_read_from_the_environment(monkeypatch):
    monkeypatch.setenv("SBL_PEAK_TFLOPS", "1")
    assert F.mfu(1000.0, 989e6) == pytest.approx(1e-3)


def test_bounds():
    assert RL.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert RL.bound_s(0, 989e12) == pytest.approx(1.0)
    # (512, 30) x (512, 30), 8 heads of 64, bf16: bytes-bound
    n_bytes = 4 * 512 * 30 * 512 * 2
    assert RL.attention_bound_s(512, 30, 30, 8, 64) == pytest.approx(n_bytes / 3.35e12)
    assert RL.attention_bound_s(1, 4096, 4096, 8, 64) == pytest.approx(
        2 * 2.0 * 8 * 4096 * 4096 * 64 / 989e12)


R = T.Rec
HAND = [R("cudaMemcpyAsync", "cuda_runtime", 0, 10),
        R("void small_mha_mma_kernel<64>(...)", "kernel", 100, 300),
        R("void other_kernel()", "kernel", 250, 400),
        R("Memcpy HtoD", "gpu_memcpy", 600, 700),
        R("cudaEventSynchronize", "cuda_runtime", 350, 650),
        R("cudaLaunchKernel", "cuda_runtime", 450, 470),
        R("late kernel", "kernel", 990, 1000)]


def test_union_window_and_busy_time():
    assert T.union([(5, 7), (0, 2), (1, 3), (3, 4), (9, 9)]) == [(0, 4), (5, 7)]
    w = T.traced_window(HAND)
    assert w == (0, 1000)
    busy = 200 + 150 - 50 + 100 + 10           # the overlap counted once
    assert T.busy_seconds(HAND, w) == pytest.approx(busy * 1e-6)
    assert T.busy_seconds(HAND, (0, 995)) == pytest.approx((busy - 5) * 1e-6)
    assert T.traced_window([R("k", "kernel", 0, 1)]) is None


@pytest.mark.parametrize("metric", ["idle_share.recognize", "idle_share.train"])
def test_idle_share_of_the_traced_window(metric):
    from port_bench.core import spec
    read = spec.load().reader(metric)
    run = SimpleNamespace(records=HAND, slice_window=(0, 1000))
    assert read(run) == pytest.approx(100 * (1 - 410 / 1000))
    run.records = [HAND[0]]
    assert read(run) is None


def test_gaps_are_put_to_the_host_operation():
    gaps = dict(T.idle_gaps(HAND, (0, 1000)))
    # [0,100) and [700,990): no runtime call; [400,600): inside the sync
    assert gaps["host: none"] == pytest.approx(390e-6)
    assert gaps["cudaEventSynchronize"] == pytest.approx(200e-6)
    ops = T.top_device_ops(HAND)
    assert ops[0][0] == "small_mha_mma_kernel<64>(...)" and ops[0][1] == pytest.approx(200e-6)
    assert T.kernel_seconds(HAND, ["small_mha_mma_kernel"]) == (1, pytest.approx(200e-6))


def test_chrome_records():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "python_function", "name": "f", "ts": 0, "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 3},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1, "dur": 2}]}
    assert T.records_from_chrome(trace) == [R("k", "kernel", 10.0, 15.0),
                                            R("aten::add", "cpu_op", 1.0, 3.0)]


def _run(entry, bidirectional, batches=3, beam=5):
    from port_bench.core import spec
    cfg = SimpleNamespace(data=SimpleNamespace(frames=30),
                          decoder=SimpleNamespace(maxlen=16, bidirectional=bidirectional),
                          dims=SimpleNamespace(n_enc_layers=6, n_dec_layers=6, n_head=8, d_k=64))
    mix = {"entry": entry, "batch": 512, "beam": beam, "trace_batches": batches}
    Part = spec.load().entry(entry).Part
    me = SimpleNamespace(cfg=cfg, mix=mix)
    part = SimpleNamespace(attention_calls=lambda: Part.attention_calls(me))
    return SimpleNamespace(cfg=cfg, mix=mix, part=part)


@pytest.mark.parametrize("entry,bidi,launches", [("recognize", True, 198),
                                                 ("recognize", False, 102),
                                                 ("beam", False, 102)])
def test_attention_roofline_counts_the_paths_calls(entry, bidi, launches):
    from port_bench.core import spec
    read = spec.load().reader("attention_roofline.recognize")
    run = _run(entry, bidi)
    per = 1e-5
    run.records = [R("void small_mha_mma_kernel<64>()", "kernel", i * 20, i * 20 + per * 1e6)
                   for i in range(3 * launches)]
    share = read(run)
    assert share is not None and 0 < share
    # one launch fewer: the path is not the counted one, nothing is read
    run.records = run.records[:-1]
    assert read(run) is None
    run.part = SimpleNamespace()     # an entry that lists no calls
    assert read(run) is None


def test_the_beams_attention_bound_by_hand():
    """B = 512 clips, K = 5: the encoder's 6 calls over (512, 30) x (512,
    30), and 16 x 6 cross calls of 2,560 one-position queries over their
    clips' 512 memories of 30 frames, 8 heads of 64, bf16: bytes-bound,
    each memory read once a clip."""
    from port_bench.core import spec
    read = spec.load().reader("attention_roofline.recognize")
    enc = 4 * 512 * 30 * 512 * 2                       # q, k, v, out
    cross = 2 * 2560 * 1 * 512 * 2 + 2 * 512 * 30 * 512 * 2
    assert cross == 36_700_160
    least = (6 * enc + 96 * cross) / 3.35e12
    run = _run("beam", False, batches=1)
    run.records = [R("void small_mha_mma_kernel<64>()", "kernel", i * 100, i * 100 + 10)
                   for i in range(102)]                # 1,020 us of K1
    assert read(run) == pytest.approx(100 * least / 1020e-6)
