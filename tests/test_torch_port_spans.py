"""The port's span recorder (``utils/profiler.py``), the spans its hot paths
open, and the benchmark's join of spans with a profiler trace
(``port_bench/core/spans.py``), on the CPU at tiny sizes."""
import collections
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from port_bench.core import spans as S
from sbl_for_multilingual_lip_reading_tpu_torch import config as C
from sbl_for_multilingual_lip_reading_tpu_torch.data import (
    SyntheticLipDataset, device_ingest)
from sbl_for_multilingual_lip_reading_tpu_torch.decode.beam import (
    make_uni_beam_decoder)
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.models.sbl import SBLTransformer
from sbl_for_multilingual_lip_reading_tpu_torch.recognize import recognize_batch
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
from sbl_for_multilingual_lip_reading_tpu_torch.utils import profiler as P


@pytest.fixture(autouse=True)
def recorder_off():
    P.disable()
    P.drain()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    P.disable()
    P.drain()


def _clips(cfg, n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, cfg.data.frames, cfg.data.raw_size,
                                  cfg.data.raw_size), generator=g,
                         dtype=torch.uint8)


def _tree(spans):
    """{(name, parent's name): count}."""
    by = {s.id: s for s in spans}
    return collections.Counter(
        (s.name, by[s.parent].name if s.parent in by else None) for s in spans)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_off_is_the_shared_null_span_with_no_clock_read(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")
    monkeypatch.setattr(P.time, "time_ns", no_clock)
    a, b = P.span("frontend"), P.span("decode.step", pos=3)
    assert a is P.NULL and b is P.NULL
    with a:
        pass
    assert P.drain() == []


def test_nesting_parents_and_threads():
    with P.recording():
        with P.span("outer", batch=P.NEXT):
            with P.span("inner"):
                pass

            def other():
                with P.span("elsewhere"):
                    with P.span("below"):
                        pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with P.span("sibling"):
            pass
    spans = {s.name: s for s in P.drain()}
    assert P.drain() == []      # drained
    outer, inner = spans["outer"], spans["inner"]
    assert outer.parent is None and inner.parent == outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    # another thread: its own stack, the request shared
    assert spans["elsewhere"].parent is None
    assert spans["below"].parent == spans["elsewhere"].id
    assert spans["elsewhere"].thread != outer.thread
    assert outer.thread == threading.get_native_id()
    assert {s.ids["batch"] for s in spans.values()} == {outer.ids["batch"]}


def test_request_ids_batch_epoch_step():
    with P.recording():
        for _ in range(2):
            with P.span("ingest", batch=P.NEXT):
                pass
            with P.span("decode"):
                with P.span("decode.step", pos=0):
                    pass
        with P.span("train.epoch_const", epoch=4):
            pass
        for i in range(2):
            with P.span("train.step", step=i):
                with P.span("train.ingest"):
                    with P.span("ingest", batch=P.NEXT):   # not a batch here
                        pass
    spans = P.drain()
    ids = [(s.name, s.ids) for s in spans]
    b0 = spans[0].ids["batch"]
    assert ids[:6] == [
        ("ingest", {"batch": b0}), ("decode.step", {"batch": b0, "pos": 0}),
        ("decode", {"batch": b0}), ("ingest", {"batch": b0 + 1}),
        ("decode.step", {"batch": b0 + 1, "pos": 0}), ("decode", {"batch": b0 + 1})]
    assert ids[6] == ("train.epoch_const", {"epoch": 4})
    steps = [(n, i) for n, i in ids[7:]]
    assert steps[:3] == [("ingest", {"epoch": 4, "step": 0}),
                         ("train.ingest", {"epoch": 4, "step": 0}),
                         ("train.step", {"epoch": 4, "step": 0})]
    assert {tuple(sorted(i.items())) for _, i in steps[3:]} == {
        (("epoch", 4), ("step", 1))}


def test_capture_records_nothing(monkeypatch):
    P.enable()
    monkeypatch.setattr(P.RECORDER, "_cuda", True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert P.span("train.forward") is P.NULL
    x = torch.ones(3, requires_grad=True) * 2
    P.backward_span(x, "frontend")
    assert x._backward_hooks is None


def _train_forward_backward(model, cfg):
    video = device_ingest(_clips(cfg), cfg.data.crop_size)
    labels = torch.tensor([[3, 4, 5, -1], [6, 7, -1, -1]])
    model.train()
    out = (model(video, labels, labels.flip(-1))
           if isinstance(model, SBLTransformer) else model(video, labels))
    out[0].float().sum().backward()


@pytest.mark.parametrize("name,hooks", [("sbl", 4), ("lrw1000", 3)])
def test_backward_hooks_only_while_recording(monkeypatch, name, hooks):
    cfg = C.tiny_test(name)
    model = build_model(cfg, "cpu")
    registered = []
    real = torch.Tensor.register_hook

    def counting(self, hook):
        registered.append(hook)
        return real(self, hook)
    monkeypatch.setattr(torch.Tensor, "register_hook", counting)
    _train_forward_backward(model, cfg)
    assert registered == [] and P.drain() == []
    with P.recording():
        _train_forward_backward(model, cfg)
    assert len(registered) == hooks
    phases = [s for s in P.drain() if s.parent is None
              and s.name in ("frontend", "encoder", "decoder")]
    # no enclosing span here: the backward's layers are roots, in order
    back = [s.name for s in sorted(phases, key=lambda s: s.start_ns)][-3:]
    assert back == ["decoder", "encoder", "frontend"]


def test_span_lands_on_the_profiler_clock():
    """A span around a ``record_function`` block: the trace's event, at
    ``ts`` after ``baseTimeNanoseconds``, starts within 50 us after the
    span's start and ends inside it (after two warm-up blocks: the first
    ones under a new profiler take some 100 us more to start)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.randn(64, 64)
    with P.recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with P.span("probe", pos=i):
                with record_function(f"probe_block{i}"):
                    (x @ x).sum()
    span = P.drain()[-1]
    trace = _export(prof)
    ev = [e for e in trace["traceEvents"] if e.get("name") == "probe_block2"][0]
    start = trace["baseTimeNanoseconds"] + round(ev["ts"] * 1e3)
    assert 0 <= start - span.start_ns <= 50_000
    assert start + round(ev["dur"] * 1e3) <= span.end_ns + 1_000
    assert ev["tid"] == span.thread


def _export(prof):
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


# ---------------------------------------------------------------------------
# the spans of the hot paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sbl", "lrw1000"])
def test_recognize_batch_span_tree(name):
    cfg = C.tiny_test(name)
    model = build_model(cfg, "cpu")
    with P.recording():
        for seed in range(2):
            recognize_batch(model, _clips(cfg, seed=seed), cfg.data.crop_size)
    spans = P.drain()
    steps = cfg.decoder.maxlen
    assert _tree(spans) == {("ingest", None): 2, ("frontend", None): 2,
                            ("encoder", None): 2, ("decode", None): 2,
                            ("decode.step", "decode"): 2 * steps}
    batches = collections.defaultdict(set)
    for s in spans:
        batches[s.ids["batch"]].add(s.name)
    assert len(batches) == 2
    assert all(v == {"ingest", "frontend", "encoder", "decode", "decode.step"}
               for v in batches.values())
    pos = sorted(s.ids["pos"] for s in spans if s.name == "decode.step")
    assert pos == sorted(list(range(steps)) * 2)


def test_cached_beam_span_tree():
    cfg = C.tiny_test("lrw1000")
    model = build_model(cfg, "cpu")
    V = cfg.decoder.vocab_size
    beam = make_uni_beam_decoder(model, 3, torch.zeros(V, V))
    with P.recording():
        beam(device_ingest(_clips(cfg), cfg.data.crop_size))
    spans = P.drain()
    L = cfg.decoder.maxlen
    assert _tree(spans) == {("ingest", None): 1, ("frontend", None): 1,
                            ("encoder", None): 1, ("decode", None): 1,
                            ("decode.step", "decode"): L,
                            ("beam.advance", "decode.step"): L,
                            ("beam.regather", "decode.step"): L}
    assert len({s.ids["batch"] for s in spans}) == 1


@pytest.mark.parametrize("name", ["sbl", "lrw1000"])
def test_two_fused_training_steps_span_tree(monkeypatch, name):
    monkeypatch.delenv("SBL_NO_EPOCH_FUSED", raising=False)
    cfg = dataclasses.replace(C.tiny_test(name), batch_size=2)
    kw = dict(kind="lrw1000", vocab="lrw1000") if name == "lrw1000" else {}
    data = SyntheticLipDataset(size=4, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=0, **kw)
    tr = Trainer(cfg, data, device="cpu", cache_on_device=True)
    with P.recording():
        assert np.isfinite(tr.train_epoch(3))
    spans = P.drain()
    tree = _tree(spans)
    want = {("train.epoch_const", None): 1, ("train.step", None): 2,
            ("train.read", None): 2,
            ("train.ingest", "train.step"): 2, ("ingest", "train.ingest"): 2,
            ("train.forward", "train.step"): 2,
            ("train.backward", "train.step"): 2,
            ("train.optimizer", "train.step"): 2}
    for layer in ("frontend", "encoder", "decoder"):
        # the forward's, and the backward's (on the CPU autograd runs on
        # the caller's thread, inside train.backward)
        want[(layer, "train.forward")] = want[(layer, "train.backward")] = 2
    if name == "sbl":
        want[("decode.step", "decoder")] = 2 * cfg.decoder.maxlen
    assert tree == want
    step_ids = {s.ids.get("step") for s in spans if s.name != "train.epoch_const"}
    assert step_ids == {0, 1}
    assert {s.ids["epoch"] for s in spans} == {3}
    by = {s.id: s for s in spans}
    for step in (0, 1):
        back = sorted((s for s in spans if s.parent in by
                       and by[s.parent].name == "train.backward"
                       and s.ids["step"] == step), key=lambda s: s.start_ns)
        assert [s.name for s in back] == ["decoder", "encoder", "frontend"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(back, back[1:]))


# ---------------------------------------------------------------------------
# the joins: the program's (device_ms) and the benchmark's (core/spans.py)
# ---------------------------------------------------------------------------

def _span(name, start, end, thread=1, id=0, parent=None):
    return S.Span(name, start, end, thread, id, parent, {})


def _ev(name, cat, start, end, tid=1, corr=None):
    return S.Event(name, cat, start, end, tid, corr)


SPANS = [_span("decode", 0, 100_000, id=1), _span("decode.step", 10_000, 50_000, id=2, parent=1),
         _span("train.backward", 0, 200_000, thread=2, id=3)]
EVENTS = [
    _ev("cudaLaunchKernel", "cuda_runtime", 20_000, 21_000, corr=1),
    _ev("cudaLaunchKernel", "cuda_runtime", 60_000, 61_000, corr=2),
    _ev("cudaLaunchKernelExC", "cuda_runtime", 150_000, 151_000, corr=3),
    _ev("cudaMemcpyAsync", "cuda_runtime", 300_000, 301_000, corr=4),
    _ev("k1", "kernel", 30_000, 40_000, tid=0, corr=1),
    _ev("k2", "kernel", 45_000, 90_000, tid=0, corr=2),
    _ev("k3", "kernel", 160_000, 170_000, tid=0, corr=3),
    _ev("Memcpy DtoH", "gpu_memcpy", 305_000, 306_000, tid=0, corr=4),
]


def test_join_by_correlation_and_thread():
    got = [(e.name, s and s.name) for e, s in S.attribute_ops(EVENTS, SPANS)]
    assert got == [("k1", "decode.step"), ("k2", "decode"),
                   # no span on the launching thread: the other thread's
                   ("k3", "train.backward"), ("Memcpy DtoH", None)]
    assert S.self_ms_a_batch(EVENTS, SPANS, "decode") == pytest.approx(0.045)
    assert S.self_ms_a_batch(EVENTS, SPANS, "encoder") is None
    assert S.launches_a_batch(EVENTS, SPANS, "decode") == 2


def test_idle_by_span_and_inside_decode():
    window = S.traced_window(EVENTS)
    assert window == (20_000, 306_000)
    idle = S.idle_by_span(EVENTS, SPANS, window)
    # 20-30 us: 10 us, short; 40-45: short; 90-160: mid 125 in train.backward
    # (another thread); 170-305: mid 237.5, in no span
    assert idle == pytest.approx({"gaps under 20 us": 15e-6, "train.backward": 70e-6,
                                  "no span": 135e-6})
    # idle while inside decode: 20-30, 40-45 and 90-100 us of 286 us
    assert S.idle_share_inside(EVENTS, SPANS, window, "decode") == pytest.approx(
        100 * 25 / 286)
    assert S.host_ms(SPANS, "decode") == pytest.approx(0.1)


def test_events_from_a_chrome_trace():
    trace = {"baseTimeNanoseconds": 1_000_000_000, "traceEvents": [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1.5,
         "dur": 2.0, "tid": 7, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 4.0, "dur": 1.0, "tid": 1,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5.5, "dur": 1.0, "tid": 1,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1.0, "dur": 1.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0}]}
    ev = S.events_of(trace)
    assert [(e.name, e.start, e.end, e.corr) for e in ev] == [
        ("cudaGraphLaunch", 1_000_001_500, 1_000_003_500, 9),
        ("a", 1_000_004_000, 1_000_005_000, 9), ("b", 1_000_005_500, 1_000_006_500, 9)]
    assert [[e.name for e in r] for r in S.replays(ev)] == [["a", "b"]]
    # the program's join reads the same trace
    spans = [P.SpanRecord("train.step", 1_000_001_000, 1_000_004_000, 7, 1, None, {})]
    assert P.device_ms(trace, spans) == pytest.approx({"train.step": 0.002})


def test_train_layer_map_matches_names_in_order():
    eager = [(_ev("ingest_k", "kernel", 0, 1), _span("train.ingest", 0, 9)),
             (_ev("conv", "kernel", 1, 2), _span("frontend", 0, 9)),
             (_ev("attn", "kernel", 2, 3), _span("encoder", 0, 9)),
             (_ev("loss", "kernel", 3, 4), _span("train.forward", 0, 9)),
             (_ev("adam", "kernel", 4, 5), _span("train.optimizer", 0, 9)),
             (_ev("stray", "kernel", 5, 6), None)]
    replay = [_ev(n, "kernel", 10 * i, 10 * i + 1_000_000 * (i + 1))
              for i, n in enumerate(["ingest_k", "conv", "attn", "loss", "adam", "stray"])]
    got = S.train_layer_ms(eager, replay)
    assert got == pytest.approx({"frontend": 3.0, "encoder": 3.0, "decoder": 4.0,
                                 "optimizer": 5.0, "unmapped": 6.0})
    assert S.first_mismatch(eager, replay) is None
    # a graph runs a fill or a copy as a kernel of another name
    graphed = [_ev("memset32", "kernel", 0, 1)] + replay
    filled = [(_ev("Memset (Device)", "gpu_memset", -1, 0), None)] + eager
    assert S.train_layer_ms(filled, graphed)["unmapped"] == pytest.approx(6.0)
    swapped = replay[:1] + [replay[2], replay[1]] + replay[3:]
    assert S.train_layer_ms(eager, swapped) is None
    assert S.first_mismatch(eager, swapped) == (1, "conv", "attn")
    assert S.train_layer_ms(eager, replay[:-1]) is None
