"""Tracing, program spans and step timing (counterpart of the JAX package's
``utils/profiler.py``).

``span`` is the port's one span recorder: the layer boundaries of the hot
paths (eval ingest, frontend, encoder, decode and its steps, the beam's
frontier, the training step's stages, the epoch's upload) open a span.  The
recorder is off by default, and then ``span`` returns one shared object
that does nothing.  On (``enable``), each span keeps in memory its name,
start and end on ``time.time_ns()`` (the clock ``torch.profiler``'s Chrome
trace converts its timestamps to: a span lies on a trace's timeline at
``(ns - baseTimeNanoseconds) / 1000`` us), its thread's native id (the
trace's ``tid``), the id of its parent on that thread, and the ids of its
request: ``batch`` for an evaluation batch, ``epoch`` and ``step`` for
training.  ``drain`` hands them over.  Under CUDA graph capture a span
records nothing.  ``backward_span`` puts the backward's layers on the
thread autograd runs them on.  ``device_ms`` joins spans with a trace.

``Trace`` is ``--profile-dir``'s trace: ``torch.profiler`` over CPU and, on
a card, CUDA activity (the kernels by symbol, with device times) with the
program's spans over them, written as a Chrome trace (``trace.json``, one
``trace_rank<r>.json`` a process in a data-parallel run) for
chrome://tracing or ui.perfetto.dev; the trainer takes it over steps 1-3 of
the first epoch, as JAX's ``jax.profiler`` trace (JAX
``training/trainer.py:492-506``).  ``StepTimer`` is the rolling step-time
tracker."""
from __future__ import annotations

import bisect
import contextlib
import functools
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

# the ids that name a request; a root span that names one starts it
REQUEST_KEYS = ("epoch", "step", "batch")
NEXT = object()     # ``batch=NEXT``: the recorder's next batch number


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int                 # threading.get_native_id()
    id: int
    parent: Optional[int]       # the enclosing span on the same thread
    ids: Dict[str, int]         # the request's ids and the span's own


class _Null:
    """The span of a recorder that is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Open:
    __slots__ = ("rec", "name", "ids", "id", "parent", "thread", "stack",
                 "start")

    def __init__(self, rec: "Recorder", name: str, ids: dict):
        self.rec, self.name, self.ids = rec, name, ids

    def __enter__(self):
        self.rec._push(self)
        return self

    def __exit__(self, *exc):
        self.rec._pop(self)
        return False


class Recorder:
    """The spans of one process (``RECORDER``); see the module's doc."""

    def __init__(self):
        self.on = False
        self.records: List[SpanRecord] = []
        self.request: Dict[str, int] = {}
        # by threading.get_ident(): each thread's open spans and native id
        # (a system call, ~7 us on the card's machine: read once a thread)
        self._stacks: Dict[int, list] = {}
        self._natives: Dict[int, int] = {}
        self._ids = itertools.count(1)
        self._batches = itertools.count()
        self._phase: Optional[_Open] = None
        self._cuda = False

    def enable(self) -> None:
        self._cuda = torch.cuda.is_available()
        self.on = True

    def disable(self) -> None:
        self.on = False
        self.request, self._phase = {}, None
        self._stacks.clear()
        self._natives.clear()

    def drain(self) -> List[SpanRecord]:
        out, self.records = self.records, []
        return out

    def _capturing(self) -> bool:
        return self._cuda and torch.cuda.is_current_stream_capturing()

    def span(self, name: str, ids: dict):
        if self._capturing():
            return NULL
        return _Open(self, name, ids)

    def _push(self, s: _Open) -> None:
        ident = threading.get_ident()
        s.stack = self._stacks.get(ident)
        if s.stack is None:
            s.stack = self._stacks[ident] = []
            self._natives[ident] = threading.get_native_id()
        s.thread = self._natives[ident]
        request = {k: s.ids[k] for k in REQUEST_KEYS if k in s.ids}
        if s.ids.get("batch") is NEXT:
            if s.stack:       # inside a request already: not a batch of its own
                del s.ids["batch"], request["batch"]
            else:
                s.ids["batch"] = request["batch"] = next(self._batches)
        if request and not s.stack:
            # a step belongs to the epoch; an epoch or a batch starts afresh
            kept = ({"epoch": self.request["epoch"]}
                    if "step" in request and "epoch" in self.request else {})
            self.request = {**kept, **request}
        s.ids = {**self.request, **s.ids}
        s.parent = s.stack[-1].id if s.stack else None
        s.id = next(self._ids)
        s.stack.append(s)
        s.start = time.time_ns()

    def _pop(self, s: _Open) -> None:
        end = time.time_ns()
        if s.stack and s.stack[-1] is s:
            s.stack.pop()
        elif s in s.stack:      # a backward phase, ended from another thread
            s.stack.remove(s)
        if self.on:
            self.records.append(SpanRecord(s.name, s.start, end, s.thread,
                                           s.id, s.parent, s.ids))

    def _begin_phase(self, name: str, grad) -> None:
        """A backward hook: the gradient of a layer's output is whole, so
        that layer's backward begins and the one before it ends; the last
        ends with the backward pass."""
        if not self.on:
            return
        cur = self._phase
        if cur is not None and cur.name == name:
            return
        if cur is None:
            torch.autograd.Variable._execution_engine.queue_callback(
                self._end_phase)
        else:
            cur.__exit__(None, None, None)
        self._phase = _Open(self, name, {})
        self._phase.__enter__()

    def _end_phase(self) -> None:
        if self._phase is not None:
            self._phase.__exit__(None, None, None)
            self._phase = None


RECORDER = Recorder()


def span(name: str, **ids):
    """A context manager: the span ``name`` around its block while the
    recorder is on (``ids``: the span's own, e.g. a decode step's ``pos``;
    a request's ``epoch``, ``step`` or ``batch=NEXT`` at a root span starts
    that request for the spans that follow, on every thread); else the
    shared ``NULL``, which does nothing."""
    if not RECORDER.on:
        return NULL
    return RECORDER.span(name, ids)


def backward_span(tensor: torch.Tensor, name: str) -> None:
    """While the recorder is on: when the gradient of ``tensor`` (a layer's
    output) is whole, the backward's span ``name`` begins on the thread that
    runs the backward, and the span begun by an earlier call ends.  The
    hook is the tensor's own and goes with its graph: nothing is registered
    while the recorder is off, under no-grad or under capture."""
    if (RECORDER.on and tensor.requires_grad and torch.is_grad_enabled()
            and not RECORDER._capturing()):
        tensor.register_hook(functools.partial(RECORDER._begin_phase, name))


def enable() -> None:
    RECORDER.enable()


def disable() -> None:
    RECORDER.disable()


def drain() -> List[SpanRecord]:
    """The spans recorded since the last drain; clears them."""
    return RECORDER.drain()


@contextlib.contextmanager
def recording():
    """The recorder on for the block (and off after it)."""
    enable()
    try:
        yield RECORDER
    finally:
        disable()


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_ms(trace: dict, spans: Iterable[SpanRecord]) -> Dict[Optional[str], float]:
    """{span name: device ms} of a ``torch.profiler`` Chrome trace (CUDA
    activity; its JSON as loaded): each kernel, copy or fill under the
    latest-starting of ``spans`` that holds its launching call (joined by
    ``correlation``) on any thread, as a stage's span holds the calls its
    backward makes on autograd's thread; under None where none holds it."""
    base = trace.get("baseTimeNanoseconds", 0)
    order = sorted(spans, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in order]
    launch, ops = {}, []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launch[corr] = base + round(e["ts"] * 1e3)
        elif e.get("cat") in DEVICE_CATS:
            ops.append((corr, e.get("dur", 0.0)))
    out: Dict[Optional[str], float] = {}
    for corr, dur in ops:
        key = None
        if corr in launch:
            t = launch[corr]
            for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                if order[j].end_ns >= t:
                    key = order[j].name
                    break
        out[key] = out.get(key, 0.0) + dur * 1e-3
    return out


def stage_split(fn, names) -> Dict[str, float]:
    """Device ms of one call of ``fn`` by the spans of ``names`` it opens
    (sequential stages, e.g. the training step's ``train.*``): the call
    under ``torch.profiler`` (CUDA activity) with the recorder on, each
    device operation counted under the stage that launched it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with recording(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [s for s in drain() if s.name in names]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            ms = device_ms(json.load(f), spans)
    return {n: ms.get(n, 0.0) for n in names}


def chrome_events(spans: Iterable[SpanRecord], base_ns: int, pid: int) -> List[dict]:
    """The spans as Chrome trace events on a trace's timeline (``base_ns``
    its ``baseTimeNanoseconds``), category ``program_span``."""
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
             "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": dict(s.ids, id=s.id, parent=s.parent)} for s in spans]


class Trace:
    """A ``torch.profiler`` trace, with the program's spans recorded while
    it runs, written to ``<logdir>/<name>`` when it stops."""

    def __init__(self, logdir: str, device, name: str = "trace.json"):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.path = os.path.join(logdir, name)
        os.makedirs(logdir, exist_ok=True)
        self._prof: Optional[torch.profiler.profile] = torch.profiler.profile(
            activities=activities)
        drain()
        enable()
        self._prof.start()

    def stop(self) -> str:
        """Stop (once) and write the trace with the spans; returns its
        path."""
        if self._prof is not None:
            self._prof.stop()
            disable()
            self._prof.export_chrome_trace(self.path)
            self._prof = None
            with open(self.path) as f:
                trace = json.load(f)
            trace.setdefault("traceEvents", []).extend(chrome_events(
                drain(), trace.get("baseTimeNanoseconds", 0), os.getpid()))
            with open(self.path, "w") as f:
                json.dump(trace, f)
        return self.path


class StepTimer:
    """Rolling step-time / throughput tracker on the host clock.

    >>> timer = StepTimer(batch_size=240)
    >>> with timer.step():
    ...     metrics = train_step(batch, generator)
    >>> timer.clips_per_sec

    A step's time is the host's: the device may still be running it, so a
    rolling mean over many steps is what it measures."""

    def __init__(self, batch_size: int, window: int = 50):
        self.batch_size = batch_size
        self.window = window
        self.times: list = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def mean_step_time(self) -> float:
        # drop the first step (kernel build, cuDNN's choice) when possible
        ts = self.times[1:] if len(self.times) > 1 else self.times
        return sum(ts) / max(len(ts), 1)

    @property
    def clips_per_sec(self) -> float:
        st = self.mean_step_time
        return self.batch_size / st if st > 0 else 0.0
