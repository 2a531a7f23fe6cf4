"""The program's spans joined with a ``torch.profiler`` trace of the same
slice, and the per-layer numbers that read them.

The program records spans (``utils/profiler.py`` of the port: name, start
and end on ``time.time_ns()``, the thread's native id, the parent span on
that thread, the request's ids) while the recorder is on.  The profiler's
Chrome trace gives each event's ``ts`` in us after its
``baseTimeNanoseconds``, on the same clock, and each kernel, copy or fill
the ``correlation`` id of the runtime call that launched it (a graph
replay's operations share their ``cudaGraphLaunch``'s).  The join:

* a device operation belongs to the innermost span (the latest-starting
  one that holds the time) on the launching thread that holds its
  launching runtime call; where none does there, to the innermost on any
  thread (autograd's device thread launches the backward while the caller
  waits inside ``train.backward``, whose own layer spans start later).  A
  CUDA call's ``tid`` is CUPTI's id of its thread, which on the H100
  machine was not the span's native id (and matched
  ``threading.get_ident() & 0xFFFFFFFF`` in one process, not in another),
  so there the rule on any thread decides;
* an idle gap of the device belongs to the innermost span, on any thread,
  that holds its midpoint.

Times here are nanoseconds on the program's clock.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls into CUDA: the runtime's, and the driver's (cuLaunchKernel of
# kernels that libraries and the port load as modules)
CALL_CATS = ("cuda_runtime", "cuda_driver")
SHORT_GAP_NS = 20_000    # shorter idle gaps are summed apart, as trace.py does
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")   # and their Ex variants

# the layer of a training step's kernel, by its innermost span (PERF.md §3:
# the batch's assembly and the ingest count under the frontend, the loss
# under the decoder)
TRAIN_LAYER = {"train.step": "frontend", "train.ingest": "frontend",
               "ingest": "frontend", "frontend": "frontend",
               "encoder": "encoder", "decoder": "decoder",
               "decode.step": "decoder", "train.forward": "decoder",
               "train.backward": "decoder", "train.optimizer": "optimizer"}


class Span(NamedTuple):
    name: str
    start: int
    end: int
    thread: int
    id: int
    parent: Optional[int]
    ids: dict


class Event(NamedTuple):
    name: str
    cat: str
    start: int
    end: int
    tid: object
    corr: Optional[int]


def spans_of(records: Iterable) -> List[Span]:
    """The program's span records (``SpanRecord``s or their tuples)."""
    return [Span(*tuple(r)) for r in records]


def events_of(trace: dict) -> List[Event]:
    """The runtime calls and device operations of a Chrome trace (its JSON
    as loaded), on the program's clock."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    out = []
    for e in trace.get("traceEvents", []):
        cat = e.get("cat", "")
        if e.get("ph") != "X" or "dur" not in e or not (
                cat in CALL_CATS or cat in DEVICE_CATS):
            continue
        start = base + round(float(e["ts"]) * 1e3)
        out.append(Event(e.get("name", ""), cat, start,
                         start + round(float(e["dur"]) * 1e3), e.get("tid"),
                         (e.get("args") or {}).get("correlation")))
    return out


class Index:
    """Spans sorted by start, for the innermost span at a time."""

    def __init__(self, spans: Sequence[Span]):
        self.order = sorted(spans, key=lambda s: s.start)
        self.starts = [s.start for s in self.order]

    def innermost(self, t: int, tid=None) -> Optional[Span]:
        """The latest-starting span that holds ``t``: on thread ``tid``
        where one does (``tid`` None: any thread), else on any."""
        other = None
        for j in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            s = self.order[j]
            if s.end >= t:
                if tid is None or s.thread == tid:
                    return s
                other = other or s
        return other


def attribute_ops(events: Sequence[Event], spans: Sequence[Span]
                  ) -> List[Tuple[Event, Optional[Span]]]:
    """Each device operation with the span it belongs to (None where no
    span holds its launching call, or the call is not in the trace)."""
    calls = {e.corr: e for e in events if e.cat in CALL_CATS}
    index = Index(spans)
    out = []
    for e in events:
        if e.cat in DEVICE_CATS:
            call = calls.get(e.corr)
            out.append((e, None if call is None
                        else index.innermost(call.start, call.tid)))
    return out


def _union(intervals) -> List[Tuple[int, int]]:
    """Sorted, merged intervals."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def device_busy(events: Sequence[Event], window: Tuple[int, int]
                ) -> List[Tuple[int, int]]:
    """The merged intervals in which the device ran an operation, clipped to
    ``window``."""
    lo, hi = window
    return _union((max(e.start, lo), min(e.end, hi)) for e in events
                  if e.cat in DEVICE_CATS and e.end > lo and e.start < hi)


def traced_window(events: Sequence[Event]) -> Optional[Tuple[int, int]]:
    """From the first runtime call's start to the last runtime call's or
    device operation's end (``core/trace.py``'s window)."""
    calls = [e for e in events if e.cat == "cuda_runtime"]
    if not calls:
        return None
    return min(e.start for e in calls), max(e.end for e in events)


def idle_gaps(events: Sequence[Event], window: Tuple[int, int]
              ) -> List[Tuple[int, int]]:
    """The device's idle intervals inside ``window``."""
    edges = [window[0]]
    for a, b in device_busy(events, window):
        edges += [a, b]
    edges.append(window[1])
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def idle_by_span(events: Sequence[Event], spans: Sequence[Span],
                 window: Tuple[int, int]) -> Dict[str, float]:
    """Seconds of the device's idle time by the innermost span (any thread)
    that holds each gap's midpoint; gaps under 20 us under "gaps under 20
    us", those no span holds under "no span"."""
    index = Index(spans)
    out: Dict[str, float] = {}
    for a, b in idle_gaps(events, window):
        if b - a < SHORT_GAP_NS:
            key = "gaps under 20 us"
        else:
            s = index.innermost((a + b) // 2)
            key = "no span" if s is None else s.name
        out[key] = out.get(key, 0.0) + (b - a) * 1e-9
    return out


def _overlap(xs: Sequence[Tuple[int, int]], ys: Sequence[Tuple[int, int]]) -> int:
    """Total length of the intersection of two sorted, merged interval
    lists."""
    i = j = tot = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        tot += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


# -- the per-layer numbers

def self_ms_a_batch(events: Sequence[Event], spans: Sequence[Span], name: str
                    ) -> Optional[float]:
    """Device ms a batch of the operations that belong to spans ``name``
    (their self time), over the number of such spans."""
    n = sum(s.name == name for s in spans)
    if not n:
        return None
    ms = sum(e.end - e.start for e, s in attribute_ops(events, spans)
             if s is not None and s.name == name) * 1e-6
    return ms / n


def launches_a_batch(events: Sequence[Event], spans: Sequence[Span], name: str
                     ) -> Optional[float]:
    """Kernel launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``) a
    batch whose innermost span (as a device operation's launching call) is
    a span ``name`` or lies inside one, over the number of such spans."""
    n_spans = sum(s.name == name for s in spans)
    if not n_spans:
        return None
    index, by_id = Index(spans), {s.id: s for s in spans}
    n = 0
    for e in events:
        if e.cat in CALL_CATS and e.name.startswith(LAUNCHES):
            s = index.innermost(e.start, e.tid)
            while s is not None and s.name != name:
                s = by_id.get(s.parent)
            n += s is not None
    return n / n_spans


def idle_share_inside(events: Sequence[Event], spans: Sequence[Span],
                      window: Tuple[int, int], name: str) -> Optional[float]:
    """% of ``window`` in which the device is idle while the host is inside
    a span ``name`` (any thread)."""
    inside = _union((max(s.start, window[0]), min(s.end, window[1]))
                    for s in spans if s.name == name
                    and s.end > window[0] and s.start < window[1])
    if not inside or window[1] <= window[0]:
        return None
    return 100.0 * _overlap(idle_gaps(events, window), inside) / (window[1] - window[0])


def host_ms(spans: Sequence[Span], name: str) -> Optional[float]:
    """Host ms summed over the spans ``name``."""
    hit = [s for s in spans if s.name == name]
    return sum(s.end - s.start for s in hit) * 1e-6 if hit else None


def replays(events: Sequence[Event]) -> List[List[Event]]:
    """The device operations of each graph replay in the trace, in order: an
    operation of a replay shares the correlation id of its
    ``cudaGraphLaunch``."""
    launches = {e.corr for e in events if e.cat in CALL_CATS
                and e.name.startswith("cudaGraphLaunch")}
    groups: Dict[int, List[Event]] = {}
    for e in events:
        if e.cat in DEVICE_CATS and e.corr in launches:
            groups.setdefault(e.corr, []).append(e)
    return [sorted(g, key=lambda e: e.start) for _, g in sorted(groups.items())]


def op_key(e: Event) -> str:
    """What must agree between an eager operation and a replayed one: a
    kernel's name; a copy's or a fill's kind, which a graph runs as a
    kernel of another name ("memset32" for "Memset (Device)",
    "memcpy32_post" for a "Memcpy DtoD")."""
    if e.cat == "gpu_memset" or (e.cat == "kernel" and e.name.startswith("memset")):
        return "memset"
    if e.cat == "gpu_memcpy" or (e.cat == "kernel" and e.name.startswith("memcpy")):
        return "memcpy"
    return e.name


def train_layer_ms(eager: Sequence[Tuple[Event, Optional[Span]]],
                   replay: Sequence[Event]) -> Optional[Dict[str, float]]:
    """Device ms of one replayed step by layer: the eager step's
    operations (with their spans, in device order) matched one to one, in
    order, with the replay's; None where the two sequences of names
    differ.  Operations whose span maps to no layer count under
    "unmapped"."""
    eager = sorted(eager, key=lambda es: es[0].start)
    if [op_key(e) for e, _ in eager] != [op_key(e) for e in replay]:
        return None
    out = {k: 0.0 for k in ("frontend", "encoder", "decoder", "optimizer", "unmapped")}
    for (_, s), r in zip(eager, replay):
        layer = TRAIN_LAYER.get(s.name) if s is not None else None
        out[layer or "unmapped"] += (r.end - r.start) * 1e-6
    return out


def first_mismatch(eager: Sequence[Tuple[Event, Optional[Span]]],
                   replay: Sequence[Event]) -> Optional[Tuple[int, str, str]]:
    """Where the two name sequences part: (index, eager name, replay name),
    or None where they agree."""
    a = [op_key(e) for e, _ in sorted(eager, key=lambda es: es[0].start)]
    b = [op_key(e) for e in replay]
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    if len(a) != len(b):
        i = min(len(a), len(b))
        return i, a[i] if i < len(a) else "", b[i] if i < len(b) else ""
    return None
