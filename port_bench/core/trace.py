"""The traced slice: ``torch.profiler`` (CPU + CUDA) over a few batches
after the window, reduced to plain records, and the reductions the
per-layer metrics and the ``breakdown`` read from them.

A record is (name, cat, start_us, end_us) from the profiler's Chrome
trace: ``cat`` "kernel", "gpu_memcpy" or "gpu_memset" for work on the
device, "cuda_runtime" (and, in traces with CPU activity, "cpu_op" and
"user_annotation") on the host.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
SHORT_GAP_US = 20.0    # shorter idle gaps are summed, not labelled
MAX_WALK = 20000       # host operations looked at for one gap


class Rec(NamedTuple):
    name: str
    cat: str
    start: float   # microseconds
    end: float


def records_from_chrome(trace: dict) -> List[Rec]:
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS or cat in HOST_CATS:
            ts = float(e["ts"])
            out.append(Rec(e.get("name", ""), cat, ts, ts + float(e["dur"])))
    return out


@contextlib.contextmanager
def profiled(holder: dict):
    """Profile the block's work on the device (CUDA activity only: the
    profiler's CPU side would slow the host by a third); on exit
    ``holder["records"]`` holds its records and ``holder["window"]`` the
    traced window, from the first CUDA runtime call to the end of the last
    runtime call or device operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            recs = records_from_chrome(json.load(f))
    holder["records"] = recs
    holder["window"] = traced_window(recs)


def traced_window(recs: Iterable[Rec]) -> Optional[Tuple[float, float]]:
    """(first runtime call's start, last runtime call's or device
    operation's end), or None for a trace without runtime calls."""
    host = [r for r in recs if r.cat == "cuda_runtime"]
    if not host:
        return None
    end = max(r.end for r in recs if r.cat == "cuda_runtime" or r.cat in DEVICE_CATS)
    return min(r.start for r in host), end


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def device_busy(recs: Sequence[Rec], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The merged intervals in which the device ran a kernel or a copy,
    clipped to ``window``."""
    lo, hi = window
    return union((max(r.start, lo), min(r.end, hi)) for r in recs
                 if r.cat in DEVICE_CATS and r.end > lo and r.start < hi)


def busy_seconds(recs: Sequence[Rec], window: Tuple[float, float]) -> float:
    return sum(b - a for a, b in device_busy(recs, window)) * 1e-6




def short_name(name: str, width: int = 120) -> str:
    """A kernel's demangled name without its leading "void " and cut to
    ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def top_device_ops(recs: Sequence[Rec], n: int = 10) -> List[List]:
    """[[name, seconds]] of the device operations that took most time,
    summed by (shortened) name."""
    tot: Dict[str, float] = {}
    for r in recs:
        if r.cat in DEVICE_CATS:
            k = short_name(r.name)
            tot[k] = tot.get(k, 0.0) + (r.end - r.start) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(recs: Sequence[Rec], window: Tuple[float, float], n: int = 10) -> List[List]:
    """[[host operation, seconds]]: the device's idle time inside
    ``window``, each gap put to the innermost host operation running at its
    middle ("host: none" where none ran), summed by that name, the longest
    first; gaps under SHORT_GAP_US are summed under one name."""
    lo, hi = window
    edges = [lo]
    for a, b in device_busy(recs, window):
        edges += [a, b]
    edges.append(hi)
    host = sorted((r for r in recs if r.cat in HOST_CATS),
                  key=lambda r: r.start)
    starts = [r.start for r in host]
    tot: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "host: none" if b - a >= SHORT_GAP_US else "gaps under 20 us"
        # the latest-starting host operation that holds mid is the innermost
        first = bisect.bisect_right(starts, mid) - 1
        for j in range(first, max(-1, first - MAX_WALK), -1):
            if b - a < SHORT_GAP_US:
                break
            if host[j].end >= mid:
                name = host[j].name
                break
        tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def kernel_seconds(recs: Sequence[Rec], names: Sequence[str]) -> Tuple[int, float]:
    """(launches, summed seconds) of the kernels whose (demangled) names
    hold one of ``names``."""
    hits = [r for r in recs if r.cat == "kernel" and any(n in r.name for n in names)]
    return len(hits), sum(r.end - r.start for r in hits) * 1e-6
