"""Share of the traced slice (its graph replays one after another) in which the
device runs no kernel and no copy, in %: 1 - the union of the device's
intervals / the traced window.  The profiler's cost on the host falls
inside the window (CUDA activity only: some 15% of a recognize batch's
time, little for a graph replay)."""
from port_bench.core import trace


def read(run):
    if not run.records or run.slice_window is None:
        return None
    lo, hi = run.slice_window
    busy = trace.busy_seconds(run.records, run.slice_window)
    return 100.0 * (1.0 - busy / ((hi - lo) * 1e-6)) if busy > 0 else None
