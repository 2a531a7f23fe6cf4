"""K1's share of its roofline on the recognize and beam paths, in %: the
least time of the attention work that K1 (``ops/attention.py``,
``csrc/attention.cu``) computes in the traced slice over K1's summed device
time there.  The work is counted at the shapes the algorithm needs,
whatever kernel computes it, as the entry's ``attention_calls()`` lists
them for one batch: (query rows, query length, memory rows, memory
length), each input read once and each output written once
(``reference/roofline``).  Nothing is read where the entry lists no calls,
or where the slice's K1 launches are not as many as it lists."""
from port_bench.core import trace
from port_bench.reference import roofline

KERNELS = ("small_mha_mma_kernel", "small_mha_f32_kernel")


def read(run):
    calls = getattr(run.part, "attention_calls", None)
    if not run.records or calls is None:
        return None
    per_batch = calls()
    n, seconds = trace.kernel_seconds(run.records, KERNELS)
    if n != len(per_batch) * run.mix["trace_batches"] or seconds <= 0:
        return None
    H, d = run.cfg.dims.n_head, run.cfg.dims.d_k
    least = sum(roofline.attention_bound_s(rows, tq, tk, H, d, kv_rows=kv)
                for rows, tq, kv, tk in per_batch)
    return 100.0 * least * run.mix["trace_batches"] / seconds
