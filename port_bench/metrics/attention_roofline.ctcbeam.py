"""K12's and K1's share of their roofline on the joint CTC/attention beam,
in %: the least time of the attention work they compute in the traced
slice (the encoder's relative-position self-attention on K12 with its
per-head f32 bias read once, the decoder's cross-attention of the beam's
hypotheses on K1 with each utterance's memory read once; at each
utterance's real length, ``reference/roofline_relpos.py``) over their
summed device time there.  K1 and K12 run one kernel body
(``small_mha_mma_kernel`` in bf16).  Nothing is read where the entry
counts no work, or where the slice's launches of that body are not as many
as the entry counts."""
from port_bench.core import trace

KERNELS = ("small_mha_mma_kernel", "small_mha_f32_kernel")


def read(run):
    work = getattr(run.part, "attention_work", None)
    if not run.records or work is None:
        return None
    launches, least = work()
    n, seconds = trace.kernel_seconds(run.records, KERNELS)
    if not launches or n != launches or seconds <= 0:
        return None
    return 100.0 * least / seconds
