"""K3 + K4's share of their roofline in a training step, in %: the least
time of the step's dropout attention (``ops/attention.py``,
``csrc/attention_train.cu``), forward and backward once each at the shapes
the algorithm needs, over K3 + K4's summed device time in the traced slice
(which also holds the decode steps' checkpointed recompute, work the
algorithm does not need).  Shapes: every encoder layer's self-attention
over the frames; at each decode step s both directions' self- and
cross-attention over the live prefix of s + 1 positions.  Forward: q, k, v
read and the output written once; backward: q, k, v and the output's
gradient read, dq, dk, dv written, five products.  Nothing is read where
the slice's launches are not the path's."""
from port_bench.core import trace
from port_bench.reference import roofline

KERNELS = ("dropout_attention_fwd_mma_kernel", "dropout_attention_bwd_mma_kernel")


def calls(cfg, B):
    T, L, n_dec = cfg.data.frames, cfg.decoder.maxlen, cfg.dims.n_dec_layers
    out = [(B, T, T)] * cfg.dims.n_enc_layers
    for s in range(L):
        out += [(2 * B, s + 1, s + 1), (2 * B, s + 1, T)] * n_dec
    return out


def launches(cfg):
    enc, L, n_dec = cfg.dims.n_enc_layers, cfg.decoder.maxlen, cfg.dims.n_dec_layers
    dec = 2 * L * n_dec
    return enc + dec * (2 if cfg.remat_decoder else 1) + enc + dec


def read(run):
    if not run.records:
        return None
    n, seconds = trace.kernel_seconds(run.records, KERNELS)
    if n != launches(run.cfg) * run.mix["trace_steps"] or seconds <= 0:
        return None
    H, d = run.cfg.dims.n_head, run.cfg.dims.d_k
    least = 0.0
    for B, tq, tk in calls(run.cfg, run.mix["batch"]):
        least += roofline.attention_bound_s(B, tq, tk, H, d)
        least += roofline.bound_s((3 * B * tq + 4 * B * tk) * H * d * 2,
                                  5 * 2.0 * B * H * tq * tk * d)
    return 100.0 * least * run.mix["trace_steps"] / seconds
