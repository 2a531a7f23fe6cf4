"""Published peaks of one NVIDIA H100 SXM and the least time a piece of
work can take on it (frozen copies of ``chip_smoke.py``'s ``bound`` and
``attention_bound``).

NVIDIA's data sheet, dense rates at the 700 W limit: 989 TFLOP/s bf16,
3.35 TB/s of HBM3.  A roofline share is the bound over the measured time.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def bound_s(n_bytes: float, n_flops: float, flops_s: float = BF16_FLOPS) -> float:
    """The least seconds: the larger of bytes over the HBM rate and
    operations over the peak."""
    return max(n_bytes / HBM_BYTES_S, n_flops / flops_s)


def attention_bound_s(B: int, Tq: int, Tk: int, H: int, d: int,
                      itemsize: int = 2, bias_bytes: int = 0,
                      matmuls: int = 2, kv_rows: int = None) -> float:
    """One flat attention call: q and the output (B, Tq, H*d), k and v
    (kv_rows, Tk, H*d) each read or written once, the bias once, and
    ``matmuls`` products of (Tq x Tk x d) per (row, head) in bf16.
    ``kv_rows`` (B where None): the distinct memories the B rows attend
    to, as when the K hypotheses of a beam share their clip's."""
    kv = B if kv_rows is None else kv_rows
    n_bytes = (2 * B * Tq + 2 * kv * Tk) * H * d * itemsize + bias_bytes
    return bound_s(n_bytes, matmuls * 2.0 * B * H * Tq * Tk * d)
