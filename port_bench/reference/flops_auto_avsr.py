"""Model FLOPs of one utterance of the Auto-AVSR VSR model under the joint
CTC/attention beam, counted from its widths alone (2 FLOPs a MAC;
convolutions and matrix products only, elementwise work and the CTC prefix
recursion not counted).

At T real frames (the padding a batch runs is not counted):

    frontend   the Conv3d stem and the ResNet-18 trunk per frame
               (``flops.frontend_flops`` at T frames)
    encoder    Linear(512 -> d); per Conformer block two FFNs of d x d_inner,
               the four attention projections, the positional projection of
               2T - 1 rows, the scores (q + u) k^T over T keys and
               (q + v) p^T over 2T - 1 positions, the context, the
               pointwise convs d -> 2d and d -> d and the depthwise conv
    CTC head   Linear(d -> V) a frame
    decoder    K hypotheses x ``steps`` cached steps: per layer the
               self-attention's four projections and its scores and context
               over the live prefix, the cross-attention's query and output
               projections and its scores and context over T frames, the
               FFN; the output layer.  The cross K/V projections once per
               utterance and layer (the K hypotheses share them).

``flops_per_utterance`` is the mean over the mix's lengths, uniform over
[min_frames, max_frames].
"""
from __future__ import annotations

from types import SimpleNamespace

from . import flops as F


def frontend_flops(cfg, T: int) -> float:
    view = SimpleNamespace(data=SimpleNamespace(frames=T, crop_size=cfg.data.crop_size),
                           frontend=cfg.frontend)
    return F.frontend_flops(view)


def encoder_flops(cfg, T: int) -> float:
    d, di, k = cfg.dims.d_model, cfg.dims.d_inner, cfg.conformer.cnn_module_kernel
    P = 2 * T - 1
    per_block = (2 * (2.0 * T * d * di * 2)          # two FFNs
                 + 4 * 2.0 * T * d * d                # q, k, v, out
                 + 2.0 * P * d * d                    # linear_pos
                 + 2.0 * T * T * d + 2.0 * T * P * d  # ac, bd
                 + 2.0 * T * T * d                    # context
                 + 2.0 * T * d * 2 * d + 2.0 * T * d * d   # pointwise convs
                 + 2.0 * T * d * k)                   # depthwise conv
    return 2.0 * T * cfg.frontend.feature_dim * d + cfg.dims.n_enc_layers * per_block


def ctc_flops(cfg, T: int) -> float:
    return 2.0 * T * cfg.dims.d_model * cfg.decoder.vocab_size


def decoder_flops(cfg, T: int, beam: int, steps: int) -> float:
    d, di, V = cfg.dims.d_model, cfg.dims.d_inner, cfg.decoder.vocab_size
    n = cfg.dims.n_dec_layers
    total = n * 2 * (2.0 * T * d * d)                  # cross K/V once
    for s in range(steps):
        L = s + 1
        per_layer = (4 * 2.0 * d * d + 2 * (2.0 * L * d)        # self
                     + 2 * 2.0 * d * d + 2 * (2.0 * T * d)      # cross
                     + 2 * (2.0 * d * di))                      # FFN
        total += beam * (n * per_layer + 2.0 * d * V)
    return total


def utterance_flops(cfg, T: int, beam: int, steps: int) -> float:
    return (frontend_flops(cfg, T) + encoder_flops(cfg, T) + ctc_flops(cfg, T)
            + decoder_flops(cfg, T, beam, steps))


def flops_per_utterance(cfg, mix: dict) -> float:
    """The mean over the mix's lengths, each equally likely."""
    lo, hi = mix["min_frames"], mix["max_frames"]
    beam, steps = cfg.conformer.beam_size, cfg.decoder.maxlen
    return sum(utterance_flops(cfg, T, beam, steps) for T in range(lo, hi + 1)) / (hi - lo + 1)
