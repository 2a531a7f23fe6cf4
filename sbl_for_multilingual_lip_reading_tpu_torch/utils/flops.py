"""Analytic model-FLOPs for MFU accounting (counterpart of the JAX
package's ``utils/flops.py``, with the same counts).

Counts the MAC-dominated work (convs + matmuls, 2 FLOPs per MAC) of each
workload's forward pass per clip, from the config alone.  Elementwise ops
(BN, ReLU, softmax, residuals, pooling) are omitted -- the standard
model-FLOPs-utilization convention -- so MFU = achieved model FLOPs/s over
the chip's peak matmul FLOPs/s.

Semantics counted are the *algorithm's* useful work, not the executed
graph: the greedy bidirectional decode re-attends a growing prefix L=1..16
(reference SBL decoder.py:301-385 recomputes the full prefix each step;
the segmented growing-buffer loop pads L up to segment widths -- that
padding is implementation waste and deliberately NOT counted, so it shows
up as lost MFU).  Cross-attention K/V projections are counted once per
layer per sequence (they are hoisted in both the reference semantics and
the implementation).

Training model FLOPs use the standard 3x-forward rule (backward ~= 2x
forward for MAC-dominated graphs); rematerialization recompute is
execution overhead, not model work, and is not counted.

Peak FLOP/s reference: NVIDIA H100 SXM = 989 TFLOP/s dense bf16 tensor-core
rate (public spec; the rate the port's bf16 GEMMs and attention kernels run
at).  Override with SBL_PEAK_TFLOPS for other cards or power limits.
"""
from __future__ import annotations

import os

H100_PEAK_TFLOPS = 989.0


def peak_flops_per_sec() -> float:
    return float(os.environ.get("SBL_PEAK_TFLOPS", H100_PEAK_TFLOPS)) * 1e12


def _conv2d(h_out: int, w_out: int, k: int, c_in: int, c_out: int) -> float:
    return 2.0 * h_out * w_out * k * k * c_in * c_out


def frontend_flops(cfg) -> float:
    """Per-clip forward FLOPs of the Conv3D-stem + ResNet-18 frontend
    (reference video_frontend.py:91-135): stem (5,7,7)/(1,2,2) conv,
    (1,3,3)/(1,2,2) maxpool, then per-frame ResNet-18 over cfg-sized
    crops, ending in the 512-wide global average pool."""
    T = cfg.data.frames
    S = cfg.data.crop_size
    c0 = cfg.frontend.conv3d_channels
    # stem conv3d: k=(5,7,7), stride (1,2,2), pad (2,3,3)
    s1 = (S + 1) // 2
    total = T * 2.0 * s1 * s1 * (5 * 7 * 7) * 1 * c0
    # maxpool (1,3,3)/(1,2,2), pad (0,1,1): spatial halves again
    side = (s1 + 1) // 2
    c_in = c0
    for stage, (c, blocks) in enumerate(zip(cfg.frontend.resnet_channels,
                                            cfg.frontend.resnet_blocks)):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            out_side = (side + 2 - 3) // stride + 1 if stride > 1 else side
            total += T * _conv2d(out_side, out_side, 3, c_in, c)
            total += T * _conv2d(out_side, out_side, 3, c, c)
            if stride != 1 or c_in != c:
                total += T * _conv2d(out_side, out_side, 1, c_in, c)
            side, c_in = out_side, c
    return total


def _mha_flops(L_q: float, L_kv: float, d: int, qkv_new: float = None
               ) -> float:
    """One multi-head attention: projections + scores + AV + out-proj.
    ``qkv_new`` overrides the K/V projection length (0 when hoisted)."""
    kv_len = L_kv if qkv_new is None else qkv_new
    proj = 2.0 * L_q * d * d + 2 * (2.0 * kv_len * d * d) + 2.0 * L_q * d * d
    attn = 2 * (2.0 * L_q * L_kv * d)
    return proj + attn


def encoder_flops(cfg) -> float:
    """Per-clip forward FLOPs of the input proj + n_enc_layers encoder
    (reference encoder.py:8-91)."""
    T = cfg.data.frames
    d, di = cfg.dims.d_model, cfg.dims.d_inner
    total = 2.0 * T * d * d                      # Linear(512->512)
    per_layer = _mha_flops(T, T, d) + 2 * (2.0 * T * d * di)
    return total + cfg.dims.n_enc_layers * per_layer


def sbl_decoder_fwd_flops(cfg) -> float:
    """Per-clip forward FLOPs of one full 16-step synchronous bidirectional
    decode (training scan and greedy recognize have the same shape: both
    re-attend the full prefix each step, reference decoder.py:95-189 /
    301-385).  Two directions x n_dec_layers; cross K/V hoisted once."""
    T_enc = cfg.data.frames
    d, di = cfg.dims.d_model, cfg.dims.d_inner
    V = cfg.decoder.vocab_size
    n_layers = cfg.dims.n_dec_layers
    steps = cfg.decoder.maxlen
    total = 0.0
    for i in range(steps):
        L = i + 1
        per_layer = (_mha_flops(L, L, d)                      # self-attn
                     + _mha_flops(L, T_enc, d, qkv_new=0)     # cross (KV hoisted)
                     + 2 * (2.0 * L * d * di))                # FFN
        total += n_layers * per_layer
        total += 2.0 * d * V                                  # head, last pos
    # cross K/V projections once per layer per sequence
    total += n_layers * 2 * (2.0 * T_enc * d * d)
    return 2 * total                                          # two directions


def uni_decoder_fwd_flops(cfg, teacher_forced: bool) -> float:
    """Unidirectional decoder (reference VSR_seq2seq decoder.py): training
    runs ONE parallel teacher-forced pass over the padded target; greedy
    recognize uses the KV-cached loop (one new position per step)."""
    T_enc = cfg.data.frames
    d, di = cfg.dims.d_model, cfg.dims.d_inner
    V = cfg.decoder.vocab_size
    n_layers = cfg.dims.n_dec_layers
    if teacher_forced:
        L = cfg.decoder.target_pad_len + 1
        per_layer = (_mha_flops(L, L, d) + _mha_flops(L, T_enc, d, qkv_new=0)
                     + 2 * (2.0 * L * d * di))
        return (n_layers * per_layer + n_layers * 2 * (2.0 * T_enc * d * d)
                + 2.0 * L * d * V)
    steps = cfg.decoder.maxlen
    total = n_layers * 2 * (2.0 * T_enc * d * d)              # cross KV once
    for i in range(steps):
        L = i + 1
        # KV-cached: project only the new position, attend to L cached
        per_layer = (2.0 * 4 * d * d + 2 * (2.0 * L * d)
                     + 2.0 * 2 * d * d + 2 * (2.0 * T_enc * d))
        total += n_layers * per_layer + 2.0 * d * V
    return total


def classify_head_flops(cfg) -> float:
    d = cfg.dims.d_model
    return 2.0 * d * 1500 + 2.0 * d * 2


def inference_flops_per_clip(cfg) -> float:
    """Forward FLOPs of the eval/recognize path for cfg's workload."""
    base = frontend_flops(cfg) + encoder_flops(cfg)
    if cfg.name == "classify":
        return base + classify_head_flops(cfg)
    if cfg.decoder.bidirectional:
        return base + sbl_decoder_fwd_flops(cfg)
    return base + uni_decoder_fwd_flops(cfg, teacher_forced=False)


def train_flops_per_clip(cfg) -> float:
    """Model FLOPs of one training step per clip: 3x forward (the
    standard fwd + 2x-bwd MFU convention; remat recompute not counted)."""
    base = frontend_flops(cfg) + encoder_flops(cfg)
    if cfg.name == "classify":
        fwd = base + classify_head_flops(cfg)
    elif cfg.decoder.bidirectional:
        fwd = base + sbl_decoder_fwd_flops(cfg)
    else:
        fwd = base + uni_decoder_fwd_flops(cfg, teacher_forced=True)
    return 3.0 * fwd


def mfu(clips_per_sec: float, flops_per_clip: float) -> float:
    return clips_per_sec * flops_per_clip / peak_flops_per_sec()
