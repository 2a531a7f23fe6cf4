"""The port's entry function: recognize a batch of uint8 clips.

The path the JAX package's ``bench.py`` times (``recognize_batch``) and its
``test.py`` evaluates:

    uint8 clips -> eval ingest (center crop + ColorNormalize)
    -> visual frontend (K2 frame stack, stem conv, ResNet-18)
    -> encoder (K1 attention) -> greedy bidirectional decode (K1)

For a ``UniTransformer`` (``lrw`` / ``lrw1000``) the decode is the KV-cached
unidirectional greedy one.  With the two eval-side switches on
(``build_model(..., use_pallas_resblock=True)`` and
``cfg.use_fused_decoder_layer``) the ResNet's eligible blocks run through K10
and every SBL decoder layer through K11.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import torch

from . import ops
from .data.ingest import device_ingest
from .models.layers import cast_dense_weights
from .models.sbl import SBLTransformer, UniTransformer


class Recognition(NamedTuple):
    ys_l2r: torch.Tensor       # (B, maxlen+1) ids, leading sos
    ys_r2l: torch.Tensor
    logits_l2r: torch.Tensor   # (B, maxlen, V) f32, one row per decode step
    logits_r2l: torch.Tensor


def recognize_batch(model: Union[SBLTransformer, UniTransformer],
                    clips_u8: torch.Tensor, crop: int,
                    n_frames: Optional[torch.Tensor] = None
                    ) -> Union[Recognition, torch.Tensor]:
    """clips_u8: (B, T, H, W) uint8 on the model's device; ``crop`` is the
    config's ``data.crop_size``; n_frames: optional (B,) valid-frame counts,
    whose padding slots are zeroed after normalization (JAX's eval step
    passes them).  Ingests in the model's compute dtype and
    decodes greedily -- an ``SBLTransformer`` in both directions, giving a
    ``Recognition``; a ``UniTransformer`` with its K/V cache, giving the
    (B, maxlen+1) ids with the leading sos -- with the f32 weights of every
    ``Dense`` cast to the compute dtype once per batch.  Puts the model in
    eval mode (BatchNorm on its running statistics, as JAX's recognize runs
    with train=False), also after a train step left it in train mode."""
    model.eval()
    with torch.inference_mode(), cast_dense_weights(model):
        video = device_ingest(clips_u8, crop, model.frontend.dtype,
                              n_frames=n_frames)
        if isinstance(model, UniTransformer):
            return model.recognize(video)
        return Recognition(*model.decode(video))


def fused_resblock_count(fcfg) -> int:
    """ResNet blocks K10 takes: stride 1 and equal input and output widths
    (five of ResNet-18's eight)."""
    n, c_in = 0, fcfg.conv3d_channels
    for stage, (ch, blocks) in enumerate(zip(fcfg.resnet_channels,
                                             fcfg.resnet_blocks)):
        for b in range(blocks):
            n += int(not (stage > 0 and b == 0) and c_in == ch)
            c_in = ch
    return n


def expected_launches(cfg, use_pallas_resblock: bool = False) -> Dict[str, int]:
    """Kernel launches one ``recognize_batch`` makes on the kernel path:
    one frame stack, and one attention per encoder layer plus, per decoder
    layer and decode step, two for an SBL model (self and cross, both
    directions folded into one launch) or one for a unidirectional model
    (the cross attention; its cached self attention is plain torch); none of
    the training kernels (BatchNorm runs on its running statistics).  With
    ``cfg.use_fused_decoder_layer`` K11 takes the SBL decoder's layers, one
    launch each, in place of their two attentions; with
    ``use_pallas_resblock`` K10 takes the eligible ResNet blocks."""
    dims, d = cfg.dims, cfg.decoder
    layer_steps = d.maxlen * dims.n_dec_layers
    fused = d.bidirectional and cfg.use_fused_decoder_layer
    per_layer = 0 if fused else (2 if d.bidirectional else 1)
    return dict(dict.fromkeys(ops.launch_counts(), 0),
                small_mha_flat=dims.n_enc_layers + per_layer * layer_steps,
                stack_frames=1,
                fused_resblock=(fused_resblock_count(cfg.frontend)
                                if use_pallas_resblock else 0),
                fused_decoder_layer=layer_steps if fused else 0)
