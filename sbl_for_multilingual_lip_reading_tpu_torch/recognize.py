"""The port's entry function: recognize a batch of uint8 clips.

The path the JAX package's ``bench.py`` times (``recognize_batch``) and its
``test.py`` evaluates:

    uint8 clips -> eval ingest (center crop + ColorNormalize)
    -> visual frontend (K2 frame stack, stem conv, ResNet-18)
    -> encoder (K1 attention) -> greedy bidirectional decode (K1)
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from .data.ingest import device_ingest
from .models.layers import cast_dense_weights
from .models.sbl import SBLTransformer


class Recognition(NamedTuple):
    ys_l2r: torch.Tensor       # (B, maxlen+1) ids, leading sos
    ys_r2l: torch.Tensor
    logits_l2r: torch.Tensor   # (B, maxlen, V) f32, one row per decode step
    logits_r2l: torch.Tensor


def recognize_batch(model: SBLTransformer, clips_u8: torch.Tensor,
                    crop: int, n_frames: Optional[torch.Tensor] = None
                    ) -> Recognition:
    """clips_u8: (B, T, H, W) uint8 on the model's device; ``crop`` is the
    config's ``data.crop_size``; n_frames: optional (B,) valid-frame counts,
    whose padding slots are zeroed after normalization (JAX's eval step
    passes them).  Ingests in the model's compute dtype and
    decodes greedily in both directions, with the f32 weights of every
    ``Dense`` cast to the compute dtype once per batch.  Puts the model in
    eval mode (BatchNorm on its running statistics, as JAX's recognize runs
    with train=False), also after a train step left it in train mode."""
    model.eval()
    with torch.inference_mode(), cast_dense_weights(model):
        video = device_ingest(clips_u8, crop, model.frontend.dtype,
                              n_frames=n_frames)
        return Recognition(*model.decode(video))


def expected_launches(cfg) -> Dict[str, int]:
    """Kernel launches one ``recognize_batch`` makes on the kernel path:
    one frame stack, and one attention per encoder layer plus two (self and
    cross, both directions folded into one launch) per decoder layer and
    decode step; none of the training kernels (BatchNorm runs on its
    running statistics)."""
    dims, d = cfg.dims, cfg.decoder
    return {"small_mha_flat": dims.n_enc_layers + 2 * d.maxlen * dims.n_dec_layers,
            "stack_frames": 1, "small_mha_dropout_fwd_flat": 0,
            "small_mha_dropout_bwd_flat": 0, "dropout_keep_mask_flat": 0,
            "ingest_train": 0, "channel_sums": 0, "channel_sums_pair": 0}
