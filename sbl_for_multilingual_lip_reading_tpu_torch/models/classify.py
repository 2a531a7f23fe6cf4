"""Stage-1 pretraining model of the ``classify`` workload: frontend +
encoder + two classification heads (counterpart of the JAX package's
``models/classify.py``, after the reference's classify Transformer,
VSR_visual_frontend_pretraining_on_LRW_LRW1000_classify/transformer/
transformer.py:6-37): a 1500-way word head over the time-pooled encoder
output and a 2-way language head over the appended frame slot
``language_slot`` (clips are padded to 31 frames, reference
data_gen.py:237, so the slot is frame 30).

Parity note, kept from JAX: the reference pools with ``torch.mean(x, dim=2,
keepdim=True)`` (transformer.py:31), which reduces the FEATURE axis to width
1 and feeds a (N, 31, 1) tensor into a 512-in Linear, a latent crash /
broadcasting bug.  The documented intent (and what the shipped ``.pt``
checkpoints imply) is time pooling, which is what both packages implement:
the mean over dim 1.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .encoder import Encoder
from .frontend import VisualFrontend
from .layers import Dense, DropoutRNG


class ClassifyTransformer(nn.Module):
    """Submodules are named as in JAX: ``frontend``, ``encoder``, and the
    heads ``fc_word`` / ``fc_lang`` (flax ``nn.Dense`` with Xavier-uniform
    kernels, computing in f32: flax promotes the compute-dtype features to
    the f32 parameters)."""

    def __init__(self, frontend: VisualFrontend, encoder: Encoder, d_model: int,
                 num_word_classes: int = 1500, num_languages: int = 2,
                 language_slot: int = 30):
        super().__init__()
        self.frontend, self.encoder = frontend, encoder
        self.language_slot = language_slot
        self.fc_word = Dense(d_model, num_word_classes, dtype=torch.float32)
        self.fc_lang = Dense(d_model, num_languages, dtype=torch.float32)

    def forward(self, video: torch.Tensor, rng: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """video: (B, frames, H, W) normalized grayscale; rng: the step's
        random numbers (JAX train=True: dropout in frontend and encoder),
        None for the deterministic forward.  BatchNorm follows the module's
        train/eval mode.  Returns f32 (word_logits (B, num_word_classes),
        language_logits (B, num_languages))."""
        enc = self.encoder(self.frontend(video, rng), rng=rng)
        pooled = enc.mean(dim=1)                  # time pooling (intended)
        lang_feat = enc[:, self.language_slot]
        return (self.fc_word(pooled.to(torch.float32)),
                self.fc_lang(lang_feat.to(torch.float32)))
