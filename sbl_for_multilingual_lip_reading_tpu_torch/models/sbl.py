"""Top-level seq2seq models: frontend -> encoder -> decoder (counterpart of
the JAX package's ``models/sbl.py``): ``SBLTransformer`` with the
bidirectional decoder, ``UniTransformer`` with the unidirectional one."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .decoder_sbl import SBLDecoder
from .decoder_uni import UniDecoder
from .encoder import Encoder
from .frontend import VisualFrontend
from .layers import DropoutRNG


class SBLTransformer(nn.Module):
    """Synchronous bidirectional multilingual lip-reading model."""

    def __init__(self, frontend: VisualFrontend, encoder: Encoder,
                 decoder: SBLDecoder):
        super().__init__()
        self.frontend, self.encoder, self.decoder = frontend, encoder, decoder

    def forward(self, video: torch.Tensor, labels_l2r: torch.Tensor,
                labels_r2l: torch.Tensor, rng: Optional[DropoutRNG] = None,
                use_gold: Optional[Sequence[bool]] = None):
        """Training forward (JAX ``SBLTransformer.__call__`` with
        train=True when ``rng`` is given).  video: (B, T, H, W) normalized
        grayscale; labels: (B, P) IGNORE-padded phoneme ids; rng: the
        step's random numbers (dropout, teacher-forcing coins); use_gold:
        injected coins.  BatchNorm follows the module's train/eval mode.
        Returns (pred_l2r, gold_l2r, pred_r2l, gold_r2l)."""
        enc = self.encoder(self.frontend(video, rng), rng=rng)
        return self.decoder(enc, labels_l2r, labels_r2l, rng, use_gold)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """video: (B, T, H, W) normalized grayscale -> encoder output
        (B, T, d_model)."""
        return self.encoder(self.frontend(video))

    def decode(self, video: torch.Tensor):
        """Greedy bidirectional decode with the per-step logits:
        (ys_l2r, ys_r2l, logits_l2r, logits_r2l)."""
        return self.decoder.decode(self.encode(video))

    def recognize(self, video: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy bidirectional decode: (ys_l2r, ys_r2l), (B, maxlen+1) ids
        with the leading sos."""
        return self.decoder.recognize(self.encode(video))


class UniTransformer(nn.Module):
    """Unidirectional seq2seq model (the ``lrw`` / ``lrw1000`` workloads)."""

    def __init__(self, frontend: VisualFrontend, encoder: Encoder,
                 decoder: UniDecoder):
        super().__init__()
        self.frontend, self.encoder, self.decoder = frontend, encoder, decoder

    def forward(self, video: torch.Tensor, labels: torch.Tensor,
                rng: Optional[DropoutRNG] = None):
        """Teacher-forced forward (JAX ``__call__``; train=True when ``rng``
        is given: dropout in frontend, encoder and decoder).  BatchNorm
        follows the module's train/eval mode.  Returns (f32 logits
        (B, maxlen, V), IGNORE-padded gold)."""
        enc = self.encoder(self.frontend(video, rng), rng=rng)
        return self.decoder(labels, enc, rng=rng)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """video: (B, T, H, W) normalized grayscale -> encoder output
        (B, T, d_model)."""
        return self.encoder(self.frontend(video))

    def recognize(self, video: torch.Tensor,
                  maxlen: Optional[int] = None) -> torch.Tensor:
        """KV-cached greedy decode: (B, maxlen+1) ids with the leading sos."""
        return self.decoder.recognize_greedy(self.encode(video), maxlen=maxlen)
