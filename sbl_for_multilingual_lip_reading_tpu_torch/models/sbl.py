"""Top-level seq2seq models: frontend -> encoder -> decoder (counterpart of
the JAX package's ``models/sbl.py``): ``SBLTransformer`` with the
bidirectional decoder, ``UniTransformer`` with the unidirectional one."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.profiler import backward_span, span
from .decoder_sbl import SBLDecoder
from .decoder_uni import UniDecoder
from .encoder import Encoder
from .frontend import VisualFrontend
from .layers import DropoutRNG


def encode(model, video: torch.Tensor, rng: Optional[DropoutRNG] = None
           ) -> torch.Tensor:
    """frontend -> encoder, each in its span (and, in a training forward
    under the recorder, its backward's)."""
    with span("frontend"):
        x = model.frontend(video, rng)
    backward_span(x, "frontend")
    with span("encoder"):
        enc = model.encoder(x, rng=rng)
    backward_span(enc, "encoder")
    return enc


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
        enc = self.encode(video, rng)
        with span("decoder"):
            out = self.decoder(enc, labels_l2r, labels_r2l, rng, use_gold)
        backward_span(out[0], "decoder")
        backward_span(out[2], "decoder")
        return out

    def encode(self, video: torch.Tensor, rng: Optional[DropoutRNG] = None
               ) -> torch.Tensor:
        """video: (B, T, H, W) normalized grayscale -> encoder output
        (B, T, d_model)."""
        return encode(self, video, rng)

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
        enc = self.encode(video, rng)
        with span("decoder"):
            out = self.decoder(labels, enc, rng=rng)
        backward_span(out[0], "decoder")
        return out

    def encode(self, video: torch.Tensor, rng: Optional[DropoutRNG] = None
               ) -> torch.Tensor:
        """video: (B, T, H, W) normalized grayscale -> encoder output
        (B, T, d_model)."""
        return encode(self, video, rng)

    def recognize(self, video: torch.Tensor,
                  maxlen: Optional[int] = None) -> torch.Tensor:
        """KV-cached greedy decode: (B, maxlen+1) ids with the leading sos."""
        return self.decoder.recognize_greedy(self.encode(video), maxlen=maxlen)
