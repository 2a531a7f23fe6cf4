"""Transformer encoder (counterpart of the JAX package's
``models/encoder.py``): Linear(feature_dim -> d_model) + LayerNorm + sinusoid
PE (added in f32) + dropout, then N self-attention/FFN layers.  All-valid
sequences pass ``lengths=None`` and build no mask."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import masks as M
from ..ops.attention import mask_to_bias
from .layers import (Dense, DropoutRNG, EncoderLayer, LayerNorm, dropout,
                     sinusoid_position_encoding)


class Encoder(nn.Module):
    def __init__(self, d_input: int = 512, n_layers: int = 6, n_head: int = 8,
                 d_k: int = 64, d_v: int = 64, d_model: int = 512,
                 d_inner: int = 2048, pe_maxlen: int = 5000,
                 dtype=torch.float32, use_kernels: bool = True,
                 dropout: float = 0.1):
        super().__init__()
        self.dtype, self.n_layers, self.dropout = dtype, n_layers, dropout
        self.linear_in = Dense(d_input, d_model, dtype=dtype)
        self.layer_norm_in = LayerNorm(d_model)
        self.register_buffer("pe", sinusoid_position_encoding(pe_maxlen, d_model),
                             persistent=False)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                d_model, d_inner, n_head, d_k, d_v, dtype, use_kernels, dropout))

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """x: (B, T, d_input); lengths: optional (B,) valid lengths; rng:
        the training forward's random numbers (None: deterministic)."""
        B, T, _ = x.shape
        non_pad = bias = None
        if lengths is not None:
            non_pad = M.non_pad_mask_from_lengths(lengths, T)
            bias = mask_to_bias(M.key_pad_mask_from_lengths(lengths, T), T, T)
        h = self.linear_in(x.to(self.dtype))
        h = self.layer_norm_in(h.to(torch.float32)) + self.pe[:T]
        h = dropout(h, self.dropout, rng).to(self.dtype)
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(h, non_pad_mask=non_pad, bias=bias,
                                            rng=rng)
        return h


def encoder_from_config(dims, d_input: int = 512, dtype=torch.float32,
                        use_kernels: bool = True) -> Encoder:
    return Encoder(d_input=d_input, n_layers=dims.n_enc_layers,
                   n_head=dims.n_head, d_k=dims.d_k, d_v=dims.d_v,
                   d_model=dims.d_model, d_inner=dims.d_inner,
                   pe_maxlen=dims.pe_maxlen, dtype=dtype,
                   use_kernels=use_kernels, dropout=dims.dropout)
