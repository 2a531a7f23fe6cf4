"""Attention / padding masks (counterpart of the JAX package's
``ops/masks.py``).  Boolean convention: True == masked out (disallowed)."""
from __future__ import annotations

import torch


def causal_mask(length: int, device=None) -> torch.Tensor:
    """(T, T) upper-triangular mask: True above the diagonal."""
    return torch.ones((length, length), dtype=torch.bool,
                      device=device).triu(diagonal=1)


def key_pad_mask_from_lengths(lengths: torch.Tensor,
                              max_len: int) -> torch.Tensor:
    """(B,) -> (B, 1, Tk) True at key positions >= length."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos >= lengths[:, None])[:, None, :]


def non_pad_mask_from_lengths(lengths: torch.Tensor,
                              max_len: int) -> torch.Tensor:
    """(B,) -> (B, T, 1) float mask, 1.0 at valid positions."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None])[..., None].to(torch.float32)


def key_pad_mask_from_ids(seq_k: torch.Tensor, pad_id: int) -> torch.Tensor:
    """(B, Tk) -> (B, 1, Tk) True where the key token == pad_id."""
    return (seq_k == pad_id)[:, None, :]


def non_pad_mask_from_ids(seq: torch.Tensor, pad_id: int) -> torch.Tensor:
    """(B, T) -> (B, T, 1) float mask, 1.0 where token != pad_id."""
    return (seq != pad_id)[..., None].to(torch.float32)
