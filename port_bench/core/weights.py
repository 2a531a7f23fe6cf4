"""Weights made from the seed, on the device, for every entry of a model's
``state_dict``: one normal draw for all of them from a generator on the
model's device, cut and scaled per tensor by the kind its name gives.

    convolutions        He normal, fan out (out x kernel area)
    dense, embeddings   Xavier normal over the last two axes
    dense biases        N(0, 0.02)
    LayerNorm, BatchNorm scale 1 + N(0, 0.1), shift N(0, 0.1)
    BatchNorm running   mean N(0, 0.1), variance exp(N(0, 0.2))

The same dict goes into the program (``load_state_dict``) and, as it is,
to the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    module = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if leaf in ("running_mean", "running_var"):
        return leaf
    norm = "layer_norm" in module or module.startswith("bn") or module.endswith("_bn")
    if norm:
        return "norm_" + leaf
    if leaf == "bias":
        return "bias"
    if len(shape) == 4 and ("conv" in name):
        return "conv"
    return "dense"


def seeded_state(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every entry of
    ``model.state_dict()``, a function of ``seed`` alone."""
    ref = model.state_dict()
    total = sum(t.numel() for t in ref.values())
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, t in ref.items():
        n = t.numel()
        x = flat[at:at + n].view(t.shape)
        at += n
        kind = _kind(name, t.shape)
        if kind == "conv":
            x = x * math.sqrt(2.0 / (t.shape[0] * t.shape[2] * t.shape[3]))
        elif kind == "dense":
            x = x * math.sqrt(2.0 / (t.shape[-1] + t.shape[-2]))
        elif kind == "bias":
            x = x * 0.02
        elif kind == "norm_weight":
            x = 1.0 + 0.1 * x
        elif kind in ("norm_bias", "running_mean"):
            x = 0.1 * x
        elif kind == "running_var":
            x = torch.exp(0.2 * x)
        out[name] = x.to(t.dtype)
    return out
