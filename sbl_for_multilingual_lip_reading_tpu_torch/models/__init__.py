"""Models of the PyTorch port.  Only the SBL workloads (``sbl``,
``sbl_stage2``) are ported so far."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .decoder_sbl import SBLDecoder
from .encoder import encoder_from_config
from .frontend import frontend_from_config
from .sbl import SBLTransformer

_NOT_PORTED = {
    "lrw": "ROADMAP.md queue A item 9 (unidirectional workloads)",
    "lrw1000": "ROADMAP.md queue A item 9 (unidirectional workloads)",
    "classify": "ROADMAP.md queue A item 11 (classify head)",
}


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every parameter, mirroring the JAX initializers (He
    fan-out normal for convs, Xavier / scaled normal for dense layers,
    identity LayerNorm/BatchNorm).  Runs on whatever device the model is
    on; draw on the CPU generator for device-independent weights."""
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)


def build_model(cfg, device=None, seed: Optional[int] = None) -> SBLTransformer:
    """Construct the eval-mode model for a WorkloadConfig (the port's, or the
    JAX package's: the fields read are the same) with f32 weights drawn
    from ``seed`` (default ``cfg.seed``) on the CPU, then moved to
    ``device``: the card when it is None (raising without one), the CPU
    only when asked.  ``.train()`` switches it to training.
    ``cfg.use_pallas_attention`` selects the hand-written kernels (K1-K8) or
    their plain PyTorch versions, as it selects the Pallas kernels in the
    JAX package; ``PALLAS_BN`` in the environment builds the frontend with
    ``FastBatchNorm`` (K7, K8), as it does in JAX."""
    if cfg.name != "sbl":
        raise NotImplementedError(
            f"workload {cfg.name!r} is not ported yet: "
            f"{_NOT_PORTED.get(cfg.name, 'ROADMAP.md queue A')}")
    device = resolve_device(device)
    dtype = getattr(torch, cfg.compute_dtype)
    kernels = cfg.use_pallas_attention
    dims, d = cfg.dims, cfg.decoder
    frontend = frontend_from_config(cfg.frontend, dtype=dtype,
                                    use_kernels=kernels)
    encoder = encoder_from_config(dims, d_input=cfg.frontend.feature_dim,
                                  dtype=dtype, use_kernels=kernels)
    decoder = SBLDecoder(
        vocab_size=d.vocab_size, d_model=dims.d_model,
        n_layers=dims.n_dec_layers, n_head=dims.n_head, d_k=dims.d_k,
        d_v=dims.d_v, d_inner=dims.d_inner, pe_maxlen=dims.pe_maxlen,
        maxlen=d.maxlen, fusion_mode=d.fusion_mode,
        decode_segments=d.decode_segments, dtype=dtype, use_kernels=kernels,
        dropout=dims.dropout, teacher_forcing_rate=d.teacher_forcing_rate,
        remat=cfg.remat_decoder)
    model = SBLTransformer(frontend, encoder, decoder)
    init_weights(model, torch.Generator().manual_seed(
        cfg.seed if seed is None else seed))
    return model.to(device).eval()
