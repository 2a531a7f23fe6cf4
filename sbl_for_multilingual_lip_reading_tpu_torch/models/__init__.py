"""Models of the PyTorch port: the bidirectional ``sbl`` / ``sbl_stage2``
workloads, the unidirectional ``lrw`` / ``lrw1000`` ones, and ``classify``."""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..config import model_kind
from ..ops.attention import HEAD_DIMS, train_kernels_fit
from ..ops.decoder_layer import MAX_ROWS, decoder_layer_fits
from ..utils.device import resolve_device
from .classify import ClassifyTransformer
from .decoder_sbl import SBLDecoder
from .decoder_uni import UniDecoder
from .encoder import encoder_from_config
from .frontend import frontend_from_config
from .sbl import SBLTransformer, UniTransformer


def check_kernel_shapes(cfg) -> None:
    """Raise ValueError where a kernel that ``cfg`` selects does not take the
    shapes its model gives it, before anything runs on the card.  The
    attention kernels (``use_pallas_attention``) are built for head widths
    in HEAD_DIMS, and the training ones (K3/K4) take the longest sequence
    of the workload (its frames, or the decoder's maxlen + 1 positions)
    within their shared memory; K11 (``use_fused_decoder_layer``) takes a
    decode segment of at most MAX_ROWS positions and d_inner a multiple of
    d_model.  Tensor parallelism changes none of this: a process launches
    the attention kernels on its heads, of the same width, and K11 on the
    whole layer."""
    dims, dec = cfg.dims, cfg.decoder
    if cfg.use_pallas_attention:
        if dims.d_k not in HEAD_DIMS:
            raise ValueError(
                f"d_k={dims.d_k} (d_model {dims.d_model} / n_head "
                f"{dims.n_head}): the attention kernels are built for head "
                f"widths {HEAD_DIMS}; choose one of them, or run with "
                f"use_pallas_attention=False")
        longest = max([cfg.data.frames] + (
            [] if dec is None else [dec.maxlen + 1, dec.target_pad_len + 2]))
        if not train_kernels_fit(dims.d_k, longest, longest):
            raise ValueError(
                f"{longest} positions at d_k={dims.d_k}: the training "
                f"attention kernels stage a head's sequence in shared "
                f"memory, which does not hold it")
    if (dec is not None and getattr(cfg, "use_fused_decoder_layer", False)
            and not decoder_layer_fits(dec.maxlen + 1, dims.d_model,
                                       dims.d_inner)):
        raise ValueError(
            f"use_fused_decoder_layer: {dec.maxlen + 1} positions, d_inner "
            f"{dims.d_inner}, d_model {dims.d_model}: the fused decoder "
            f"layer takes at most {MAX_ROWS} positions and d_inner a "
            f"multiple of d_model")


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every parameter, mirroring the JAX initializers (He
    fan-out normal for convs, Xavier / scaled normal for dense layers,
    identity LayerNorm/BatchNorm).  Runs on whatever device the model is
    on; draw on the CPU generator for device-independent weights."""
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)


def build_model(cfg, device=None, seed: Optional[int] = None,
                use_pallas_resblock: bool = False
                ) -> Union[SBLTransformer, UniTransformer, ClassifyTransformer]:
    """Construct the eval-mode model for a WorkloadConfig (the port's, or the
    JAX package's: the fields read are the same) with f32 weights drawn
    from ``seed`` (default ``cfg.seed``) on the CPU, then moved to
    ``device``: the card when it is None (raising without one), the CPU
    only when asked.  ``.train()`` switches it to training.
    ``cfg.use_pallas_attention`` selects the hand-written kernels or their
    plain PyTorch versions, as it selects the Pallas kernels in the JAX
    package; ``PALLAS_BN`` in the environment builds the frontend with
    ``FastBatchNorm`` (K7, K8), as it does in JAX.  Two eval-side switches,
    both off by default as in JAX: ``cfg.use_fused_decoder_layer`` (K11 on
    the deterministic SBL decode) and ``use_pallas_resblock`` (K10 on the
    eligible ResNet blocks in eval mode; a field of the frontend modules in
    JAX, which no config carries).  ``cfg.remat_frontend`` checkpoints the
    frontend's ResNet blocks in training.  A bidirectional decoder config gives an
    ``SBLTransformer``, a unidirectional one a ``UniTransformer``, and the
    ``classify`` workload (no decoder) a ``ClassifyTransformer`` whose
    language slot is the last frame.  On the card, a config whose shapes a
    selected kernel does not take raises (``check_kernel_shapes``)."""
    kind = model_kind(cfg)
    device = resolve_device(device)
    if device.type == "cuda":
        check_kernel_shapes(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    kernels = cfg.use_pallas_attention
    dims, d = cfg.dims, cfg.decoder
    frontend = frontend_from_config(cfg.frontend, dtype=dtype,
                                    use_kernels=kernels,
                                    use_pallas_resblock=use_pallas_resblock,
                                    remat=getattr(cfg, "remat_frontend", False))
    encoder = encoder_from_config(dims, d_input=cfg.frontend.feature_dim,
                                  dtype=dtype, use_kernels=kernels)
    if kind == "classify":
        model = ClassifyTransformer(frontend, encoder, dims.d_model,
                                    num_word_classes=cfg.num_word_classes,
                                    num_languages=cfg.num_languages,
                                    language_slot=cfg.data.frames - 1)
    else:
        common = dict(vocab_size=d.vocab_size, d_model=dims.d_model,
                      n_layers=dims.n_dec_layers, n_head=dims.n_head,
                      d_k=dims.d_k, d_v=dims.d_v, d_inner=dims.d_inner,
                      pe_maxlen=dims.pe_maxlen, maxlen=d.maxlen, dtype=dtype,
                      use_kernels=kernels, dropout=dims.dropout)
        if kind == "sbl":
            decoder = SBLDecoder(
                fusion_mode=d.fusion_mode, decode_segments=d.decode_segments,
                teacher_forcing_rate=d.teacher_forcing_rate,
                remat=cfg.remat_decoder,
                use_fused_layer=getattr(cfg, "use_fused_decoder_layer", False),
                **common)
            model = SBLTransformer(frontend, encoder, decoder)
        else:
            decoder = UniDecoder(tie_embedding=d.tie_embedding, **common)
            model = UniTransformer(frontend, encoder, decoder)
    init_weights(model, torch.Generator().manual_seed(
        cfg.seed if seed is None else seed))
    return model.to(device).eval()
