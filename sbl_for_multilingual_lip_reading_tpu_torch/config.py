"""Workload configuration of the port: the fields its ported paths read.

A subset of the JAX package's ``config.py``, with the same dataclass,
field and preset names and the same defaults, so that a config of either
package can be handed to ``models.build_model`` and the training step.  The
port keeps its own copy because the machine it runs on has no JAX; the JAX
package remains the source of truth, and ``tests/test_torch_port_package.py``
checks that every field here equals its JAX counterpart in every preset.

Every workload is ported, for training and evaluation: ``sbl`` (and
``sbl_stage2``, the same model with teacher forcing annealed to 0.1), the
unidirectional ``lrw`` and ``lrw1000``, and ``classify``, the stage-1
pretraining of frontend and encoder (no decoder: ``decoder`` is None).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .vocab import LRW1000_PHONEMES, LRW_PHONEMES, TOTAL_PHONEMES


@dataclasses.dataclass(frozen=True)
class TransformerDims:
    d_model: int = 512
    n_head: int = 8
    d_k: int = 64
    d_v: int = 64
    d_inner: int = 2048
    n_enc_layers: int = 6
    n_dec_layers: int = 6
    dropout: float = 0.1
    pe_maxlen: int = 5000


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    conv3d_channels: int = 64
    resnet_channels: Tuple[int, int, int, int] = (64, 128, 256, 512)
    resnet_blocks: Tuple[int, int, int, int] = (2, 2, 2, 2)
    feature_dim: int = 512
    dropout: float = 0.5
    bn_momentum: float = 0.9   # share of the running statistic kept
    bn_epsilon: float = 1e-5


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 58
    maxlen: int = 16                    # decode steps
    target_pad_len: int = 14            # label buffer length
    tie_embedding: bool = False         # SBL uses untied heads
    bidirectional: bool = True          # SBL synchronous L2R + R2L
    fusion_mode: str = "symmetric"      # or "reference_aliased"
    teacher_forcing_rate: float = 0.5   # P(gold token) per decode step
    decode_segments: int = 8


@dataclasses.dataclass(frozen=True)
class DataConfig:
    frames: int = 30
    raw_size: int = 96
    crop_size: int = 88
    mean: float = 0.413621      # ColorNormalize
    std: float = 0.1700239
    frame_removal_p: float = 0.05   # FrameRemoval
    max_crop_offset: int = 8        # RandomCrop offset range
    random_drop_p: float = 0.0      # the LRW project's RandomDrop
    per_clip_crop: bool = False     # one crop offset per clip (LRW protocol)
    # dataset roots of the real-data CLI (the reference's relative layout)
    lrw_path: str = "../roi_80_116_175_211_npy_gray"
    lrw1000_path: str = "../LRW1000_npy_rsz122_gray"
    lrw1000_info: str = "../LRW1000_info"
    lrw1000_images: str = "../LRW1000/images"
    lrw1000_wav: str = "../LRW1000_audio"
    data_fraction: float = 1.0      # share of each LRW word's clips used


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Noam schedule + Adam."""
    k: float = 0.2
    warmup_steps: int = 4000
    lr_base_dim: int = 512
    adam_b1: float = 0.9
    adam_b2: float = 0.98
    adam_eps: float = 1e-9
    label_smoothing: float = 0.1
    grad_clip: Optional[float] = None   # max global gradient norm; None = off


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The process layout of a training run (``parallel/mesh.py``): a
    ``data`` x ``model`` grid of processes, one card each.  Each of the
    ``data`` replicas takes its stripe of every global batch; each of its
    ``model`` processes holds its slice of the attention heads and FFN
    columns (tensor parallelism, Megatron's layout of JAX's
    ``PARAM_RULES``).  ``sync_batchnorm`` takes the frontend's BatchNorm
    statistics over the global batch; False keeps them per replica, with
    replica 0's running statistics kept (the reference's
    ``nn.DataParallel``)."""
    data: int = 1
    model: int = 1
    sync_batchnorm: bool = True


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    name: str = "sbl"   # sbl | lrw | lrw1000 | classify
    dims: TransformerDims = TransformerDims()
    frontend: FrontendConfig = FrontendConfig()
    decoder: Optional[DecoderConfig] = DecoderConfig()
    data: DataConfig = DataConfig()
    optim: OptimConfig = OptimConfig()
    mesh: MeshConfig = MeshConfig()
    batch_size: int = 240
    seed: int = 7
    # the classify workload's heads and loss (reference classify
    # train.py:127-130)
    num_word_classes: int = 1500
    num_languages: int = 2
    language_loss_weight: float = 0.1
    # fixed LRW-1000 samples per batch (TwoStreamBatchSampler); 0 = plain
    # shuffling
    secondary_batch_size: int = 0
    compute_dtype: str = "bfloat16"
    # the hand-written kernels (K1-K5) instead of their plain versions, as
    # the field selects the Pallas kernels in JAX
    use_pallas_attention: bool = True
    # the whole-decoder-layer kernel (K11, ops/decoder_layer.py) on
    # deterministic decode steps; training steps keep the module composition
    use_fused_decoder_layer: bool = False
    # recompute each ResNet block of the frontend in the backward instead
    # of keeping its activations (less memory, one more frontend forward)
    remat_frontend: bool = False
    # checkpoint each decode step for the backward
    remat_decoder: bool = True
    # top-level parameter subtrees ("frontend", "encoder", "decoder") whose
    # gradients are zeroed
    freeze_prefixes: Tuple[str, ...] = ()


def sbl() -> WorkloadConfig:
    """Headline SBL multilingual config: 58-token vocab, bidirectional decoder."""
    return WorkloadConfig(
        name="sbl",
        decoder=DecoderConfig(vocab_size=len(TOTAL_PHONEMES), bidirectional=True))


def sbl_stage2() -> WorkloadConfig:
    """SBL fine-tuning stage: teacher forcing annealed 0.5 -> 0.1."""
    return WorkloadConfig(name="sbl", decoder=DecoderConfig(
        vocab_size=len(TOTAL_PHONEMES), bidirectional=True,
        teacher_forcing_rate=0.1))


def lrw_seq2seq() -> WorkloadConfig:
    """LRW English seq2seq: 42-token vocab, unidirectional tied decoder."""
    return WorkloadConfig(
        name="lrw",
        decoder=DecoderConfig(vocab_size=len(LRW_PHONEMES), bidirectional=False,
                              tie_embedding=True, maxlen=14, target_pad_len=12),
        # the LRW project's augmentation: per-clip RandomCrop + RandomDrop,
        # no FrameRemoval
        data=dataclasses.replace(DataConfig(), frame_removal_p=0.0,
                                 random_drop_p=0.01, per_clip_crop=True),
    )


def lrw1000_seq2seq() -> WorkloadConfig:
    """LRW-1000 Mandarin seq2seq: 48-token vocab, unidirectional tied decoder,
    bigram-LM-biased beam search at eval."""
    return WorkloadConfig(
        name="lrw1000",
        decoder=DecoderConfig(vocab_size=len(LRW1000_PHONEMES),
                              bidirectional=False, tie_embedding=True,
                              maxlen=16, target_pad_len=14),
    )


def classify() -> WorkloadConfig:
    """Stage-1 frontend pretraining: 1500-way word + 2-way language heads;
    clips padded to 31 frames (reference classify/data_gen.py:237)."""
    return WorkloadConfig(name="classify", decoder=None,
                          data=dataclasses.replace(DataConfig(), frames=31),
                          batch_size=120)


def tiny_test(name: str = "sbl") -> WorkloadConfig:
    """CPU-runnable miniature for tests: 2 layers, d_model 64."""
    base = {"sbl": sbl, "lrw": lrw_seq2seq, "lrw1000": lrw1000_seq2seq,
            "classify": classify}[name]()
    dims = TransformerDims(d_model=64, n_head=4, d_k=16, d_v=16, d_inner=128,
                           n_enc_layers=2, n_dec_layers=2)
    decoder = base.decoder
    if decoder is not None:
        decoder = dataclasses.replace(decoder, maxlen=8, decode_segments=1)
    return dataclasses.replace(
        base,
        dims=dims,
        frontend=FrontendConfig(conv3d_channels=8, resnet_channels=(8, 16, 32, 64),
                                resnet_blocks=(1, 1, 1, 1), feature_dim=64),
        decoder=decoder,
        data=dataclasses.replace(base.data, raw_size=40, crop_size=32),
        batch_size=2,
        compute_dtype="float32",
        # short warmup so a handful of test steps sees a usable lr
        optim=dataclasses.replace(base.optim, k=0.1, warmup_steps=20,
                                  lr_base_dim=dims.d_model),
    )


PRESETS = {"sbl": sbl, "sbl_stage2": sbl_stage2, "lrw": lrw_seq2seq,
           "lrw1000": lrw1000_seq2seq, "classify": classify}


def model_kind(cfg: WorkloadConfig) -> str:
    """The model, steps, validation and best-model metric ``cfg`` takes:
    ``"classify"`` (no decoder), ``"sbl"`` (a bidirectional decoder) or
    ``"uni"`` (``lrw`` / ``lrw1000``).  The one place the port decides it;
    a decoder-less config of another workload is refused."""
    if cfg.decoder is None:
        if cfg.name != "classify":
            raise ValueError(f"workload {cfg.name!r} has no decoder; only "
                             f"'classify' builds without one")
        return "classify"
    return "sbl" if cfg.decoder.bidirectional else "uni"
