"""Workload configuration of the port: the fields its ported paths read.

A subset of the JAX package's ``config.py``, with the same dataclass,
field and preset names and the same defaults, so that a config of either
package can be handed to ``models.build_model``.  The port keeps its own
copy because the machine it runs on has no JAX; the JAX package remains
the source of truth, and ``tests/test_torch_port_package.py`` checks that
every field here equals its JAX counterpart in every preset.

Only the ``sbl`` workload's recognize path is ported so far.  Its training
stages (``sbl_stage2`` in JAX) differ only in training fields.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .vocab import TOTAL_PHONEMES


@dataclasses.dataclass(frozen=True)
class TransformerDims:
    d_model: int = 512
    n_head: int = 8
    d_k: int = 64
    d_v: int = 64
    d_inner: int = 2048
    n_enc_layers: int = 6
    n_dec_layers: int = 6
    pe_maxlen: int = 5000


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    conv3d_channels: int = 64
    resnet_channels: Tuple[int, int, int, int] = (64, 128, 256, 512)
    resnet_blocks: Tuple[int, int, int, int] = (2, 2, 2, 2)
    feature_dim: int = 512
    bn_epsilon: float = 1e-5


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 58
    maxlen: int = 16
    fusion_mode: str = "symmetric"      # or "reference_aliased"
    decode_segments: int = 8


@dataclasses.dataclass(frozen=True)
class DataConfig:
    frames: int = 30
    raw_size: int = 96
    crop_size: int = 88
    mean: float = 0.413621      # ColorNormalize
    std: float = 0.1700239


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    name: str = "sbl"
    dims: TransformerDims = TransformerDims()
    frontend: FrontendConfig = FrontendConfig()
    decoder: DecoderConfig = DecoderConfig()
    data: DataConfig = DataConfig()
    seed: int = 7
    compute_dtype: str = "bfloat16"
    # the hand-written kernels (K1 attention, K2 frame stack) instead of
    # their plain versions, as the field selects the Pallas kernels in JAX
    use_pallas_attention: bool = True


def sbl() -> WorkloadConfig:
    """Headline SBL multilingual config: 58-token vocab, bidirectional decoder."""
    return WorkloadConfig(name="sbl",
                          decoder=DecoderConfig(vocab_size=len(TOTAL_PHONEMES)))


def tiny_test() -> WorkloadConfig:
    """CPU-runnable miniature of ``sbl`` for tests: 2 layers, d_model 64."""
    base = sbl()
    return dataclasses.replace(
        base,
        dims=TransformerDims(d_model=64, n_head=4, d_k=16, d_v=16, d_inner=128,
                             n_enc_layers=2, n_dec_layers=2),
        frontend=FrontendConfig(conv3d_channels=8, resnet_channels=(8, 16, 32, 64),
                                resnet_blocks=(1, 1, 1, 1), feature_dim=64),
        decoder=dataclasses.replace(base.decoder, maxlen=8, decode_segments=1),
        data=dataclasses.replace(base.data, raw_size=40, crop_size=32),
        compute_dtype="float32",
    )
