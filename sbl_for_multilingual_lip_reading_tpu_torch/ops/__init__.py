"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, plus the mask helpers.  Kernels build at first use (``_build``)."""
from .attention import (MASK_FILL, BatchRows, dropout_keep_mask, dropout_keep_mask_flat,
                        dropout_keep_mask_flat_plain,
                        fused_mha, fused_mha_plain, fused_small_mha,
                        fused_small_mha_plain, mask_to_bias, small_mha,
                        small_mha_bwd, small_mha_bwd_plain, small_mha_dropout,
                        small_mha_dropout_bwd, small_mha_dropout_bwd_flat,
                        small_mha_dropout_bwd_flat_plain,
                        small_mha_dropout_bwd_plain, small_mha_dropout_flat,
                        small_mha_dropout_flat_plain, small_mha_dropout_fwd,
                        small_mha_dropout_fwd_flat, small_mha_dropout_fwd_plain,
                        small_mha_flat, small_mha_flat_plain,
                        train_kernels_fit)
from .batchnorm import (bn_train, channel_sums, channel_sums_pair,
                        channel_sums_pair_plain, channel_sums_plain)
from .decoder_layer import (decoder_layer_fits, fused_decoder_layer,
                            fused_decoder_layer_plain, layer_params_to_args)
from .ingest import ingest_train, ingest_train_plain
from .resblock import fold_bn, fused_resblock, fused_resblock_plain
from .stem import (stack_frames, stack_frames_plain, stack_frames_u8,
                   stack_frames_u8_plain)

# K1 ... K11, in the order they were ported, then the layout twins of K1 and
# K3-K5 (the flat kernels on views) and K12
KERNELS = (small_mha_flat, stack_frames, small_mha_dropout_fwd_flat,
           small_mha_dropout_bwd_flat, dropout_keep_mask_flat, ingest_train,
           channel_sums, channel_sums_pair, stack_frames_u8, fused_resblock,
           fused_decoder_layer, fused_small_mha, small_mha_bwd,
           small_mha_dropout_fwd, small_mha_dropout_bwd, dropout_keep_mask,
           fused_mha)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in KERNELS}
