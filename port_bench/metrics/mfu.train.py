"""The window's training FLOP rate as a share of the H100's published
dense bf16 peak (989 TFLOP/s), in %: clips/s x ``train_flops_per_clip``
(3x the forward; the remat recompute not counted)."""


def read(run):
    w = run.window
    if not w["seconds"]:
        return None
    return 100.0 * run.flops.mfu(w["clips"] / w["seconds"],
                                 run.flops.train_flops_per_clip(run.cfg))
