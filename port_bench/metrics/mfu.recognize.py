"""The window's model FLOP rate as a share of the H100's published dense
bf16 peak (989 TFLOP/s), in %: clips/s x the model FLOPs of a clip, as
the entry's ``flops_per_clip(flops)`` counts them with
``reference/flops.py`` (the forward of the recognize path, or of the beam
search with its width).  Read from the window, not the traced slice."""


def read(run):
    w = run.window
    per_clip = getattr(run.part, "flops_per_clip", None)
    if not w["seconds"] or per_clip is None:
        return None
    return 100.0 * run.flops.mfu(w["clips"] / w["seconds"], per_clip(run.flops))
