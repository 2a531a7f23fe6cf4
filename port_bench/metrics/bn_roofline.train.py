"""K7 + K8's share of their roofline in a training step, in %: the least
time of the frontend's BatchNorm statistics (``ops/batchnorm.py``,
``csrc/batchnorm.cu``) over K7 + K8's summed device time in the traced
slice.  The work: per BatchNorm, the forward's sums (its bf16 input read
once, 3 operations an element at the f32 rate) and the backward's pair of
sums (input and output gradient read once, 5 operations an element); the
remat recompute's sums are work the algorithm does not need (their time
stays in the denominator).  Shapes from the configuration: the stem's
output and each ResNet block's convolutions, over the step's B x T
frames.  Nothing is read where the slice's launches are not the path's."""
from port_bench.core import trace
from port_bench.reference import roofline

KERNELS = ("channel_sums_kernel",)
F32_OPS = 67e12          # H100 SXM float32, outside the tensor cores


def shapes(cfg, frames):
    """(channels, side) of every frontend BatchNorm."""
    S = cfg.data.crop_size
    side = (S + 1) // 2
    out = [(cfg.frontend.conv3d_channels, side)]
    side = (side + 1) // 2
    c_in = cfg.frontend.conv3d_channels
    for stage, (c, blocks) in enumerate(zip(cfg.frontend.resnet_channels,
                                            cfg.frontend.resnet_blocks)):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            if stride > 1:
                side = (side + 2 - 3) // stride + 1
            out += [(c, side), (c, side)]
            if stride != 1 or c_in != c:
                out.append((c, side))
            c_in = c
    return out


def read(run):
    if not run.records:
        return None
    frames = run.mix["batch"] * run.cfg.data.frames
    bns = shapes(run.cfg, frames)
    want = (2 * len(bns) + (len(bns) - 1 if run.cfg.remat_frontend else 0)) * run.mix["trace_steps"]
    n, seconds = trace.kernel_seconds(run.records, KERNELS)
    if n != want or seconds <= 0:
        return None
    least = 0.0
    for c, side in bns:
        numel = frames * c * side * side
        least += roofline.bound_s(numel * 2 + 8 * c, 3.0 * numel, F32_OPS)
        least += roofline.bound_s(2 * numel * 2 + 16 * c, 5.0 * numel, F32_OPS)
    return 100.0 * least * run.mix["trace_steps"] / seconds
