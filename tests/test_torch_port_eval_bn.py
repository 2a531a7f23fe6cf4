"""The frontend's one-pass eval BatchNorm (``models/frontend.py::bn_eval_``)
against the module path it replaces in eval mode with autograd off.

The module path widens the conv output to f32, runs (x - mean) * inv +
bias there (JAX ``fold_bn``'s x * a + b for ``FusedBNAct`` and
``DotBatchNorm``) and rounds to the compute dtype; ``bn_eval_`` computes
x * a + b in f32 and rounds once.  Tolerances:

* f32: the two formulas differ by an f32 ulp or so, so 1e-6 of the
  tensor's largest element;
* bf16: both round an f32 value, and an ulp of difference there can carry
  the rounding across, so at most one bf16 ulp, in at most 1e-4 of the
  elements.

Also: the route returns the compute dtype and makes no f32 tensor of
activation size; ``bn_eval_.calls`` counts 20 BatchNorms a frontend
forward at the ``sbl`` widths, 10 with K10 on, none in training or with
gradients recorded; eval with gradients back-propagates through the
module path as ``F.batch_norm`` on the running statistics does.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from sbl_for_multilingual_lip_reading_tpu_torch.models import frontend
from sbl_for_multilingual_lip_reading_tpu_torch.models.frontend import (
    BasicBlock, VisualFrontend)

F32_REL = 1e-6
BF16_MAX_DIFFERING = 1e-4
SBL_WIDTHS = dict(conv3d_channels=64, resnet_channels=(64, 128, 256, 512),
                  resnet_blocks=(2, 2, 2, 2), feature_dim=512)
BN_CLASSES = (frontend.BatchNorm, frontend.FastBatchNorm, frontend.DotBatchNorm,
              frontend.FusedBNAct)
SWITCHES = ("DOT_BN", "NO_DOT_BN", "PALLAS_BN", "FUSED_BN_ACT", "NO_FUSED_BN_ACT")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _randomize(module, seed):
    """He-normal convs; BN scales, biases and running statistics moved off
    their initial values."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, frontend.BatchNorm):
                C = m.weight.shape[0]
                m.weight.copy_(0.75 + 0.5 * torch.rand(C, generator=g))
                m.bias.copy_(0.2 * torch.randn(C, generator=g))
                m.running_mean.copy_(0.3 * torch.randn(C, generator=g))
                m.running_var.copy_(0.5 + torch.rand(C, generator=g))
            elif isinstance(m, BasicBlock):
                m.init_weights(g)
            elif isinstance(m, VisualFrontend):
                m.init_weights(g)
    return module


def _assert_route_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=F32_REL * want.abs().max().item())
        return
    g, w = got.float(), want.float()
    differ = g != w
    # one bf16 ulp of the larger magnitude: 2^(exponent - 7)
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs())
                                            .clamp_min(2.0 ** -126))) - 7)
    assert bool(((g - w).abs() <= ulp)[differ].all()), "a difference above one bf16 ulp"
    assert differ.float().mean().item() <= BF16_MAX_DIFFERING


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", BN_CLASSES, ids=lambda k: k.__name__)
def test_bn_eval_matches_each_batchnorms_eval(kind, dtype):
    """One BatchNorm of each class: ``bn_eval_`` over a conv-sized tensor
    against the class's eval forward (grad on) rounded to the dtype."""
    bn = _randomize(frontend.make_batchnorm(64, 1e-5, 0.9, kind, False,
                                            relu=False), 1).eval()
    x = (2.0 * torch.randn((8, 64, 24, 24), generator=torch.Generator().manual_seed(2))
         + 0.5).to(dtype)
    want = bn(x).to(dtype).detach()
    with torch.no_grad():
        got = frontend.bn_eval_(bn, x.clone())
    _assert_route_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out,stride", [(32, 32, 1), (32, 64, 2)],
                         ids=["identity", "downsample"])
def test_block_route_matches_module_path(c_in, c_out, stride, dtype):
    """A BasicBlock in eval mode: under ``inference_mode`` (bn1 + ReLU, bn2
    + residual + ReLU, and ``downsample_bn`` where the block has one, each
    by ``bn_eval_``) against the module path it takes with gradients on."""
    block = _randomize(BasicBlock(c_in, c_out, stride, dtype=dtype), 3).eval()
    x = torch.randn((8, c_in, 16, 16),
                    generator=torch.Generator().manual_seed(4)).to(dtype)
    frontend.bn_eval_.calls = 0
    with torch.inference_mode():
        got = block(x)
    assert frontend.bn_eval_.calls == (3 if block.has_downsample else 2)
    want = block(x).detach()
    assert frontend.bn_eval_.calls == (3 if block.has_downsample else 2)
    _assert_route_close(got, want)


def _stem_frontend(dtype, seed, negative=False):
    fe = _randomize(VisualFrontend(conv3d_channels=16, resnet_channels=(16, 32),
                                   resnet_blocks=(1, 1), feature_dim=32, dtype=dtype,
                                   dropout=0.0, use_kernels=False), seed).eval()
    if negative:
        with torch.no_grad():
            fe.bn3d.weight[::3].neg_()
            fe.bn3d.weight[1] = -0.0
    return fe


def _trunk_inputs(fe, x, grad):
    """The stem's output (the trunk's input) and the frontend's output."""
    seen = []
    hook = fe.resnet.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].detach().clone()))
    with (torch.enable_grad() if grad else torch.inference_mode()):
        y = fe(x).detach()
    hook.remove()
    return seen[0], y


@pytest.mark.parametrize("negative", [False, True], ids=["scales", "negative_scales"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_route_matches_module_path(dtype, negative):
    """The stem (BatchNorm, ReLU, max pool: the trunk's input) and the
    frontend's output under ``inference_mode`` against the module path,
    with positive BatchNorm scales and with a third of them negative."""
    fe = _stem_frontend(dtype, 5, negative)
    x = torch.randn((2, 6, 48, 48), generator=torch.Generator().manual_seed(6))
    got_stem, got = _trunk_inputs(fe, x, grad=False)
    want_stem, want = _trunk_inputs(fe, x, grad=True)
    assert got.dtype == dtype
    _assert_route_close(got_stem, want_stem)
    _assert_route_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_pool_first_equals_pool_last(dtype):
    """The route's stem (negated weights where the scale is negative, max
    pool, then ``bn_eval_`` and the ReLU on the pooled quarter) equals the
    one-pass BatchNorm and ReLU over the conv output pooled after them,
    bit for bit, negative and -0.0 scales included."""
    fe = _stem_frontend(dtype, 12, negative=True)
    xs = torch.randn((12, 5, 40, 40),
                     generator=torch.Generator().manual_seed(13)).to(dtype)
    with torch.inference_mode():
        got = fe._one_pass_stem(xs)
        y = F.conv2d(xs, fe.conv3d_weight.to(dtype), stride=2, padding=3)
        want = F.max_pool2d(torch.relu_(frontend.bn_eval_(fe.bn3d, y)), 3, 2, 1)
    assert got.dtype == dtype
    assert torch.equal(got, want)


class _F32Activations(TorchDispatchMode):
    """The 4-D f32 tensors the dispatched ops return, by op."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    and t.dim() == 4):
                self.seen.append((str(func), tuple(t.shape)))
        return out


def test_bf16_route_makes_no_f32_activation():
    """In bf16 no op of the eval route returns an f32 activation but the
    trunk's global average pool's widening of the last block's output; the
    module path (gradients on) makes one or more a BatchNorm."""
    fe = _randomize(VisualFrontend(conv3d_channels=8, resnet_channels=(8, 16),
                                   resnet_blocks=(1, 1), feature_dim=16,
                                   dtype=torch.bfloat16, dropout=0.0,
                                   use_kernels=False), 7).eval()
    x = torch.randn((2, 6, 32, 32), generator=torch.Generator().manual_seed(8))
    with torch.inference_mode(), _F32Activations() as route:
        y = fe(x)
    assert y.dtype == torch.bfloat16
    assert [shape for _, shape in route.seen] == [(12, 16, 4, 4)]
    assert route.seen[0][0] in ("aten.to.dtype", "aten._to_copy.default")
    with _F32Activations() as module_path:
        fe(x)
    assert len(module_path.seen) > 6


@pytest.mark.parametrize("mode,want", [("inference", 20), ("no_grad", 20),
                                       ("k10", 10), ("train", 0),
                                       ("train_no_grad", 0), ("eval_grad", 0)])
def test_counter_per_frontend_forward(mode, want):
    """``bn_eval_.calls`` after one frontend forward at the ``sbl`` widths
    (tiny frames): the stem, 8 blocks' bn1 and bn2 and 3 downsamples in
    eval with autograd off; K10 takes 5 blocks' two; none in training or
    with gradients recorded."""
    fe = VisualFrontend(**SBL_WIDTHS, dropout=0.0, use_kernels=False,
                        use_pallas_resblock=mode == "k10")
    fe.train(mode.startswith("train"))
    x = torch.randn((1, 2, 16, 16), generator=torch.Generator().manual_seed(9))
    ctx = {"inference": torch.inference_mode, "k10": torch.inference_mode,
           "no_grad": torch.no_grad, "train_no_grad": torch.no_grad}.get(
               mode, torch.enable_grad)
    frontend.bn_eval_.calls = 0
    with ctx():
        fe(x)
    assert frontend.bn_eval_.calls == want


def _reference_block(block, x):
    """The block in f32 by ``F.conv2d`` and ``F.batch_norm`` on the running
    statistics."""
    def bn(m, y):
        return F.batch_norm(y, m.running_mean, m.running_var, m.weight, m.bias,
                            training=False, eps=m.eps)
    y = F.relu(bn(block.bn1, F.conv2d(x, block.conv1.weight, stride=block.stride,
                                      padding=1)))
    y = bn(block.bn2, F.conv2d(y, block.conv2.weight, padding=1))
    res = bn(block.downsample_bn, F.conv2d(x, block.downsample_conv.weight,
                                           stride=block.stride))
    return F.relu(y + res)


def test_eval_with_grad_backpropagates_through_the_module_path():
    """Eval mode with gradients on: no ``bn_eval_``, and the gradients of
    sum(y^2) for the input and every parameter (BatchNorm scale and bias
    included) equal an f32 ``F.batch_norm`` composition's."""
    block = _randomize(BasicBlock(8, 16, 2), 10).eval()
    x = torch.randn((4, 8, 12, 12), generator=torch.Generator().manual_seed(11))
    frontend.bn_eval_.calls = 0
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    y = block(xs[0])
    (y * y).sum().backward()
    got = [xs[0].grad] + [p.grad.clone() for p in block.parameters()]
    assert frontend.bn_eval_.calls == 0
    block.zero_grad()
    want_y = _reference_block(block, xs[1])
    (want_y * want_y).sum().backward()
    want = [xs[1].grad] + [p.grad for p in block.parameters()]
    np.testing.assert_allclose(y.detach().numpy(), want_y.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max().item())
