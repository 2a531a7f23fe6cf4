"""CPU parity of the port's two train-mode BatchNorm variants against the
JAX package: ``ops/bn_relu.py::bn_act_train`` (``FusedBNAct``,
``FUSED_BN_ACT``) and ``ops/bn_dot.py::bn_train_dot`` (``DotBatchNorm``,
``DOT_BN``), the frontend built with each, their switches, remat, and the
statistics synchronised over two gloo processes.

The same seeded numpy inputs go through both packages, NCHW in the port
and NHWC in JAX.  Tolerances:

* f32: sums in another order, so 1e-5 on outputs and statistics and 1e-4
  of each gradient's largest element;
* bf16: both round one f32 value to bf16, and an f32 ulp of difference
  can carry that rounding across, so outputs sit within one bf16 ulp of
  |y| <= 8 (2^-5); gradients within 2^-6 of their largest element (a bf16
  ulp of the dx values, and the f32 sums of g x_hat formed from them);
* the frontends (f32, tiny): output 1e-4, gradients 1e-3 of each tensor's
  largest element, running statistics 1e-5, as the ``FastBatchNorm``
  frontend test holds them;
* sync over W = 2 against one process on the whole batch: f32, the
  statistics summed in another order, 1e-5 on outputs and 1e-4 of each
  gradient's largest element.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from sbl_for_multilingual_lip_reading_tpu_torch.models import (  # noqa: E402
    frontend, init_weights)
from sbl_for_multilingual_lip_reading_tpu_torch.ops.bn_dot import (  # noqa: E402
    bn_train_dot)
from sbl_for_multilingual_lip_reading_tpu_torch.ops.bn_relu import (  # noqa: E402
    bn_act_train)

EPS = 1e-5
WORLD = 2
WORKER_TIMEOUT = 120
FRONTEND = dict(conv3d_channels=8, resnet_channels=(8, 12), resnet_blocks=(1, 1),
                feature_dim=12)
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


def _inputs(dtype, shape=(6, 7, 4, 5), seed=0):
    rng = np.random.default_rng(seed)
    C = shape[1]
    x = (rng.standard_normal(shape) * 2 + 0.7).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(C) * 0.3 + 1).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.2).astype(np.float32)
    dt = getattr(torch, dtype)
    return dict(x=torch.from_numpy(x).to(dt), res=torch.from_numpy(res).to(dt),
                dy=torch.from_numpy(dy).to(dt), scale=torch.from_numpy(scale),
                bias=torch.from_numpy(bias))


def _nhwc(t):
    import jax.numpy as jnp
    dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[t.dtype]
    return jnp.asarray(t.float().permute(0, 2, 3, 1).numpy()).astype(dt)


def _nchw(a):
    import jax.numpy as jnp
    return np.asarray(a.astype(jnp.float32)).transpose(0, 3, 1, 2)


def _close(got, want, dtype, what, kind):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if kind == "out":
        tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    elif kind == "stat":
        tol = 1e-5
    else:
        scale = np.abs(want).max()
        tol = (1e-4 if dtype == "float32" else 2.0 ** -6) * scale
    np.testing.assert_allclose(got, want, atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_bn_act_train_matches_jax(relu, with_res, dtype):
    import jax
    import jax.numpy as jnp
    from sbl_for_multilingual_lip_reading_tpu.ops.bn_relu import (
        bn_act_train as jax_bn_act_train)
    t = _inputs(dtype, seed=int(relu) * 2 + int(with_res))
    x, s, b = (t[k].clone().requires_grad_(True) for k in ("x", "scale", "bias"))
    r = t["res"].clone().requires_grad_(True) if with_res else None
    y, mean, var = bn_act_train(x, s, b, r, eps=EPS, relu=relu)
    assert y.dtype == x.dtype and mean.dtype == var.dtype == torch.float32
    (y.float() * t["dy"].float()).sum().backward()

    dyj = _nhwc(t["dy"])

    def loss(xj, sj, bj, rj):
        yj, mj, vj = jax_bn_act_train(xj, sj, bj, rj, eps=EPS, relu=relu)
        return jnp.sum(yj.astype(jnp.float32) * dyj.astype(jnp.float32)), (yj, mj, vj)
    args = (_nhwc(t["x"]), jnp.asarray(t["scale"].numpy()),
            jnp.asarray(t["bias"].numpy()), _nhwc(t["res"]) if with_res else None)
    argnums = (0, 1, 2, 3) if with_res else (0, 1, 2)
    (_, (yj, mj, vj)), grads = jax.value_and_grad(loss, argnums, has_aux=True)(*args)
    _close(y, _nchw(yj), dtype, "y", "out")
    _close(mean, mj[0], dtype, "mean", "stat")
    _close(var, vj[0], dtype, "var", "stat")
    _close(x.grad, _nchw(grads[0]), dtype, "dx", "grad")
    _close(s.grad, grads[1], dtype, "dscale", "grad")
    _close(b.grad, grads[2], dtype, "dbias", "grad")
    if with_res:
        _close(r.grad, _nchw(grads[3]), dtype, "dres", "grad")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_train_dot_matches_jax(dtype):
    import jax
    import jax.numpy as jnp
    from sbl_for_multilingual_lip_reading_tpu.ops.bn_dot import (
        bn_train_dot as jax_bn_train_dot)
    t = _inputs(dtype, seed=7)
    x, s, b = (t[k].clone().requires_grad_(True) for k in ("x", "scale", "bias"))
    y, mean, var = bn_train_dot(x, s, b, EPS)
    assert y.dtype == mean.dtype == var.dtype == torch.float32
    # the module casts y to the compute dtype, as JAX's callers do
    (y.to(x.dtype).float() * t["dy"].float()).sum().backward()
    dyj = _nhwc(t["dy"])

    def loss(xj, sj, bj):
        yj, mj, vj = jax_bn_train_dot(xj, sj, bj, EPS, 1)
        return (jnp.sum(yj.astype(xj.dtype).astype(jnp.float32)
                        * dyj.astype(jnp.float32)), (yj, mj, vj))
    (_, (yj, mj, vj)), grads = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
        _nhwc(t["x"]), jnp.asarray(t["scale"].numpy()),
        jnp.asarray(t["bias"].numpy()))
    _close(y, _nchw(yj), "float32", "y", "out")
    _close(mean, mj[0], dtype, "mean", "stat")
    _close(var, vj[0], dtype, "var", "stat")
    _close(x.grad, _nchw(grads[0]), dtype, "dx", "grad")
    _close(s.grad, grads[1], dtype, "dscale", "grad")
    _close(b.grad, grads[2], dtype, "dbias", "grad")


@pytest.mark.parametrize("with_res", [False, True])
def test_bn_act_train_saves_x_res_and_channel_vectors_only(with_res):
    t = _inputs("bfloat16", shape=(4, 6, 5, 5))
    x = t["x"].clone().requires_grad_(True)
    res = t["res"] if with_res else None
    saved = []

    def pack(tensor):
        saved.append(tensor)
        return tensor
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda tensor: tensor):
        y, _, _ = bn_act_train(x, t["scale"], t["bias"], res, eps=EPS)
    full = [s for s in saved if s.dim() > 1]
    assert all(s.dim() == 1 and s.shape == (6,) for s in saved if s.dim() <= 1)
    assert len(full) == 1 + with_res
    assert full[0] is x and (not with_res or full[1] is res)
    assert len(saved) == 4 + 1 + with_res
    y.float().sum().backward()
    assert x.grad.shape == x.shape


def _jax_frontend(**kw):
    import jax.numpy as jnp
    from sbl_for_multilingual_lip_reading_tpu.models.frontend import VisualFrontend
    return VisualFrontend(dtype=jnp.float32, dropout=0.0, **FRONTEND, **kw)


@pytest.fixture(scope="module")
def jax_frontends():
    """JAX's frontend with each switch's field: perturbed variables, a
    clip, and the train output, parameter gradients of sum(y^2) and
    running statistics after the step, and the eval output."""
    import jax
    import jax.numpy as jnp
    from test_torch_port_recognize import _perturbed
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    out = {}
    for field in ("use_fused_bn_act", "use_dot_bn"):
        m = _jax_frontend(**{field: True})
        variables = jax.device_get(jax.jit(m.init)(jax.random.PRNGKey(1),
                                                   jnp.asarray(x[..., None])))
        variables = _perturbed(variables, np.random.default_rng(7))

        def loss(p, m=m, variables=variables):
            y, upd = m.apply({**variables, "params": p}, jnp.asarray(x[..., None]),
                             train=True, deterministic=True,
                             mutable=["batch_stats"])
            return jnp.sum(y * y), (y, upd)
        (_, (y, upd)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
        ye = jax.jit(lambda v, m=m: m.apply(v, jnp.asarray(x[..., None]),
                                            train=False))(variables)
        out[field] = jax.device_get(dict(variables=variables, y=y, stats=upd,
                                         grads=g, y_eval=ye))
    return x, out


def _port_frontend(field, variables, **kw):
    from sbl_for_multilingual_lip_reading_tpu_torch.utils import state_dict_from_jax
    port = frontend.VisualFrontend(dropout=0.0, **FRONTEND, **{field: True}, **kw)
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    return port


@pytest.mark.parametrize("field,kind", [("use_fused_bn_act", frontend.FusedBNAct),
                                        ("use_dot_bn", frontend.DotBatchNorm)])
def test_frontend_with_each_switch_matches_jax(jax_frontends, field, kind):
    from sbl_for_multilingual_lip_reading_tpu_torch.utils import state_dict_from_jax
    x, ref = jax_frontends
    ref = ref[field]
    port = _port_frontend(field, ref["variables"])
    bns = [m for m in port.modules() if isinstance(m, frontend.BatchNorm)]
    assert len(bns) == 6 and {type(m) for m in bns} == {kind}
    port.eval()
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref["y_eval"]), atol=1e-4)
    port.train()
    y = port(torch.from_numpy(x))
    (y * y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref["y"]), atol=1e-4)
    want = state_dict_from_jax(ref["grads"])
    for name, p in port.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)
    stats = state_dict_from_jax({}, ref["stats"]["batch_stats"])
    for name, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("env,field,want", [
    ({}, {}, frontend.BatchNorm),
    ({"FUSED_BN_ACT": "1"}, {}, frontend.FusedBNAct),
    ({}, {"use_fused_bn_act": True}, frontend.FusedBNAct),
    ({"FUSED_BN_ACT": "1", "NO_FUSED_BN_ACT": "1"}, {}, frontend.BatchNorm),
    ({"NO_FUSED_BN_ACT": "1"}, {"use_fused_bn_act": True}, frontend.BatchNorm),
    ({"DOT_BN": "1"}, {}, frontend.DotBatchNorm),
    ({}, {"use_dot_bn": True}, frontend.DotBatchNorm),
    ({"NO_DOT_BN": "1"}, {"use_dot_bn": True}, frontend.BatchNorm),
    ({"DOT_BN": "1", "PALLAS_BN": "1", "FUSED_BN_ACT": "1"}, {},
     frontend.DotBatchNorm),
    ({"PALLAS_BN": "1", "FUSED_BN_ACT": "1"}, {}, frontend.FastBatchNorm),
    ({"NO_DOT_BN": "1", "DOT_BN": "1", "FUSED_BN_ACT": "1"}, {},
     frontend.FusedBNAct),
])
def test_switches_follow_jax_precedence(monkeypatch, env, field, want):
    """Every BatchNorm of the frontend is of the class JAX's precedence
    picks (DOT_BN, then PALLAS_BN, then FUSED_BN_ACT), and JAX's switch
    functions read the environment as the port's do."""
    from sbl_for_multilingual_lip_reading_tpu.models import (
        frontend as jax_frontend)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = frontend.VisualFrontend(**FRONTEND, **field)
    assert {type(m) for m in port.modules()
            if isinstance(m, frontend.BatchNorm)} == {want}
    for name, fn in (("use_dot_bn", "dot_bn_on"),
                     ("use_fused_bn_act", "fused_bn_act_on")):
        on = field.get(name, False)
        assert getattr(frontend, fn)(on) == getattr(jax_frontend, "_" + fn)(on)
    fused = [m for m in port.modules() if isinstance(m, frontend.FusedBNAct)]
    assert [m.relu for m in fused] == ([] if want is not frontend.FusedBNAct
                                       else [True, True, True, True, True, False])


@pytest.mark.parametrize("field", ["use_fused_bn_act", "use_dot_bn"])
def test_remat_moves_running_statistics_once(field):
    """remat_frontend recomputes each block in the backward: the same
    output and gradients, bit for bit, and the running statistics move
    once."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, 16, 16)).astype(np.float32))
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        m = frontend.VisualFrontend(dropout=0.0, remat=remat, **FRONTEND,
                                    **{field: True})
        init_weights(m, torch.Generator().manual_seed(0))
        m.train()
        y = m(x)
        (y * y).sum().backward()
        runs.append((y.detach(), {n: p.grad for n, p in m.named_parameters()},
                     {n: b.clone() for n, b in m.named_buffers()}))
    (y0, g0, b0), (y1, g1, b1) = runs
    assert torch.equal(y0, y1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(b0[n], b1[n]) for n in b0)
    assert not torch.equal(b0["bn3d.running_mean"], torch.zeros(8))


# ---------------------------------------------------------------------------
# synchronised statistics over two gloo processes
# ---------------------------------------------------------------------------

def _sync_cases(x, res, dy, scale, bias, mesh=None):
    """Each op's (y, mean, var, dx, dscale, dbias[, dres]) on x; with a mesh
    the parameter gradients are summed over the processes, as the step's
    all-reduce sums them."""
    out = {}
    for name in ("act_res", "act", "dot"):
        xt, st, bt = (t.clone().requires_grad_(True) for t in (x, scale, bias))
        rt = res.clone().requires_grad_(True) if name == "act_res" else None
        if name == "dot":
            y, mean, var = bn_train_dot(xt, st, bt, EPS, mesh)
        else:
            y, mean, var = bn_act_train(xt, st, bt, rt, eps=EPS, relu=True,
                                        mesh=mesh)
        (y * dy).sum().backward()
        gs, gb = st.grad, bt.grad
        if mesh is not None:
            mesh.all_reduce_(gs)
            mesh.all_reduce_(gb)
        out[name] = [y.detach(), mean, var, xt.grad, gs, gb] + (
            [rt.grad] if rt is not None else [])
    # the module's running statistics under sync
    m = frontend.FusedBNAct(x.shape[1])
    m.sync = mesh
    m.train()(x)
    out["running"] = [m.running_mean.clone(), m.running_var.clone()]
    return out


def _sync_inputs():
    t = _inputs("float32", shape=(8, 5, 3, 4), seed=11)
    return t["x"], t["res"], t["dy"], t["scale"], t["bias"]


def _worker(rank, port, workdir):
    torch.set_num_threads(1)
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import (
        make_mesh, shutdown)
    mesh = make_mesh(WORLD, device="cpu", rank=rank,
                     init_method=f"tcp://localhost:{port}")
    x, res, dy, scale, bias = _sync_inputs()
    rows = slice(rank * x.shape[0] // WORLD, (rank + 1) * x.shape[0] // WORLD)
    out = _sync_cases(x[rows], res[rows], dy[rows], scale, bias, mesh)
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    shutdown()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_sync_over_two_processes_equals_one_process(tmp_path):
    want = _sync_cases(*_sync_inputs())
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(r), str(port), str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    half = 8 // WORLD
    for name, ref in want.items():
        for i, w in enumerate(ref):
            for r in range(WORLD):
                g = got[r][name][i]
                if g.dim() == 4:         # y, dx, dres: this process's rows
                    w_r = w[r * half:(r + 1) * half]
                    tol = 1e-5 if i == 0 else 1e-4 * w.abs().max().item()
                else:                   # statistics and parameter gradients
                    w_r = w
                    tol = 1e-5 if i in (1, 2) or name == "running" else (
                        1e-4 * w.abs().max().item())
                torch.testing.assert_close(g, w_r, rtol=0, atol=tol,
                                           msg=f"{name}[{i}] rank {r}")


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
