"""CPU checks of the port's epoch-fused cached route (JAX
``make_epoch_fused_step`` / ``make_epoch_fused_step_mesh`` and the
``Trainer``'s ``_epoch_const``, ``_epoch_const_mesh``, ``_train_epoch_fused``).
On the CPU the fused step runs eagerly; its CUDA graph is checked on the
card (``chip_smoke.py`` E9).

* the epoch's order and plans equal JAX's ``_epoch_const``, a truncated
  epoch included (JAX ``tests/test_training.py``'s parity after a
  ``max_steps=1`` epoch);
* under a data 2 and a data 2 x model 2 mesh, every process's order and
  plans are its columns of JAX's ``_epoch_const_mesh``, all from its own
  N/2 rows of the dataset, the only rows its cache holds (a per-shard
  permutation, DistributedSampler's semantics; before the route was
  ported, the port drew one global permutation and striped it);
* the host route, the per-step cached route and the fused route give the
  same losses over 2 epochs with dropout on, for ``sbl``, ``lrw1000`` and
  ``classify`` (rtol 1e-5; they draw the same batches, plans and random
  numbers, and on the CPU agree bit for bit);
* at dropout 0 and teacher forcing 1.0 the fused route equals JAX's
  ``_train_epoch_fused`` over 2 epochs x 2 steps (each epoch's mean loss
  within 1e-5 relative, ``test_torch_port_trainer.py``'s tolerance);
* `cli train --cache-on-device` takes the fused route and traces it; an
  out-of-memory in its first step rebuilds it with ``remat_frontend``;
* the fused step draws from no host generator: the Trainer's generator is
  a subclass whose draws raise once the epoch's constants are drawn;
* two gloo processes (started by this file: ``python
  tests/test_torch_port_fused.py worker RANK PORT DIR``) on a data 2 mesh
  give the losses of the one-process fused run on the same batch stream,
  dropout on, each holding N/2 cached clips;
* the plain attention versions take the seed as the kernels read it, an
  int64 tensor (two's complement above 2^63), and draw what the int draws;
* a state dict saved without ``capturable`` resumes with Adam's step
  counts moved to their parameters' device;
* chip_smoke E9's comparison of the routes' updates sees a wrong update
  (an lr frozen at capture, a skipped or a doubled one) that leaves the
  losses bit-equal;
* the lr computed on the device equals ``noam_lr`` within one f32 ulp
  where numpy's f32 power rounds the root as the device does (2 ulp
  elsewhere: numpy's root is 1 ulp off there).

Torch runs on one thread here and in the workers.  One JAX Trainer a
configuration.
"""
import dataclasses
import json
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

from sbl_for_multilingual_lip_reading_tpu_torch import config as C  # noqa: E402
from sbl_for_multilingual_lip_reading_tpu_torch import ops  # noqa: E402
from sbl_for_multilingual_lip_reading_tpu_torch.data import (  # noqa: E402
    SyntheticLipDataset)
from sbl_for_multilingual_lip_reading_tpu_torch.training import (  # noqa: E402
    trainer as port_trainer)
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (  # noqa: E402
    Trainer)

EPOCHS = 2
LOSS_RTOL = 1e-5
WORKER_TIMEOUT = 240
MESH_BATCH, MESH_SIZE = 4, 8


def _route(monkeypatch, fused: bool):
    if fused:
        monkeypatch.delenv("SBL_NO_EPOCH_FUSED", raising=False)
    else:
        monkeypatch.setenv("SBL_NO_EPOCH_FUSED", "1")


def _data(cfg, size=5, seed=0):
    kind = {"lrw1000": "lrw1000", "classify": "lrw"}.get(cfg.name, "all")
    kw = dict(vocab="lrw1000") if cfg.name == "lrw1000" else {}
    return SyntheticLipDataset(size=size, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, kind=kind,
                               seed=seed, **kw)


def _config(name="sbl", **kw):
    cfg = C.tiny_test(name)
    return dataclasses.replace(cfg, batch_size=2, **kw)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a), (b): the epoch's constants against JAX's
# ---------------------------------------------------------------------------

def _jax_data(cfg, mesh=None):
    from sbl_for_multilingual_lip_reading_tpu.data.synthetic import (
        SyntheticLipDataset as JaxSynthetic)
    return JaxSynthetic(size=MESH_SIZE if mesh else 5, frames=cfg.data.frames,
                        raw_size=cfg.data.raw_size)


def _jax_trainer(cfg, mesh=None):
    from sbl_for_multilingual_lip_reading_tpu.training import trainer as jt
    return jt.Trainer(cfg, _jax_data(cfg, mesh), mesh=mesh, cache_on_device=True)


def _jax_constants(cfg, mesh=None):
    """A JAX ``Trainer`` with what its ``_epoch_const`` / ``_epoch_const_mesh``
    read and nothing built (its model's init is a compile of its own): the
    config, the dataset, the mesh, ``np_rng`` from the seed, the device
    cache's slots and a state at step 0."""
    import types
    from sbl_for_multilingual_lip_reading_tpu.training import trainer as jt
    from sbl_for_multilingual_lip_reading_tpu.utils.logging import get_logger
    tr = jt.Trainer.__new__(jt.Trainer)
    tr.cfg, tr.train_dataset, tr.mesh = cfg, _jax_data(cfg, mesh), mesh
    tr.np_rng = np.random.default_rng(cfg.seed)
    tr.state = types.SimpleNamespace(step=0)
    tr._dev_clips = tr._host_small = tr._dev_small = None
    tr.logger = get_logger()
    return tr


def _host(const, n):
    return (const.order[:n].numpy(),
            {k: v[:n].numpy() for k, v in const.per_step.items()},
            int(const.base))


def test_epoch_const_equals_jax_including_after_a_truncated_epoch():
    import jax
    from sbl_for_multilingual_lip_reading_tpu import config as JC
    jtr = _jax_constants(dataclasses.replace(JC.tiny_test("sbl"), batch_size=2))
    tr = Trainer(_config(), _data(_config()), device="cpu",
                 cache_on_device=True)
    for epoch, max_steps in ((0, 1), (1, None), (2, None)):
        want, n = jtr._epoch_const(epoch, max_steps)
        want = jax.device_get(want)
        const, got_n = tr._epoch_const(epoch, max_steps)
        assert got_n == n == (1 if max_steps else 2)
        order, plans, base = _host(const, n)
        assert np.array_equal(order, want["order"])
        assert plans.keys() == want["per_step"].keys()
        for k in plans:
            assert np.array_equal(plans[k], want["per_step"][k]), k
        # JAX's state never moved; the port's base is its step counter
        assert base == int(want["base"]) == 0
    # the random numbers of a step: one row a step, drawn from the
    # Trainer's generator as the per-step route draws them
    assert not torch.equal(const.seeds[0], const.seeds[1])


@pytest.fixture
def world_one_group():
    """A gloo group of one process: a ``DataMesh`` of another shape can
    build its Trainer (whose only collective there is the weights'
    broadcast) and draw its constants."""
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("data,model", [(2, 1), (2, 2)],
                         ids=["data2", "data2_model2"])
def test_epoch_const_mesh_is_each_process_share_of_jax(world_one_group, data,
                                                       model):
    """C4: each process's batch columns come from its own rows."""
    import jax
    from sbl_for_multilingual_lip_reading_tpu import config as JC
    from sbl_for_multilingual_lip_reading_tpu.parallel import make_mesh as jax_mesh
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import DataMesh
    jcfg = dataclasses.replace(JC.tiny_test("sbl"), batch_size=MESH_BATCH,
                               mesh=JC.MeshConfig(data=data, model=model))
    jtr = _jax_constants(jcfg, jax_mesh(data, model))
    assert jtr._mesh_fused_ok()
    want = [jax.device_get(jtr._epoch_const_mesh(e, m)[0])
            for e, m in ((0, 1), (1, None))]
    cfg = dataclasses.replace(_config(), batch_size=MESH_BATCH,
                              mesh=C.MeshConfig(data=data, model=model))
    ds = _data(cfg, MESH_SIZE)
    bl, nl = MESH_BATCH // data, MESH_SIZE // data
    seeds = []
    for d in range(data):
        for m in range(model):
            mesh = DataMesh(d, data, torch.device("cpu"), "gloo", m, model)
            tr = Trainer(cfg, ds, device="cpu", mesh=mesh, cache_on_device=True)
            assert tr._mesh_fused_ok() and tr._fused_route()
            for w, (e, m_steps) in zip(want, ((0, 1), (1, None))):
                const, n = tr._epoch_const_mesh(e, m_steps)
                order, plans, _ = _host(const, n)
                cols = slice(d * bl, (d + 1) * bl)
                assert np.array_equal(order, w["order"][:, cols])
                for k in plans:
                    assert np.array_equal(plans[k], w["per_step"][k][:, cols]), k
                # the shard-local invariant: only the data index's rows
                assert ((order >= d * nl) & (order < (d + 1) * nl)).all()
            seeds.append(const.seeds[:n].clone())
            # the cache holds the data index's N/W clips, and only those
            assert tr._dev_clips.shape[0] == nl
            assert torch.equal(tr._dev_clips, torch.from_numpy(np.stack(
                [ds[i]["clip_u8"] for i in range(d * nl, (d + 1) * nl)])))
    # every process draws the same random numbers
    assert all(torch.equal(s, seeds[0]) for s in seeds)


# ---------------------------------------------------------------------------
# (c): the three routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sbl", "lrw1000", "classify"])
def test_host_per_step_and_fused_routes_agree_with_dropout_on(monkeypatch,
                                                              name):
    cfg = _config(name)
    assert cfg.dims.dropout > 0
    runs = []
    for cache, fused in ((False, False), (True, False), (True, True)):
        _route(monkeypatch, fused)
        tr = Trainer(cfg, _data(cfg), device="cpu", cache_on_device=cache)
        history = []
        means = [tr.train_epoch(e, history=history) for e in range(EPOCHS)]
        assert (tr.fused_step is not None) == fused
        assert tr.state.step == int(tr.state.step_dev) == len(history) == 4
        runs.append((means, [h["loss"] for h in history]))
    assert all(np.isfinite(runs[0][1]))
    for means, losses in runs[1:]:
        np.testing.assert_allclose(losses, runs[0][1], rtol=LOSS_RTOL)
        np.testing.assert_allclose(means, runs[0][0], rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# (d): against JAX's _train_epoch_fused
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_fused():
    """JAX's fused route (its default for a cached dataset) over 2 epochs of
    2 steps at dropout 0 and teacher forcing 1.0; the starting variables."""
    import jax
    from sbl_for_multilingual_lip_reading_tpu import config as JC
    from test_torch_port_recognize import _perturbed
    from test_torch_port_trainer import _deterministic
    cfg = _deterministic(JC.tiny_test("sbl"))
    os.environ.pop("SBL_NO_EPOCH_FUSED", None)
    tr = _jax_trainer(cfg)
    variables = _perturbed({"params": jax.device_get(tr.state.params),
                            "batch_stats": jax.device_get(tr.state.batch_stats)},
                           np.random.default_rng(11))
    tr.state = tr.state.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"])
    losses = [tr.train_epoch(e, max_steps=2) for e in range(EPOCHS)]
    assert tr._fused_step is not None
    return dict(variables=variables, losses=losses)


def test_fused_route_matches_jax_train_epoch_fused(jax_fused, monkeypatch):
    from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
        state_dict_from_jax)
    from test_torch_port_trainer import _deterministic
    _route(monkeypatch, True)
    cfg = _deterministic(C.tiny_test())
    tr = Trainer(cfg, _data(cfg), device="cpu", cache_on_device=True)
    v = jax_fused["variables"]
    tr.model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    losses = [tr.train_epoch(e, max_steps=2) for e in range(EPOCHS)]
    assert tr.fused_step is not None
    np.testing.assert_allclose(losses, jax_fused["losses"], rtol=LOSS_RTOL)


def test_fused_route_memory_guard_rebuilds_with_remat(monkeypatch):
    """The fused step's first call runs under the memory guard: an
    out-of-memory there rebuilds it with ``remat_frontend`` (on the card
    before anything is captured) and retries the same step, whose losses
    are those of the run that never ran out (remat on == off)."""
    from sbl_for_multilingual_lip_reading_tpu_torch.training import (
        memguard, steps)
    _route(monkeypatch, True)
    cfg = _config()
    want = []
    Trainer(cfg, _data(cfg), device="cpu", cache_on_device=True).train_epoch(
        0, history=want)
    real, fails = steps.FusedStep.__call__, [1]

    def flaky(self, *args, **kw):
        if fails:
            fails.pop()
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return real(self, *args, **kw)
    monkeypatch.setattr(steps.FusedStep, "__call__", flaky)
    monkeypatch.setattr(memguard, "card_memory",
                        lambda device: (75 * 2 ** 30, 80 * 2 ** 30))
    tr = Trainer(cfg, _data(cfg), device="cpu", cache_on_device=True)
    got = []
    tr.train_epoch(0, history=got)
    assert not fails and tr.cfg.remat_frontend and tr.model.frontend.resnet.remat
    assert [h["loss"] for h in got] == [h["loss"] for h in want]


# ---------------------------------------------------------------------------
# (e): no host generator inside the step
# ---------------------------------------------------------------------------

class _RaisingGenerator(torch.Generator):
    """A Trainer's generator whose draws raise once ``armed``."""
    armed = False


def _guard_draws(monkeypatch, gen):
    for fn in ("randint", "rand", "randn", "randperm", "bernoulli",
               "multinomial", "normal"):
        real = getattr(torch, fn)

        def guarded(*args, _real=real, _fn=fn, **kw):
            if gen.armed and kw.get("generator") is gen:
                raise AssertionError(f"torch.{_fn} drew from the Trainer's "
                                     f"generator inside a step")
            return _real(*args, **kw)
        monkeypatch.setattr(torch, fn, guarded)


def _armed_trainer(monkeypatch, cfg):
    tr = Trainer(cfg, _data(cfg), device="cpu", cache_on_device=True)
    gen = _RaisingGenerator()
    gen.set_state(tr.generator.get_state())
    tr.generator = gen
    _guard_draws(monkeypatch, gen)
    return tr, gen


def test_fused_step_draws_from_no_host_generator(monkeypatch):
    cfg = _config()
    _route(monkeypatch, True)
    tr, gen = _armed_trainer(monkeypatch, cfg)
    draw = tr._epoch_const

    def then_arm(*args, **kw):
        out = draw(*args, **kw)
        gen.armed = True    # every draw of the epoch is done
        return out
    monkeypatch.setattr(tr, "_epoch_const", then_arm)
    for epoch in range(EPOCHS):
        gen.armed = False
        assert np.isfinite(tr.train_epoch(epoch))
    assert tr.state.step == 4
    # the guard itself: the per-step route draws inside its steps
    _route(monkeypatch, False)
    tr, gen = _armed_trainer(monkeypatch, cfg)
    gen.armed = True
    with pytest.raises(AssertionError, match="Trainer's generator"):
        tr.train_epoch(0)


def test_cli_train_cache_on_device_takes_the_fused_route_and_traces(
        tmp_path, monkeypatch, caplog):
    """`cli train --cache-on-device` (no new flag) runs the fused route, as
    JAX's CLI does, and ``--profile-dir`` traces its steps 1-3."""
    import logging
    from sbl_for_multilingual_lip_reading_tpu_torch import cli
    _route(monkeypatch, True)
    monkeypatch.setitem(C.PRESETS, "sbl", C.tiny_test)
    trace = tmp_path / "trace"
    with caplog.at_level(logging.INFO):
        tr, _ = cli.run_train([
            "--cpu", "--synthetic", "--synthetic-size", "8", "--batch-size", "2",
            "--d_model", "16", "--n_head", "2", "--d_inner", "32",
            "--n_layers_enc", "1", "--n_layers_dec", "1", "--epochs", "1",
            "--max-eval-batches", "1", "--cache-on-device",
            "--profile-dir", str(trace), "--save-dir", str(tmp_path / "ck")])
    assert tr.fused_step is not None and tr.state.step == 4
    assert "epoch-fused route, eager on cpu" in caplog.text
    # the program's spans of steps 1-3 over the profiler's events, on its
    # timeline
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    steps = sorted(e["args"]["step"] for e in spans if e["name"] == "train.step")
    assert steps == [1, 2, 3]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    first = min(e["ts"] for e in spans if e["name"] == "train.step")
    last = max(e["ts"] + e["dur"] for e in spans if e["name"] == "train.step")
    assert any(first <= e["ts"] <= last for e in ops)
    assert {"train.forward", "train.backward", "frontend", "decoder"} <= {
        e["name"] for e in spans}


# ---------------------------------------------------------------------------
# (f): two gloo processes
# ---------------------------------------------------------------------------

def _mesh_config():
    return dataclasses.replace(_config(), batch_size=MESH_BATCH,
                               mesh=C.MeshConfig(data=2))


def _run(tr) -> list:
    history = []
    for e in range(EPOCHS):
        tr.train_epoch(e, history=history)
    return [h["loss"] for h in history]


def _worker(rank: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import (
        make_mesh, shutdown)
    os.environ.pop("SBL_NO_EPOCH_FUSED", None)
    mesh = make_mesh(2, device="cpu", rank=rank,
                     init_method=f"tcp://localhost:{port}")
    cfg = _mesh_config()
    tr = Trainer(cfg, _data(cfg, MESH_SIZE), device="cpu", mesh=mesh,
                 cache_on_device=True)
    losses = _run(tr)
    torch.save(dict(losses=losses, rows=tr._dev_clips.shape[0],
                    fused=tr.fused_step is not None),
               Path(workdir) / f"rank{rank}.pt")
    shutdown()


@pytest.fixture(scope="module")
def gloo_fused(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("fused")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "SBL_NO_EPOCH_FUSED")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(r), str(port), str(workdir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
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
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def test_gloo_two_process_fused_run_equals_one_process(gloo_fused, monkeypatch):
    """The one-process fused run on the mesh's batch stream (its order drawn
    per data index, the plans and random numbers as drawn for the global
    batch): the processes' global losses equal its losses."""
    _route(monkeypatch, True)
    order = port_trainer.epoch_order
    monkeypatch.setattr(port_trainer, "epoch_order",
                        lambda seed, n, batch, data=1, max_steps=None:
                        order(seed, n, batch, 2, max_steps))
    cfg = dataclasses.replace(_mesh_config(), mesh=C.MeshConfig())
    want = _run(Trainer(cfg, _data(cfg, MESH_SIZE), device="cpu",
                        cache_on_device=True))
    assert len(want) == EPOCHS * MESH_SIZE // MESH_BATCH
    for rank in gloo_fused:
        assert rank["fused"] and rank["rows"] == MESH_SIZE // 2
        np.testing.assert_allclose(rank["losses"], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("seed", [5, 2 ** 62 + 3, 2 ** 64 - 5])
def test_plain_versions_take_the_seed_as_an_int64_tensor(seed):
    """K3/K4/K5 read their seed from an int64 on the device (two's
    complement above 2^63); their plain versions take the same tensor and
    draw what the int draws."""
    from sbl_for_multilingual_lip_reading_tpu_torch.ops import attention as A
    t = torch.tensor(seed - 2 ** 64 if seed >= 2 ** 63 else seed)
    assert torch.equal(A.dropout_keep_mask_flat_plain(3, 5, 7, 2, seed, 0.3, "cpu"),
                       A.dropout_keep_mask_flat_plain(3, 5, 7, 2, t, 0.3, "cpu"))
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn((3, 5, 16), generator=g) for _ in range(4))
    args = (q, k, v, 2, None)
    assert torch.equal(A.small_mha_dropout_flat_plain(*args, seed, 0.3),
                       A.small_mha_dropout_flat_plain(*args, t, 0.3))
    for a, b in zip(A.small_mha_dropout_bwd_flat_plain(*args, seed, 0.3, None, dout),
                    A.small_mha_dropout_bwd_flat_plain(*args, t, 0.3, None, dout)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="one int64"):
        A.dropout_keep_mask_flat_plain(3, 5, 7, 2, t.float(), 0.3, "cpu")


def test_resumed_adam_steps_move_to_the_parameters_device(monkeypatch):
    """A state dict saved without ``capturable`` (here on the CPU) loads
    Adam's step counts onto the host; the first capturable update moves
    them to their parameters' device as f32 (a ``meta`` model stands in
    for the card) and then marks the group capturable."""
    from sbl_for_multilingual_lip_reading_tpu_torch.training.state import (
        TrainState)
    cpu = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(cpu.parameters(), lr=1e-3, capturable=False)
    cpu(torch.ones(1, 3)).sum().backward()
    opt.step()
    saved = opt.state_dict()
    card = torch.nn.Linear(3, 2, device="meta")
    resumed = torch.optim.Adam(card.parameters(), lr=torch.zeros(()))
    resumed.load_state_dict(saved)
    assert {resumed.state[p]["step"].device.type
            for p in card.parameters()} == {"cpu"}
    state = TrainState(card, resumed, C.OptimConfig())
    state.capturable = True
    monkeypatch.setattr(resumed, "step", lambda: None)
    state.apply_gradients()
    for p in card.parameters():
        step = resumed.state[p]["step"]
        assert step.device.type == "meta" and step.dtype == torch.float32
    assert all(g["capturable"] for g in resumed.param_groups)


@pytest.fixture(scope="module")
def e9_tiny():
    """chip_smoke's E9 helpers and a good run: 3 fused steps of the tiny
    ``sbl`` preset at the full config's Noam schedule (warm-up 4000)."""
    import chip_smoke
    base = C.tiny_test("sbl")
    cfg = dataclasses.replace(base, batch_size=2, optim=dataclasses.replace(
        base.optim, k=0.2, warmup_steps=4000))
    data = _data(cfg, size=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        _route(mp, True)
        good = chip_smoke._fused_run(torch, ops, Trainer(
            cfg, data, device="cpu", cache_on_device=True), True, 3)
    return chip_smoke, cfg, data, good


@pytest.mark.parametrize("fault", ["none", "frozen_lr", "skipped", "doubled"])
def test_e9_update_check_sees_a_wrong_update(monkeypatch, e9_tiny, fault):
    """chip_smoke E9 compares the graphed and the per-step route's updates
    (``_update_errors`` within E9_UPDATE_TOL), because the warm-up's lr is
    too small for the losses to show a wrong update: a step run at the
    previous step's lr (an lr frozen at capture), a skipped and a doubled
    update leave the 3 losses bit-equal and move the updates by far more
    than the tolerance; a run without a fault repeats the updates."""
    from sbl_for_multilingual_lip_reading_tpu_torch.training import state as S
    chip_smoke, cfg, data, good = e9_tiny
    apply = S.TrainState.apply_gradients

    def faulty(self):
        if self.step == 2 and fault == "frozen_lr":
            self.step_dev.sub_(1)
            lr = apply(self)
            self.step_dev.add_(1)
            return lr
        if self.step == 2 and fault == "skipped":
            self.step += 1
            return self.lr
        if self.step == 2 and fault == "doubled":
            apply(self)
            self.step -= 1
        return apply(self)
    monkeypatch.setattr(S.TrainState, "apply_gradients", faulty)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    _route(monkeypatch, True)
    got = chip_smoke._fused_run(torch, ops, Trainer(
        cfg, data, device="cpu", cache_on_device=True), True, 3)
    errs, left_out = chip_smoke._update_errors(got["updates"], good["updates"],
                                               good["moments"])
    assert got["losses"] == good["losses"]
    assert left_out and all(n.endswith("w_ks.bias") for n in left_out)
    if fault == "none":
        assert max(errs.values()) == 0.0
    else:
        assert np.median(list(errs.values())) > 100 * chip_smoke.E9_UPDATE_TOL


# ---------------------------------------------------------------------------
# (g): the lr on the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,warmup,d_model", [(0.2, 4000, 512), (0.5, 100, 16)])
def test_noam_on_the_device_equals_noam_lr_within_one_ulp(k, warmup, d_model):
    """The lr computed on the device from the step counter is ``noam_lr``'s
    formula with s ** -0.5 rounded correctly to f32 (from f64): bit-equal to
    that, and within one f32 ulp of ``noam_lr`` wherever numpy's f32 power
    (the C library's powf, faithfully but not correctly rounded; XLA's CPU
    schedule gives the same bits) rounds the root the same way -- where it
    does not, 1 ulp apart in the root, the product may land 2 ulp apart."""
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
        noam_lr, noam_lr_device)
    steps = np.concatenate([np.arange(0, 12000), [10 ** 6, 10 ** 8]])
    got = noam_lr_device(torch.from_numpy(steps), k, warmup, d_model).numpy()
    want = np.array([noam_lr(int(s), k, warmup, d_model) for s in steps],
                    np.float32)
    s = np.maximum(steps + 1, 1).astype(np.float32)
    root = (1.0 / np.sqrt(s.astype(np.float64))).astype(np.float32)
    exact = np.float32(k * d_model ** -0.5) * np.minimum(
        root, s * np.float32(warmup ** -1.5))
    assert np.array_equal(got, exact)
    # noam_lr's own root: a scalar power, as it computes it
    same_root = root == np.array([x ** np.float32(-0.5) for x in s], np.float32)
    assert same_root.mean() > 0.99
    np.testing.assert_array_max_ulp(got[same_root], want[same_root], maxulp=1)
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
