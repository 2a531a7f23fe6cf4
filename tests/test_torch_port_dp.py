"""Data parallelism of the port on the CPU: W = 2 processes over gloo,
started by this file (``python tests/test_torch_port_dp.py worker RANK
WORLD PORT DIR``), each on its half of a global batch, against the
one-process step on the whole batch (the halves one after another) and
against JAX.

The workers run every case once on inputs this file writes (a tiny
``sbl`` / ``lrw1000`` model's weights, global batches with their plans,
seeds, the one-process steps' ReLU signs) and save what they saw; the
tests compare:

* with dropout on (encoder, decoder, frontend and attention dropout,
  teacher forcing drawn), ``remat_frontend`` and ``grad_clip``: loss,
  every averaged gradient, the parameters after the update and the BN
  running statistics equal the one-process step's, on both BatchNorm
  routes (plain, and ``FastBatchNorm``'s K7/K8 plain versions), within
  chip_smoke's f32 train-step tolerances (TRAIN_LOSS_TOL,
  TRAIN_GRAD_TOL as a per-parameter relative norm, TRAIN_BN_TOL); the
  BatchNorm scale and bias gradients are not counted once a process;
* the teacher-forcing coins are the same in both processes and their
  dropout masks differ: each is its rows of the one-process mask;
* with dropout 0 and JAX's coins injected: the step equals JAX's
  ``make_mesh(data=2)`` step on the 8 virtual CPU devices (the
  ``tests/test_sharding.py`` pattern), and with ``sync_batchnorm`` off
  JAX's ``GroupedBatchNorm(groups=2)`` step, within
  ``test_torch_port_train.py``'s step tolerances;
* ``lrw1000`` with unequal token counts in the two processes: the loss is
  the global token mean and the gradients the one-process ones;
* a checkpoint written by process 0 loads at W = 1;
* the ``Batcher``'s stripes and the device cache's are the same batches
  with the same plans, the rows of the one-process plans of the striped
  batch.

Torch runs on one thread in the workers and here.  The workers import
nothing of JAX.  Each worker has its own timeout (WORKER_TIMEOUT).
"""
import dataclasses
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

from sbl_for_multilingual_lip_reading_tpu_torch import config as PC  # noqa: E402
from sbl_for_multilingual_lip_reading_tpu_torch.data import (  # noqa: E402
    Batcher, SyntheticLipDataset)
from sbl_for_multilingual_lip_reading_tpu_torch.models import (  # noqa: E402
    build_model, layers)
from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (  # noqa: E402
    make_optimizer)
from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (  # noqa: E402
    make_train_step)
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (  # noqa: E402
    Trainer, attach_plans)

from chip_smoke import (  # noqa: E402  (phase 5's tolerances, its comparison)
    TRAIN_BN_TOL, TRAIN_GRAD_TOL, TRAIN_LOSS_TOL, _grad_errors)

WORLD = 2
BATCH = 4                  # global; 2 a process
WORKER_TIMEOUT = 420
STEP_SEED = 11
GRAD_CLIP = 0.5            # below these steps' gradient norms: the clip acts
# a ReLU input on which a process and the one-process step disagree in sign
# lies within their forwards' f32 difference of 0
FLIP_MARGIN = 1e-4


# ---------------------------------------------------------------------------
# inputs (written by the fixture, read by the workers)
# ---------------------------------------------------------------------------

def _dropout_cfg(pallas_bn):
    cfg = PC.tiny_test("sbl")
    return dataclasses.replace(
        cfg, batch_size=BATCH, remat_frontend=True,
        optim=dataclasses.replace(cfg.optim, grad_clip=GRAD_CLIP),
        mesh=PC.MeshConfig(data=WORLD)), pallas_bn


def _batch(cfg, size, seed, data_seed=2, **kw):
    ds = SyntheticLipDataset(size=size, frames=cfg.data.frames,
                             raw_size=cfg.data.raw_size, seed=data_seed, **kw)
    b = next(iter(Batcher(ds, size, shuffle=False)))
    return attach_plans(b, np.random.default_rng(seed), cfg)


def _uni_batch(cfg):
    """An lrw1000 batch whose first half has long labels and second half
    short ones: the two processes count different numbers of tokens."""
    b = _batch(cfg, BATCH, 4, kind="lrw1000", vocab="lrw1000")
    labels = b["labels"].copy()
    labels[BATCH // 2:, 2:] = -1
    return dict(b, labels=labels)


def _rows(batch, rank):
    n = BATCH // WORLD
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank * n:(rank + 1) * n]))
            for k, v in batch.items()}


def _whole(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# one step, recorded (both sides)
# ---------------------------------------------------------------------------

def _rows_of(mask, shape, rank):
    """A process's part of a one-process tensor: its rows along the first
    axis where the two shapes differ (the batch axis; the frontend folds
    frames into it, the decoder keeps a direction axis before it)."""
    axis = next(a for a, (m, n) in enumerate(zip(mask.shape, shape)) if m != n)
    n = shape[axis]
    assert mask.shape[axis] == WORLD * n, (tuple(mask.shape), tuple(shape))
    return mask.narrow(axis, rank * n, n)


class _Recorder:
    """Records the teacher-forcing coins and the first elementwise dropout
    mask a step draws, and each ReLU's input signs.  Given ``routing`` (the
    one-process step's signs) and ``rank``, every ReLU passes x where the
    one-process step's input at the process's rows was > 0, and |x| goes to
    ``flips`` where x's own sign disagrees.  The two steps' f32 forwards
    differ in the last bits (BatchNorm sums in another order), and an input
    that close to 0 may take the kink's other side: one such element moves
    a gradient by up to a few 1e-3 (``test_torch_port_train.py`` meets the
    same against JAX); routed, every flip is checked to lie within
    FLIP_MARGIN of 0."""

    def __init__(self, monkey, routing=None, rank=0):
        self.coins, self.masks, self.signs, self.flips = [], [], [], []
        coins, keep = layers.DropoutRNG.coins, layers.DropoutRNG.keep
        relu = torch.nn.functional.relu
        todo = iter(routing or ())

        def rec_relu(x, inplace=False):
            if routing is None:
                self.signs.append(x.detach() > 0)
                return relu(x)
            sign = _rows_of(next(todo), x.shape, rank)
            own = x.detach() > 0
            self.flips.extend(x.detach()[own != sign].abs().tolist())
            return x * sign.to(x.dtype)
        monkey.setattr(torch.nn.functional, "relu", rec_relu)

        def rec_coins(rng, n, p):
            out = coins(rng, n, p)
            self.coins.append(out)
            return out

        def rec_keep(rng, shape, rate, batch_dim=0):
            out = keep(rng, shape, rate, batch_dim)
            self.masks.append(out.clone())
            return out
        monkey.setattr(layers.DropoutRNG, "coins", rec_coins)
        monkey.setattr(layers.DropoutRNG, "keep", rec_keep)


def _step(cfg, sd, batch, mesh=None, pallas_bn=False, use_gold=None,
          routing=None):
    """One train step of ``cfg`` from state ``sd`` on ``batch`` (a dict of
    tensors): loss, metrics, gradients, state after, coins, the first
    dropout mask, and the ReLU signs (one process) or the flips against
    ``routing`` (a data-parallel process, ``_Recorder``)."""
    with pytest.MonkeyPatch.context() as mp:
        if pallas_bn:
            mp.setenv("PALLAS_BN", "1")
        else:
            mp.delenv("PALLAS_BN", raising=False)
        model = build_model(cfg, "cpu")
        model.load_state_dict(sd)
        rec = _Recorder(mp, routing, 0 if mesh is None else mesh.rank)
        step = make_train_step(model, make_optimizer(model, cfg.optim), cfg, mesh)
        kw = {} if use_gold is None else {"use_gold": use_gold}
        out = step(batch, torch.Generator().manual_seed(STEP_SEED), **kw)
    return dict(metrics={k: v.item() for k, v in out.items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                sd={k: v.clone() for k, v in model.state_dict().items()},
                coins=rec.coins, first_mask=rec.masks[0] if rec.masks else None,
                bn_type=type(model.frontend.bn3d).__name__, signs=rec.signs,
                flips=rec.flips)


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _trainer_cases(mesh, workdir):
    """Process 0's checkpoint, and the two batch sources' first batches."""
    cfg = dataclasses.replace(PC.tiny_test("sbl"), batch_size=BATCH,
                              mesh=PC.MeshConfig(data=WORLD))
    ds = SyntheticLipDataset(size=3 * BATCH, frames=cfg.data.frames,
                             raw_size=cfg.data.raw_size, seed=5)
    out = {}
    tr = Trainer(cfg, ds, {}, checkpoint_dir=str(workdir / "ckpt"),
                 device="cpu", mesh=mesh)
    tr.fit(1, max_steps_per_epoch=1)
    out["fit_sd"] = {k: v.clone() for k, v in tr.model.state_dict().items()}
    for cache in (False, True):
        tr = Trainer(cfg, ds, {}, device="cpu", mesh=mesh,
                     cache_on_device=cache)
        if cache:
            it = tr._device_batches(0)
        else:
            it = tr._host_batches(Batcher(ds, BATCH, shuffle=True, seed=cfg.seed,
                                          process_index=mesh.rank,
                                          process_count=mesh.size))
        out[f"batches_cache{int(cache)}"] = [
            {k: np.asarray(v) for k, v in next(it).items()} for _ in range(2)]
    return out


def _worker(rank, world, port, workdir):
    torch.set_num_threads(1)
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import (
        make_mesh, shutdown)
    workdir = Path(workdir)
    mesh = make_mesh(world, device="cpu", rank=rank,
                     init_method=f"tcp://localhost:{port}")
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    results = {}
    for name, case in inputs["steps"].items():
        cfg = case["cfg"]
        res = _step(cfg, case["sd"], _rows(case["batch"], rank), mesh,
                    case.get("pallas_bn", False), case.get("use_gold"),
                    case.get("routing"))
        results[name] = res
    results["trainer"] = _trainer_cases(mesh, workdir)
    torch.save(results, workdir / f"rank{rank}.pt")
    shutdown()


# ---------------------------------------------------------------------------
# the fixture: inputs, workers, references
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _jax_side():
    """The JAX variables (perturbed tiny init) and coins, and JAX's mesh
    and grouped-BN steps on the global batch, in the port's naming."""
    import jax
    import jax.numpy as jnp
    from sbl_for_multilingual_lip_reading_tpu import config as JC
    from sbl_for_multilingual_lip_reading_tpu.models import (
        build_model as build_jax_model)
    from sbl_for_multilingual_lip_reading_tpu.parallel import (
        make_mesh as jax_mesh, shard_batch, shard_params)
    from sbl_for_multilingual_lip_reading_tpu.training import (
        schedule as jax_schedule)
    from sbl_for_multilingual_lip_reading_tpu.training.steps import (
        make_sbl_train_step as make_jax_step)
    from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
        state_dict_from_jax)
    from test_torch_port_recognize import _perturbed
    from test_torch_port_train import (TEST_ADAM_EPS, XLA_OPTIONS, _jax_coins,
                                       _jax_state)

    def both(sync):
        out = []
        for mod in (JC, PC):
            cfg = mod.tiny_test("sbl")
            out.append(dataclasses.replace(
                cfg, batch_size=BATCH,
                dims=dataclasses.replace(cfg.dims, dropout=0.0),
                frontend=dataclasses.replace(cfg.frontend, dropout=0.0),
                optim=dataclasses.replace(cfg.optim, adam_eps=TEST_ADAM_EPS),
                mesh=mod.MeshConfig(data=WORLD, sync_batchnorm=sync)))
        return out

    jcfg, pcfg = both(True)
    T, crop = jcfg.data.frames, jcfg.data.crop_size
    key = jax.random.PRNGKey(0)
    labels = jnp.zeros((2, jcfg.decoder.target_pad_len), jnp.int32)
    variables = jax.device_get(jax.jit(lambda: build_jax_model(jcfg).init(
        {"params": key, "dropout": key, "teacher": key},
        jnp.zeros((2, T, crop, crop)), labels, labels, train=False))())
    variables = _perturbed(variables, np.random.default_rng(3))
    batch = _batch(pcfg, BATCH, 6)
    rng = jax.random.PRNGKey(5)
    out = {"variables": variables, "batch": batch, "cfgs": {}}
    for name, sync in (("jax_mesh", True), ("jax_grouped", False)):
        jcfg, pcfg = both(sync)
        model = build_jax_model(jcfg)
        step = make_jax_step(model, jax_schedule.make_optimizer(jcfg.optim), jcfg)
        state = _jax_state(jcfg, variables)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        coins = _jax_coins(model, jcfg, rng, 0)
        if sync:
            mesh = jax_mesh(data=WORLD, model=1)
            with mesh:
                state = state.replace(
                    params=shard_params(state.params, mesh),
                    batch_stats=shard_params(state.batch_stats, mesh))
                jbatch = shard_batch(jbatch, mesh)
                compiled = step.lower(state, jbatch, rng).compile(XLA_OPTIONS)
                state, metrics = compiled(state, jbatch, rng)
        else:
            compiled = step.lower(state, jbatch, rng).compile(XLA_OPTIONS)
            state, metrics = compiled(state, jbatch, rng)
        out["cfgs"][name] = pcfg
        out[name] = dict(loss=float(metrics["loss"]), coins=coins,
                         sd=state_dict_from_jax(*jax.device_get(
                             (state.params, state.batch_stats))))
    out["sd0"] = state_dict_from_jax(variables["params"],
                                     variables["batch_stats"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    workdir = tmp_path_factory.mktemp("dp")
    jx = _jax_side()
    steps = {}
    for name, pallas_bn in (("dropout", False), ("dropout_kernel_bn", True)):
        cfg, _ = _dropout_cfg(pallas_bn)
        model = build_model(cfg, "cpu")
        steps[name] = dict(cfg=cfg, pallas_bn=pallas_bn, batch=_batch(cfg, BATCH, 3),
                           sd={k: v.clone() for k, v in model.state_dict().items()})
    for name in ("jax_mesh", "jax_grouped"):
        steps[name] = dict(cfg=jx["cfgs"][name], batch=jx["batch"], sd=jx["sd0"],
                           use_gold=[bool(c) for c in jx[name]["coins"]])
    ucfg = dataclasses.replace(PC.tiny_test("lrw1000"), batch_size=BATCH,
                               mesh=PC.MeshConfig(data=WORLD))
    steps["uni_counts"] = dict(cfg=ucfg, batch=_uni_batch(ucfg),
                               sd=build_model(ucfg, "cpu").state_dict())
    refs = {name: _step(c["cfg"], c["sd"], _whole(c["batch"]), None,
                        c.get("pallas_bn", False), c.get("use_gold"))
            for name, c in steps.items()}
    for name in ("dropout", "dropout_kernel_bn", "uni_counts"):
        steps[name]["routing"] = refs[name]["signs"]
    torch.save({"steps": steps}, workdir / "inputs.pt")

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(r), str(WORLD), str(port),
         str(workdir)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
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
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(ranks=ranks, refs=refs, jax=jx, steps=steps, workdir=workdir)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _first_lr(cfg):
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import noam_lr
    return noam_lr(0, cfg.optim.k, cfg.optim.warmup_steps, cfg.optim.lr_base_dim)


def _assert_equals_one_process(got, want, lr):
    """chip_smoke's f32 train-step tolerances on the loss, the gradients and
    the running statistics; the parameters after Adam's first step as in
    ``test_torch_port_train.py``: each within 2 lr (a gradient of rounding
    size, such as the key projections' biases, which are zero in exact
    arithmetic, takes a step of lr in either sign) and 99% of them within
    PARAM_P99_ATOL."""
    from test_torch_port_train import PARAM_P99_ATOL
    assert max(got["flips"], default=0.0) <= FLIP_MARGIN, sorted(got["flips"])[-5:]
    f32 = "float32"
    assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) <= TRAIN_LOSS_TOL[f32]
    errs = _grad_errors(got["grads"], want["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TRAIN_GRAD_TOL[f32], (worst, errs[worst])
    diffs = []
    for k, w in want["sd"].items():
        d = (got["sd"][k] - w).abs()
        if "running" in k:
            assert d.max().item() <= TRAIN_BN_TOL[f32], (k, d.max().item())
        else:
            assert d.max().item() <= 2 * lr + 1e-6, (k, d.max().item())
            diffs.append(d.ravel())
    assert torch.quantile(torch.cat(diffs), 0.99).item() <= PARAM_P99_ATOL


@pytest.mark.parametrize("case", ["dropout", "dropout_kernel_bn"])
def test_dp_step_with_dropout_equals_one_process_step(runs, case):
    want = runs["refs"][case]
    assert want["bn_type"] == ("FastBatchNorm" if case.endswith("bn")
                               else "BatchNorm")
    assert want["first_mask"] is not None and not want["first_mask"].all()
    for rank in runs["ranks"]:
        _assert_equals_one_process(rank[case], want,
                                   _first_lr(runs["steps"][case]["cfg"]))
        assert rank[case]["metrics"]["loss"] == runs["ranks"][0][case]["metrics"]["loss"]


def test_dp_batchnorm_parameter_gradients_are_counted_once(runs):
    want = runs["refs"]["dropout_kernel_bn"]["grads"]
    for rank in runs["ranks"]:
        got = rank["dropout_kernel_bn"]["grads"]
        for name in ("frontend.bn3d.weight", "frontend.bn3d.bias",
                     "frontend.resnet.layer4_block0.bn2.weight"):
            ratio = (got[name].norm() / want[name].norm()).item()
            assert abs(ratio - 1.0) < 1e-3, (name, ratio)


def test_dp_coins_are_shared_and_masks_are_each_process_rows(runs):
    want = runs["refs"]["dropout"]
    n = BATCH // WORLD
    masks = []
    for r, rank in enumerate(runs["ranks"]):
        got = rank["dropout"]
        assert got["coins"] == want["coins"] and got["coins"]
        # the frontend's feature dropout, frames folded into the batch
        per = want["first_mask"].shape[0] // BATCH
        assert torch.equal(got["first_mask"],
                           want["first_mask"][r * n * per:(r + 1) * n * per])
        masks.append(got["first_mask"])
    assert not torch.equal(masks[0], masks[1])


def test_dp_attention_masks_are_each_process_rows():
    """K3/K4/K5's batch-row map: a process's mask is its rows of the
    one-process mask, for a launch of one direction and for the decoder's
    two directions in one launch; (0, B, B) is today's mask."""
    from sbl_for_multilingual_lip_reading_tpu_torch.ops import attention
    B, W, H, Tq, Tk, seed = 6, 3, 2, 5, 7, 1234
    n = B // W
    whole = attention.dropout_keep_mask_flat_plain(2 * B, Tq, Tk, H, seed, 0.3,
                                                   "cpu")
    assert torch.equal(whole, attention.dropout_keep_mask_flat_plain(
        2 * B, Tq, Tk, H, seed, 0.3, "cpu", attention.BatchRows(0, 2 * B, 2 * B)))
    for r in range(W):
        rows = attention.BatchRows(r * n, n, B)
        one = attention.dropout_keep_mask_flat(n, Tq, Tk, H, seed, 0.3, "cpu", rows)
        assert torch.equal(one, whole[r * n:(r + 1) * n])
        two = attention.dropout_keep_mask_flat_plain(2 * n, Tq, Tk, H, seed, 0.3,
                                                     "cpu", rows)
        assert torch.equal(two, torch.cat([whole[r * n:(r + 1) * n],
                                           whole[B + r * n:B + (r + 1) * n]]))
    with pytest.raises(ValueError, match="do not lie"):
        attention.dropout_keep_mask_flat_plain(2, 1, 1, 1, 0, 0.1, "cpu",
                                               attention.BatchRows(5, 2, 6))


def _assert_matches_jax(got, want, lr):
    from test_torch_port_train import LOSS_RTOL, PARAM_P99_ATOL, STAT_ATOL
    np.testing.assert_allclose(got["metrics"]["loss"], want["loss"],
                               rtol=LOSS_RTOL)
    diffs = []
    for name, w in want["sd"].items():
        d = np.abs(got["sd"][name].numpy() - w.numpy())
        if "running" in name:
            assert d.max() <= STAT_ATOL, (name, d.max())
        else:
            assert d.max() <= 2 * lr + 1e-6, (name, d.max())
            diffs.append(d.ravel())
    assert np.percentile(np.concatenate(diffs), 99) <= PARAM_P99_ATOL


@pytest.mark.parametrize("case", ["jax_mesh", "jax_grouped"])
def test_dp_step_matches_jax(runs, case):
    """Dropout 0, JAX's coins injected: the W = 2 step against JAX's
    make_mesh(data=2) step (synchronised BatchNorm), and with
    sync_batchnorm off against JAX's GroupedBatchNorm(groups=2) step,
    whose running statistics are group 0's (process 0's half)."""
    from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import noam_lr
    cfg = runs["jax"]["cfgs"][case]
    lr = noam_lr(0, cfg.optim.k, cfg.optim.warmup_steps, cfg.optim.lr_base_dim)
    for rank in runs["ranks"]:
        _assert_matches_jax(rank[case], runs["jax"][case], lr)
    if case == "jax_grouped":
        # per-process statistics differ from the synchronised ones
        a = runs["ranks"][0]["jax_grouped"]["sd"]["frontend.bn3d.running_mean"]
        b = runs["ranks"][0]["jax_mesh"]["sd"]["frontend.bn3d.running_mean"]
        assert (a - b).abs().max().item() > 1e-4


def test_dp_no_sync_keeps_process_zero_statistics(runs):
    """--no-sync-batchnorm: the running statistics every process keeps are
    those of plain local BatchNorm on process 0's half."""
    c = runs["steps"]["jax_grouped"]
    half = {k: v[:BATCH // WORLD] for k, v in c["batch"].items()}
    local = _step(dataclasses.replace(c["cfg"], mesh=PC.MeshConfig()), c["sd"],
                  _whole(half), None, False, c["use_gold"])
    for rank in runs["ranks"]:
        for k, w in local["sd"].items():
            if "running" in k:
                assert torch.allclose(rank["jax_grouped"]["sd"][k], w,
                                      rtol=0, atol=1e-6), k


def test_dp_unequal_token_counts_take_the_global_mean(runs):
    want = runs["refs"]["uni_counts"]
    counts = [(np.asarray(runs["steps"]["uni_counts"]["batch"]["labels"][
        r * 2:(r + 1) * 2]) >= 0).sum() for r in range(WORLD)]
    assert counts[0] != counts[1]
    for rank in runs["ranks"]:
        _assert_equals_one_process(rank["uni_counts"], want,
                                   _first_lr(runs["steps"]["uni_counts"]["cfg"]))
        assert rank["uni_counts"]["metrics"]["n_correct"] == \
            want["metrics"]["n_correct"]


def test_dp_checkpoint_of_process_zero_loads_at_one_process(runs):
    cfg = dataclasses.replace(PC.tiny_test("sbl"), batch_size=BATCH)
    tr = Trainer(cfg, [], device="cpu")
    tr.restore(str(runs["workdir"] / "ckpt"))
    assert tr.state.step == 1
    got = tr.model.state_dict()
    for rank in runs["ranks"]:
        sd = rank["trainer"]["fit_sd"]
        assert set(sd) == set(got)
        for k, v in sd.items():
            assert torch.equal(v, got[k]), k


def test_dp_batcher_and_device_cache_stripes_are_equal(runs):
    cfg = dataclasses.replace(PC.tiny_test("sbl"), batch_size=BATCH)
    ds = SyntheticLipDataset(size=3 * BATCH, frames=cfg.data.frames,
                             raw_size=cfg.data.raw_size, seed=5)
    order = Batcher(ds, BATCH, shuffle=True, seed=cfg.seed).index_batches()
    plan_rng = np.random.default_rng(cfg.seed)
    for s in range(2):
        idx = next(order)
        stripes = np.concatenate([idx[p::WORLD] for p in range(WORLD)])
        whole = attach_plans(Batcher._collate([ds[int(i)] for i in stripes]),
                             plan_rng, cfg)
        for r, rank in enumerate(runs["ranks"]):
            host = rank["trainer"]["batches_cache0"][s]
            dev = rank["trainer"]["batches_cache1"][s]
            assert set(host) == set(dev)
            for k in host:
                assert np.array_equal(host[k], dev[k]), k
                assert np.array_equal(host[k], whole[k][r * 2:(r + 1) * 2]), k


def test_make_mesh_refuses_what_it_cannot_give(monkeypatch):
    """Tensor parallelism raises, naming its ROADMAP item; NCCL with more
    processes than cards raises, as JAX's make_mesh does, before any
    process group starts; a rank outside the mesh raises."""
    from sbl_for_multilingual_lip_reading_tpu_torch.parallel import mesh
    with pytest.raises(NotImplementedError, match="queue A item 17"):
        mesh.make_mesh(2, model=2, device="cpu", rank=0)
    with pytest.raises(ValueError, match="outside a mesh"):
        mesh.make_mesh(2, device="cpu", rank=2)
    monkeypatch.setattr(mesh, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        mesh.make_mesh(2, device="cuda:0", rank=0)
    assert not torch.distributed.is_initialized()


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
