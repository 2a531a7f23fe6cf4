"""Tensor parallelism of the port on the CPU (the mesh's ``model`` axis):
four gloo processes started by this file (``python tests/test_torch_port_tp.py
worker RANK PORT DIR``) hold three layouts at once -- the (data 2, model 2)
grid ``make_mesh(2, 2)`` builds, two (1, 2) grids (ranks 0-1 and 2-3) and
one (1, 4) grid -- and run every case on inputs this file writes (tiny
models' weights, global batches with their plans, seeds, the one-process
steps' ReLU signs); the tests compare what they saw with the one-process
runs here:

* ``sbl`` steps with dropout on, ``remat_frontend`` and ``grad_clip``, on
  both BatchNorm routes, at model = 2, data 2 x model 2 and model = 4:
  loss, the gathered gradients, the gathered parameters after the update
  and the BN running statistics equal the one-process step's within
  ``test_torch_port_dp.py``'s tolerances (chip_smoke's f32 train-step
  tolerances, the parameters within 2 lr and 99% within PARAM_P99_ATOL);
  the clip's global norm is the one-process norm (NORM_RTOL); the
  elementwise dropout masks are the same in every model process of a data
  index (its rows of the one-process masks), and the ReLUs follow the
  one-process signs with flips within FLIP_MARGIN of 0;
* dropout 0 and JAX's coins: the (2, 2) step equals JAX's
  ``make_mesh(data=2, model=2)`` step on 8 virtual CPU devices;
* ``lrw1000`` (unequal token counts) and ``classify`` steps equal their
  one-process steps; greedy (cached) and beam decoding on the sharded
  models give the one-process tokens, and so does the SBL decode with
  K11 on (``use_fused_decoder_layer``), which launches the fused layer;
* checkpoints: written at model = 2 they load at model = 1, written at
  model = 1 each process restores its slices, and a resumed run equals an
  uninterrupted one;
* ``cli train --cpu --mesh-model 2`` starts its two processes and finishes.

Without workers: every parameter's shard decision against JAX's
``param_spec`` at model = 2 and 4, K3/K4/K5's head offset, and
``state_dict_from_jax`` into a sharded model.

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
for p in (REPO, REPO / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from sbl_for_multilingual_lip_reading_tpu_torch import config as PC  # noqa: E402
from sbl_for_multilingual_lip_reading_tpu_torch.data import (  # noqa: E402
    SyntheticLipDataset)
from sbl_for_multilingual_lip_reading_tpu_torch.models import (  # noqa: E402
    build_model, layers)
from sbl_for_multilingual_lip_reading_tpu_torch.ops import attention  # noqa: E402
from sbl_for_multilingual_lip_reading_tpu_torch.parallel import mesh as M  # noqa: E402
from sbl_for_multilingual_lip_reading_tpu_torch.training import state  # noqa: E402
from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (  # noqa: E402
    make_optimizer)
from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (  # noqa: E402
    make_train_step)
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import (  # noqa: E402
    Trainer)

from test_torch_port_dp import (  # noqa: E402  (the dp file's inputs and checks)
    BATCH, GRAD_CLIP, STEP_SEED, _assert_equals_one_process,
    _assert_matches_jax, _batch, _first_lr, _uni_batch, _whole)

WORLD = 4
WORKER_TIMEOUT = 300
# the clip's norm: the gradients it sums differ within the step's tolerance
# and the sharded squares add in another order (readings <= 6.4e-7)
NORM_RTOL = 1e-5


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _step_cfg(name="sbl", **over):
    cfg = PC.tiny_test(name)
    return dataclasses.replace(
        cfg, batch_size=BATCH, remat_frontend=True,
        optim=dataclasses.replace(cfg.optim, grad_clip=GRAD_CLIP), **over)


def _eval_cfg(name, **over):
    return dataclasses.replace(PC.tiny_test(name), batch_size=BATCH, **over)


def _video(cfg, seed=8):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((2, cfg.data.frames, cfg.data.crop_size,
                       cfg.data.crop_size), generator=g)


# ---------------------------------------------------------------------------
# one step, recorded (both sides)
# ---------------------------------------------------------------------------

def _part(full, shape, mesh):
    """A process's part of a one-process tensor: the model index's columns
    of the last axis where the widths differ, and the data index's rows of
    the first other axis that differs (the batch axis; the frontend folds
    frames into it, the decoder keeps a direction axis before it)."""
    t = full
    if t.shape[-1] != shape[-1]:
        n = shape[-1]
        assert t.shape[-1] == mesh.model_size * n
        t = t.narrow(-1, mesh.model_rank * n, n)
    for a in range(t.dim() - 1):
        if t.shape[a] != shape[a]:
            n = shape[a]
            assert t.shape[a] == mesh.size * n
            t = t.narrow(a, mesh.rank * n, n)
            break
    assert t.shape == shape, (tuple(full.shape), tuple(shape))
    return t


class _Recorder:
    """Records the teacher-forcing coins, the elementwise dropout masks, the
    clip's global norm and each ReLU's input signs; given ``routing`` (the
    one-process step's signs) every ReLU passes x where the one-process
    input at the process's part was > 0, and |x| goes to ``flips`` where
    x's own sign disagrees (``test_torch_port_dp.py``'s ``_Recorder``)."""

    def __init__(self, monkey, routing=None, mesh=None):
        self.coins, self.masks, self.signs, self.flips = [], [], [], []
        self.norms = []
        coins, keep = layers.DropoutRNG.coins, layers.DropoutRNG.keep
        relu = torch.nn.functional.relu
        clip = state.clip_by_global_norm_
        todo = iter(routing or ())

        def rec_relu(x, inplace=False):
            if routing is None:
                self.signs.append(x.detach() > 0)
                return relu(x)
            full = next(todo)
            sign = full if mesh is None else _part(full, x.shape, mesh)
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
            if len(self.masks) < 4:
                self.masks.append(out.clone())
            return out

        def rec_clip(params, max_norm):
            norm = clip(params, max_norm)
            self.norms.append(norm.item())
            return norm
        monkey.setattr(layers.DropoutRNG, "coins", rec_coins)
        monkey.setattr(layers.DropoutRNG, "keep", rec_keep)
        monkey.setattr(state, "clip_by_global_norm_", rec_clip)


def _whole_grads(model, mesh):
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    plan = getattr(model, "tp_plan", {})
    return {n: M.gather_from_model(g, mesh, plan[n][0]) if n in plan else g
            for n, g in grads.items()}


def _step(cfg, sd, batch, mesh=None, pallas_bn=False, use_gold=None,
          routing=None):
    """One train step of ``cfg`` from the whole state ``sd`` on ``batch``
    (the process's rows), sharded over ``mesh``'s model group when given:
    loss, metrics, the whole gradients and state after, and what
    ``_Recorder`` saw."""
    with pytest.MonkeyPatch.context() as mp:
        if pallas_bn:
            mp.setenv("PALLAS_BN", "1")
        else:
            mp.delenv("PALLAS_BN", raising=False)
        model = build_model(cfg, "cpu")
        model.load_state_dict(sd)
        if mesh is not None:
            M.shard_model(model, mesh)
        rec = _Recorder(mp, routing, mesh)
        step = make_train_step(model, make_optimizer(model, cfg.optim), cfg, mesh)
        kw = {} if use_gold is None else {"use_gold": use_gold}
        out = step(batch, torch.Generator().manual_seed(STEP_SEED), **kw)
        grads = _whole_grads(model, mesh)
    return dict(metrics={k: v.item() for k, v in out.items()}, grads=grads,
                sd={k: v.clone() for k, v in M.gather_state_dict(
                    model.state_dict(), model).items()},
                coins=rec.coins, masks=rec.masks, norms=rec.norms,
                signs=rec.signs, flips=rec.flips,
                sharded=sorted(getattr(model, "tp_plan", {})))


# ---------------------------------------------------------------------------
# eval, trainer and checkpoints (both sides)
# ---------------------------------------------------------------------------

def _decode(cfg, sd, mesh=None):
    """Greedy and beam tokens of a model of ``cfg`` (K11's launches with
    ``use_fused_decoder_layer``)."""
    from sbl_for_multilingual_lip_reading_tpu_torch.decode.beam import (
        make_sbl_beam_decoder, make_uni_beam_decoder)
    from sbl_for_multilingual_lip_reading_tpu_torch.models import decoder_sbl
    from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import (
        cast_dense_weights)
    model = build_model(cfg, "cpu")
    model.load_state_dict(sd)
    if mesh is not None:
        M.shard_model(model, mesh)
    video = _video(cfg)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        fused = decoder_sbl.fused_decoder_layer
        mp.setattr(decoder_sbl, "fused_decoder_layer",
                   lambda *a, **k: calls.append(1) or fused(*a, **k))
        with torch.inference_mode():
            greedy = model.recognize(video)
        with torch.inference_mode(), cast_dense_weights(model):
            cast = model.recognize(video)
        if cfg.decoder.bidirectional:
            beam = make_sbl_beam_decoder(model, 2)(video)
        else:
            beam = make_uni_beam_decoder(model, 2)(video)
    return dict(greedy=greedy, cast=cast, beam=beam, fused_calls=len(calls))


def _trainer_cfg():
    return dataclasses.replace(PC.tiny_test("sbl"), batch_size=BATCH)


def _trainer_ds(cfg):
    return SyntheticLipDataset(size=BATCH, frames=cfg.data.frames,
                               raw_size=cfg.data.raw_size, seed=5)


def _trainer_cases(mesh, workdir):
    """At model = 2: one epoch with a checkpoint, a resume of it, two
    uninterrupted epochs, and a restore of the one-process checkpoint."""
    cfg = _trainer_cfg()
    ds = _trainer_ds(cfg)
    out = {}
    tag = f"pair{torch.distributed.get_rank() // 2}"

    def sd_of(tr):
        return {k: v.clone() for k, v in M.gather_state_dict(
            tr.model.state_dict(), tr.model).items()}
    tr = Trainer(cfg, ds, {}, checkpoint_dir=str(workdir / f"ckpt_{tag}"),
                 device="cpu", mesh=mesh)
    tr.fit(1, max_steps_per_epoch=1)
    out["fit_sd"] = sd_of(tr)
    tr = Trainer(cfg, ds, {}, device="cpu", mesh=mesh)
    start = tr.restore(str(workdir / f"ckpt_{tag}")) + 1
    tr.fit(2, max_steps_per_epoch=1, start_epoch=start)
    out["resumed_sd"] = sd_of(tr)
    tr = Trainer(cfg, ds, {}, device="cpu", mesh=mesh)
    tr.fit(2, max_steps_per_epoch=1)
    out["uninterrupted_sd"] = sd_of(tr)
    tr = Trainer(cfg, ds, {}, device="cpu", mesh=mesh)
    tr.restore(str(workdir / "ckpt_one"))
    out["restored_local"] = {k: v.clone() for k, v in tr.model.state_dict().items()}
    out["restored_adam"] = {
        n: (tr.model.tp_plan[n][0], tr.optimizer.state[p]["exp_avg"].clone())
        for n, p in tr.model.named_parameters() if n in tr.model.tp_plan}
    return out


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _layouts(rank, port):
    """The three meshes of this process (every process creates every group,
    in the same order)."""
    import torch.distributed as dist
    g22 = M.make_mesh(2, 2, device="cpu", rank=rank,
                      init_method=f"tcp://localhost:{port}")
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    singles = [dist.new_group([r]) for r in range(WORLD)]
    g12 = M.DataMesh(0, 1, torch.device("cpu"), "gloo", rank % 2, 2,
                     singles[rank], pairs[rank // 2])
    g14 = M.DataMesh(0, 1, torch.device("cpu"), "gloo", rank, 4,
                     singles[rank], None)
    return {"g22": g22, "g12": g12, "g14": g14}


def _worker(rank, port, workdir):
    torch.set_num_threads(1)
    workdir = Path(workdir)
    meshes = _layouts(rank, port)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    results = {}
    for name, case in inputs["steps"].items():
        mesh = meshes[case["layout"]]
        n = BATCH // mesh.size
        batch = {k: torch.from_numpy(np.ascontiguousarray(
            v[mesh.rank * n:(mesh.rank + 1) * n])) for k, v in case["batch"].items()}
        results[name] = _step(case["cfg"], case["sd"], batch, mesh,
                              case.get("pallas_bn", False), case.get("use_gold"),
                              case.get("routing"))
    for name, case in inputs["decodes"].items():
        results[name] = _decode(case["cfg"], case["sd"], meshes["g12"])
    results["trainer"] = _trainer_cases(meshes["g12"], workdir)
    torch.save(results, workdir / f"rank{rank}.pt")
    M.shutdown()


# ---------------------------------------------------------------------------
# the fixture: inputs, workers, references
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _jax_side():
    """JAX's make_mesh(data=2, model=2) step at dropout 0 on the perturbed
    tiny init (test_torch_port_dp.py's ``_jax_side`` on the (2, 2) mesh)."""
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

    cfgs = []
    for mod in (JC, PC):
        cfg = mod.tiny_test("sbl")
        cfgs.append(dataclasses.replace(
            cfg, batch_size=BATCH,
            dims=dataclasses.replace(cfg.dims, dropout=0.0),
            frontend=dataclasses.replace(cfg.frontend, dropout=0.0),
            optim=dataclasses.replace(cfg.optim, adam_eps=TEST_ADAM_EPS),
            mesh=mod.MeshConfig(data=2, model=2)))
    jcfg, pcfg = cfgs
    T, crop = jcfg.data.frames, jcfg.data.crop_size
    key = jax.random.PRNGKey(0)
    labels = jnp.zeros((2, jcfg.decoder.target_pad_len), jnp.int32)
    variables = jax.device_get(jax.jit(lambda: build_jax_model(jcfg).init(
        {"params": key, "dropout": key, "teacher": key},
        jnp.zeros((2, T, crop, crop)), labels, labels, train=False))())
    variables = _perturbed(variables, np.random.default_rng(3))
    batch = _batch(pcfg, BATCH, 6)
    rng = jax.random.PRNGKey(5)
    model = build_jax_model(jcfg)
    step = make_jax_step(model, jax_schedule.make_optimizer(jcfg.optim), jcfg)
    st = _jax_state(jcfg, variables)
    mesh = jax_mesh(data=2, model=2)
    with mesh:
        st = st.replace(params=shard_params(st.params, mesh),
                        batch_stats=shard_params(st.batch_stats, mesh))
        qs = st.params["encoder"]["layer_0"]["slf_attn"]["w_qs"]["kernel"]
        assert not qs.sharding.is_fully_replicated
        jbatch = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        compiled = step.lower(st, jbatch, rng).compile(XLA_OPTIONS)
        st, metrics = compiled(st, jbatch, rng)
    return dict(cfg=pcfg, batch=batch, loss=float(metrics["loss"]),
                coins=_jax_coins(model, jcfg, rng, 0),
                sd0=state_dict_from_jax(variables["params"],
                                        variables["batch_stats"]),
                sd=state_dict_from_jax(*jax.device_get(
                    (st.params, st.batch_stats))))


def _cli_train(tmp):
    """``cli train --cpu --mesh-model 2`` at tiny dims, started in the
    background (it starts its two processes itself)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    argv = [sys.executable, "-m", "sbl_for_multilingual_lip_reading_tpu_torch.cli",
            "train", "--cpu", "--mesh-model", "2", "--synthetic",
            "--synthetic-size", "4", "--batch-size", "2", "--d_model", "16",
            "--n_head", "2", "--d_inner", "32", "--n_layers_enc", "1",
            "--n_layers_dec", "1", "--epochs", "1", "--max-steps-per-epoch",
            "1", "--max-eval-batches", "1", "--save-dir", str(tmp / "cli_ckpt")]
    return argv, subprocess.Popen(argv, cwd=REPO, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    workdir = tmp_path_factory.mktemp("tp")
    cli_argv, cli = _cli_train(workdir)
    steps, decodes = {}, {}
    for layout, pallas_bn in (("g12", False), ("g12", True), ("g22", False),
                              ("g22", True), ("g14", False)):
        cfg = _step_cfg()
        steps[f"sbl_{layout}_bn{int(pallas_bn)}"] = dict(
            cfg=cfg, layout=layout, pallas_bn=pallas_bn,
            batch=_batch(cfg, BATCH, 3),
            sd={k: v.clone() for k, v in build_model(cfg, "cpu").state_dict().items()})
    ucfg = _step_cfg("lrw1000")
    steps["uni_g22"] = dict(cfg=ucfg, layout="g22", batch=_uni_batch(ucfg),
                            sd=build_model(ucfg, "cpu").state_dict())
    ccfg = _step_cfg("classify")
    steps["classify_g12"] = dict(cfg=ccfg, layout="g12",
                                 batch=_batch(ccfg, BATCH, 4),
                                 sd=build_model(ccfg, "cpu").state_dict())
    jx = _jax_side()
    steps["jax_g22"] = dict(cfg=jx["cfg"], layout="g22", batch=jx["batch"],
                            sd=jx["sd0"], use_gold=[bool(c) for c in jx["coins"]])
    refs = {name: _step(c["cfg"], c["sd"], _whole(c["batch"]), None,
                        c.get("pallas_bn", False), c.get("use_gold"))
            for name, c in steps.items()}
    for name, c in steps.items():
        if name != "jax_g22":
            c["routing"] = refs[name]["signs"]
    for name, cfg in (("decode_sbl", _eval_cfg("sbl")),
                      ("decode_sbl_k11", _eval_cfg(
                          "sbl", use_fused_decoder_layer=True)),
                      ("decode_uni", _eval_cfg("lrw1000"))):
        decodes[name] = dict(cfg=cfg, sd=build_model(cfg, "cpu").state_dict())
    dec_refs = {name: _decode(c["cfg"], c["sd"]) for name, c in decodes.items()}
    # the one-process checkpoint the workers restore at model = 2
    cfg = _trainer_cfg()
    one = Trainer(cfg, _trainer_ds(cfg), {}, device="cpu")
    one.fit(1, max_steps_per_epoch=1)
    one.save(str(workdir / "ckpt_one"))
    torch.save({"steps": steps, "decodes": decodes}, workdir / "inputs.pt")

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(r), str(port), str(workdir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs + [cli]:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs + [cli]:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [log[-3000:] for p, log in zip(procs + [cli], logs)
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(ranks=ranks, refs=refs, dec_refs=dec_refs, jax=jx, steps=steps,
                workdir=workdir, one=one, cli_log=logs[-1], cli_argv=cli_argv)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sbl_g12_bn0", "sbl_g12_bn1", "sbl_g22_bn0",
                                  "sbl_g22_bn1", "sbl_g14_bn0"])
def test_tp_step_with_dropout_equals_one_process_step(runs, case):
    want = runs["refs"][case]
    assert want["masks"] and not want["masks"][0].all()
    lr = _first_lr(runs["steps"][case]["cfg"])
    for rank in runs["ranks"]:
        got = rank[case]
        assert got["sharded"], "nothing was sharded"
        _assert_equals_one_process(got, want, lr)
        assert got["metrics"]["loss"] == runs["ranks"][0][case]["metrics"]["loss"]


@pytest.mark.parametrize("case", ["sbl_g12_bn0", "sbl_g22_bn1", "sbl_g14_bn0"])
def test_tp_grad_clip_norm_is_the_one_process_norm(runs, case):
    want = runs["refs"][case]["norms"]
    assert len(want) == 1 and want[0] > GRAD_CLIP      # the clip acts
    for rank in runs["ranks"]:
        assert rank[case]["norms"] == pytest.approx(want, rel=NORM_RTOL)


@pytest.mark.parametrize("case", ["sbl_g12_bn0", "sbl_g22_bn0", "sbl_g14_bn0"])
def test_tp_elementwise_masks_equal_across_model_processes(runs, case):
    """Dropout on whole activations draws the same mask in every model
    process of a data index: its rows of the one-process mask; the coins
    are the one-process coins."""
    want = runs["refs"][case]
    layout = runs["steps"][case]["layout"]
    data = 2 if layout == "g22" else 1
    model = 4 if layout == "g14" else 2
    for r, rank in enumerate(runs["ranks"]):
        got = rank[case]
        assert got["coins"] == want["coins"] and got["coins"]
        d = (r // model) if data > 1 else 0
        for g, w in zip(got["masks"], want["masks"]):
            axis = next(a for a in range(w.dim()) if w.shape[a] != g.shape[a]) \
                if g.shape != w.shape else None
            if axis is None:
                assert torch.equal(g, w)
            else:
                n = g.shape[axis]
                assert torch.equal(g, w.narrow(axis, d * n, n))
        peer = runs["ranks"][r ^ 1][case]["masks"]   # the other model index
        assert all(torch.equal(a, b) for a, b in zip(got["masks"], peer))


def test_tp_step_matches_jax_mesh_2x2(runs):
    """Dropout 0, JAX's coins injected: the (2, 2) grid's step against JAX's
    make_mesh(data=2, model=2) step."""
    cfg = runs["jax"]["cfg"]
    lr = _first_lr(cfg)
    for rank in runs["ranks"]:
        _assert_matches_jax(rank["jax_g22"], runs["jax"], lr)


@pytest.mark.parametrize("case", ["uni_g22", "classify_g12"])
def test_tp_uni_and_classify_steps_equal_one_process(runs, case):
    want = runs["refs"][case]
    lr = _first_lr(runs["steps"][case]["cfg"])
    for rank in runs["ranks"]:
        _assert_equals_one_process(rank[case], want, lr)
    if case == "uni_g22":
        counts = [(np.asarray(runs["steps"][case]["batch"]["labels"][
            d * 2:(d + 1) * 2]) >= 0).sum() for d in range(2)]
        assert counts[0] != counts[1]
        # JAX's rules leave the decoder's fc and FFN whole: only the
        # projections shard there
        sharded = runs["ranks"][0][case]["sharded"]
        assert "decoder.slf_attn_0.w_qs.weight" in sharded
        assert "decoder.slf_attn_0.fc.weight" not in sharded
        assert "decoder.pos_ffn_0.w_1.weight" not in sharded
        assert "encoder.layer_0.slf_attn.fc.weight" in sharded


@pytest.mark.parametrize("case", ["decode_sbl", "decode_sbl_k11", "decode_uni"])
def test_tp_decoding_gives_the_one_process_tokens(runs, case):
    want = runs["dec_refs"][case]
    for rank in runs["ranks"]:
        got = rank[case]
        for key in ("greedy", "cast", "beam"):
            for g, w in zip(got[key], want[key]):
                if g.dtype.is_floating_point:      # beam scores
                    assert torch.allclose(g, w, rtol=0, atol=1e-5), key
                else:
                    assert torch.equal(g, w), key


def test_tp_k11_switch_launches_the_fused_layer(runs):
    """Under tensor parallelism ``use_fused_decoder_layer`` runs the fused
    layer on the gathered weights, every step and layer of both decodes
    (greedy twice, beam), never the module path."""
    cfg = runs["steps"]["sbl_g12_bn0"]["cfg"]
    per_decode = cfg.dims.n_dec_layers * cfg.decoder.maxlen
    want = runs["dec_refs"]["decode_sbl_k11"]["fused_calls"]
    assert want >= 3 * per_decode
    for rank in runs["ranks"]:
        assert rank["decode_sbl_k11"]["fused_calls"] == want
        assert rank["decode_sbl"]["fused_calls"] == 0


def test_tp_checkpoint_loads_at_one_process_and_resumes(runs):
    """A checkpoint written at model = 2 loads at model = 1 (the whole
    state); one written at model = 1 restores each process's slices, with
    Adam's moments; a resumed run equals an uninterrupted one."""
    cfg = _trainer_cfg()
    for pair in (0, 1):
        tr = Trainer(cfg, [], device="cpu")
        tr.restore(str(runs["workdir"] / f"ckpt_pair{pair}"))
        assert tr.state.step == 1
        got = tr.model.state_dict()
        for rank in runs["ranks"][2 * pair:2 * pair + 2]:
            for k, v in rank["trainer"]["fit_sd"].items():
                assert torch.equal(v, got[k]), k
    one = runs["one"]
    whole = one.model.state_dict()
    for r, rank in enumerate(runs["ranks"]):
        tr = rank["trainer"]
        for k, v in tr["restored_local"].items():
            w = whole[k]
            if v.shape != w.shape:
                dim = next(a for a in range(w.dim()) if w.shape[a] != v.shape[a])
                w = w.chunk(2, dim)[r % 2]
            assert torch.equal(v, w), k
        names = dict(one.model.named_parameters())
        assert tr["restored_adam"]
        for n, (dim, m) in tr["restored_adam"].items():
            w = one.optimizer.state[names[n]]["exp_avg"]
            assert torch.equal(m, w.chunk(2, dim)[r % 2]), n
        for k, v in tr["uninterrupted_sd"].items():
            assert torch.equal(v, tr["resumed_sd"][k]), k


def test_tp_cli_train_starts_its_processes(runs):
    log = runs["cli_log"]
    assert "epoch 0 train_loss" in log, log[-2000:]
    ckpt = torch.load(runs["workdir"] / "cli_ckpt" / "checkpoint.pt",
                      weights_only=True)
    # written whole: every tensor has the one-process model's shape
    from sbl_for_multilingual_lip_reading_tpu_torch import cli
    cfg = cli.config_from_args(cli.build_argparser().parse_args(
        runs["cli_argv"][runs["cli_argv"].index("train") + 1:]))
    whole = build_model(cfg, "cpu").state_dict()
    assert cfg.mesh.model == 2 and set(ckpt["model"]) == set(whole)
    for k, v in whole.items():
        assert ckpt["model"][k].shape == v.shape, k
    assert ckpt["step"] == 1


# ---------------------------------------------------------------------------
# without workers
# ---------------------------------------------------------------------------

def _jax_variables(name, shapes_only=False):
    import jax
    import jax.numpy as jnp
    from sbl_for_multilingual_lip_reading_tpu import config as JC
    from sbl_for_multilingual_lip_reading_tpu.models import (
        build_model as build_jax_model)
    cfg = JC.tiny_test(name)
    key = jax.random.PRNGKey(0)
    T, crop = cfg.data.frames, cfg.data.crop_size
    model = build_jax_model(cfg)
    video = jnp.zeros((2, T, crop, crop))
    if name == "classify":
        init = lambda: model.init({"params": key, "dropout": key}, video,  # noqa: E731
                                  train=False)
    elif cfg.decoder.bidirectional:
        labels = jnp.zeros((2, cfg.decoder.target_pad_len), jnp.int32)
        init = lambda: model.init(  # noqa: E731
            {"params": key, "dropout": key, "teacher": key}, video, labels,
            labels, train=False)
    else:
        labels = jnp.zeros((2, cfg.decoder.target_pad_len), jnp.int32)
        init = lambda: model.init({"params": key, "dropout": key}, video,  # noqa: E731
                                  labels, train=False)
    if shapes_only:
        return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                      jax.eval_shape(init))
    return jax.device_get(jax.jit(init)())


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("name", ["sbl", "lrw1000", "classify"])
def test_shard_decisions_equal_jax_param_spec(name, model_size):
    """Every JAX parameter of the tiny model: the port's decision (the plan
    of ``shard_model``, under the parameter's port name) is JAX's
    ``param_spec`` on its path, the sharded dim mapped to the port's layout
    ((..., in, out) there, (..., out, in) here); the column-parallel biases
    JAX keeps whole follow their weights here."""
    from flax import traverse_util
    from sbl_for_multilingual_lip_reading_tpu.parallel import (
        make_mesh as jax_mesh, param_spec as jax_param_spec)
    from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
        state_dict_from_jax)
    variables = _jax_variables(name, shapes_only=True)
    mesh = jax_mesh(data=8 // model_size, model=model_size)
    model = build_model(PC.tiny_test(name), "cpu")
    plan = M.shard_plan(model, model_size)
    port_sd = model.state_dict()
    seen = 0
    for path, a in traverse_util.flatten_dict(variables["params"]).items():
        jpath = "/".join(path)
        key = next(iter(state_dict_from_jax(
            traverse_util.unflatten_dict({path: a}))))
        assert key in port_sd, key
        spec = tuple(jax_param_spec(jpath, np.shape(a), mesh))
        port_dim = plan.get(key, (None,))[0]
        assert M.param_spec(key, tuple(port_sd[key].shape), model_size) == (
            None if "model" not in spec else port_sd[key].dim() - (
                2 if spec.index("model") == len(spec) - 1 else 1)), jpath
        if path[-1] == "kernel":
            if "model" in spec:
                seen += 1
                want = a.ndim - 2 if spec.index("model") == a.ndim - 1 else a.ndim - 1
                assert port_dim == want, jpath
            else:
                assert port_dim is None, jpath
        elif path[-1] == "bias" and key in plan:
            weight = key[:-len("bias")] + "weight"
            assert plan[weight][0] == port_sd[weight].dim() - 2, jpath
            assert plan[key][0] == port_sd[key].dim() - 1
        else:
            assert key not in plan, jpath
    assert seen > 0


def test_heads_that_do_not_divide_stay_whole():
    """The port's one decision of its own: 3 heads at model = 2 (JAX would
    split a head's columns) keep the attention whole; the FFN still shards,
    and the sharded model's step equals the whole one's."""
    cfg = PC.tiny_test("sbl")
    cfg = dataclasses.replace(cfg, dims=dataclasses.replace(
        cfg.dims, d_model=48, n_head=3, d_k=16, d_v=16))
    plan = M.shard_plan(build_model(cfg, "cpu"), 2)
    assert M.param_spec("encoder.layer_0.slf_attn.w_qs.weight", (48, 48), 2) == 0
    assert "encoder.layer_0.slf_attn.w_qs.weight" not in plan
    assert "decoder.cross_kv_0.w_ks.weight" not in plan
    assert plan["encoder.layer_0.pos_ffn.w_1.weight"][0] == 0


@pytest.mark.parametrize("model_size", [2, 4])
def test_head_offset_masks_are_the_process_heads(model_size):
    """K3/K4/K5's head map: a process launching its H/M heads at h0 = m H/M
    draws heads [h0, h0 + H/M) of the one-process masks (with the batch-row
    map too), and its K3/K4 plain outputs are those heads' columns of the
    one-process outputs; h0 = 0 is today's mask."""
    B, H, Tq, Tk, d, seed, rate = 3, 4, 5, 7, 8, 4321, 0.3
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(B, T, H * d, generator=g)
                     for T in (Tq, Tk, Tk, Tq))
    whole = attention.dropout_keep_mask_flat_plain(B, Tq, Tk, H, seed, rate, "cpu")
    assert torch.equal(whole, attention.dropout_keep_mask_flat_plain(
        B, Tq, Tk, H, seed, rate, "cpu", h0=0))
    out = attention.small_mha_dropout_fwd_flat(q, k, v, H, None, seed, rate)
    grads = attention.small_mha_dropout_bwd_flat(q, k, v, H, None, seed, rate,
                                                 None, dout)
    rows = attention.BatchRows(1, 2, 3)
    mapped = attention.dropout_keep_mask_flat_plain(2, Tq, Tk, H, seed, rate,
                                                    "cpu", rows)
    n = H // model_size
    for m in range(model_size):
        h0, cols = m * n, slice(m * n * d, (m + 1) * n * d)
        assert torch.equal(attention.dropout_keep_mask_flat(
            B, Tq, Tk, n, seed, rate, "cpu", h0=h0), whole[:, h0:h0 + n])
        assert torch.equal(attention.dropout_keep_mask(
            B, Tq, Tk, n, seed, rate, "cpu", h0=h0), whole[:, h0:h0 + n])
        assert torch.equal(attention.dropout_keep_mask_flat_plain(
            2, Tq, Tk, n, seed, rate, "cpu", rows, h0), mapped[:, h0:h0 + n])
        local = [t[..., cols].contiguous() for t in (q, k, v, dout)]
        got = attention.small_mha_dropout_fwd_flat(*local[:3], n, None, seed,
                                                   rate, h0=h0)
        assert torch.allclose(got, out[..., cols], rtol=0, atol=1e-6)
        got = attention.small_mha_dropout_bwd_flat(*local[:3], n, None, seed,
                                                   rate, None, local[3], h0=h0)
        for a, b in zip(got, grads):
            assert torch.allclose(a, b[..., cols], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="head offset"):
        attention.dropout_keep_mask_flat_plain(1, 1, 1, 1, 0, 0.1, "cpu", h0=-1)


def test_state_dict_from_jax_into_a_sharded_model():
    """The same JAX numpy parameters give each process its slices: every
    entry of ``state_dict_from_jax(..., model=sharded)`` is the process's
    chunk of the whole entry (the plan's dim), and it loads."""
    from sbl_for_multilingual_lip_reading_tpu_torch.utils import (
        state_dict_from_jax)
    variables = _jax_variables("sbl")
    whole = state_dict_from_jax(variables["params"], variables["batch_stats"])
    for m in range(2):
        model = build_model(PC.tiny_test("sbl"), "cpu")
        M.shard_model(model, M.DataMesh(0, 1, torch.device("cpu"), "gloo", m, 2))
        local = state_dict_from_jax(variables["params"],
                                    variables["batch_stats"], model=model)
        assert set(local) == set(whole)
        for k, v in local.items():
            w = whole[k]
            if k in model.tp_plan:
                w = w.chunk(2, model.tp_plan[k][0])[m]
                assert v.shape != whole[k].shape
            assert torch.equal(v, w), k
        model.load_state_dict(local)


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
