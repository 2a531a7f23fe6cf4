"""Print the CPU readings behind the tolerances of the port's parity tests
(the numbers of PERF.md's "CPU readings"), from the tests' own fixtures.

    JAX_PLATFORMS=cpu python tests/torch_port_readings.py train [plain]
    JAX_PLATFORMS=cpu python tests/torch_port_readings.py eval
    JAX_PLATFORMS=cpu python tests/torch_port_readings.py routing [FIRST LAST [FILE...]]

``train``: three train steps of the port against JAX, per step the loss,
the BN statistics and the parameters, and the one-step gradients per
tensor, with the test's XLA options and Adam epsilon; ``plain`` compiles
JAX with XLA's default options and the production epsilon instead, which on
some CPUs shows the faulty frontend gradient.  ``ATEN_CPU_CAPABILITY=default``
in the environment takes torch off its AVX2/AVX-512 paths.  ``eval``: the
plain versions of K9, K10 and K11 against the Pallas kernels in interpret
mode, and the unidirectional decoder in f32 and bf16.  ``routing``: the
step and gradient tests of ``test_torch_port_train.py`` (``sbl``),
``test_torch_port_uni_train.py`` and ``test_torch_port_classify.py`` at
each perturbation seed FIRST..LAST (default 1..24), four processes at a
time, each seed's outcome with the elements on which the port's ReLU sign
disagrees with JAX's (the count held to the step-0 margin, the largest |x|
held to each margin) and, for the ``sbl`` files, the largest distance
between a port ReLU input and the JAX input it was matched with
(``routing [FIRST LAST] [FILE...]`` runs only the named files of
ROUTING_TESTS).  The train readings run the port on JAX's routing, as the
tests do.  Not a test:
pytest does not collect it.
"""
import dataclasses
import functools
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]

import jax.numpy as jnp
import numpy as np
import pytest
import torch


def train_readings(plain: bool) -> None:
    import test_torch_port_train as T
    if plain:
        T.XLA_OPTIONS = {}
    eps = 1e-9 if plain else T.TEST_ADAM_EPS
    setup = T._setup()
    for mode in T.FUSION_MODES:
        cfg = T._cfg(mode, adam_eps=eps)
        _, want = T._jax_steps(cfg, T._jax_state(cfg, setup["variables"]),
                               setup["batches"])
        model, opt = T._port(cfg, setup["variables"])
        step = T.make_sbl_train_step(model, opt, cfg)
        for i, (batch, w) in enumerate(zip(setup["batches"], want)):
            with T.jax_routing_by_value(w["relu"], []):
                m = step(T._torch_batch(batch), torch.Generator().manual_seed(i),
                         use_gold=w["coins"])
            if i == 0:
                grads, _ = T._jax_grads(cfg, setup["variables"], batch)
                rel, zero = [], []
                for n, p in model.named_parameters():
                    g, ref = p.grad.numpy(), grads[n].numpy()
                    if "w_ks.bias" in n:     # zero in exact arithmetic
                        zero.append(max(np.abs(g).max(), np.abs(ref).max()))
                    else:
                        rel.append((np.abs(g - ref).max() / np.abs(ref).max(), n))
                print(f"{mode} gradients: worst {max(rel)[0]:.3g} of max|g| at "
                      f"{max(rel)[1]}; zero-gradient tensors <= {max(zero):.3g}")
            sd = model.state_dict()
            stat = max(np.abs(sd[n].numpy() - t.numpy()).max()
                       for n, t in w["sd"].items() if "running" in n)
            d = np.concatenate([np.abs(sd[n].numpy() - t.numpy()).ravel()
                                for n, t in w["sd"].items() if "running" not in n])
            print(f"{mode} step {i} (adam_eps {eps}): loss rel "
                  f"{abs(m['loss'].item() - w['loss']) / w['loss']:.3g}, BN "
                  f"{stat:.3g}, parameters p99 {np.percentile(d, 99):.3g} max "
                  f"{d.max():.3g}")


def eval_readings() -> None:
    import jax
    import test_torch_port_eval_kernels as E
    import test_torch_port_uni as U
    torch.set_num_threads(1)
    for name in U.WORKLOADS:
        t = U._tiny(name)
        model, variables = t["model"], t["variables"]
        want, _ = jax.jit(lambda v, x, l: model.apply(v, x, l, train=False))(
            variables, t["video"], jnp.asarray(t["labels"]))
        port = U._port(t["cfg"], variables)
        with torch.inference_mode():
            got, _ = port(torch.from_numpy(np.array(t["video"])),
                          torch.from_numpy(t["labels"]))
        print(f"{name} f32 teacher-forced logits: max diff "
              f"{np.abs(got.numpy() - np.asarray(want)).max():.3g}")
    t = U._tiny("lrw1000")
    cfg = dataclasses.replace(t["cfg"], compute_dtype="bfloat16")
    enc = jnp.asarray(t["enc"]).astype(jnp.bfloat16)
    labels = jnp.asarray(t["labels"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(U.jax_attention, "available", lambda: True)
        mp.setattr(U.jax_attention, "fused_small_mha_flat", functools.partial(
            U.jax_attention.fused_small_mha_flat, interpret=True))
        model = U.build_jax_model(cfg)
        want, _ = U._jit_exact(lambda v, e: model.apply(
            v, e, method=lambda m, e: m.decoder(labels, e, deterministic=True)),
            t["variables"], enc)
    port = U._port(cfg, t["variables"])
    with torch.inference_mode():
        got, _ = port.decoder(torch.from_numpy(t["labels"]), U._bf16(enc))
    d = np.abs(U._f32(got) - U._f32(want))
    print(f"lrw1000 bf16 decoder logits: max diff {d.max():.3g}, share "
          f"differing {(d > 0).mean():.3g}")

    rng = np.random.default_rng(1)
    clips = rng.integers(0, 256, size=(2, 5, 32, 32), dtype=np.uint8)
    for dt in ("float32", "bfloat16"):
        want = E.jax_stem.stack_frames_u8(jnp.asarray(clips), 24,
                                          dtype=jnp.dtype(dt), kt=5, interpret=True)
        got = E.ops.stack_frames_u8(torch.from_numpy(clips), 24, getattr(torch, dt))
        print(f"K9 {dt}: max diff "
              f"{np.abs(got.float().numpy() - np.asarray(want, np.float32)).max():.3g}")
    for shape in E.RESBLOCK_SHAPES:
        args = E._resblock_inputs(*shape, seed=shape[2])
        want = np.asarray(E.jax_resblock.fused_resblock(
            *(jnp.asarray(a) for a in args), interpret=True))
        got = E._port_resblock(*args, torch.float32)
        print(f"K10 f32 {shape}: {np.abs(got - want).max() / np.abs(want).max():.3g} "
              f"of the largest element")
    for shape in E.RESBLOCK_SHAPES[:2]:
        x, w1, a1, b1, w2, a2, b2 = E._resblock_inputs(*shape, seed=shape[2])
        bf = jnp.bfloat16
        want = np.asarray(E.jax_resblock.fused_resblock(
            jnp.asarray(x, bf), jnp.asarray(w1, bf), a1, b1, jnp.asarray(w2, bf),
            a2, b2, interpret=True), np.float32)
        got = E._port_resblock(x, w1, a1, b1, w2, a2, b2, torch.bfloat16)
        print(f"K10 bf16 {shape}: max diff {np.abs(got - want).max():.3g}, share "
              f"differing {(got != want).mean():.3g}")
    for mask in ("unmasked", "causal", "partial_prefix"):
        params, h, kh, vh = E._jax_layer(seed=1)
        B, L, D = h.shape
        m = E._masks(L)[mask]
        bias = None if m is None else np.where(m, -1e9, 0.0).astype(np.float32)
        want = np.asarray(E.jax_layer.fused_decoder_layer(
            h, *E.jax_layer.layer_params_to_args(params), ckh=kh, cvh=vh,
            mask_bias=None if bias is None else jnp.asarray(bias), interpret=True))
        got = E.ops.fused_decoder_layer(
            E._t(h)[None], *E._port_args(params), E._t(kh).reshape(1, B, -1, D),
            E._t(vh).reshape(1, B, -1, D), kh.shape[2],
            mask_bias=None if bias is None else E._t(bias))
        print(f"K11 f32 {mask}: max diff {np.abs(got[0].numpy() - want).max():.3g}")


ROUTING_TESTS = {
    "sbl": ("test_torch_port_train",
            "three_train_steps or one_step_gradients or frozen_prefix"),
    "sbl_bf16": ("test_torch_port_train_bf16", "bf16_train_step"),
    "uni": ("test_torch_port_uni_train",
            "match_jax and (steps or gradients)"),
    "classify": ("test_torch_port_classify",
                 "three_classify or gradients")}


def routing_one(which: str, seed: int) -> None:
    """One file's step and gradient tests at one perturbation seed; prints
    one JSON line: the largest |x| the tests held to each flip margin, the
    count held to the step-0 margin, and the largest distance between a
    port ReLU input and the JAX input it was matched with."""
    import json
    import test_torch_port_train as T
    import test_torch_port_uni_train as U
    name, select = ROUTING_TESTS[which]
    mod = __import__(name)
    mod.PERTURB_SEED = T.PERTURB_SEED = seed
    lists, checked, distances = [], [], []
    check = T._assert_flips_within_margin

    def recording(route, by_value):
        def routing(relu_inputs, flips, *args, **kw):
            lists.append(flips)
            if by_value:
                kw["distances"] = distances
            return route(relu_inputs, flips, *args, **kw)
        return routing

    def record(flips, margin=T.FLIP_MARGIN):
        checked.append((margin, flips))
        check(flips, margin)
    routes = {n: recording(getattr(T, n), n == "jax_routing_by_value")
              for n in ("jax_routing", "jax_routing_by_value")}
    for m in (T, U, mod):
        for n, fn in routes.items():
            if hasattr(m, n):
                setattr(m, n, fn)
        m._assert_flips_within_margin = record
    rc = pytest.main(["-q", "-p", "no:cacheprovider", mod.__file__, "-k", select])
    maxima = {}
    for margin, flips in checked:
        key = f"{margin:g}"
        maxima[key] = max(maxima.get(key, 0.0), max(flips, default=0.0))
    unchecked = [x for flips in lists
                 if not any(flips is c for _, c in checked) for x in flips]
    print(json.dumps(dict(
        which=which, seed=seed, passed=int(rc) == 0,
        step0_flips=sum(len(f) for m, f in checked if m == T.FLIP_MARGIN),
        max_by_margin=maxima, unchecked_max=max(unchecked, default=0.0),
        match_max=max(distances, default=0.0))), flush=True)


def routing_readings(first: int, last: int, files=()) -> None:
    import json
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    def run(job):
        which, seed = job
        res = subprocess.run([sys.executable, __file__, "routing-one", which,
                              str(seed)], capture_output=True, text=True,
                             check=False)
        return json.loads(res.stdout.strip().splitlines()[-1])
    files = list(files) or list(ROUTING_TESTS)
    jobs = [(w, s) for w in files for s in range(first, last + 1)]
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(run, jobs))
    for which in files:
        mine = [r for r in results if r["which"] == which]
        for r in mine:
            print(json.dumps(r))
        maxima = {}
        for r in mine:
            for key, v in r["max_by_margin"].items():
                maxima[key] = max(maxima.get(key, 0.0), v)
        print(f"{which}: {sum(r['passed'] for r in mine)} of {len(mine)} seeds "
              f"pass; step-0 sign disagreements {sum(r['step0_flips'] for r in mine)}"
              f" over {sum(bool(r['step0_flips']) for r in mine)} seeds; largest "
              f"|x| by margin {maxima}; unchecked "
              f"{max(r['unchecked_max'] for r in mine):.3g}; largest match "
              f"distance {max(r['match_max'] for r in mine):.3g}")

if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "eval"
    if which == "train":
        train_readings(plain="plain" in sys.argv[2:])
    elif which == "routing":
        first, last = map(int, sys.argv[2:4]) if len(sys.argv) > 3 else (1, 24)
        routing_readings(first, last, sys.argv[4:])
    elif which == "routing-one":
        routing_one(sys.argv[2], int(sys.argv[3]))
    else:
        eval_readings()
