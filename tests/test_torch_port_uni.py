"""CPU parity of the port's unidirectional workloads (``lrw``, ``lrw1000``)
against the JAX package: ``preprocess_targets_uni``, the cached
self-attention step, ``UniDecoder`` (teacher-forced forward, greedy with and
without the K/V cache, the step functions), ``UniTransformer`` end to end,
the variable mapping, and the evaluation entry points (``Trainer``,
``cli test``) with WER/PER equal to JAX's.

The JAX variables of ``config.tiny_test("lrw")`` / ``("lrw1000")`` are built
once per module, moved off their initial values and carried into the port
with ``state_dict_from_jax``; both sides run on the same numpy-seeded clips
and labels.  f32 on both sides, the JAX model on its XLA path: logits within
1e-4 (readings <= 1.5e-6), tokens identical.  One bf16 case, the decoder
alone from identical encoder output: the JAX decoder runs its Pallas
attention in interpret mode with XLA held to the roundings the program
states.  The f32 logits (an f32 product of 64-term rows with the tied
table) also carry f32 summation-order noise, whose size follows the CPU:
an element counts as differing only where it moves by more than
F32_ROUNDING = 1e-5 (an f32 dot of 64 terms with |x| < 4 rounds at ~1e-6).
Readings: on one AMD EPYC every bf16 hidden state identical, the logits
2.4e-7 apart, 5.5% of them differing at all; on an Intel Xeon max 3.5e-3,
26.7% differing at all, 4.2% by more than 1e-5.  The tolerance, 2^-4 with
at most a quarter of the elements differing by more than f32 rounding, is
what a one-ulp flip of a hidden state (2^-8 relative) costs the logits
(|x| < 4) on a CPU that sums in another order; tokens identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sbl_for_multilingual_lip_reading_tpu import config as C
from sbl_for_multilingual_lip_reading_tpu.data import (
    SyntheticLipDataset as JaxSyntheticLipDataset)
from sbl_for_multilingual_lip_reading_tpu.data.pipeline import (
    device_ingest as jax_device_ingest)
from sbl_for_multilingual_lip_reading_tpu.models import (
    build_model as build_jax_model)
from sbl_for_multilingual_lip_reading_tpu.models.decoder_uni import (
    preprocess_targets_uni as jax_preprocess)
from sbl_for_multilingual_lip_reading_tpu.models.layers import (
    MultiHeadAttention as JaxMHA)
from sbl_for_multilingual_lip_reading_tpu.ops import attention as jax_attention
from sbl_for_multilingual_lip_reading_tpu.training import Trainer as JaxTrainer
from sbl_for_multilingual_lip_reading_tpu_torch import cli
from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
from sbl_for_multilingual_lip_reading_tpu_torch.data import SyntheticLipDataset
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.models.decoder_uni import (
    make_uni_cache, preprocess_targets_uni)
from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import (
    MultiHeadAttention)
from sbl_for_multilingual_lip_reading_tpu_torch.models.sbl import UniTransformer
from sbl_for_multilingual_lip_reading_tpu_torch.recognize import (
    expected_launches, recognize_batch)
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
from sbl_for_multilingual_lip_reading_tpu_torch.utils import state_dict_from_jax

from test_torch_port_recognize import _bf16, _f32, _jit_exact, _perturbed

LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 2.0 ** -4
BF16_MAX_DIFFERING = 0.25
F32_ROUNDING = 1e-5
WORKLOADS = ("lrw", "lrw1000")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _labels(rng, cfg, B):
    """IGNORE-padded labels of mixed lengths, one of them full."""
    P, V = cfg.decoder.target_pad_len, cfg.decoder.vocab_size
    labels = rng.integers(2, V, size=(B, P)).astype(np.int32)
    for b, n in enumerate(rng.integers(1, P, size=B)):
        if b:
            labels[b, n:] = -1
    return labels


def _tiny(name):
    cfg = C.tiny_test(name)
    model = build_jax_model(cfg)
    T, raw, crop = cfg.data.frames, cfg.data.raw_size, cfg.data.crop_size
    key = jax.random.PRNGKey(0)
    labels0 = jnp.zeros((2, cfg.decoder.target_pad_len), jnp.int32)
    variables = jax.device_get(jax.jit(lambda: model.init(
        {"params": key, "dropout": key}, jnp.zeros((2, T, crop, crop)),
        labels0, train=False))())
    rng = np.random.default_rng(0)
    variables = _perturbed(variables, rng)
    clips = rng.integers(0, 256, size=(3, T, raw, raw), dtype=np.uint8)
    video = jax_device_ingest(jnp.asarray(clips), None, None, None, crop,
                              jnp.float32)
    enc = jax.jit(lambda v, x: model.apply(v, x, method=model.encode))(
        variables, video)
    return dict(cfg=cfg, model=model, variables=variables, clips=clips,
                video=video, enc=enc, labels=_labels(rng, cfg, 3))


@pytest.fixture(scope="module", params=WORKLOADS)
def tiny(request):
    return _tiny(request.param)


def _port(cfg, variables):
    model = build_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    return model


@pytest.mark.parametrize("maxlen,P", [(8, 12), (14, 12), (16, 14), (5, 5)])
def test_preprocess_targets_uni_matches_jax(maxlen, P):
    rng = np.random.default_rng(maxlen)
    labels = rng.integers(2, 40, size=(6, P)).astype(np.int32)
    for b, n in enumerate((0, 1, P // 2, P - 1, P, 3)):
        labels[b, n:] = -1
    want_in, want_out = jax_preprocess(jnp.asarray(labels), maxlen)
    got_in, got_out = preprocess_targets_uni(torch.from_numpy(labels), maxlen)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))


def test_decode_step_matches_jax():
    """``MultiHeadAttention.decode_step`` over three steps against JAX's, on
    one set of weights: outputs and caches."""
    D, H, d, B, L = 32, 4, 8, 3, 4
    jax_mha = JaxMHA(D, H, d, d, 0.0)
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((L, B, 1, D)).astype(np.float32)
    params = jax_mha.init(jax.random.PRNGKey(2), jnp.asarray(xs[0]),
                          jnp.asarray(xs[0]), jnp.asarray(xs[0]))
    params = _perturbed({"params": jax.device_get(params["params"])}, rng)
    port = MultiHeadAttention(D, H, d, d, dropout=0.0)
    port.load_state_dict(state_dict_from_jax(params["params"]))
    kc = vc = jnp.zeros((B, L, H * d))
    pk, pv = (torch.zeros((B, L, H * d)) for _ in range(2))
    for step in range(3):
        want, kc, vc = jax_mha.apply(params, jnp.asarray(xs[step]), kc, vc, step,
                                     method=jax_mha.decode_step)
        with torch.inference_mode():
            got, pk, pv = port.decode_step(torch.from_numpy(xs[step]), pk, pv, step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(pk.numpy(), np.asarray(kc), atol=1e-5)
        np.testing.assert_allclose(pv.numpy(), np.asarray(vc), atol=1e-5)


def test_decoder_layer_matches_jax():
    """The uncached ``DecoderLayer`` (self-attention, cross-attention over
    the encoder output, FFN, non-pad multiplies) with causal and
    encoder-length masks."""
    from sbl_for_multilingual_lip_reading_tpu.models.layers import (
        DecoderLayer as JaxDecoderLayer)
    from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import DecoderLayer
    from sbl_for_multilingual_lip_reading_tpu_torch.ops import mask_to_bias
    D, DI, H, d, B, T, Tk = 32, 64, 4, 8, 3, 5, 7
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    enc = rng.standard_normal((B, Tk, D)).astype(np.float32)
    non_pad = (np.arange(T)[None, :] < np.array([5, 3, 1])[:, None])[..., None]
    causal = np.triu(np.ones((T, T), bool), 1)[None]
    enc_pad = (np.arange(Tk)[None, None, :] >= np.array([7, 4, 2])[:, None, None])
    jax_layer = JaxDecoderLayer(D, DI, H, d, d, 0.0)
    params = jax_layer.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(enc))
    params = _perturbed({"params": jax.device_get(params["params"])}, rng)
    want = jax_layer.apply(params, jnp.asarray(x), jnp.asarray(enc),
                           jnp.asarray(non_pad, jnp.float32), jnp.asarray(causal),
                           jnp.asarray(enc_pad))
    port = DecoderLayer(D, DI, H, d, d, dropout=0.0)
    port.load_state_dict(state_dict_from_jax(params["params"]))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(enc),
                   torch.from_numpy(non_pad).float(),
                   mask_to_bias(torch.from_numpy(causal), T, T),
                   mask_to_bias(torch.from_numpy(enc_pad), T, Tk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not got[1, 3:].any() and not got[2, 1:].any()


def test_state_dict_mapping_complete_tiny(tiny):
    cfg, variables = tiny["cfg"], tiny["variables"]
    params = traverse_util.flatten_dict(variables["params"])
    stats = traverse_util.flatten_dict(variables["batch_stats"])
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    model = build_model(cfg, "cpu")
    assert isinstance(model, UniTransformer)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    assert len(got) == len(params) + len(stats)
    assert got == want
    # tied: the embedding table is the only output projection
    assert not any("tgt_word_prj" in k for k in got)
    assert "decoder.slf_attn_1.w_qs.weight" in got
    assert "decoder.cross_kv_0.w_ks.weight" in got


@pytest.mark.parametrize("name", WORKLOADS)
def test_state_dict_mapping_complete_full_dims(name):
    cfg = C.PRESETS[name]()
    model = build_jax_model(cfg)
    key = jax.random.PRNGKey(0)
    labels = jnp.zeros((2, cfg.decoder.target_pad_len), jnp.int32)
    T, crop = cfg.data.frames, cfg.data.crop_size
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key}, jnp.zeros((2, T, crop, crop)), labels,
        train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), shapes)
    got = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        zeros["params"], zeros["batch_stats"]).items()}
    want = {k: tuple(v.shape)
            for k, v in build_model(cfg, "cpu").state_dict().items()}
    assert got == want
    assert want["decoder.tgt_word_emb.weight"] == (cfg.decoder.vocab_size, 512)


def test_untied_decoder_maps_its_projection():
    cfg = C.tiny_test("lrw")
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, tie_embedding=False))
    model = build_jax_model(cfg)
    key = jax.random.PRNGKey(1)
    T, crop = cfg.data.frames, cfg.data.crop_size
    labels = jnp.zeros((2, cfg.decoder.target_pad_len), jnp.int32)
    variables = jax.device_get(jax.jit(lambda: model.init(
        {"params": key, "dropout": key}, jnp.zeros((2, T, crop, crop)), labels,
        train=False))())
    port = _port(cfg, variables)
    assert port.decoder.tgt_word_prj.weight.shape == (cfg.decoder.vocab_size, 64)
    assert port.decoder.x_logit_scale == 1.0
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, 6, 64)).astype(np.float32)
    lab = _labels(rng, cfg, 2)
    want, _ = model.apply(variables, jnp.asarray(lab), jnp.asarray(enc),
                          deterministic=True,
                          method=lambda m, l, e, deterministic: m.decoder(
                              l, e, deterministic=deterministic))
    with torch.inference_mode():
        got, _ = port.decoder(torch.from_numpy(lab), torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL)


def test_teacher_forced_logits_match_jax(tiny):
    model, variables = tiny["model"], tiny["variables"]
    want, want_gold = jax.jit(lambda v, x, l: model.apply(v, x, l, train=False))(
        variables, tiny["video"], jnp.asarray(tiny["labels"]))
    port = _port(tiny["cfg"], variables)
    with torch.inference_mode():
        got, gold = port(torch.from_numpy(np.array(tiny["video"])),
                         torch.from_numpy(tiny["labels"]))
    assert got.dtype == torch.float32
    assert got.shape == (3, tiny["cfg"].decoder.maxlen,
                         tiny["cfg"].decoder.vocab_size)
    np.testing.assert_array_equal(gold.numpy(), np.asarray(want_gold))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


def test_teacher_forced_forward_with_encoder_lengths_matches_jax(tiny):
    model, variables = tiny["model"], tiny["variables"]
    lengths = np.array([30, 11, 4], np.int32)
    want, _ = jax.jit(lambda v, e, l, n: model.apply(
        v, l, e, n, True, method=lambda m, l, e, n, d: m.decoder(l, e, n, d)))(
        variables, tiny["enc"], jnp.asarray(tiny["labels"]), jnp.asarray(lengths))
    port = _port(tiny["cfg"], variables)
    with torch.inference_mode():
        got, _ = port.decoder(torch.from_numpy(tiny["labels"]),
                              torch.from_numpy(np.array(tiny["enc"])),
                              torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


def test_decoder_is_causal(tiny):
    """A later label does not move an earlier position's logits."""
    port = _port(tiny["cfg"], tiny["variables"])
    enc = torch.from_numpy(np.array(tiny["enc"]))
    labels = torch.from_numpy(tiny["labels"].copy())
    changed = labels.clone()
    changed[0, 4] = (changed[0, 4] + 1) % tiny["cfg"].decoder.vocab_size
    with torch.inference_mode():
        a, _ = port.decoder(labels, enc)
        b, _ = port.decoder(changed, enc)
    # position t reads inputs sos, y_0 .. y_{t-1}: y_4 first enters at t=5
    assert torch.equal(a[0, :5], b[0, :5])
    assert not torch.equal(a[0, 5:], b[0, 5:])
    assert torch.equal(a[1:], b[1:])


def test_greedy_tokens_match_jax_cached_and_uncached(tiny):
    model, variables = tiny["model"], tiny["variables"]
    want = np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, method=model.recognize))(variables, tiny["video"]))
    port = _port(tiny["cfg"], variables)
    got = recognize_batch(port, torch.from_numpy(tiny["clips"]),
                          tiny["cfg"].data.crop_size)
    assert got.shape == (3, tiny["cfg"].decoder.maxlen + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    enc = torch.from_numpy(np.array(tiny["enc"]))
    with torch.inference_mode():
        cached = port.decoder.recognize_greedy(enc)
        uncached = port.decoder.recognize_greedy(enc, kv_cache=False)
        short = port.decoder.recognize_greedy(enc, maxlen=3)
    np.testing.assert_array_equal(cached.numpy(), want)
    np.testing.assert_array_equal(uncached.numpy(), want)
    np.testing.assert_array_equal(short.numpy(), want[:, :4])


def test_step_logits_match_jax(tiny):
    """``step_logits`` / ``step_logits_cached`` / ``decode_step_cached`` at
    every step of a fixed token buffer."""
    model, variables, cfg = tiny["model"], tiny["variables"], tiny["cfg"]
    L = cfg.decoder.maxlen + 1
    rng = np.random.default_rng(3)
    ys = rng.integers(2, cfg.decoder.vocab_size, size=(3, L)).astype(np.int32)
    ys[:, 0] = 0
    port = _port(cfg, variables)
    enc = torch.from_numpy(np.array(tiny["enc"]))
    dims = cfg.dims
    with torch.inference_mode():
        enc_kv = port.decoder.compute_cross_kv(enc)
        cache = make_uni_cache(3, L, dims.n_dec_layers, dims.n_head * dims.d_k,
                               dims.n_head * dims.d_v, torch.float32)
        for step in (0, 1, 4, cfg.decoder.maxlen - 1):
            want = model.apply(variables, jnp.asarray(ys), tiny["enc"], step,
                               method=lambda m, y, e, s: m.decoder.step_logits(y, e, s))
            got = port.decoder.step_logits(torch.from_numpy(ys).long(), enc, step)
            got2 = port.decoder.step_logits_cached(torch.from_numpy(ys).long(),
                                                   enc_kv, step)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL)
            assert torch.equal(got, got2)
        for step in range(cfg.decoder.maxlen):
            lg, cache = port.decoder.decode_step_cached(
                torch.from_numpy(ys[:, step]).long(), cache, enc_kv, step)
            full = port.decoder.step_logits_cached(torch.from_numpy(ys).long(),
                                                   enc_kv, step)
            np.testing.assert_allclose(lg.numpy(), full.numpy(), atol=1e-5)


def test_bf16_decoder_matches_jax():
    """``lrw1000`` at bf16 from identical encoder output: greedy tokens and
    teacher-forced logits against JAX on its Pallas attention path."""
    t = _tiny("lrw1000")
    cfg = dataclasses.replace(t["cfg"], compute_dtype="bfloat16")
    enc = jnp.asarray(t["enc"]).astype(jnp.bfloat16)
    labels = jnp.asarray(t["labels"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_attention, "available", lambda: True)
        mp.setattr(jax_attention, "fused_small_mha_flat", functools.partial(
            jax_attention.fused_small_mha_flat, interpret=True))
        model = build_jax_model(cfg)
        want, _ = _jit_exact(lambda v, e: model.apply(
            v, e, method=lambda m, e: m.decoder(labels, e, deterministic=True)),
            t["variables"], enc)
        want_ys = _jit_exact(lambda v, e: model.apply(
            v, e, method=lambda m, e: m.decoder.recognize_greedy(
                e, kv_cache=False)), t["variables"], enc)
    port = _port(cfg, t["variables"])
    with torch.inference_mode():
        got, _ = port.decoder(torch.from_numpy(t["labels"]), _bf16(enc))
        ys = port.decoder.recognize_greedy(_bf16(enc), kv_cache=False)
    diff = np.abs(_f32(got) - _f32(want))
    assert diff.max() <= BF16_LOGIT_TOL, diff.max()
    differing = (diff > F32_ROUNDING).mean()
    assert differing <= BF16_MAX_DIFFERING, differing
    np.testing.assert_array_equal(ys.numpy(), np.asarray(want_ys))


def test_expected_launches_of_a_unidirectional_model(monkeypatch):
    """The encoder's and the cached cross attention's calls go through K1's
    wrapper (one query token per step); the cached self attention is plain
    torch, as it is plain einsums in JAX."""
    from sbl_for_multilingual_lip_reading_tpu_torch.models import frontend, layers
    cfg = port_config.tiny_test("lrw1000")
    calls = {"small_mha_flat": 0, "stack_frames": 0}
    shapes = set()

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            shapes.add(tuple(args[0].shape[1:2]))
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    spy(layers, "small_mha_flat")
    spy(frontend, "stack_frames")
    clips = torch.zeros((2, cfg.data.frames, cfg.data.raw_size, cfg.data.raw_size),
                        dtype=torch.uint8)
    recognize_batch(build_model(cfg, "cpu"), clips, cfg.data.crop_size)
    expected = expected_launches(cfg)
    assert calls == {k: expected[k] for k in calls}
    assert calls["small_mha_flat"] == (cfg.dims.n_enc_layers
                                       + cfg.decoder.maxlen * cfg.dims.n_dec_layers)
    assert shapes == {(30,), (1,)}


# ------------------------------------------------- the slice as a whole
@pytest.fixture(scope="module")
def jax_trainers():
    """One JAX Trainer per workload on the synthetic data `cli test` reads."""
    out = {}
    for name in WORKLOADS:
        cfg = C.tiny_test(name)
        args = cli.build_argparser().parse_args(
            ["--synthetic", "--synthetic-size", "8"])
        ds = JaxSyntheticLipDataset(size=4, frames=cfg.data.frames,
                                    raw_size=cfg.data.raw_size, kind=name,
                                    vocab=name, seed=3 + WORKLOADS.index(name))
        out[name] = (cfg, args, ds, JaxTrainer(cfg, ds, {name: ds}))
    return out


def _variables(tr):
    return jax.device_get({"params": tr.state.params,
                           "batch_stats": tr.state.batch_stats})


def test_trainer_evaluates_and_refuses_to_train(jax_trainers):
    """The Trainer evaluates as JAX's does; it trains a unidirectional
    workload (the train step's parity is in test_torch_port_uni_train.py)
    and with grad_clip set; it refuses tensor parallelism."""
    cfg, _, ds, jtr = jax_trainers["lrw"]
    want = jtr.validate_seq2seq(ds)
    tr = Trainer(cfg, ds, {"lrw": ds}, device="cpu",
                 model=_port(cfg, _variables(jtr)))
    got = tr.validate_seq2seq(ds)
    assert set(got) == {"l2r_wer", "l2r_per"}
    assert got == pytest.approx(want)
    out = tr.fit(1, max_steps_per_epoch=1)
    assert np.isfinite(out["train_loss"]) and tr.state.step == 1
    clipped = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, grad_clip=1.0))
    tr = Trainer(clipped, ds, device="cpu", model=_port(cfg, _variables(jtr)))
    assert np.isfinite(tr.fit(1, max_steps_per_epoch=1)["train_loss"])
    # a tensor-parallel config asks for its data x model grid (the grid's
    # runs: test_torch_port_tp.py)
    from sbl_for_multilingual_lip_reading_tpu_torch import parallel
    asked = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parallel, "make_mesh", lambda *a: asked.append(a) or None)
        Trainer(dataclasses.replace(cfg, mesh=port_config.MeshConfig(model=2)),
                ds, device="cpu")
    assert asked == [(1, 2, "cpu")]


@pytest.mark.parametrize("name,extra", [
    ("lrw", []), ("lrw1000", []),
    ("lrw1000", ["--beam-size", "2"]),
    ("lrw1000", ["--beam-size", "2", "--bigram-lm"])],
    ids=["lrw-greedy", "lrw1000-greedy", "lrw1000-beam", "lrw1000-beam-bigram"])
def test_cli_test_matches_jax_validate(jax_trainers, monkeypatch, tmp_path,
                                       name, extra):
    """``cli test --cpu --workload <name>`` on a checkpoint this test saves:
    WER/PER equal to JAX's ``validate_seq2seq`` on the same weights and the
    same synthetic test split, greedy, with a beam, and with the bigram LM
    built from the TRAIN split."""
    from sbl_for_multilingual_lip_reading_tpu import cli as jax_cli
    from sbl_for_multilingual_lip_reading_tpu.decode import (
        bigram_from_dataset as jax_bigram)
    cfg, args, _, jtr = jax_trainers[name]
    train_ds, test_sets = jax_cli.make_datasets(cfg, args, eval_split="test")
    bigram = None
    if "--bigram-lm" in extra:
        bigram = jnp.log(jnp.asarray(jax_bigram(train_ds, cfg.decoder.vocab_size))
                         + 1e-10)
    beam = 2 if extra else None
    want = {k: jtr.validate_seq2seq(ds, beam_size=beam, bigram_logp=bigram)
            for k, ds in test_sets.items()}
    assert set(want) == {name}

    monkeypatch.setitem(port_config.PRESETS, name,
                        lambda: port_config.tiny_test(name))
    save = str(tmp_path / "ckpt")
    Trainer(port_config.tiny_test(name), [], {}, device="cpu",
            model=_port(cfg, _variables(jtr))).save(save)
    got = cli.run_test(["--cpu", "--workload", name, "--synthetic",
                        "--synthetic-size", "8", "--checkpoint", save] + extra)
    assert set(got) == {name}
    assert got[name] == pytest.approx(want[name])


def test_cli_train_refuses_a_unidirectional_workload(monkeypatch):
    # `train --workload lrw1000` runs (test_torch_port_uni_train.py), and
    # with --mesh-model 2 and no RANK it starts its two processes (their
    # run: test_torch_port_tp.py)
    import torch.multiprocessing as mp
    started = []
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(mp, "start_processes",
                        lambda fn, nprocs, args, **kw: started.append(
                            (fn, nprocs, args[1])))
    argv = ["--cpu", "--workload", "lrw1000", "--synthetic", "--mesh-model", "2"]
    assert cli.run_train(argv) == (None, None)
    assert started == [(cli._train_process, 2, 2)]


def test_synthetic_dataset_vocabs_match_jax():
    for vocab, kind in (("lrw", "lrw"), ("lrw1000", "lrw1000"), ("sbl", "all")):
        mine = SyntheticLipDataset(size=6, frames=3, raw_size=8, kind=kind,
                                   vocab=vocab, seed=2)
        theirs = JaxSyntheticLipDataset(size=6, frames=3, raw_size=8, kind=kind,
                                        vocab=vocab, seed=2)
        for i in range(6):
            a, b = mine[i], theirs[i]
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="vocab"):
        SyntheticLipDataset(vocab="classify")
