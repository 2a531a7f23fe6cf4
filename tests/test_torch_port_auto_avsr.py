"""The port's Auto-AVSR model (``models/conformer.py``, the ``ctc_attention``
kind), its CTC prefix scorer (``decode/ctc_prefix.py``) and its joint
CTC/attention beam (``decode/beam.py``) against the plain reference
``port_bench/reference/auto_avsr_vsr.py`` (no JAX: the JAX package has no such
model), in float32 at a tiny size: d 64, 4 heads of 16, 2 Conformer blocks
and 2 decoder layers, a depthwise conv of 7 taps, 50 ids, at most 40
frames.

Also: the Swish frontend's one-pass eval route against its module route;
the prefix scorer and the reference's against a brute-force sum over every
CTC alignment; the beam's frontier rule under its own numbers; a
mixed-length batch equal, utterance by utterance, to each utterance alone;
the benchmark's seeded weights drawing every entry of the model; the
reference importing nothing of the program, of JAX or of flax; the kernel
shape check split into the evaluation and the training kernels; the
Trainer refusing the kind.
"""
import dataclasses
import itertools
import math
import sys
from pathlib import Path

import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu_torch import config as C
from sbl_for_multilingual_lip_reading_tpu_torch import models
from sbl_for_multilingual_lip_reading_tpu_torch.data.ingest import device_ingest
from sbl_for_multilingual_lip_reading_tpu_torch.decode import ctc_prefix as P
from sbl_for_multilingual_lip_reading_tpu_torch.decode.beam import (
    make_ctc_attention_beam_decoder)
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model, conformer, frontend
from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import cast_dense_weights

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from port_bench.core.weights import _kind, seeded_state  # noqa: E402
from port_bench.reference import auto_avsr_vsr as R  # noqa: E402

TOL = 1e-5
V, MAXLEN, K = 50, 6, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_cfg() -> C.CTCAttentionConfig:
    cfg = C.auto_avsr_vsr()
    return dataclasses.replace(
        cfg,
        dims=C.TransformerDims(d_model=64, n_head=4, d_k=16, d_v=16, d_inner=128,
                               n_enc_layers=2, n_dec_layers=2),
        frontend=C.FrontendConfig(conv3d_channels=8, resnet_channels=(8, 16, 32, 64),
                                  resnet_blocks=(1, 1, 1, 1), feature_dim=64),
        decoder=dataclasses.replace(cfg.decoder, vocab_size=V, maxlen=MAXLEN),
        data=dataclasses.replace(cfg.data, frames=40, raw_size=40, crop_size=32),
        conformer=dataclasses.replace(cfg.conformer, cnn_module_kernel=7, beam_size=K),
        compute_dtype="float32", batch_size=3)


def ref_cfg(cfg) -> dict:
    return dict(resnet_blocks=list(cfg.frontend.resnet_blocks), d_model=cfg.dims.d_model,
                n_head=cfg.dims.n_head, n_enc_layers=cfg.dims.n_enc_layers,
                n_dec_layers=cfg.dims.n_dec_layers, crop_size=cfg.data.crop_size,
                mean=cfg.data.mean, std=cfg.data.std)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    model = build_model(cfg, device="cpu")
    state = seeded_state(model, 2024, "cpu")
    model.load_state_dict(state)
    g = torch.Generator().manual_seed(3)
    clips = torch.randint(0, 256, (3, 24, 40, 40), generator=g, dtype=torch.uint8)
    lengths = torch.tensor([24, 13, 19])
    return cfg, model, R.Weights(state), clips, lengths


def video_of(cfg, clips, lengths):
    return device_ingest(clips, cfg.data.crop_size, torch.float32, n_frames=lengths,
                         mean=cfg.data.mean, std=cfg.data.std)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# ------------------------------------------------------------------ the model
def test_the_preset_builds_at_the_published_widths():
    cfg = C.auto_avsr_vsr()
    with torch.device("meta"):
        fe = frontend.frontend_from_config(cfg.frontend, activation="swish")
        model = conformer.ctc_attention_from_config(cfg, fe, torch.bfloat16)
    assert 249e6 < sum(p.numel() for p in model.parameters()) < 251e6
    assert C.model_kind(cfg) == "ctc_attention"
    assert (cfg.dims.d_model, cfg.dims.n_head, cfg.dims.d_inner, cfg.dims.n_enc_layers,
            cfg.dims.n_dec_layers, cfg.decoder.vocab_size) == (768, 12, 3072, 12, 6, 5049)
    assert (cfg.conformer.cnn_module_kernel, cfg.conformer.beam_size,
            int(cfg.conformer.pre_beam_ratio * cfg.conformer.beam_size)) == (31, 40, 60)


@pytest.mark.parametrize("blocks", [(1, 1, 1, 1), (2, 2, 2, 2)])
def test_the_swish_frontend_on_both_routes_and_against_the_reference(blocks):
    fe = frontend.VisualFrontend(8, (8, 16, 32, 64), blocks, 64, activation="swish",
                                 use_kernels=False).eval()
    g = torch.Generator().manual_seed(1)
    for m in fe.modules():
        for bn in (m,) if isinstance(m, frontend.BatchNorm) else ():
            bn.weight.data = torch.randn(bn.weight.shape, generator=g).abs() + 0.5
            bn.weight.data[::3] *= -1          # negative scales too
            bn.bias.data = torch.randn(bn.bias.shape, generator=g) * 0.1
            bn.running_mean.data = torch.randn(bn.running_mean.shape, generator=g) * 0.1
            bn.running_var.data = torch.rand(bn.running_var.shape, generator=g) + 0.5
    fe.init_weights(g)
    for m in fe.modules():
        if isinstance(m, frontend.BasicBlock):
            m.init_weights(g)
    x = torch.randn(2, 9, 32, 32, generator=g)
    module_route = fe(x).detach()                     # autograd on: the module path
    calls = frontend.bn_eval_.calls
    with torch.no_grad():
        one_pass = fe(x)
    assert frontend.bn_eval_.calls - calls == 1 + 2 * sum(blocks) + 3
    assert rel_err(one_pass, module_route) < TOL
    W = R.Weights({"frontend." + k: v for k, v in fe.state_dict().items()})
    for b in range(2):
        ref = R.frontend(x[b], W, {"resnet_blocks": list(blocks)})
        assert rel_err(one_pass[b], ref) < TOL


def test_swish_is_chosen_at_build_and_takes_no_k10():
    fe = frontend.VisualFrontend(8, (8, 16, 32, 64), (1, 1, 1, 1), 64,
                                 use_kernels=False).eval()
    assert not fe.swish and not fe.resnet.layer1_block0.swish
    swish = frontend.VisualFrontend(8, (8, 16, 32, 64), (1, 1, 1, 1), 64,
                                    use_kernels=False, use_pallas_resblock=True,
                                    activation="swish").eval()
    x = torch.zeros(1, 8, 16, 16)
    assert not swish.resnet.layer1_block0._fused_eligible(x)   # K10 never under Swish
    with pytest.raises(ValueError, match="activation"):
        frontend.VisualFrontend(activation="gelu")


def test_fused_bn_act_falls_back_under_swish(monkeypatch):
    monkeypatch.setenv("FUSED_BN_ACT", "1")
    assert frontend.batchnorm_kind() is frontend.FusedBNAct
    assert frontend.batchnorm_kind(swish=True) is frontend.BatchNorm


def test_a_conformer_block_against_the_reference(tiny):
    cfg, model, W, _, _ = tiny
    g = torch.Generator().manual_seed(4)
    T, d = 17, cfg.dims.d_model
    x = torch.randn(1, T, d, generator=g)
    enc = model.encoder
    with torch.no_grad():
        got = enc.layer_0(x, enc.pos_emb(T), None, None)[0]
    p = "encoder.layer_0"
    h = x[0]
    h = h + 0.5 * R.ffn(R.layer_norm(h, W, p + ".layer_norm_ff_macaron"), W,
                        p + ".feed_forward_macaron", "f32", R.swish)
    h = h + R.rel_mha(R.layer_norm(h, W, p + ".layer_norm_mha"), W, p + ".self_attn",
                      cfg.dims.n_head, "f32")
    h = h + R.conv_module(R.layer_norm(h, W, p + ".layer_norm_conv"), W,
                          p + ".conv_module", "f32")
    h = h + 0.5 * R.ffn(R.layer_norm(h, W, p + ".layer_norm_ff"), W, p + ".feed_forward",
                        "f32", R.swish)
    want = R.layer_norm(h, W, p + ".layer_norm_final")
    assert rel_err(got, want) < TOL


def test_the_ctc_log_probs_against_the_reference(tiny):
    cfg, model, W, clips, lengths = tiny
    with torch.no_grad():
        enc = model.encode(video_of(cfg, clips, lengths), lengths)
        lp = model.ctc.log_probs(enc)
    for b in range(3):
        n = int(lengths[b])
        e = R.encode(clips[b, :n], W, ref_cfg(cfg))
        assert rel_err(enc[b, :n], e) < TOL
        assert (lp[b, :n] - R.ctc_log_probs(e, W)).abs().max() < TOL * 10


def test_the_cached_decoder_steps_against_the_full_forward(tiny):
    cfg, model, W, clips, lengths = tiny
    dec = model.decoder
    g = torch.Generator().manual_seed(5)
    B, L = 3, MAXLEN + 1
    ys = torch.randint(1, V - 1, (B * 2, L), generator=g)
    ys[:, 0] = model.sos_id
    with torch.no_grad(), cast_dense_weights(model):
        enc = model.encode(video_of(cfg, clips, lengths), lengths)
        kv = dec.compute_cross_kv(enc)
        bias = torch.where(torch.arange(enc.shape[1])[None] < lengths[:, None], 0.0,
                           -1e9)[:, None, :].expand(B, 2, -1).contiguous()
        cache = models.decoder_uni.make_uni_cache(B * 2, L, dec.n_layers,
                                                  *dec.cache_widths(), torch.float32, "cpu")
        steps = []
        for s in range(MAXLEN):
            logits, cache = dec.decode_step_cached(ys[:, s], cache, kv, s, bias)
            steps.append(logits)
    got = torch.stack(steps, 1)                                   # (B*2, MAXLEN, V)
    for b in range(B):
        n = int(lengths[b])
        mem = R.encode(clips[b, :n], W, ref_cfg(cfg))
        want = R.decoder_logits(ys[2 * b:2 * b + 2, :-1], mem, W, ref_cfg(cfg))
        assert rel_err(got[2 * b:2 * b + 2], want) < TOL


# ------------------------------------------------------------ the CTC prefixes
def brute_force(x: torch.Tensor, prefix, cands, blank, eos):
    """log P(the labels begin with prefix + c), by every alignment; for eos
    log P(the labels are the prefix)."""
    T, Vs = x.shape
    out = {c: [] for c in cands}
    for a in itertools.product(range(Vs), repeat=T):
        logp = float(sum(x[t, a[t]] for t in range(T)))
        labels, prev = [], None
        for s in a:
            if s != blank and s != prev:
                labels.append(s)
            prev = s
        for c in cands:
            if c == eos:
                hit = labels == list(prefix)
            else:
                hit = labels[:len(prefix) + 1] == list(prefix) + [c]
            if hit:
                out[c].append(logp)
    return torch.tensor([torch.logsumexp(torch.tensor(v, dtype=torch.float64), 0).item()
                         if v else -math.inf for v in (out[c] for c in cands)])


def port_scores(x_tbv, lengths, b, prefix, cands, blank, eos, sos):
    """The port's scores of cands after prefix for utterance b, the state
    built label by label as the beam builds it."""
    state = P.initial_state(x_tbv, 1, blank)
    B = x_tbv.shape[1]
    last = torch.full((B,), sos)
    for step, label in enumerate(prefix):
        ids = torch.full((B, 1), label)
        psi, rec = P.ctc_prefix(x_tbv, lengths, state, last, ids, step, blank, eos)
        state = P.select(rec, psi, step, torch.arange(B), torch.zeros(B, dtype=torch.int64))
        last = torch.full((B,), label)
    ids = torch.tensor(cands)[None].expand(B, -1).contiguous()
    psi, _ = P.ctc_prefix(x_tbv, lengths, state, last, ids, len(prefix), blank, eos)
    return psi[b].to(torch.float64)


@pytest.mark.parametrize("prefix", [(), (1,), (2, 1), (1, 1), (2, 3, 2)])
def test_the_prefix_scorers_against_every_alignment(prefix):
    g = torch.Generator().manual_seed(len(prefix) * 7 + sum(prefix))
    T, Vs, blank, eos = 6, 5, 0, 4
    x = torch.log_softmax(torch.randn(2, T, Vs, generator=g) * 2, dim=-1)
    lengths = torch.tensor([T, 4])
    cands = [0, 1, 2, 3, 4]
    x_tbv = P.frames_first(x, lengths, blank)
    for b in range(2):
        n = int(lengths[b])
        want = brute_force(x[b, :n], prefix, cands, blank, eos)
        mine = port_scores(x_tbv, lengths, b, prefix, cands, blank, eos, sos=eos)
        ref = R.prefix_scores(x[b, :n], torch.tensor([prefix], dtype=torch.int64),
                              torch.tensor([cands]), blank, eos)[0].to(torch.float64)
        possible = torch.isfinite(want)
        assert possible[1:].any()
        assert (mine[possible] - want[possible]).abs().max() < 1e-4
        assert (ref[possible] - want[possible]).abs().max() < 1e-4
        # impossible prefixes: the reference -inf, the port at its logzero
        assert (ref[~possible] == -math.inf).all()
        assert (mine[~possible] < -1e9).all()


def test_the_prefix_scores_of_a_beam_against_the_reference(tiny):
    cfg, model, W, clips, lengths = tiny
    beam = make_ctc_attention_beam_decoder(model, cfg)
    seen = []
    beam.watch = seen.append
    toks, _ = beam(video_of(cfg, clips, lengths), lengths)
    with torch.no_grad():
        for b in range(3):
            n = int(lengths[b])
            x = R.ctc_log_probs(R.encode(clips[b, :n], W, ref_cfg(cfg)), W)
            for rec in seen[:4]:
                s = rec["step"]
                prefixes = rec["tokens"][b, :, 1:s + 1]
                live = ~rec["finished"][b]
                want = R.prefix_scores(x, prefixes, rec["ids"][b], model.blank_id,
                                       model.eos_id)
                got = rec["psi"][b]
                ok = live[:, None] & torch.isfinite(want) & (want > -1e5)
                assert ok.any()
                assert (got[ok] - want[ok]).abs().max() < 1e-3


# --------------------------------------------------------------------- the beam
def test_the_frontier_keeps_the_k_best_candidates(tiny):
    cfg, model, _, clips, lengths = tiny
    beam = make_ctc_attention_beam_decoder(model, cfg)
    seen = []
    beam.watch = seen.append
    toks, scores = beam(video_of(cfg, clips, lengths), lengths)
    assert toks.shape == (3, K, MAXLEN + 1) and scores.shape == (3, K)
    assert (toks[:, :, 0] == model.sos_id).all()
    assert (scores[:, 1:] <= scores[:, :-1]).all()
    eos, w = model.eos_id, cfg.conformer.ctc_weight
    for rec in seen:
        B, Kk, Cc = rec["cand"].shape
        assert Cc == int(cfg.conformer.pre_beam_ratio * K) + 1
        flat = rec["cand"].reshape(B, -1)
        kth = flat.sort(dim=1, descending=True).values[:, K - 1]
        kept = torch.gather(flat, 1, rec["parent"] * Cc + rec["slot"])
        assert torch.equal(kept, rec["new_scores"])
        assert (kept >= kth[:, None]).all()
        # the candidates' scores from their parts
        logp = torch.log_softmax(rec["logits"], -1).view(B, Kk, -1)
        dec = torch.gather(logp, 2, rec["ids"])
        live = ~rec["finished"]
        want = rec["scores"][..., None] + (1 - w) * dec + w * (
            rec["psi"] - rec["psi_prev"][..., None])
        ok = live[..., None] & (rec["cand"] > -1e8)
        assert torch.allclose(rec["cand"][ok], want[ok], atol=1e-5)
        assert (rec["ids"][..., -1] == eos).all()
        # a finished hypothesis continues with eos alone, at no cost
        frozen = rec["cand"][rec["finished"]]
        if frozen.numel():
            assert torch.equal(frozen[:, -1], rec["scores"][rec["finished"]])
            assert (frozen[:, :-1] < -1e8).all()
    # no hypothesis repeats another of its utterance
    for b in range(3):
        assert len({tuple(t.tolist()) for t in toks[b]}) == K


def test_each_utterance_of_a_mixed_batch_as_alone(tiny):
    cfg, model, _, clips, lengths = tiny
    beam = make_ctc_attention_beam_decoder(model, cfg)
    video = video_of(cfg, clips, lengths)
    with torch.no_grad():
        enc = model.encode(video, lengths)
    toks, scores = beam(video, lengths)
    for b in range(3):
        n = int(lengths[b])
        one = video_of(cfg, clips[b:b + 1, :n], lengths[b:b + 1])
        with torch.no_grad():
            alone = model.encode(one, lengths[b:b + 1])
        assert (enc[b, :n] - alone[0]).abs().max() < TOL
        t1, s1 = beam(one, lengths[b:b + 1])
        assert torch.equal(t1[0], toks[b])
        assert (s1[0] - scores[b]).abs().max() < TOL


def test_the_spans_and_the_prefix_counter(tiny):
    from sbl_for_multilingual_lip_reading_tpu_torch.utils import profiler
    cfg, model, _, clips, lengths = tiny
    beam = make_ctc_attention_beam_decoder(model, cfg)
    video = video_of(cfg, clips, lengths)
    before = P.ctc_prefix.cells
    with profiler.recording():
        beam(video, lengths)
        spans = profiler.drain()
    C, N, T = int(1.5 * K) + 1, 3 * K, clips.shape[1]
    assert P.ctc_prefix.cells - before == sum(
        (T - max(s, 1) + 1) * N * C for s in range(MAXLEN))
    by = {}
    for sp in spans:
        by.setdefault(sp.name, []).append(sp)
    assert [sp.ids["layer"] for sp in by["conformer.layer"]] == [0, 1]
    assert len(by["ctc.head"]) == 1
    assert [sp.ids["pos"] for sp in by["ctc.prefix"]] == list(range(MAXLEN))
    ids = {sp.id: sp for sp in spans}
    assert all(ids[sp.parent].name == "encoder" for sp in by["conformer.layer"])
    assert all(ids[sp.parent].name == "decode.step" for sp in by["ctc.prefix"])
    assert ids[by["ctc.head"][0].parent].name == "decode"
    # off, the search records nothing
    beam(video, lengths)
    assert profiler.drain() == []


# ------------------------------------------------------- the benchmark's parts
def test_the_seeded_weights_draw_every_entry(tiny):
    cfg, model, _, _, _ = tiny
    state = model.state_dict()
    drawn = seeded_state(model, 7, "cpu")
    assert set(drawn) == set(state)
    for name, t in state.items():
        kind = _kind(name, t.shape)
        if t.dim() == 1:
            assert kind != "dense", name
        if "layer_norm" in name or name.rsplit(".", 2)[-2] == "bn":
            assert kind.startswith("norm_") or kind.startswith("running"), name
        assert drawn[name].shape == t.shape


def test_the_reference_imports_nothing_of_the_program():
    text = (ROOT / "port_bench" / "reference" / "auto_avsr_vsr.py").read_text()
    for name in ("sbl_for_multilingual_lip_reading_tpu", "jax", "flax"):
        assert f"import {name}" not in text and f"from {name}" not in text


# ------------------------------------------------- kernel shapes, the Trainer
def test_the_kernel_shape_check_splits_eval_from_training_kernels():
    cfg = C.auto_avsr_vsr()
    assert cfg.data.frames == 155 and not models.trained(cfg)
    models.check_kernel_shapes(cfg)               # K3/K4 would not take 155 frames
    with pytest.raises(ValueError, match="shared memory"):
        models.check_train_kernel_shapes(cfg)
    with pytest.raises(ValueError, match="head widths"):
        models.check_kernel_shapes(dataclasses.replace(
            cfg, dims=dataclasses.replace(cfg.dims, n_head=16, d_k=48, d_v=48)))
    sbl = C.sbl()
    assert models.trained(sbl)
    with pytest.raises(ValueError, match="shared memory"):
        models.check_kernel_shapes(dataclasses.replace(
            sbl, data=dataclasses.replace(sbl.data, frames=155)))


def test_the_trainer_refuses_the_ctc_attention_kind():
    from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
    with pytest.raises(ValueError, match="evaluation only"):
        Trainer(tiny_cfg(), train_dataset=None, device="cpu")
