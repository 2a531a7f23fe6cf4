"""The plain reference against the port at tiny sizes on the CPU, where
the port takes its kernels' plain versions, in float32: the reference's
logits at the served tokens are the port's, and its beam scores the
beam's."""
import dataclasses

import numpy as np
import pytest
import torch

from port_bench.core.traffic import make_clips
from port_bench.core.weights import seeded_state
from port_bench.reference import bigram as BG
from port_bench.reference import model as R
from port_bench.tests.conftest import TINY

torch.set_num_threads(2)


def build(name, seed):
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    cfg = C.tiny_test(name)
    model = build_model(cfg, device="cpu")
    state = seeded_state(model, seed, "cpu")
    model.load_state_dict(state)
    mc = dict(resnet_blocks=list(cfg.frontend.resnet_blocks),
              n_enc_layers=cfg.dims.n_enc_layers, n_dec_layers=cfg.dims.n_dec_layers,
              n_head=cfg.dims.n_head, crop_size=cfg.data.crop_size)
    g = torch.Generator().manual_seed(seed)
    clips = make_clips(g, 6, cfg.data.frames, cfg.data.raw_size, "cpu")
    return cfg, model, R.Weights(state), mc, clips


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_sbl_logits_at_the_served_tokens(seed):
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import recognize_batch
    cfg, model, W, mc, clips = build("sbl", seed)
    out = recognize_batch(model, clips, cfg.data.crop_size)
    ys = torch.stack([out.ys_l2r, out.ys_r2l])
    with torch.no_grad():
        ref = R.sbl_teacher_forced(ys, R.encode(clips, W, mc), W, mc)
    prog = torch.stack([out.logits_l2r, out.logits_r2l])
    assert (prog - ref).abs().max().item() < 1e-4
    assert torch.equal(ref.argmax(-1), ys[..., 1:])


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 1])
def test_uni_greedy_tokens_and_logits(seed):
    from sbl_for_multilingual_lip_reading_tpu_torch.recognize import recognize_batch
    cfg, model, W, mc, clips = build("lrw1000", seed)
    ids = recognize_batch(model, clips, cfg.data.crop_size)
    with torch.no_grad():
        enc = R.encode(clips, W, mc)
        ref = R.uni_logits(ids[:, :-1], enc, W, mc)
        prog = model.decoder.step_logits(ids, model.encode(R.ingest(clips, mc["crop_size"])), 3)
    assert torch.equal(ref.argmax(-1), ids[:, 1:])
    assert (prog - ref[:, 3]).abs().max().item() < 1e-4


def test_beam_scores():
    from sbl_for_multilingual_lip_reading_tpu_torch.data.ingest import device_ingest
    from sbl_for_multilingual_lip_reading_tpu_torch.decode.beam import make_uni_beam_decoder
    cfg, model, W, mc, clips = build("lrw1000", 5)
    big = BG.seeded_bigram_logp(5, cfg.decoder.vocab_size,
                                dict(sequences=300, min_len=2, max_len=6, floor=1e-6))
    tok, sc = make_uni_beam_decoder(model, 3, torch.from_numpy(big))(
        device_ingest(clips, cfg.data.crop_size, torch.float32))
    n, K, L = tok.shape
    flat = tok.reshape(n * K, L)
    with torch.no_grad():
        lg = R.uni_logits(flat[:, :-1], R.encode(clips, W, mc).repeat_interleave(K, 0), W, mc)
    ref = R.beam_scores(flat, lg, torch.from_numpy(big))
    assert (ref - sc.reshape(-1)).abs().max().item() < 1e-4


@pytest.mark.parametrize("seed,K", [(6, 5), (2 ** 31 + 11, 3)])
def test_the_reference_beam_search_is_the_programs(seed, K):
    """The plain search (the whole prefix run again each step, the
    frontier kept as a list of the clip's hypotheses) finds the program's
    hypotheses and scores, in float32."""
    from sbl_for_multilingual_lip_reading_tpu_torch.data.ingest import device_ingest
    from sbl_for_multilingual_lip_reading_tpu_torch.decode.beam import make_uni_beam_decoder
    cfg, model, W, mc, clips = build("lrw1000", seed)
    mc = dict(mc, vocab_size=cfg.decoder.vocab_size, maxlen=cfg.decoder.maxlen)
    big = BG.seeded_bigram_logp(seed, cfg.decoder.vocab_size,
                                dict(sequences=300, min_len=2, max_len=6, floor=1e-6))
    tok, sc = make_uni_beam_decoder(model, K, torch.from_numpy(big))(
        device_ingest(clips, cfg.data.crop_size, torch.float32))
    with torch.no_grad():
        ref_tok, ref_sc = R.beam_search(R.encode(clips, W, mc), W, mc, K, torch.from_numpy(big))
    assert torch.equal(ref_tok, tok)
    assert (ref_sc - sc).abs().max().item() < 1e-4


def test_bigram_copy_matches_the_port():
    from sbl_for_multilingual_lip_reading_tpu_torch.decode.bigram import build_bigram_matrix
    seqs = BG.seeded_sequences(9, 50, 48, 2, 8)
    np.testing.assert_array_equal(BG.build_bigram_matrix(seqs, 48, floor=1e-6),
                                  build_bigram_matrix(seqs, 48, floor=1e-6))


def test_control_rounds_through_float8():
    x = torch.linspace(-3, 3, 101)
    y = R.q8(x, "fp8")
    assert not torch.equal(x, y) and (x - y).abs().max() < 3 * 2 ** -4
    assert R.q8(x, "f32") is x
    with pytest.raises(ValueError):
        R.q8(x, "int4")


def test_tiny_overrides_match_the_tiny_preset():
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    t = C.tiny_test("sbl")
    assert t.dims.d_model == TINY["dims"]["d_model"]
    assert list(t.frontend.resnet_channels) == TINY["frontend"]["resnet_channels"]
    assert dataclasses.asdict(t.data)["crop_size"] == TINY["data"]["crop_size"]
