"""CPU parity of the port's beam search (``decode/beam.py``,
``decode/bigram.py``, ``utils/hypotheses.py``) against the JAX package: each
case of the JAX package's ``tests/test_beam.py`` runs through the JAX
function and its counterpart on the same inputs; tokens must be equal and
scores within 1e-5 (f32 log-softmax sums; readings <= 1e-6).  Several cases
build exact ties on purpose (prefix-independent logits make every live
hypothesis score alike): they hold the port's ``top_k`` to JAX's order,
lowest index first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbl_for_multilingual_lip_reading_tpu import config as C
from sbl_for_multilingual_lip_reading_tpu.data import (
    SyntheticLipDataset as JaxSyntheticLipDataset)
from sbl_for_multilingual_lip_reading_tpu.decode import beam as jax_beam
from sbl_for_multilingual_lip_reading_tpu.decode import bigram as jax_bigram
from sbl_for_multilingual_lip_reading_tpu.training import Trainer as JaxTrainer
from sbl_for_multilingual_lip_reading_tpu.utils import hypotheses as jax_hyp
from sbl_for_multilingual_lip_reading_tpu_torch import cli
from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
from sbl_for_multilingual_lip_reading_tpu_torch.decode import beam, bigram
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.training.trainer import Trainer
from sbl_for_multilingual_lip_reading_tpu_torch.utils import (hypotheses,
                                                              state_dict_from_jax)
from sbl_for_multilingual_lip_reading_tpu_torch.vocab import EOS_ID, SOS_ID

V = 6
SCORE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(step_logits, B, K, bigram_logp=None):
    """``beam_search`` on prefix-independent per-step logits (maxlen, V),
    through JAX and through the port."""
    maxlen = step_logits.shape[0]
    jl = jnp.asarray(step_logits)
    want = jax_beam.beam_search(
        lambda ys, step: jnp.broadcast_to(jl[step], (ys.shape[0], V)),
        jnp.zeros((B, 3, 8)), beam_size=K, maxlen=maxlen, vocab_size=V,
        bigram_logp=None if bigram_logp is None else jnp.asarray(bigram_logp))
    tl = torch.from_numpy(step_logits)
    got = beam.beam_search(
        lambda ys, step: tl[step].expand(ys.shape[0], V),
        torch.zeros((B, 3, 8)), beam_size=K, maxlen=maxlen, vocab_size=V,
        bigram_logp=None if bigram_logp is None else torch.from_numpy(bigram_logp))
    return got, want


def _assert_same(got, want):
    *got_tokens, got_scores = got
    *want_tokens, want_scores = want
    for g, w in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               atol=SCORE_TOL, rtol=0)


def test_top_k_takes_the_lowest_index_among_equals():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0],
                  [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    got_v, got_i = beam.top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i.tolist() == [[1, 2, 4, 0], [0, 1, 2, 3]]


@pytest.mark.parametrize("finished_row", [False, True])
def test_advance_matches_jax(finished_row):
    """One frontier step on random state, with ties among the candidates
    (two hypotheses with one score and one log-probability row)."""
    rng = np.random.default_rng(0)
    B, K, L, step = 2, 3, 5, 1
    tokens = rng.integers(2, V, size=(B, K, L)).astype(np.int32)
    tokens[:, :, 0] = SOS_ID
    scores = rng.standard_normal((B, K)).astype(np.float32)
    scores[:, 1] = scores[:, 0]
    logp = np.log(rng.dirichlet(np.ones(V), size=(B, K))).astype(np.float32)
    logp[:, 1] = logp[:, 0]
    finished = np.zeros((B, K), bool)
    finished[:, 2] = finished_row
    big = np.log(rng.dirichlet(np.ones(V), size=V)).astype(np.float32)
    last = tokens[:, :, step]
    want = jax_beam._advance(jnp.asarray(tokens), jnp.asarray(scores),
                             jnp.asarray(finished), jnp.asarray(logp), step,
                             jnp.asarray(last), jnp.asarray(big), EOS_ID)
    got = beam._advance(torch.from_numpy(tokens).long(), torch.from_numpy(scores),
                        torch.from_numpy(finished), torch.from_numpy(logp), step,
                        torch.from_numpy(last).long(), torch.from_numpy(big),
                        EOS_ID)
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SCORE_TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_beam_finds_argmax_path():
    maxlen = 4
    step_logits = np.random.RandomState(0).randn(maxlen, V).astype(np.float32)
    got, want = _both(step_logits, B=2, K=3)
    _assert_same(got, want)
    tokens, scores = got
    assert tokens.shape == (2, 3, maxlen + 1)
    # with prefix-independent logits the greedy path is optimal
    np.testing.assert_array_equal(tokens[0, 0, 1:].numpy(),
                                  step_logits.argmax(-1))
    assert (np.diff(scores[0].numpy()) <= 1e-6).all()
    lp = torch.log_softmax(torch.from_numpy(step_logits), -1)
    assert abs(scores[0, 0].item() - lp.max(-1).values.sum().item()) < 1e-4


def test_beam_eos_freezes_score():
    maxlen = 4
    # step 0 strongly prefers eos: the hypothesis ends at once
    step_logits = np.full((maxlen, V), -5.0, np.float32)
    step_logits[0, EOS_ID] = 10.0
    step_logits[1:, 3] = 5.0
    got, want = _both(step_logits, B=1, K=2)
    _assert_same(got, want)
    tokens, scores = got
    assert tokens[0, 0, 1] == EOS_ID and (tokens[0, 0, 2:] == EOS_ID).all()
    lp0 = torch.log_softmax(torch.from_numpy(step_logits[0]), -1)
    assert abs(scores[0, 0].item() - lp0[EOS_ID].item()) < 1e-4


def test_bigram_bias_changes_path():
    maxlen = 2
    logits = np.zeros((maxlen, V), np.float32)       # a uniform model
    counts = [[SOS_ID, 4], [SOS_ID, 4], [SOS_ID, 3]]
    big = bigram.build_bigram_matrix(counts, V, floor=1e-4)
    np.testing.assert_array_equal(
        big, jax_bigram.build_bigram_matrix(counts, V, floor=1e-4))
    got, want = _both(logits, B=1, K=2, bigram_logp=np.log(big))
    _assert_same(got, want)
    assert int(got[0][0, 0, 1]) == 4


@pytest.mark.parametrize("floor,normalize", [(0.0, True), (1e-6, True),
                                             (0.5, False)])
def test_bigram_matrix_matches_jax(floor, normalize):
    rng = np.random.default_rng(1)
    seqs = [rng.integers(2, V, size=rng.integers(0, 5)).tolist() for _ in range(20)]
    want = jax_bigram.build_bigram_matrix(seqs, V, floor=floor, normalize=normalize)
    got = bigram.build_bigram_matrix(seqs, V, floor=floor, normalize=normalize)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    m = bigram.build_bigram_matrix([[2, 3], [2, 4]], 6)
    assert m[SOS_ID, 2] == 1.0 and m[3, EOS_ID] == 1.0
    assert abs(m[2, 3] - 0.5) < 1e-6 and abs(m[2, 4] - 0.5) < 1e-6


def test_bigram_from_dataset_matches_jax():
    ds = JaxSyntheticLipDataset(size=12, frames=2, raw_size=8, kind="lrw1000",
                                vocab="lrw1000")
    want = jax_bigram.bigram_from_dataset(ds, 48)
    np.testing.assert_array_equal(bigram.bigram_from_dataset(ds, 48), want)

    class LabelsOnly:
        def __len__(self):
            return len(ds)

        def labels_only(self, i):
            return ds[i]["labels"]

        def __getitem__(self, i):
            raise AssertionError("a corpus scan must not decode clips")
    np.testing.assert_array_equal(bigram.bigram_from_dataset(LabelsOnly(), 48),
                                  want)


def _sbl_both(lg_l, lg_r, B, K):
    maxlen = lg_l.shape[0]
    jl, jr = jnp.asarray(lg_l), jnp.asarray(lg_r)
    want = jax_beam.sbl_beam_search(
        lambda a, b, step: (jnp.broadcast_to(jl[step], (a.shape[0], V)),
                            jnp.broadcast_to(jr[step], (a.shape[0], V))),
        B, K, maxlen, V)
    tl, tr = torch.from_numpy(lg_l), torch.from_numpy(lg_r)
    got = beam.sbl_beam_search(
        lambda a, b, step: (tl[step].expand(a.shape[0], V),
                            tr[step].expand(a.shape[0], V)),
        B, K, maxlen, V)
    return got, want


def test_sbl_beam_argmax_paths_and_scores():
    maxlen = 4
    rng = np.random.RandomState(1)
    lg_l = rng.randn(maxlen, V).astype(np.float32)
    lg_r = rng.randn(maxlen, V).astype(np.float32)
    got, want = _sbl_both(lg_l, lg_r, B=2, K=3)
    _assert_same(got, want)
    tok_l, tok_r, scores = got
    assert tok_l.shape == tok_r.shape == (2, 3, maxlen + 1)
    np.testing.assert_array_equal(tok_l[0, 0, 1:].numpy(), lg_l.argmax(-1))
    np.testing.assert_array_equal(tok_r[0, 0, 1:].numpy(), lg_r.argmax(-1))
    expect = sum(torch.log_softmax(torch.from_numpy(x), -1).max(-1).values.sum()
                 for x in (lg_l, lg_r)).item()
    assert abs(scores[0, 0].item() - expect) < 1e-4


def test_sbl_beam_per_direction_eos_freeze():
    maxlen = 4
    lg_l = np.full((maxlen, V), -5.0, np.float32)
    lg_l[0, EOS_ID] = 10.0          # l2r ends at step 0
    lg_l[1:, 3] = 5.0               # a tempting continuation it must not take
    lg_r = np.full((maxlen, V), -5.0, np.float32)
    lg_r[:, 4] = 5.0                # r2l never ends
    got, want = _sbl_both(lg_l, lg_r, B=1, K=2)
    _assert_same(got, want)
    assert (got[0][0, 0, 1:] == EOS_ID).all() and (got[1][0, 0, 1:] == 4).all()


def _tiny_models(name):
    """A JAX Trainer's model and the port's with its weights."""
    cfg = C.tiny_test(name)
    vocab = name if name != "sbl" else "sbl"
    ds = JaxSyntheticLipDataset(size=4, frames=cfg.data.frames,
                                raw_size=cfg.data.raw_size, vocab=vocab,
                                kind=name if name != "sbl" else "all")
    jtr = JaxTrainer(cfg, ds)
    variables = jax.device_get({"params": jtr.state.params,
                                "batch_stats": jtr.state.batch_stats})
    port = build_model(cfg, "cpu")
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    video = np.random.default_rng(3).standard_normal(
        (2, cfg.data.frames, cfg.data.crop_size, cfg.data.crop_size)
    ).astype(np.float32)
    return cfg, ds, jtr, variables, port, video


@pytest.fixture(scope="module")
def uni():
    return _tiny_models("lrw1000")


@pytest.fixture(scope="module")
def sbl():
    return _tiny_models("sbl")


def test_uni_beam_size1_matches_greedy(uni):
    cfg, _, jtr, variables, port, video = uni
    want = jax_beam.make_uni_beam_decoder(jtr.model, beam_size=1)(
        variables, jnp.asarray(video))
    got = beam.make_uni_beam_decoder(port, beam_size=1)(torch.from_numpy(video))
    _assert_same(got, want)
    with torch.inference_mode():
        greedy = port.recognize(torch.from_numpy(video)).numpy()
    best = got[0][:, 0].numpy()
    # beam 1 follows the argmax chain until its first eos, then freezes to
    # eos while greedy keeps decoding
    for b in range(best.shape[0]):
        for t in range(1, best.shape[1]):
            if best[b, t] == EOS_ID:
                break
            assert best[b, t] == greedy[b, t]


@pytest.mark.parametrize("with_bigram", [False, True])
def test_uni_beam_cached_token_identical_and_matches_jax(uni, with_bigram):
    cfg, _, jtr, variables, port, video = uni
    V_ = cfg.decoder.vocab_size
    big = None
    if with_bigram:
        big = np.log(np.random.default_rng(0).random((V_, V_)) + 0.1
                     ).astype(np.float32)
    want = jax_beam.make_uni_beam_decoder(
        jtr.model, beam_size=3,
        bigram_logp=None if big is None else jnp.asarray(big))(
            variables, jnp.asarray(video))
    kv = beam.make_uni_beam_decoder(port, beam_size=3, bigram_logp=big)(
        torch.from_numpy(video))
    ref = beam.make_uni_beam_decoder(port, beam_size=3, bigram_logp=big,
                                     kv_cache=False)(torch.from_numpy(video))
    assert torch.equal(kv[0], ref[0])
    np.testing.assert_allclose(kv[1].numpy(), ref[1].numpy(), atol=1e-4)
    _assert_same(kv, want)
    assert kv[0].shape == (2, 3, cfg.decoder.maxlen + 1)
    assert (kv[0][:, :, 0] == SOS_ID).all()


def test_sbl_beam_size1_matches_greedy(sbl):
    cfg, _, jtr, variables, port, video = sbl
    want = jax_beam.make_sbl_beam_decoder(jtr.model, beam_size=1)(
        variables, jnp.asarray(video))
    got = beam.make_sbl_beam_decoder(port, beam_size=1)(torch.from_numpy(video))
    _assert_same(got, want)
    with torch.inference_mode():
        g_l2r, g_r2l = port.recognize(torch.from_numpy(video))
    for greedy, best in ((g_l2r.numpy(), got[0][:, 0].numpy()),
                         (g_r2l.numpy(), got[1][:, 0].numpy())):
        for b in range(best.shape[0]):
            for t in range(1, best.shape[1]):
                if best[b, t] == EOS_ID:
                    break
                assert best[b, t] == greedy[b, t]


def test_sbl_beam_decoder_end_to_end_matches_jax(sbl):
    cfg, ds, jtr, variables, port, video = sbl
    want = jax_beam.make_sbl_beam_decoder(jtr.model, beam_size=3)(
        variables, jnp.asarray(video))
    got = beam.make_sbl_beam_decoder(port, beam_size=3)(torch.from_numpy(video))
    _assert_same(got, want)
    tok_l, tok_r, scores = got
    L = cfg.decoder.maxlen + 1
    assert tok_l.shape == tok_r.shape == (2, 3, L) and scores.shape == (2, 3)
    assert (np.diff(scores.numpy(), axis=1) <= 1e-6).all()
    # the Trainer's eval path with a beam: both directions, equal to JAX's
    tr = Trainer(cfg, [], {}, device="cpu", model=port)
    out = tr.validate_seq2seq(ds, max_batches=1, beam_size=2)
    assert set(out) == {"l2r_wer", "l2r_per", "r2l_wer", "r2l_per"}
    assert out == pytest.approx(jtr.validate_seq2seq(ds, max_batches=1,
                                                     beam_size=2))


def test_cli_test_sbl_beam_matches_jax_validate(sbl, monkeypatch, tmp_path):
    """``cli test --cpu --workload sbl --beam-size 2`` on a checkpoint this
    test saves: WER/PER of both directions equal to JAX's."""
    from sbl_for_multilingual_lip_reading_tpu import cli as jax_cli
    cfg, _, jtr, variables, port, _ = sbl
    args = cli.build_argparser().parse_args(["--synthetic", "--synthetic-size", "8"])
    _, test_sets = jax_cli.make_datasets(cfg, args, eval_split="test")
    want = {k: jtr.validate_seq2seq(ds, beam_size=2) for k, ds in test_sets.items()}
    monkeypatch.setitem(port_config.PRESETS, "sbl", port_config.tiny_test)
    save = str(tmp_path / "ckpt")
    Trainer(port_config.tiny_test(), [], {}, device="cpu", model=port).save(save)
    got = cli.run_test(["--cpu", "--workload", "sbl", "--synthetic",
                        "--synthetic-size", "8", "--beam-size", "2",
                        "--checkpoint", save])
    assert set(got) == {"lrw", "lrw1000"}
    for k in got:
        assert got[k] == pytest.approx(want[k])


def test_hypothesis_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 6, size=(2, 3, 5))
    scores = rng.standard_normal((2, 3)).astype(np.float32)
    want = jax_hyp.beam_outputs_to_hyps(tokens, scores)
    got = hypotheses.beam_outputs_to_hyps(torch.from_numpy(tokens),
                                          torch.from_numpy(scores))
    assert got == want
    chars = ["<sos>", "<eos>", "a", "b", "<space>", "c"]
    assert (hypotheses.parse_hypothesis(got[0][0], chars)
            == jax_hyp.parse_hypothesis(want[0][0], chars))
    js = {"utt2spk": "spk", "output": [{"name": "target1", "text": "ab"}]}
    assert (hypotheses.add_results_to_json(js, got[1], chars)
            == jax_hyp.add_results_to_json(js, want[1], chars))
    path = tmp_path / "dict.txt"
    path.write_text("".join(f"{c} {i}\n" for i, c in enumerate(chars)))
    assert hypotheses.process_dict(str(path)) == jax_hyp.process_dict(str(path))
    assert hypotheses.process_dict(str(path)) == (chars, 0, 1)
