"""Whole runs of the harness on the CPU at tiny sizes (the kernels' plain
versions; ``run_cell`` with ``device="cpu"``, which the command line never
takes), and the faults that have to turn ``correct`` false."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from port_bench import faults
from port_bench.core import runner, spec
from port_bench.tests.conftest import ROOT

CELLS = ["tiny_sbl.recognize", "tiny_uni.recognize", "tiny_uni.beam"]
TRAIN = "tiny_sbl.train"
SEED = 2 ** 31 + 12345


def run(root, cell, seed=SEED):
    torch.set_num_threads(2)
    return runner.run_cell(spec.load(root), cell, seed, 0.3, False,
                           time.perf_counter(), device="cpu")


@pytest.mark.parametrize("cell", CELLS + [TRAIN])
def test_a_sound_run_is_correct(tiny_bench, cell):
    res = run(tiny_bench, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    rate = ["train_clips_per_s"] if cell == TRAIN else ["recognize_clips_per_s",
                                                       "recognize_batch_p90_ms"]
    assert set(res["metrics"]) == set(rate + ["peak_alloc_gb", "setup_s"])
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def _bump_step(monkeypatch):
    """A token altered where it is produced: at decode step 2 the token
    after the best gets the most logit."""
    from sbl_for_multilingual_lip_reading_tpu_torch.models import decoder_sbl, decoder_uni

    def bump(lg, step):
        if step != 2:
            return lg
        lg = lg.clone()
        nxt = (lg.argmax(-1, keepdim=True) + 1) % lg.shape[-1]
        return lg.scatter(-1, nxt, lg.max(-1, keepdim=True).values + 5.0)

    sbl_fwd = decoder_sbl._SBLStep.forward
    monkeypatch.setattr(decoder_sbl._SBLStep, "forward",
                        lambda self, ys, kv, step, *a, **k: bump(sbl_fwd(self, ys, kv, step, *a, **k), step))
    uni_step = decoder_uni.UniDecoder.decode_step_cached

    def uni(self, tok, cache, enc_kv, step):
        lg, cache = uni_step(self, tok, cache, enc_kv, step)
        return bump(lg, step), cache
    monkeypatch.setattr(decoder_uni.UniDecoder, "decode_step_cached", uni)


def _half_batch(monkeypatch):
    """Half of the batch left out: the entry answers the first half, the
    rest of its answers are zeros."""
    from port_bench.core import traffic
    batch = traffic.ClosedLoop.batch

    def half(self, i, keep=True):
        entry = type(self).entry

        def cut_entry(clips):
            served, logits = entry(self, clips)
            h = clips.shape[0] // 2

            def cut(t):
                t = t.clone()
                t[h:] = 0
                return t
            return (tuple(cut(s) for s in served),
                    None if logits is None else tuple(cut(x) for x in logits))
        self.entry = cut_entry
        return batch(self, i, keep)
    monkeypatch.setattr(traffic.ClosedLoop, "batch", half)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_bump_step, _half_batch])
def test_a_fault_makes_the_run_incorrect(tiny_bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run(tiny_bench, cell)
    assert not res["correct"], res["checks"]


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged: no optimizer update."""
    from sbl_for_multilingual_lip_reading_tpu_torch.training import state
    monkeypatch.setattr(state.TrainState, "apply_gradients", lambda self: self.lr)


def _half_loss(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from sbl_for_multilingual_lip_reading_tpu_torch.training import steps
    perf = steps.cal_performance

    def half(pred, gold, smoothing=0.0):
        h = pred.shape[0] // 2
        return perf(pred[:h], gold[:h], smoothing)
    monkeypatch.setattr(steps, "cal_performance", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_loss, _bump_step])
def test_a_training_fault_makes_the_run_incorrect(tiny_bench, monkeypatch, fault):
    fault(monkeypatch)
    res = run(tiny_bench, TRAIN)
    assert not res["correct"], res["checks"]


def test_the_decode_widths_are_the_programs():
    from sbl_for_multilingual_lip_reading_tpu_torch.models.decoder_sbl import SBLDecoder
    from port_bench.reference.train import segment_widths
    for maxlen, segments in ((16, 8), (16, 4), (8, 1), (14, 3), (16, 16)):
        dec = SBLDecoder(vocab_size=8, d_model=16, n_layers=1, n_head=2, d_k=8, d_v=8,
                         d_inner=16, maxlen=maxlen, decode_segments=segments,
                         use_kernels=False)
        want = [b + 1 for a, b in dec._segments() for _ in range(a, b)]
        assert segment_widths(maxlen, segments) == want


def test_the_launch_count_check():
    from types import SimpleNamespace
    from port_bench.core.traffic import launches_off
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    b = spec.load(ROOT)
    want = b.entry("recognize").expected_launches(C.sbl())
    assert want == {"small_mha_flat": 198, "stack_frames": 1}
    assert b.entry("recognize").expected_launches(C.lrw1000_seq2seq())["small_mha_flat"] == 102
    beam = b.entry("beam").Part.expected_launches(SimpleNamespace(cfg=C.lrw1000_seq2seq()))
    assert beam == {"small_mha_flat": 102, "stack_frames": 1}
    before = {"small_mha_flat": 10, "stack_frames": 1, "fused_decoder_layer": 0}
    after = {"small_mha_flat": 10 + 3 * 198, "stack_frames": 4, "fused_decoder_layer": 0}
    assert launches_off(before, after, 3, want) == 0
    after["fused_decoder_layer"] = 96
    assert launches_off(before, after, 3, want) == 96


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_frontier_fault_makes_the_beam_run_incorrect(tiny_bench, monkeypatch, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    torch.set_num_threads(2)
    res = runner.run_cell(spec.load(tiny_bench), "tiny_uni.beam", SEED, 0.3, False,
                          time.perf_counter(), device="cpu", control="both")
    assert not res["correct"], res["checks"]
    # the logits and every score are sound: only the frontier is at fault
    assert res["checks"]["step_logit_err"]["value"] <= res["checks"]["step_logit_err"]["limit"]
    assert res["readings"]["score_step"] < 1e-4


def test_no_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "sbl.recognize.b512", "--seed", str(2 ** 33), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_only_the_benchmark_gives_no_result(tmp_path):
    """A directory with BENCHMARK.json and port_bench/ alone (no program)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "lrw1000.beam5.b512", "--seed", "5", "--seconds", "1",
                          "--trace", "1"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "lrw1000.recognize.b512", "--seed", str(2 ** 31 + 3),
                          "--seconds", "3", "--trace", "0"], capture_output=True,
                         text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
