"""BENCHMARK.json against the contract it is written to, and the rule that
a cell, a configuration, a mix or a per-layer metric is added by adding
files and entries alone."""
import json
import math

import pytest

from port_bench.tests.conftest import ROOT
from port_bench.core import spec

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture
def bench():
    return spec.load(ROOT)


def test_every_name_resolves_to_its_file(bench):
    assert bench.problems() == []


def test_keys_and_values_follow_the_contract(bench):
    s = bench.spec
    assert set(s) == TOP
    assert s["command"] == ["python3", "port_bench/run.py"] and s["paths"] == ["port_bench"]
    assert 1 <= s["run_seconds"] <= 51
    for group, keys in KEYS.items():
        for e in s[group]:
            assert set(e) - {"workloads"} == keys, (group, e["name"])
            if group in ("end_to_end", "per_layer"):
                assert e["better"] in ("lower", "higher")
                assert e["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    for w in s["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = [e["name"] for g in KEYS for e in s[g]]
    assert len(names) == len(set(names))
    assert len(json.dumps(s)) <= 64 * 1024


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench.spec["end_to_end"]}
    for cell in bench.cells:
        mine = {m["name"] for m in bench.end_to_end_of(cell)}
        assert "setup_s" in mine and len(mine) >= 2, cell
        layer = bench.per_layer_of(cell)
        assert layer, cell
        for m in layer:
            assert m["moves"] in mine, (cell, m["name"])
    for m in bench.spec["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", bench.cells))
    cells_4 = sum(w["chips"] == 4 for w in bench.spec["workloads"])
    assert cells_4 <= max(1, math.floor(0.25 * len(bench.cells)))


def test_config_files_state_their_sizes(bench):
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from port_bench.core.runner import build_config
    for name, c in bench.configs.items():
        conf = json.loads(bench.config_file(name).read_text())
        assert conf["reduced"] == c["reduced"] == []
        build_config(C.PRESETS, conf, {"batch": 512})


def test_a_cell_config_mix_and_metric_are_added_as_files(tiny_bench):
    """The tiny cells of the fixture, and a per-layer metric, added
    without editing a file that was there."""
    before = {p.relative_to(ROOT): p.read_bytes()
              for p in (ROOT / "port_bench").rglob("*") if p.is_file()
              and "__pycache__" not in p.parts and "tests" not in p.parts
              and "_cache" not in p.parts}
    (tiny_bench / "port_bench/metrics/dummy_ms.recognize.py").write_text(
        "def read(run):\n    return 1.5\n")
    s = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    s["per_layer"].append({"name": "dummy_ms.recognize", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "frontend",
                           "moves": "recognize_clips_per_s",
                           "workloads": ["tiny_sbl.recognize"]})
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(s))
    b = spec.load(tiny_bench)
    assert b.problems() == []
    assert "tiny_uni.beam" in b.cells and "tiny_sbl" in b.configs
    assert [m["name"] for m in b.per_layer_of("tiny_sbl.recognize")][-1] == "dummy_ms.recognize"
    assert b.reader("dummy_ms.recognize")(None) == 1.5
    for rel, data in before.items():
        assert (tiny_bench / rel).read_bytes() == data, rel


def test_a_missing_file_is_named(tiny_bench):
    (tiny_bench / "port_bench/traffic/tiny.beam5.json").unlink()
    (tiny_bench / "port_bench/metrics/mfu.recognize.py").unlink()
    probs = spec.load(tiny_bench).problems()
    assert any("tiny.beam5.json" in p for p in probs)
    assert any("mfu.recognize: reader missing" in p for p in probs)


@pytest.mark.parametrize("name,ok", [("sbl.recognize.b512", True), ("a-b_c.9", True),
                                     ("has space", False), ("a/b", False), ("a,b", False),
                                     (".lead", False), ("x" * 65, False), ("muµ", False)])
def test_name_characters(name, ok):
    assert bool(spec.NAME.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [("clips/s", True), ("%", True), ("ms", True),
                                     ("tokens per s", False), ("µs", False), ("", False)])
def test_unit_characters(unit, ok):
    assert bool(spec.UNIT.match(unit)) is ok


ENCODE_ONLY = '''"""Entry of a test: the encoder's output of each clip, judged against
the reference's, and a rate of its own."""
import torch

from port_bench.core.traffic import ClosedLoop, EvalPart
from port_bench.reference import model as R


class Loop(ClosedLoop):
    def entry(self, clips):
        from sbl_for_multilingual_lip_reading_tpu_torch.data.ingest import device_ingest
        video = device_ingest(clips, self.cfg.data.crop_size, self.model.frontend.dtype)
        with torch.inference_mode():
            return (self.model.encode(video).float(),), None


class Part(EvalPart):
    def make_loop(self):
        return Loop(self.model, self.cfg, self.mix, self.seed, self.dev)

    def expected_launches(self):
        return {"stack_frames": 1, "small_mha_flat": self.cfg.dims.n_enc_layers}

    def judge(self, state, control=False):
        s = self.sample
        with torch.no_grad():
            ref = R.encode(s["clips"], R.Weights(state), self.conf["model"])
        return {"enc_err": float((s["served"][0] - ref).abs().max())}

    def end_to_end(self, window):
        return {"encode_clips_per_s": window["clips"] / window["seconds"]}
'''


def test_a_new_way_to_drive_the_program_is_added_as_files(tiny_bench):
    """A mix whose entry is new (an encoder-only pass), its cell, its
    limits and an end-to-end metric of its own, added as files and
    entries: no file of ``core/`` or any other that was there changes,
    and the cell runs."""
    import time
    import torch
    from port_bench.core import runner
    before = {p.relative_to(tiny_bench): p.read_bytes()
              for p in (tiny_bench / "port_bench").rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    (tiny_bench / "port_bench/entries/encode_only.py").write_text(ENCODE_ONLY)
    (tiny_bench / "port_bench/traffic/tiny.encode.json").write_text(json.dumps(
        {"entry": "encode_only", "batch": 4, "pool": 2, "warmup_batches": 1,
         "trace_batches": 1, "sample": 4}))
    (tiny_bench / "port_bench/limits/tiny_uni.encode.json").write_text(json.dumps(
        {"enc_err": {"limit": 1e-3}, "unanswered": {"limit": 0},
         "launches_off": {"limit": 0}}))
    s = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    s["workloads"].append({"name": "tiny_uni.encode", "config": "tiny_uni",
                           "traffic": "tiny.encode", "chips": 1, "why": "a test's entry"})
    s["end_to_end"].insert(0, {"name": "encode_clips_per_s", "unit": "clips/s",
                               "better": "higher", "bound": 0.05, "source": "host_clock",
                               "workloads": ["tiny_uni.encode"]})
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(s))
    b = spec.load(tiny_bench)
    assert b.problems() == []
    torch.set_num_threads(2)
    res = runner.run_cell(b, "tiny_uni.encode", 2 ** 31 + 9, 0.3, False,
                          time.perf_counter(), device="cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"encode_clips_per_s", "peak_alloc_gb", "setup_s"}
    assert res["checks"]["enc_err"]["value"] < 1e-4
    for rel, data in before.items():
        assert (tiny_bench / rel).read_bytes() == data, rel
    # an entry that is named and has no file is found before a run
    (tiny_bench / "port_bench/entries/encode_only.py").unlink()
    assert any("entry 'encode_only' missing" in p for p in spec.load(tiny_bench).problems())
