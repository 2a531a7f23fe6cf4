"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout with a tiny configuration and its cells added as data,
as a later change would add them."""
from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "dims": {"d_model": 64, "n_head": 4, "d_k": 16, "d_v": 16, "d_inner": 128,
             "n_enc_layers": 2, "n_dec_layers": 2},
    "frontend": {"conv3d_channels": 8, "resnet_channels": [8, 16, 32, 64],
                 "resnet_blocks": [1, 1, 1, 1], "feature_dim": 64},
    "data": {"raw_size": 40, "crop_size": 32},
    "compute_dtype": "float32",
}


def tiny_model(base: dict, preset: str) -> dict:
    m = dict(base["model"])
    m.update(TINY["dims"])
    m.update(TINY["frontend"])
    m.update(TINY["data"])
    m.update(compute_dtype="float32", maxlen=8)
    return m


def write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture(autouse=True)
def environment():
    """A run sets its cell's environment (``PALLAS_BN`` ...) in the
    process; a test's run leaves none behind."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.fixture
def tiny_bench(tmp_path):
    """A checkout holding BENCHMARK.json and port_bench/ with cells
    ``tiny_sbl.recognize``, ``tiny_uni.recognize`` and ``tiny_uni.beam``
    added: configurations, mixes and limits as new files, cells as new
    entries."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, preset in (("tiny_sbl", "sbl"), ("tiny_uni", "lrw1000")):
        base = json.loads((root / "port_bench/configs" / f"{preset}.json").read_text())
        overrides = dict(TINY, decoder={"maxlen": 8, "decode_segments": 1},
                         optim={"warmup_steps": 20, "lr_base_dim": 64})
        conf = dict(base, name=name, overrides=overrides, model=tiny_model(base, preset))
        if "train" in base:
            conf["train"] = dict(base["train"], decode_segments=1, warmup_steps=20,
                                 lr_base_dim=64)
        write(root / "port_bench/configs" / f"{name}.json", conf)
        spec["configs"].append(dict(spec["configs"][0] if preset == "sbl" else spec["configs"][1],
                                    name=name, file=f"port_bench/configs/{name}.json"))
    for mix in ("recognize.b512", "beam5.b512"):
        t = json.loads((root / "port_bench/traffic" / f"{mix}.json").read_text())
        t.update(batch=4, pool=2, warmup_batches=1, trace_batches=1, sample=4)
        if "bigram" in t:
            t["bigram"] = dict(t["bigram"], sequences=200)
        write(root / "port_bench/traffic" / f"tiny.{mix.split('.')[0]}.json", t)
    t = json.loads((root / "port_bench/traffic/train.cached.b240.json").read_text())
    t.update(batch=2, clips=8, first_steps=3, trace_steps=1)
    write(root / "port_bench/traffic/tiny.train.json", t)
    cells = [("tiny_sbl.recognize", "tiny_sbl", "tiny.recognize", "sbl.recognize.b512"),
             ("tiny_uni.recognize", "tiny_uni", "tiny.recognize", "lrw1000.recognize.b512"),
             ("tiny_uni.beam", "tiny_uni", "tiny.beam5", "lrw1000.beam5.b512"),
             ("tiny_sbl.train", "tiny_sbl", "tiny.train", "sbl.train.cached.b240")]
    for cell, conf, mix, like in cells:
        spec["workloads"].append({"name": cell, "config": conf, "traffic": mix,
                                  "chips": 1, "why": "a CPU test's tiny copy"})
        shutil.copy(root / "port_bench/limits" / f"{like}.json",
                    root / "port_bench/limits" / f"{cell}.json")
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    write(root / "BENCHMARK.json", spec)
    return root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips itself without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip with "
                    "`python3 -m pytest port_bench/tests -m card`")
