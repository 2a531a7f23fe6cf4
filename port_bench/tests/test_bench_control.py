"""The control -- the plain reference in float8 put in the program's place
-- comes out as not correct, on the CPU at a size a test run holds (the
eval cells at d_model 256 and 3 + 3 layers, the training cell at the tiny
sizes).  On the chip the control was read at each cell's own size (PERF.md
gives the readings the limits were set from)."""
import pytest
import torch

from port_bench.core import runner, spec
from port_bench.tests import conftest

SMALL = {"dims": {"d_model": 256, "n_head": 4, "d_k": 64, "d_v": 64, "d_inner": 512,
                  "n_enc_layers": 3, "n_dec_layers": 3},
         "frontend": {"conv3d_channels": 16, "resnet_channels": [16, 32, 64, 128],
                      "resnet_blocks": [1, 1, 1, 1], "feature_dim": 128},
         "data": {"raw_size": 40, "crop_size": 32}, "compute_dtype": "float32"}


@pytest.fixture
def small_bench(tmp_path, monkeypatch):
    monkeypatch.setattr(conftest, "TINY", SMALL)
    return conftest.tiny_bench.__wrapped__(tmp_path)


@pytest.mark.parametrize("cell", ["tiny_sbl.recognize", "tiny_uni.recognize", "tiny_uni.beam"])
def test_the_control_is_not_correct(small_bench, cell):
    """A whole run with the float8 reference's answers judged in the
    program's place: its logits at the served tokens, or its own beam
    search."""
    torch.set_num_threads(2)
    b = spec.load(small_bench)
    res = runner.run_cell(b, cell, 2 ** 31 + 77, 0.3, False, 0.0, device="cpu",
                          control="on")
    assert not res["correct"], res["checks"]
    sound = runner.run_cell(b, cell, 2 ** 31 + 77, 0.3, False, 0.0, device="cpu",
                            control="both")
    assert sound["correct"], sound["checks"]
    assert set(sound["readings"]) >= {"control_" + k for k in sound["checks"]
                                      if k not in ("launches_off", "unanswered")}


def test_the_training_control_is_not_correct(tiny_bench):
    """The first steps' readings taken from the float8 reference, from the
    run's own start, in place of the program's."""
    torch.set_num_threads(2)
    res = runner.run_cell(spec.load(tiny_bench), "tiny_sbl.train", 2 ** 31 + 5, 0.3, False,
                          0.0, device="cpu", control="on")
    assert not res["correct"], res["checks"]
