"""The import guard compares whole top-level names."""
import subprocess
import sys

from port_bench.tests.conftest import ROOT
from port_bench.core import guard


def test_the_port_passes_and_the_jax_package_is_caught():
    port = "sbl_for_multilingual_lip_reading_tpu_torch"
    assert guard.forbidden_loaded([port, port + ".ops.attention", "torch", "numpy"]) == []
    assert guard.forbidden_loaded([port, "sbl_for_multilingual_lip_reading_tpu.models"]) == [
        "sbl_for_multilingual_lip_reading_tpu"]
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert guard.forbidden_loaded(["jaxtyping", "flaxen", "jax_extra"]) == []


def test_the_harness_loads_no_jax():
    """Importing the harness, the reference and the port's modules a run
    uses loads nothing the guard forbids."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.core.runner, port_bench.core.check, port_bench.core.traffic\n"
            "import port_bench.control\n"
            "import sbl_for_multilingual_lip_reading_tpu_torch.recognize\n"
            "import sbl_for_multilingual_lip_reading_tpu_torch.decode.beam\n"
            "import sbl_for_multilingual_lip_reading_tpu_torch.models\n"
            "from port_bench.core import guard; print(guard.forbidden_loaded())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "port_bench/reference").glob("*.py"):
        text = path.read_text()
        for name in ("sbl_for_multilingual_lip_reading_tpu", "jax", "flax"):
            assert f"import {name}" not in text and f"from {name}" not in text, path
