"""The port's analytic model-FLOPs (``utils/flops.py``) against the JAX
package's: every per-workload count at every preset and its tiny form, the
MFU arithmetic, and the card's peak (989 TFLOP/s dense bf16, the H100 SXM's;
``SBL_PEAK_TFLOPS`` overrides it, as in JAX)."""
import pytest

from sbl_for_multilingual_lip_reading_tpu import config as JC
from sbl_for_multilingual_lip_reading_tpu.utils import flops as jax_flops
from sbl_for_multilingual_lip_reading_tpu_torch import config as PC
from sbl_for_multilingual_lip_reading_tpu_torch.utils import flops

WORKLOADS = ("sbl", "sbl_stage2", "lrw", "lrw1000", "classify")


def _cfgs(name, tiny):
    if tiny:
        # tiny_test knows the four base workloads; stage 2 is sbl's model
        base = "sbl" if name == "sbl_stage2" else name
        return PC.tiny_test(base), JC.tiny_test(base)
    return PC.PRESETS[name](), JC.PRESETS[name]()


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_counts_equal_jax(name, tiny):
    mine, theirs = _cfgs(name, tiny)
    for fn in ("frontend_flops", "encoder_flops", "inference_flops_per_clip",
               "train_flops_per_clip", "classify_head_flops"):
        assert getattr(flops, fn)(mine) == getattr(jax_flops, fn)(theirs), fn
    if mine.decoder is None:
        return
    if mine.decoder.bidirectional:
        assert (flops.sbl_decoder_fwd_flops(mine)
                == jax_flops.sbl_decoder_fwd_flops(theirs))
    else:
        for teacher_forced in (False, True):
            assert (flops.uni_decoder_fwd_flops(mine, teacher_forced)
                    == jax_flops.uni_decoder_fwd_flops(theirs, teacher_forced))


def test_peak_is_the_h100s_and_overridable(monkeypatch):
    monkeypatch.delenv("SBL_PEAK_TFLOPS", raising=False)
    assert flops.H100_PEAK_TFLOPS == 989.0
    assert flops.peak_flops_per_sec() == 989.0e12
    per_clip = flops.train_flops_per_clip(PC.sbl())
    assert flops.mfu(1000.0, per_clip) == pytest.approx(
        1000.0 * per_clip / 989.0e12, rel=1e-15)
    monkeypatch.setenv("SBL_PEAK_TFLOPS", "197")
    assert flops.peak_flops_per_sec() == jax_flops.peak_flops_per_sec() == 197e12
    assert flops.mfu(50.0, per_clip) == jax_flops.mfu(
        50.0, jax_flops.train_flops_per_clip(JC.sbl()))
