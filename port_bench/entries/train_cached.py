"""Entry ``train_cached``: the program's ``Trainer`` on a dataset made from
the seed and resident on the device, the epoch-fused step replayed as one
CUDA graph a step, as ``cli train --cache-on-device`` runs it
(``core/training.py``).  Set-up drives the Trainer through its first
steps, which the reference follows; the window runs whole epochs of the
same Trainer.  End to end: the clips of the window's steps a second.
"""
from __future__ import annotations

import time

from port_bench.core import training


def configure(cfg, mix: dict, seed: int):
    return training.with_config(cfg, mix, seed)


class Part:
    def __init__(self, torch_mod, model, cfg, conf, mix, seed, dev):
        self.cfg, self.conf, self.mix = cfg, conf, mix
        self.seed, self.dev = int(seed), dev
        self.names = [k for k, _ in model.named_parameters()]
        self.driver = training.TrainDriver(model, cfg, mix, seed, dev)

    def set_up(self) -> None:
        self.prog = self.driver.first_steps()

    def window(self, seconds: float) -> dict:
        start, steps = time.perf_counter(), 0
        while True:
            steps += self.driver.run_epoch()
            if time.perf_counter() - start >= seconds:
                break
        clips = steps * self.mix["batch"]
        return {"steps": steps, "clips": clips, "attempted": clips, "failed": 0}

    def spans(self, model) -> dict:
        return {}

    def traced_slice(self) -> None:
        self.driver.run_epoch(self.mix["trace_steps"])

    def path_numbers(self, cuda: bool) -> dict:
        from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import \
            frontend_bn_count
        if not cuda:   # the CPU runs the fused step eagerly, with no graph
            return {"replays_off": 0.0, "rebuilt": 0.0, "launches_off": 0.0}
        return self.driver.path(frontend_bn_count(self.cfg.frontend))

    def release(self) -> None:
        self.driver.release()

    def judge(self, state, control: bool = False) -> dict:
        """The first steps' numbers; with ``control`` also the control's:
        the reference in float8 from the same start, in the program's
        place."""
        rcfg = training.reference_config(self.conf, self.mix)

        def ref(**kw):
            return training.reference_readings(state, self.names, self.driver.dataset,
                                               self.seed, rcfg, self.mix["first_steps"],
                                               self.dev, **kw)
        base = ref()
        out = {k: v for k, v in training.readings(self.prog, base).items()
               if not isinstance(v, str)}
        if control:
            got = training.readings(ref(prec="fp8"), base)
            out.update({"control_" + k: v for k, v in got.items() if not isinstance(v, str)})
        return out

    def end_to_end(self, window: dict) -> dict:
        return {"train_clips_per_s": window["clips"] / window["seconds"]}
