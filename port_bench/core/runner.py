"""One run of one cell: set-up, the measured window, the traced slice
(``--trace 1``), the judgement of the served answers, and the result line.

Set-up (``setup_s``) runs from the process's first statement to the first
timed batch: the kernel library (built by nvcc into the package's
``_build/`` on a checkout's first run, loaded after), the model with
weights made on the device from the seed, the pinned pool of clips, and
the warm-up batches, which take every shape the window takes.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import subprocess
import sys
import time
from types import SimpleNamespace

from . import guard
from .spec import Bench


class RunError(RuntimeError):
    """The run cannot give a result."""


def _replace(obj, overrides: dict):
    """``obj`` (a config dataclass) with ``overrides`` applied, nested
    dicts into nested dataclasses."""
    changes = {}
    for k, v in overrides.items():
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            changes[k] = _replace(cur, v)
        else:
            changes[k] = tuple(v) if isinstance(v, list) else v
    return dataclasses.replace(obj, **changes)


def _find(cfg, key: str):
    """The value of ``key`` among the config's fields and those of its
    nested dataclasses (every name the config files use is unique)."""
    if hasattr(cfg, key):
        return getattr(cfg, key)
    for f in dataclasses.fields(cfg):
        sub = getattr(cfg, f.name)
        if dataclasses.is_dataclass(sub) and hasattr(sub, key):
            return getattr(sub, key)
    raise KeyError(key)


# the training settings a config file names otherwise than the port's fields
TRAIN_FIELDS = {"dropout": "dims.dropout", "frontend_dropout": "frontend.dropout",
                "noam_k": "optim.k", "frame_removal_p": "data.frame_removal_p"}


def build_config(presets: dict, conf: dict, mix: dict):
    """The port's config a cell runs: the preset, the file's overrides and
    the mix's batch.  Every size and training setting the file states must
    be the config's."""
    cfg = _replace(presets[conf["preset"]](), conf.get("overrides", {}))
    cfg = dataclasses.replace(cfg, batch_size=mix["batch"])
    stated = dict(conf["model"], **conf.get("train", {}))
    for key, want in stated.items():
        if key in TRAIN_FIELDS:
            part, field = TRAIN_FIELDS[key].split(".")
            have = getattr(getattr(cfg, part), field)
        else:
            have = _find(cfg, key)
        have = list(have) if isinstance(have, tuple) else have
        if have != want:
            raise RunError(f"config {conf['name']}: {key} is {have!r} in the "
                           f"run, {want!r} in its file")
    return cfg


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=False)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _guard(stage: str) -> None:
    found = guard.forbidden_loaded()
    if found:
        raise RunError(f"after {stage}: forbidden modules loaded: {found}")


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", control: str = "off") -> dict:
    """The result of one run (the dict of the result line).  The mix's
    ``entry`` names the file of ``entries/`` that drives the program
    (``Bench.entry``): its ``Part`` plays set-up, window, traced slice and
    judgement, and gives the end-to-end values.

    ``control`` (never taken by the command line): "on" judges the
    control's answers (the float8 reference in the program's place)
    against the limits in place of the program's; "both" judges the
    program's and adds every reading of both under ``readings``, for
    ``control.py``."""
    cell = bench.cell(name)
    conf, mix, limits = bench.config(cell), bench.traffic(cell), bench.limits(cell)
    for env in (conf.get("env", {}), mix.get("env", {})):
        os.environ.update({k: str(v) for k, v in env.items()})
    import torch
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C, ops
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from ..reference import flops
    from . import trace as T
    from .weights import seeded_state

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    entry = bench.entry(mix["entry"])
    cfg = dataclasses.replace(build_config(C.PRESETS, conf, mix), seed=int(seed))
    if hasattr(entry, "configure"):
        cfg = entry.configure(cfg, mix, seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        ops._build.library()
    model = build_model(cfg, device=dev)
    state = seeded_state(model, seed, dev)
    model.load_state_dict(state)
    state = {k: v.cpu() for k, v in state.items()}   # the reference's copy
    part = entry.Part(torch, model, cfg, conf, mix, seed, dev)
    part.set_up()
    if cuda:
        torch.cuda.synchronize()
    _guard("set-up")

    start = time.perf_counter()
    setup_s = start - t0
    window = part.window(seconds)
    window["seconds"] = time.perf_counter() - start

    records, slice_win, spans = [], None, {}
    if trace:
        spans = part.spans(model)
        holder: dict = {}
        with T.profiled(holder):
            part.traced_slice()
        records, slice_win = holder["records"], holder["window"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    _guard("the window")

    # the judgement, once the program's state is freed
    numbers = part.path_numbers(cuda)
    part.release()
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = part.judge(state, control != "off")
    if control == "on":
        readings = {k[len("control_"):]: v for k, v in readings.items()
                    if k.startswith("control_")}
    numbers.update(readings)
    numbers = {k: v for k, v in numbers.items() if k in limits}
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise RunError(f"{name}: no reading of {missing}")
    checks = {k: {"value": numbers[k], "limit": limits[k]["limit"]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    run = SimpleNamespace(cell=cell, conf=conf, mix=mix, cfg=cfg, flops=flops,
                          window=window, records=records, slice_window=slice_win,
                          spans=spans, part=part)
    end_to_end = dict(part.end_to_end(window), peak_alloc_gb=peak / 1e9, setup_s=setup_s)
    metrics = {}
    if not trace:
        for m in bench.end_to_end_of(name):
            v = end_to_end.get(m["name"])
            if v is None:
                raise RunError(f"{name}: no value for {m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench.per_layer_of(name):
            v = bench.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": device_info}
    if trace and slice_win is not None:
        device_info["busy_s"] = T.busy_seconds(records, slice_win)
        device_info["window_s"] = (slice_win[1] - slice_win[0]) * 1e-6
        result["breakdown"] = {"device_ops": T.top_device_ops(records),
                               "idle_gaps": T.idle_gaps(records, slice_win)}
    if control == "both":
        result["readings"] = readings
    result["checks"] = checks
    _guard("the judgement")
    return result


def report_checks(checks: dict, log=sys.stderr) -> None:
    """Each number compared beside its limit, as the run's last lines on
    standard error."""
    for k, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r}) {ok}",
              file=log, flush=True)
