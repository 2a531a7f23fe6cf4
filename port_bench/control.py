"""Readings that set the limits of ``correct``: for each seed, the
program's numbers and the control's (the reference in float8) on the same
clips and tokens, at the cell's own sizes, in one process.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 ... [--mode both|on]

Evaluation cells: one whole run a seed (``runner.run_cell`` with a short
window at the cell's own load, long enough to answer the batches the
sample draws from), judged as a run judges its window's sample, with the
control's readings on the same clips beside the program's (``--mode
both``), or the control alone in the program's place, judged by the
cell's limits (``--mode on``: its result has to be ``correct`` false).
Training cells: the program's first steps against the reference's, and
on ``--control-seeds`` the control's and the fault of half of the batch
left out.  One JSON line a seed; the last line gathers the largest program
reading and the smallest control reading of each number.  Runs on the
card only, as the benchmark does.
"""
import argparse
import json
import sys
import time
from pathlib import Path


ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench.core import spec  # noqa: E402
from port_bench.faults import FAULTS  # noqa: E402


def train_readings(bench, name, seeds, control_seeds, device="cuda", log=sys.stdout):
    """For the cached-training mix: per seed the program's first steps
    against the reference's; on ``control_seeds`` also the control's (the
    reference in float8) and the fault of half of the batch left out (the
    reference on half the rows, the mean over them)."""
    import gc
    import torch
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from port_bench.core import runner, training
    from port_bench.core.weights import seeded_state

    cell = bench.cell(name)
    conf, mix = bench.config(cell), bench.traffic(cell)
    for k, v in mix.get("env", {}).items():
        import os
        os.environ[k] = str(v)
    rcfg = training.reference_config(conf, mix)
    dev = torch.device(device)
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        cfg = training.with_config(runner.build_config(C.PRESETS, conf, mix), mix, seed)
        model = build_model(cfg, device=dev)
        state = seeded_state(model, seed, dev)
        model.load_state_dict(state)
        state = {k: v.cpu() for k, v in state.items()}
        names = [k for k, _ in model.named_parameters()]
        driver = training.TrainDriver(model, cfg, mix, seed, dev)
        prog = driver.first_steps()
        dataset = driver.dataset
        driver.release()
        del model, driver
        gc.collect()
        torch.cuda.empty_cache()
        ref = training.reference_readings(state, names, dataset, seed, rcfg,
                                          mix["first_steps"], dev)
        row = dict(training.readings(prog, ref), seed=seed,
                   losses=prog["losses"], ref_losses=ref["losses"],
                   ref_seconds=ref["seconds"])
        if seed in control_seeds:
            for tag, kw in (("control", {"prec": "fp8"}), ("half", {"half": True})):
                other = training.reference_readings(state, names, dataset, seed, rcfg,
                                                    mix["first_steps"], dev, **kw)
                row.update({f"{tag}_{k}": v for k, v in training.readings(other, ref).items()})
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), file=log, flush=True)
        rows.append(row)
    return rows


def run_readings(bench, name, seeds, seconds, mode, device="cuda", log=sys.stdout):
    """Whole runs of the cell, one a seed, in this process
    (``runner.run_cell``, a window of ``seconds``): with ``mode`` "both"
    the program's readings and the control's on the same sample; with
    "on" the control judged in the program's place against the cell's
    limits, whose result has to be ``correct`` false."""
    from port_bench.core import runner
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        res = runner.run_cell(bench, name, seed, seconds, False, t, device=device,
                              control=mode)
        row = {"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
               "checks": {k: c["value"] for k, c in res["checks"].items()},
               "seconds": time.perf_counter() - t}
        if mode == "both":
            row["readings"] = res["readings"]
        print(json.dumps(row), file=log, flush=True)
        rows.append(row)
    summary = {}
    if mode == "both":
        first = rows[0]["readings"]
        for k in first:
            if k.startswith("control_") and k[8:] in first:
                base = k[8:]
                summary[base] = {"lower": max(r["readings"][base] for r in rows),
                                 "upper": min(r["readings"][k] for r in rows),
                                 "seeds": len(rows)}
    else:
        summary = {"correct": [r["correct"] for r in rows]}
    print(json.dumps({"cell": name, "mode": mode, "summary": summary}), file=log, flush=True)
    return rows, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=None,
                   help="training cells: the seeds that also read the control "
                        "and the faults (default: all)")
    p.add_argument("--mode", choices=("both", "on"), default="both",
                   help="both: readings of the program and the control; on: the "
                        "control in the program's place, judged by the limits")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None,
                   help="plant one of faults.py's faults in the program first")
    p.add_argument("--seconds", type=float, default=21.0,
                   help="the window of each run (long enough for the sample)")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_bench control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = spec.load(ROOT)
    if args.fault:
        FAULTS[args.fault]()
    train = bench.traffic(bench.cell(args.workload))["entry"] == "train_cached"
    if train and args.mode == "both":
        train_readings(bench, args.workload, args.seeds,
                       args.seeds if args.control_seeds is None else args.control_seeds)
    else:
        run_readings(bench, args.workload, args.seeds, args.seconds, args.mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
