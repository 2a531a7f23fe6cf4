"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The cells, configurations, mixes and metrics are the entries of
``BENCHMARK.json`` and the files under ``port_bench/`` they name.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` also ``breakdown``;
``checks`` last: each number compared beside its limit, which are also the
last lines of standard error).  Without a card, or with fewer than the cell
asks for, the run exits 2 and prints no result; with a module of JAX or of
the JAX package loaded, 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench.core import guard, spec  # noqa: E402

# every compile cache in a fixed directory inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "port_bench" / "_cache" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "port_bench" / "_cache" / "triton"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = spec.load(ROOT)
    cell = bench.cell(args.workload)
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    os.environ["USE_FLAX"] = "0"
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from port_bench.core import runner
    print(f"card: {runner.card_line()}", flush=True)
    try:
        result = runner.run_cell(bench, args.workload, args.seed, args.seconds,
                                 bool(args.trace), T0)
    except runner.RunError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3
    found = guard.forbidden_loaded()
    if found:
        print(f"port_bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    runner.report_checks(result["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
