"""The program's spans in one cell, joined with a traced slice of it.

    python3 port_bench/spans_probe.py --workload <cell> --seed <n> \\
        [--seconds 15] [--cost-runs 3] [--out DIR]

from the root of a checkout, on a machine with the card the cell asks for.
Set-up as ``run.py``'s (the cell's configuration, weights, clips or
dataset from the seed, its warm-up), then:

1. the clock: a span around ``torch.cuda.synchronize()`` under the profiler
   (CUDA activity), placed against the trace's ``cudaDeviceSynchronize``;
2. the recorder's cost: ``--cost-runs`` windows of ``--seconds`` with the
   recorder off and as many with it on, in turns (off, on, on, off, ...),
   the cell's clips a second of each;
3. the traced slice as ``run.py --trace 1`` takes it (the mix's batches or
   steps, ``torch.profiler`` with CUDA activity only), with the recorder
   on: the device's idle time by program span (``core/spans.py``), and the
   span metrics: the encoder's device ms a batch, the launches a batch
   inside ``decode``, the idle share while the host is inside ``decode``;
   for training the host ms of ``train.epoch_const``;
4. training cells: one eager call of the epoch-fused step with the
   recorder on, under the profiler, its device operations matched one to
   one with those of the slice's last graph replay: the replay's device ms
   by layer.

Prints the card and, last, one JSON line; with ``--out`` also writes the
slice's trace and spans there.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench.core import spans as S, spec  # noqa: E402
from port_bench.run import CACHES  # noqa: E402


def profiled_trace(fn, margin_s: float = 0.0) -> dict:
    """The Chrome trace (as loaded) of ``fn()`` under ``torch.profiler``,
    CUDA activity only, as ``core/trace.py::profiled`` takes it; with
    ``margin_s``, idle host time before and after the call inside the
    profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def clock_check(P) -> dict:
    """A span around ``torch.cuda.synchronize()`` against the trace's
    ``cudaDeviceSynchronize`` record nearest it: how far inside the span the
    record starts and ends (ns; both >= 0 where the clock is shared), five
    times."""
    import torch
    out = []
    for _ in range(5):
        with P.recording():
            trace = profiled_trace(lambda: _sync_span(torch, P))
            spans = [s for s in S.spans_of(P.drain()) if s.name == "clock.sync"]
        syncs = [e for e in S.events_of(trace) if e.name == "cudaDeviceSynchronize"]
        if spans and syncs:
            s = spans[0]
            e = min(syncs, key=lambda e: abs(e.start - s.start))
            out.append({"start_after_span_ns": e.start - s.start,
                        "end_before_span_ns": s.end - e.end,
                        "span_ns": s.end - s.start, "record_ns": e.end - e.start,
                        "same_thread": e.tid == s.thread})
    return {"runs": out}


def _sync_span(torch, P):
    x = torch.ones(1 << 20, device="cuda")
    for _ in range(20):
        x = x * 1.0001
    with P.span("clock.sync"):
        torch.cuda.synchronize()


def calls_by_name(events) -> dict:
    """{category: {name: count}} of the host's CUDA calls, the 12 most."""
    out: dict = {}
    for e in events:
        if e.cat in S.CALL_CATS:
            d = out.setdefault(e.cat, {})
            d[e.name] = d.get(e.name, 0) + 1
    return {c: dict(sorted(d.items(), key=lambda kv: -kv[1])[:12]) for c, d in out.items()}


def window_rate(part, seconds: float) -> float:
    """Clips a second of one window (an evaluation part counts its batches
    from its first window on)."""
    before = getattr(part, "i", 0)
    start = time.perf_counter()
    w = part.window(seconds)
    seconds = time.perf_counter() - start
    if hasattr(part, "i"):
        return (part.i - before) * part.mix["batch"] / seconds
    return w["clips"] / seconds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--cost-runs", type=int, default=3)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)

    bench = spec.load(ROOT)
    cell = bench.cell(args.workload)
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    os.environ["USE_FLAX"] = "0"
    import torch
    if not torch.cuda.is_available():
        print("spans_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from port_bench.core import runner
    from port_bench.core.weights import seeded_state
    from sbl_for_multilingual_lip_reading_tpu_torch import config as C, ops
    from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
    from sbl_for_multilingual_lip_reading_tpu_torch.utils import profiler as P
    card = runner.card_line()
    print(f"card: {card}", flush=True)

    conf, mix = bench.config(cell), bench.traffic(cell)
    for env in (conf.get("env", {}), mix.get("env", {})):
        os.environ.update({k: str(v) for k, v in env.items()})
    dev = torch.device("cuda")
    entry = bench.entry(mix["entry"])
    cfg = dataclasses.replace(runner.build_config(C.PRESETS, conf, mix), seed=args.seed)
    if hasattr(entry, "configure"):
        cfg = entry.configure(cfg, mix, args.seed)
    ops._build.library()
    model = build_model(cfg, device=dev)
    model.load_state_dict(seeded_state(model, args.seed, dev))
    part = entry.Part(torch, model, cfg, conf, mix, args.seed, dev)
    part.set_up()
    torch.cuda.synchronize()
    result = {"card": card, "cell": args.workload, "seed": args.seed,
              "setup_s": time.perf_counter() - T0, "clock": clock_check(P)}
    train = mix["entry"].startswith("train")

    cost = {"off": [], "on": [], "spans_a_second_on": []}
    for k in range(2 * args.cost_runs):
        on = k % 4 in (1, 2)
        if on:
            P.enable()
        rate = window_rate(part, args.seconds)
        if on:
            P.disable()
            cost["spans_a_second_on"].append(len(P.drain()) / args.seconds)
        cost["on" if on else "off"].append(rate)
    result["cost"] = cost

    with P.recording():
        trace = profiled_trace(part.traced_slice)
        recs = P.drain()
    spans, events = S.spans_of(recs), S.events_of(trace)
    win = S.traced_window(events)
    idle = S.idle_by_span(events, spans, win)
    total_idle = sum(idle.values())
    long_idle = total_idle - idle.get("gaps under 20 us", 0.0)
    sl = {"window_s": (win[1] - win[0]) * 1e-9,
          "busy_s": sum(b - a for a, b in S.device_busy(events, win)) * 1e-9,
          "idle_by_span_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
          "idle_in_a_span_share_of_long_gaps":
              (long_idle - idle.get("no span", 0.0)) / long_idle if long_idle else None,
          "spans": len(spans),
          "threads": sorted({s.thread for s in spans}),
          "call_tids": sorted({str(e.tid) for e in events if e.cat in S.CALL_CATS}),
          "main_thread": [threading.get_native_id(), threading.get_ident(),
                          threading.get_ident() & 0xFFFFFFFF],
          "calls": calls_by_name(events)}
    if train:
        sl["epoch_upload_ms.train"] = S.host_ms(spans, "train.epoch_const")
    else:
        sl["encoder_ms.recognize"] = S.self_ms_a_batch(events, spans, "encoder")
        sl["decode_launches.recognize"] = S.launches_a_batch(events, spans, "decode")
        sl["decode_idle_share.recognize"] = S.idle_share_inside(events, spans, win, "decode")
        sl["self_ms_a_span"] = {n: S.self_ms_a_batch(events, spans, n) for n in
                                 ("ingest", "frontend", "encoder", "decode",
                                  "decode.step", "beam.advance", "beam.regather")}
    result["slice"] = sl
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        stem = f"{args.workload}.{args.seed}"
        (args.out / f"{stem}.trace.json").write_text(json.dumps(trace))
        (args.out / f"{stem}.spans.json").write_text(json.dumps([list(s) for s in spans]))

    if train:
        result["map"] = train_map(torch, P, part, events, args.out)
    print(json.dumps(result), flush=True)
    return 0


def train_map(torch, P, part, slice_events, out_dir) -> dict:
    """One eager call of the fused step with the recorder on, matched with
    the slice's last replay: device ms of that replay by layer."""
    from sbl_for_multilingual_lip_reading_tpu_torch.models.layers import EagerGenerators
    tr = part.driver.trainer
    fs = tr.fused_step
    reps = S.replays(slice_events)
    if not reps:
        return {"error": "no graph replay in the slice"}
    replay = reps[-1]
    i = 0

    def eager():
        # on the stream the step was captured on, as its warm-up ran
        fs.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(fs.stream):
            fs.fn(i, None, EagerGenerators(tr.device, fs.const.host_seeds[i]))
        torch.cuda.current_stream().wait_stream(fs.stream)

    with P.recording():
        trace = profiled_trace(eager, margin_s=0.05)
        recs = P.drain()
    spans, events = S.spans_of(recs), S.events_of(trace)
    eager_ops = S.attribute_ops(events, spans)
    layers = S.train_layer_ms(eager_ops, replay)
    busy = S.device_busy(replay, (replay[0].start, replay[-1].end))
    out = {"replays": len(reps), "replay_ops": len(replay), "eager_ops": len(eager_ops),
           "replay_busy_ms": sum(b - a for a, b in busy) * 1e-6,
           "replay_ops_ms": sum(e.end - e.start for e in replay) * 1e-6,
           "layers_ms": layers, "eager_spans": len(spans),
           "eager_unattributed": sum(s is None for _, s in eager_ops)}
    out["eager_tids"] = sorted({str(e.tid) for e in events if e.cat in S.CALL_CATS})
    out["eager_threads"] = sorted({s.thread for s in spans})
    out["unattributed_by_name"] = dict(collections.Counter(
        e.name[:60] for e, s in eager_ops if s is None).most_common(8))
    if layers is None:
        out["first_mismatch"] = S.first_mismatch(eager_ops, replay)
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / "map_mismatch.json").write_text(json.dumps({
                "eager": [S.op_key(e) for e, _ in sorted(eager_ops, key=lambda es: es[0].start)],
                "replay": [S.op_key(e) for e in replay]}))
    # the eager step's own split, for comparison
    own = {}
    for e, s in eager_ops:
        k = S.TRAIN_LAYER.get(s.name, "unmapped") if s is not None else "unmapped"
        own[k] = own.get(k, 0.0) + (e.end - e.start) * 1e-6
    out["eager_layers_ms"] = own
    return out


if __name__ == "__main__":
    sys.exit(main())
