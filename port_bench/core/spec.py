"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell
or one per-layer metric sits in a file of its own, found by its name:

    port_bench/configs/<config>.json    sizes, preset, environment, source
    port_bench/traffic/<traffic>.json   the mix's parameters; its ``entry``
                                        names the file below
    port_bench/entries/<entry>.py       how the program is driven: a
                                        ``Part`` (set-up, window, traced
                                        slice, judgement, end-to-end values)
    port_bench/limits/<cell>.json       the limits that decide ``correct``
    port_bench/metrics/<metric>.py      a reader with ``read(run)``

so a later change adds a cell, a configuration, a mix, a way to drive the
program or a metric by adding files and entries, and edits none that is
there.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    pass


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


class Bench:
    """The parsed ``BENCHMARK.json`` of the checkout at ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "port_bench"
        self.spec = _load_json(self.root / "BENCHMARK.json")
        self.configs = {c["name"]: c for c in self.spec["configs"]}
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.end_to_end = {m["name"]: m for m in self.spec["end_to_end"]}
        self.per_layer = {m["name"]: m for m in self.spec["per_layer"]}

    # -- files by name
    def config_file(self, name: str) -> Path:
        return self.root / self.configs[name]["file"]

    def traffic_file(self, name: str) -> Path:
        return self.bench_dir / "traffic" / f"{name}.json"

    def limits_file(self, cell: str) -> Path:
        return self.bench_dir / "limits" / f"{cell}.json"

    def metric_file(self, name: str) -> Path:
        return self.bench_dir / "metrics" / f"{name}.py"

    def entry_file(self, name: str) -> Path:
        return self.bench_dir / "entries" / f"{name}.py"

    # -- a cell's parts
    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                            f"(have {sorted(self.cells)})")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        return _load_json(self.config_file(cell["config"]))

    def traffic(self, cell: dict) -> dict:
        return _load_json(self.traffic_file(cell["traffic"]))

    def limits(self, cell: dict) -> dict:
        return _load_json(self.limits_file(cell["name"]))

    def _reports(self, metric: dict, cell: str) -> bool:
        return cell in metric.get("workloads", self.cells)

    def end_to_end_of(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if self._reports(m, cell)]

    def per_layer_of(self, cell: str) -> List[dict]:
        return [m for m in self.spec["per_layer"] if self._reports(m, cell)]

    def reader(self, metric: str):
        """The ``read(run)`` function of a per-layer metric's file."""
        return _module(self.metric_file(metric), "port_bench_metric_").read

    def entry(self, name: str):
        """The module of an entry's file (its ``Part``, and ``configure``
        where it changes the program's config)."""
        if not NAME.match(name):
            raise SpecError(f"bad entry name {name!r}")
        return _module(self.entry_file(name), "port_bench_entry_")

    def problems(self) -> List[str]:
        """Every file a name points to that is missing, and every name or
        unit outside the allowed characters."""
        out = []
        s = self.spec
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            for e in s[group]:
                if not NAME.match(e["name"]):
                    out.append(f"{group}: bad name {e['name']!r}")
                if "unit" in e and not UNIT.match(e["unit"]):
                    out.append(f"{group}: bad unit {e['unit']!r}")
        for c in s["configs"]:
            for k in c["reduced"]:
                if not NAME.match(k):
                    out.append(f"config {c['name']}: bad key {k!r}")
            if not self.config_file(c["name"]).is_file():
                out.append(f"config {c['name']}: {c['file']} missing")
        for w in s["workloads"]:
            for k in ("config", "traffic"):
                if not NAME.match(w[k]):
                    out.append(f"workload {w['name']}: bad {k} {w[k]!r}")
            if w["config"] not in self.configs:
                out.append(f"workload {w['name']}: no config {w['config']!r}")
            for path in (self.traffic_file(w["traffic"]),
                         self.limits_file(w["name"])):
                if not path.is_file():
                    out.append(f"workload {w['name']}: {path} missing")
            if self.traffic_file(w["traffic"]).is_file():
                entry = self.traffic(w).get("entry", "")
                if not NAME.match(entry) or not self.entry_file(entry).is_file():
                    out.append(f"workload {w['name']}: entry {entry!r} missing")
        for m in s["per_layer"]:
            if not self.metric_file(m["name"]).is_file():
                out.append(f"metric {m['name']}: reader missing")
            if m["moves"] not in self.end_to_end:
                out.append(f"metric {m['name']}: moves unknown {m['moves']!r}")
        for m in s["end_to_end"] + s["per_layer"]:
            for w in m.get("workloads", []):
                if w not in self.cells:
                    out.append(f"metric {m['name']}: unknown workload {w!r}")
        return out


_LOADED: dict = {}


def _module(path: Path, prefix: str):
    """The module of a file, loaded once a process."""
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    key = str(path.resolve())
    if key not in _LOADED:
        name = prefix + re.sub(r"\W", "_", path.stem)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def load(root: Path = ROOT) -> Bench:
    return Bench(root)


