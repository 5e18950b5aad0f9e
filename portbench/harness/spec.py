"""Resolve a cell by name into the files that define it.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic mix. Everything else is found by name, so a new
cell, configuration, mix or metric is new files and entries only:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  model's sizes as they are run;
* ``traffic/<traffic>.json``: the mix, read by ``harness.traffic``;
* ``cells/<workload>.json``: what the deployment fixes for this cell (the
  engine's slots, pages and horizon, the set-up, the correctness sample
  and its limits);
* ``metrics/<metric>.py``: one reader per metric, ``read(w) -> float |
  None`` over a ``harness.window.Window``.

The metrics a cell reports are those of ``BENCHMARK.json`` whose
``workloads`` list names it, or that have no such list.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    read: object                      # read(window) -> float | None
    moves: str | None = None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                      # configs/<config>.json
    traffic: dict                     # traffic/<traffic>.json
    cell: dict                        # cells/<workload>.json
    metrics: list = field(default_factory=list)    # [Metric]

    def metrics_for(self, trace: bool) -> list:
        """A ``--trace 0`` run reports the end-to-end metrics, a ``--trace
        1`` run the per-layer ones."""
        return [m for m in self.metrics if m.end_to_end != trace]


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<name>.py``'s ``read``, loaded by path (names hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its files
    and metric readers. Raises ``KeyError`` for an unknown cell and
    ``FileNotFoundError`` for a missing file."""
    bench = load_json(root / "BENCHMARK.json")
    bench_dir = root / "portbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    cell = load_json(bench_dir / "cells" / f"{workload}.json")
    metrics = []
    for e2e, key in ((True, "end_to_end"), (False, "per_layer")):
        for m in bench[key]:
            if _applies(m, workload):
                metrics.append(Metric(m["name"], m["unit"], m["better"],
                                      m["source"], e2e,
                                      load_reader(m["name"], bench_dir),
                                      m.get("moves")))
    return Cell(workload, int(w["chips"]), config, traffic, cell, metrics)
