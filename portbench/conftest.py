"""Fixtures of the benchmark's own tests: the paths, and tiny cells of each
part of a mix that run on the CPU (the kernels' plain versions) in seconds.

    python -m pytest portbench -q          # from the checkout's root

None needs the card: what only the card can show (the kernels, times, the
control at the cells' own sizes) is read by the runs and by
``calibrate.py`` there.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = {"name": "tiny-dense", "family": "dense", "reference": "dense",
              "n_layers": 2,
              "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16,
              "d_ff": 128, "vocab_size": 256, "pattern": ["attn"],
              "act": "swiglu", "norm_eps": 1e-5, "rope_theta": 1e6}
ENGINE = {"page_size": 16, "decode_horizon": 4, "prefill_mode": "batched",
          "sched_policy": "fcfs"}
# the tiny cells' limit: sound runs on the CPU read 0 or rounding
TINY_LIMIT = 1e-3


def tiny_cell(kind: str, *, sample: int = 2, limit: float = TINY_LIMIT):
    """A ``harness.spec.Cell`` at tiny widths whose mix is ``kind``: one of
    the parts (adopted / open / closed) alone, or ``mixed`` (adopted rows
    with open arrivals behind shared prefixes). It reports the metrics
    ``BENCHMARK.json`` gives ``yi34b-decode-long``."""
    from harness.spec import Cell, Metric, load_reader
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    check = {"sample": sample,
             "limits": {"logit_gap": limit, "min_positions": 10}}
    adopted = {"requests": 4, "context": {"dist": "uniform", "lo": 40,
                                          "hi": 90}, "max_new": 64}
    open_ = {"arrival": {"process": "gamma", "shape": 0.5,
                         "rate_per_s": 20.0},
             "prompt": {"dist": "lognormal", "median": 20, "sigma": 1.0,
                        "lo": 4, "hi": 60},
             "output": {"dist": "lognormal", "median": 6, "sigma": 0.8,
                        "lo": 2, "hi": 16}, "set_seed": 1}
    closed = {"clients": 4,
              "prompt": {"dist": "uniform", "lo": 8, "hi": 24},
              "output": {"dist": "uniform", "lo": 8, "hi": 24},
              "stagger_first": True}
    traffic, cell = {
        "adopted": ({"adopted": adopted},
                    {"engine": dict(ENGINE, n_slots=4, n_pages=64,
                                    max_context=160), "adopt_group": 2}),
        "open": ({"open": open_},
                 {"engine": dict(ENGINE, n_slots=8, n_pages=64,
                                 max_context=80)}),
        "closed": ({"closed": closed},
                   {"engine": dict(ENGINE, n_slots=4, n_pages=32,
                                   max_context=64)}),
        "mixed": ({"adopted": dict(adopted, requests=2), "open": open_,
                   "prefix": {"groups": 2, "length": {
                       "dist": "uniform", "lo": 8, "hi": 16}}},
                  {"engine": dict(ENGINE, n_slots=8, n_pages=128,
                                  max_context=160), "adopt_group": 2}),
    }[kind]
    cell["check"] = check
    name = "yi34b-decode-long"
    metrics = []
    for e2e, key in ((True, "end_to_end"), (False, "per_layer")):
        for m in bench[key]:
            if "workloads" not in m or name in m["workloads"]:
                metrics.append(Metric(m["name"], m["unit"], m["better"],
                                      m["source"], e2e,
                                      load_reader(m["name"])))
    return Cell(f"tiny-{kind}", 1, dict(TINY_DENSE), traffic, cell, metrics)


@pytest.fixture(autouse=True)
def short_warm_up(monkeypatch):
    """The tiny cells warm for a tenth of a second, not the cells' two."""
    from harness import drive
    monkeypatch.setattr(drive, "WARM_S", 0.1)


@pytest.fixture
def cpu_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
