"""The paper-figure benches on the port (``launch/paper_bench.py``)
against ``benchmarks/run.py``'s six suites: every row equal (name, value
and derived string), 173 in all; and the CLI's CSV."""
import pathlib
import sys

import pytest

from repro_torch.launch import paper_bench as PB

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmarks import (io_overlap, latency_breakdown,  # noqa: E402
                        lazy_alloc, throughput_scaling, tp_pp_ablation,
                        utilization)

PAIRS = [(throughput_scaling, PB.throughput_scaling),
         (tp_pp_ablation, PB.tp_pp_ablation), (lazy_alloc, PB.lazy_alloc),
         (io_overlap, PB.io_overlap),
         (latency_breakdown, PB.latency_breakdown),
         (utilization, PB.utilization)]


@pytest.mark.parametrize("ref, ours", PAIRS,
                         ids=[p[1].__name__ for p in PAIRS])
def test_suite_rows_equal_repro(ref, ours):
    want, got = [], []
    ref.run(lambda *r: want.append(r))
    ours(lambda *r: got.append(r))
    assert got == want and len(got) > 0


def test_all_rows_and_cli(capsys):
    rows = []
    PB.run_all(lambda *r: rows.append(r))
    assert len(rows) == 173
    assert PB.main() == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    name, us, derived = rows[0]
    assert out[1] == f"{name},{us:.2f},{derived}"
    assert out[-1] == "# 173 benchmark rows"
