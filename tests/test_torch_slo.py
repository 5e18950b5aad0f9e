"""The port's SLO bench against ``BENCH_slo.json``, on the CPU.

``repro_torch.launch.slo_bench`` replays the committed workload trace
(``benchmarks/traces/slo_default.json``) through the port's engine on a
``VirtualClock`` under FCFS, EDF and the SLO-aware policy, with repro's
``PRNGKey(0)`` weights converted. Its counters are functions of scheduling
alone, so every row equals the committed baseline's exactly and
``benchmarks/check_regression.py`` passes it; under the ``slo`` policy
(priority preemption mid-decode) the row and the tokens also equal repro's
own bench run. The port's copy of the trace generator reproduces the
committed trace and materializes the same prompts.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro_torch.data import workload
from repro_torch.launch import slo_bench
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.clock import VirtualClock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
import slo_bench as jax_slo_bench  # noqa: E402
import workload as jax_workload  # noqa: E402


@pytest.fixture(scope="module")
def params():
    """repro's bench weights (``serving_bench._setup``), converted."""
    _, jp = jax_slo_bench._setup("llama3.2-1b")
    return params_from_numpy(slo_bench.bench_config(),
                             jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def rows(params):
    return slo_bench.bench(params=params, device="cpu")


def test_slo_rows_equal_bench_slo_json(rows):
    want = json.loads((ROOT / "BENCH_slo.json").read_text())["rows"]
    got = [{k: v for k, v in r.items() if k != "outputs"} for r in rows]
    assert got == want


def test_check_regression_accepts_the_port(rows, tmp_path):
    fresh = tmp_path / "slo.json"
    slo_bench.write_json(rows, str(fresh))
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "check_regression.py"),
         "--baseline", str(ROOT / "BENCH_slo.json"), "--fresh", str(fresh)],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_smoke_flag_is_a_noop(tmp_path, capsys):
    """``--smoke`` parses as ``benchmarks/slo_bench.py`` parses it: the same
    committed trace, the same rows (scheduling under ``eos=-1`` does not
    depend on the weights, so the port's own seeded weights give
    ``BENCH_slo.json``'s rows too)."""
    out = tmp_path / "slo.json"
    slo_bench.main(["--smoke", "--device", "cpu", "--json", str(out)])
    assert "slo_slo," in capsys.readouterr().out
    want = json.loads((ROOT / "BENCH_slo.json").read_text())["rows"]
    assert json.loads(out.read_text())["rows"] == want


def test_slo_policy_row_and_tokens_equal_repro(rows):
    """The ``slo`` policy (priority preemption through re-prefill) on
    repro's engine: the same row and the same tokens."""
    jrow = jax_slo_bench.bench_policy(
        "slo", jax_workload.load_trace(jax_slo_bench.DEFAULT_TRACE))
    port = {r["policy"]: r for r in rows}["slo"]
    assert port == jrow


def test_trace_generator_matches_committed_trace():
    cfg = workload.default_slo_config()
    trace = workload.generate(cfg)
    assert trace == workload.load_trace(slo_bench.DEFAULT_TRACE)
    assert trace == jax_workload.generate(jax_workload.default_slo_config())
    for ev in trace["events"]:
        if ev["kind"] == "submit":
            np.testing.assert_array_equal(
                workload.prompt_tokens(trace, ev, 256),
                jax_workload.prompt_tokens(trace, ev, 256))
            spec = workload.request_of(trace, ev, 256)
            assert (spec.priority, spec.tenant, spec.deadline_s) == \
                (ev["priority"], ev["tenant"], ev["deadline_s"])


def test_virtual_clock():
    vc = VirtualClock()
    assert vc() == 0.0
    vc.advance(0.25)
    vc.advance_to(1.0)
    vc.advance_to(0.5)          # never goes backwards
    assert vc() == 1.0
    with pytest.raises(AssertionError):
        vc.advance(-0.1)
