"""The port's serving and KV-cache benches (``repro_torch.launch``) on the
CPU.

``serving_bench`` at ``BENCH_serving.json``'s sizes: all 12 rows, in the
baseline's order, and the counter layer of
``benchmarks/check_regression.py::check_serving`` (emitted tokens, syncs per
token, the speculative rows' accept length, the robustness and handoff
counters) reports nothing against the baseline; the layer's normalized
timings compare this run's CPU wall clock with the baseline's and are
printed, not asserted. Its ``--smoke`` JSON carries the baseline's keys.

``kvcache_bench`` at a 90% share, with and without the prefix cache, against
``benchmarks/kvcache_bench.py``'s engine and waves on converted weights and
the port's in-vocabulary system prompt: peak pages, cache hits and reused
tokens, emitted tokens and outputs equal.
"""
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro_torch.launch import kvcache_bench as KVB
from repro_torch.launch import serving_bench as SB
from repro_torch.models.convert import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _module(name):
    """A framework-free module of ``benchmarks/`` (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"bench_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _baseline():
    return json.loads((ROOT / "BENCH_serving.json").read_text())


def _key(r):
    return (r["trace"], r["arch"], r["mode"], r["horizon"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The benches run tiny shapes here: one intra-op thread a worker keeps
    the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def serving_rows():
    rows = SB.run(lambda *a: None, device="cpu")
    return [{k: v for k, v in r.items() if k != "outputs"} for r in rows]


def test_serving_bench_has_every_baseline_row(serving_rows):
    base = _baseline()["rows"]
    assert [_key(r) for r in serving_rows] == [_key(r) for r in base]


def test_serving_bench_counter_layer_matches_baseline(serving_rows):
    msgs = _module("check_regression").check_serving(
        _baseline(), [{"bench": "serving", "rows": serving_rows}], 0.20,
        False)
    timing = [m for m in msgs if "normalized" in m]
    counters = [m for m in msgs if "normalized" not in m]
    for m in timing:        # reported (pytest -rP shows them), not asserted
        print(f"[timing layer] {m}")
    assert not counters, counters
    by = {_key(r): r for r in serving_rows}
    assert by["spec", "llama3.2-1b", "batched", 1]["accept_len_mean"] == 16.0
    assert by["disagg", "llama3.2-1b", "disagg_1p1d", 1]["handoff_ok"] == 8


def test_serving_bench_smoke_json_has_baseline_keys(tmp_path):
    path = tmp_path / "serving.json"
    SB.main(["--smoke", "--json", str(path), "--device", "cpu"])
    got = json.loads(path.read_text())
    base = _baseline()
    assert got["bench"] == base["bench"] == "serving"
    assert [_key(r) for r in got["rows"]] == [_key(r) for r in base["rows"]]
    for g, b in zip(got["rows"], base["rows"]):
        assert set(g) == set(b), (_key(b), set(g) ^ set(b))


@pytest.mark.parametrize("cache", [False, True], ids=["no-cache", "cache"])
def test_kvcache_bench_matches_repro(cache):
    """The reference's 90%-shared waves (three of 8 x 512 tokens on 1024
    pages) through both packages on the same weights and system prompt."""
    ref = _module("kvcache_bench")
    jcfg, jparams = ref._setup()
    cfg = KVB.bench_config()
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    eng = ref._make_engine(cache=cache, n_pages=1024)
    for w in (1, 2, 3):
        want = ref._wave(eng, jcfg, w, system=KVB.system_prompt(cfg),
                         shared_frac=0.9)
    want["eng"] = eng
    got = KVB.bench(shared_frac=0.9, cache=cache, params=params,
                    device="cpu")
    assert len(set(map(tuple, got["outputs"].values()))) > 1
    assert got["outputs"] == want["outputs"]
    assert got["peak_pages"] == want["peak_pages"]
    assert got["peak_kv"] == want["peak_kv"]
    assert got["tokens"] == sum(len(v) for v in want["outputs"].values())
    if cache:
        a, b = got["eng"].cache.stats, want["eng"].cache.stats
        assert (a.hits, a.hit_tokens) == (b.hits, b.hit_tokens)
        assert a.hits >= 16
