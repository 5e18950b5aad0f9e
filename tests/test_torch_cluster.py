"""repro_torch's disaggregated serving against repro's and its own engine.

The handoff wire format (round trip, blobs crossing between the two
packages in both directions, every torn or flipped blob refused by both);
a prefill/decode cluster token-identical to one colocated engine in slot,
batched and chunked prefill (batched and chunked also equal to repro's
cluster, counters included); a colocated cluster; the zamba2 carry
handoff; adoption into a decode engine whose horizons are captured (stand-
in graphs) with every buffer kept; ``BENCH_serving.json``'s ``disagg_1p1d``
row; ``serve --disagg``, ``--static``, ``--sched-policy`` and
``--no-decode-bucket``; and the chaos soak's ``disagg`` scenario.
"""
import json
import pathlib
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kvcache import handoff as JHO
from repro.models import model as JMDL
from repro.serving import ClusterConfig as JaxClusterConfig
from repro.serving import EngineCluster as JaxCluster
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.kvcache import handoff as HO
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import (ClusterConfig, DecodeEngine, EngineCluster,
                                 EngineConfig, Request)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# tests/test_cluster.py's geometry
KW = dict(n_slots=3, page_size=4, n_pages=96, max_context=64, eos_token=-1)


@pytest.fixture(scope="module")
def models():
    jcfg = replace(jax_reduced(jax_get_config("llama3.2-1b")),
                   dtype="float32")
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(3, 20)))
            for _ in range(n)]


def single(cfg, params, ps, max_new=5, **ekw):
    eng = DecodeEngine(cfg, EngineConfig(**{**KW, **ekw}), params,
                       device="cpu")
    for r, p in enumerate(ps):
        eng.submit(Request(r, p, max_new))
    return {k: list(v) for k, v in eng.run(2000).items()}


def cluster(cfg, params, ps, ccfg=None, max_new=5, **ekw):
    cl = EngineCluster(cfg, EngineConfig(**{**KW, **ekw}),
                       ccfg or ClusterConfig(), params, device="cpu")
    for r, p in enumerate(ps):
        cl.submit(Request(r, p, max_new))
    return cl, {k: list(v) for k, v in cl.run(2000).items()}


def assert_drained(cl, n) -> None:
    assert cl.done()
    assert sum(1 for rec in cl.reqs.values()
               if rec["state"] in ("done", "aborted")) == n == len(cl.reqs)
    for h in cl.handles:
        if h.alive:
            eng = h.eng
            assert eng.batcher.done() and eng._inflight is None
            assert eng.alloc.pages_in_use == 0
            assert not eng.rsnaps and not eng.deadline_t \
                and not eng._abort_req


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------

ENTRY = {"prompt_len": 9, "max_new": 4, "state": "warm", "depth": 9,
         "priority": 2}


def _arrays():
    rng = np.random.default_rng(1)
    return {"prompt": np.arange(8, dtype=np.int32),
            "out": np.asarray([7, 3], np.int32),
            "kv_k": rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32),
            "kv_v": rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32),
            "rows": {"mamba": {"conv": np.ones((2, 1, 3), np.float32),
                               "ssm": (np.zeros((2, 1, 4), np.float32),
                                       np.full((2, 1), 5.0, np.float32))}}}


def test_handoff_roundtrip_and_nested_arrays():
    arrs = _arrays()
    h = HO.pack(3, ENTRY, arrs)
    got = HO.decode(HO.encode(h))
    assert got.req_id == 3 and got.entry == ENTRY
    assert got.kv_pages == 3
    nested = HO.nested_arrays(got)
    assert np.array_equal(nested["prompt"], arrs["prompt"])
    assert np.array_equal(nested["kv_v"], arrs["kv_v"])
    assert np.array_equal(nested["rows"]["mamba"]["ssm"]["1"],
                          arrs["rows"]["mamba"]["ssm"][1])
    # torch leaves go through checkpoint.to_numpy: bf16 crosses as f32
    t = HO.pack(0, ENTRY, {"kv_k": torch.ones(2, dtype=torch.bfloat16)})
    assert t.arrays["kv_k"].dtype == np.float32


@pytest.mark.parametrize("direction", ["repro_to_port", "port_to_repro"])
def test_handoff_blob_decodes_in_the_other_package(direction):
    """One wire format: a blob either package encodes decodes in the
    other with equal arrays, entry and id, and the encodings are equal
    byte for byte."""
    arrs = _arrays()
    enc, dec = ((JHO, HO) if direction == "repro_to_port" else (HO, JHO))
    blob = enc.encode(enc.pack(11, ENTRY, arrs))
    assert blob == dec.encode(dec.pack(11, ENTRY, arrs))
    got = dec.decode(blob)
    want = enc.pack(11, ENTRY, arrs)
    assert got.req_id == 11 and got.entry == ENTRY
    assert set(got.arrays) == set(want.arrays)
    for k, v in want.arrays.items():
        assert got.arrays[k].dtype == v.dtype
        assert np.array_equal(got.arrays[k], v), k


@pytest.mark.parametrize("damage", ["tear", "flip"])
def test_handoff_damage_detected_in_both_packages(damage):
    """Every salt's torn or flipped blob is the same bytes in both packages
    and raises HandoffError in both before anything is built."""
    h = HO.pack(0, {"prompt_len": 4, "max_new": 2, "state": "cold"},
                {"prompt": np.arange(4, dtype=np.int32),
                 "out": np.asarray([1], np.int32)})
    blob = HO.encode(h)
    for salt in range(12):
        bad = getattr(HO, damage)(blob, salt)
        assert bad == getattr(JHO, damage)(blob, salt)
        with pytest.raises(HO.HandoffError):
            HO.decode(bad)
        with pytest.raises(JHO.HandoffError):
            JHO.decode(bad)
    assert HO.decode(blob).entry == h.entry    # the pristine one decodes


# ---------------------------------------------------------------------------
# disaggregated == colocated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["slot", "batched", "chunked"])
def test_disagg_token_identical_to_colocated(models, mode):
    """Every request crosses the handoff once and comes out with the single
    engine's tokens; in batched and chunked prefill repro's cluster gives
    the same tokens and router counters."""
    jcfg, jparams, cfg, params = models
    ps = prompts(6)
    ref = single(cfg, params, ps, prefill_mode=mode)
    cl, outs = cluster(cfg, params, ps, prefill_mode=mode)
    assert outs == ref
    assert cl.counters["handoffs"] == cl.counters["handoff_ok"] == 6
    assert_drained(cl, 6)
    if mode != "slot":
        jcl = JaxCluster(jcfg, JaxEngineConfig(use_pallas=False,
                                               prefill_mode=mode, **KW),
                         JaxClusterConfig(), jparams)
        for r, p in enumerate(ps):
            jcl.submit(JaxRequest(r, p, 5))
        assert {k: list(v) for k, v in jcl.run(2000).items()} == outs
        assert jcl.counters == cl.counters


def test_colocated_cluster_matches_single_engine(models):
    _, _, cfg, params = models
    ps = prompts(6)
    cl, outs = cluster(cfg, params, ps,
                       ClusterConfig(colocated=True, n_prefill=1, n_decode=0))
    assert outs == single(cfg, params, ps)
    assert cl.counters["handoffs"] == 0
    assert [h.role for h in cl.handles] == ["both"]
    assert_drained(cl, 6)


def test_disagg_zamba2_carry_handoff():
    """The hybrid's Mamba2 carry rides the handoff with its KV pages
    (flattened by ``pack``, rebuilt by ``_rows_from_nested``); the decode
    engine seats it warm and the tokens equal the port's single engine."""
    cfg = replace(reduced(get_config("zamba2-1.2b")), dtype="float32")
    params = MDL.init_params(cfg, 0, torch.float32, "cpu")
    ps = prompts(3)
    ref = single(cfg, params, ps, max_new=4)
    cl, outs = cluster(cfg, params, ps, max_new=4)
    assert outs == ref
    assert cl.counters["handoff_ok"] == 3
    assert cl.handles[1].eng.rstate_restores >= 1
    assert_drained(cl, 3)


def test_adopt_into_a_captured_decode_engine_keeps_its_buffers(
        models, monkeypatch):
    """The decode engine's horizons run as (stand-in) graphs: adoptions
    after its first capture write pages in place, no tensor a graph reads
    is rebound, and no key is captured twice."""
    from test_torch_graphs import _stand_in_graphs
    _, _, cfg, params = models
    ps = prompts(6)
    ref = single(cfg, params, ps, decode_horizon=4)
    cl = EngineCluster(cfg, EngineConfig(decode_horizon=4, **KW),
                       ClusterConfig(), params, device="cpu")
    dec = cl.handles[1].eng
    _stand_in_graphs(monkeypatch, dec.horizons)
    captures, late = [], []
    capture, adopt = dec.horizons.capture, dec.adopt_request
    monkeypatch.setattr(dec.horizons, "capture",
                        lambda key: (captures.append(key), capture(key)))
    monkeypatch.setattr(dec, "adopt_request", lambda rid, *a, **k: (
        late.append(rid) if captures else None, adopt(rid, *a, **k))[1])

    def ptrs():
        return [t.data_ptr() for t in (
            dec.state["pool"]["k"], dec.state["pool"]["v"], dec.dev.bt,
            dec.dev.ctx, dec.dev.tokens, dec.dev.rem, dec.horizons.allow)]
    before = ptrs()
    for r, p in enumerate(ps):
        cl.submit(Request(r, p, 5))
    while not cl.done():
        cl.tick()
        assert ptrs() == before
    assert late                  # requests adopted after the first capture
    assert len(captures) == len(set(captures)) == len(dec.horizons.captured)
    assert {k: list(v) for k, v in cl.outputs.items()} == ref
    assert_drained(cl, 6)


# ---------------------------------------------------------------------------
# BENCH_serving.json row 9
# ---------------------------------------------------------------------------

def test_bench_serving_disagg_row_counters(models):
    """``benchmarks/serving_bench.py::bench_disagg``'s geometry, warm-up
    and seeds on the port's cluster: the committed row's counters exactly."""
    _, _, cfg, params = models
    row = next(r for r in json.loads(
        (ROOT / "BENCH_serving.json").read_text())["rows"]
        if r["mode"] == "disagg_1p1d")
    cl = EngineCluster(cfg, EngineConfig(
        n_slots=4, page_size=8, n_pages=160, max_context=128, eos_token=-1,
        prefill_mode="batched"), ClusterConfig(n_prefill=1, n_decode=1),
        params, device="cpu")
    rng = np.random.default_rng(7)
    for i in range(2):
        cl.submit(Request(1000 + i, rng.integers(
            0, cfg.vocab_size, size=int(rng.integers(8, 64))), 8))
    cl.run(10_000)
    warm = dict(cl.counters)
    rng = np.random.default_rng(0)
    for i in range(8):
        plen = int(rng.integers(8, 64))
        cl.submit(Request(i, rng.integers(0, cfg.vocab_size, size=plen), 8))
    cl.run(10_000)
    c = cl.counters
    got = {"tokens": sum(len(v) for k, v in cl.outputs.items() if k < 1000),
           "aborted": len(cl.aborted),
           "faults_injected": cl.faults.total_fired,
           "handoffs": c["handoffs"] - warm["handoffs"],
           "handoff_ok": c["handoff_ok"] - warm["handoff_ok"],
           **{k: c[k] for k in ("handoff_retries", "handoff_redispatches",
                                "redispatched_requests", "engine_deaths",
                                "shed")}}
    assert got == {k: row[k] for k in got}
    assert got["tokens"] == 72 and got["handoffs"] == got["handoff_ok"] == 8


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

SERVE = ["--requests", "6", "--slots", "3", "--page", "8", "--pages", "64",
         "--max-context", "128", "--mean-new", "8", "--device", "cpu"]


def test_serve_disagg_completes_with_a_handoff_each(capsys):
    from repro_torch.launch import serve
    args = SERVE + ["--decode-horizon", "1"]
    st = serve.serve(args + ["--disagg", "--engines", "1+1"])
    out = capsys.readouterr().out
    assert st["completed"] == 6 and "completed=6/6" in out
    assert st["cluster"]["handoffs"] == st["cluster"]["handoff_ok"] == 6
    assert "handoffs=6 ok=6" in out
    assert out.count("page balance per shard: max=0 min=0") == 2
    assert st["outputs"] == serve.serve(args)["outputs"]


# the example's memory-constrained regime: static reserves 32 + 1 pages a
# request, so the 72-page pool holds 2 static requests
LONGBENCH = ["--requests", "10", "--slots", "6", "--page", "8", "--pages",
             "72", "--max-context", "256", "--mean-new", "10", "--device",
             "cpu"]


def test_serve_static_admits_fewer_than_lazy(capsys):
    from repro_torch.launch import serve
    lazy = serve.serve(LONGBENCH)
    static = serve.serve(LONGBENCH + ["--static"])
    out = capsys.readouterr().out
    assert "mode=lazy(DPA)" in out and "mode=static" in out
    assert lazy["completed"] == static["completed"] == 10
    assert static["avg_batch"] < lazy["avg_batch"]
    assert static["outputs"] == lazy["outputs"]


@pytest.mark.parametrize("flags", [["--sched-policy", "sjf"],
                                   ["--policy", "memory_aware"],
                                   ["--no-decode-bucket"]])
def test_serve_policy_and_bucket_flags(flags, capsys):
    from repro_torch.launch import serve
    st = serve.serve(SERVE + flags)
    out = capsys.readouterr().out
    assert st["completed"] == 6 and "completed=6/6" in out
    if "--no-decode-bucket" not in flags:
        assert f"policy={flags[1]}" in out
    assert st["outputs"] == serve.serve(SERVE)["outputs"]


# ---------------------------------------------------------------------------
# the chaos soak's disagg scenario
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_soak_disagg(models, seed):
    """Its invariants hold (asserted inside: terminal, leak-free,
    backpressure fired, handoffs made, completed requests equal the clean
    run's); seed 0's stats equal ``benchmarks/chaos_soak.py``'s."""
    from repro_torch.launch.chaos_soak import ChaosSoak
    stats, outs = ChaosSoak("cpu", params=models[3]).disagg(seed)
    assert stats["completed"] + stats["aborted"] == 14 == len(outs)
    assert stats["cluster"]["shed"] >= 1
    if seed == 0:
        assert stats["cluster"]["engine_deaths"] >= 1
        sys.path.insert(0, str(ROOT / "benchmarks"))
        import chaos_soak as jax_soak
        want = jax_soak.scenario_disagg(0)
        for k, v in want.items():
            assert stats[k] == v, k
