"""repro_torch's cluster router against repro's under seeded faults.

``tests/test_cluster.py``'s robustness cases, run on both packages with
the same converted weights, prompts and fault plan: torn and corrupt
handoffs retried, an all-corrupt plan re-driven cold, a timeout
re-dispatched, engine death recovered cold and warm, every engine dead,
router backpressure and the router's telemetry. Outputs, aborts, the
router's counters and the fired-fault log must be equal, and every
surviving port engine drained without a leak.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JMDL
from repro.runtime.faults import FaultConfig as JaxFaultConfig
from repro.serving import ClusterConfig as JaxClusterConfig
from repro.serving import EngineCluster as JaxCluster
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.faults import FaultConfig
from repro_torch.serving import ClusterConfig, EngineCluster, EngineConfig
from repro_torch.serving import Request

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


def both(models, ccfg: dict, faults: dict | None = None, snap=None,
         **ekw):
    """The same cluster in both packages: ``ccfg`` the ClusterConfig
    fields, ``faults`` the FaultConfig fields, ``snap`` a pair of snapshot
    directories (repro's, the port's)."""
    jcfg, jparams, cfg, params = models
    jc = dict(ccfg, faults=JaxFaultConfig(**faults) if faults else None)
    tc = dict(ccfg, faults=FaultConfig(**faults) if faults else None)
    if snap is not None:
        jc["snapshot_dir"], tc["snapshot_dir"] = map(str, snap)
    jax_cl = JaxCluster(jcfg, JaxEngineConfig(use_pallas=False, **KW, **ekw),
                        JaxClusterConfig(**jc), jparams)
    cl = EngineCluster(cfg, EngineConfig(**KW, **ekw), ClusterConfig(**tc),
                       params, device="cpu")
    return jax_cl, cl


def submit_all(cl, reqs, ps, max_new):
    return [cl.submit(reqs(r, p, max_new)) for r, p in enumerate(ps)]


def assert_same(jax_cl, cl) -> None:
    """Outputs, aborts, counters, degradation and the fault log equal."""
    assert {k: list(v) for k, v in cl.outputs.items()} \
        == {k: list(v) for k, v in jax_cl.outputs.items()}
    assert cl.aborted == jax_cl.aborted
    assert cl.counters == jax_cl.counters
    assert cl.stats_dict() == jax_cl.stats_dict()
    assert cl.degraded_mode == jax_cl.degraded_mode
    assert dict(cl.faults.counts) == dict(jax_cl.faults.counts)
    assert list(cl.faults.events) == list(jax_cl.faults.events)
    assert [(h.role, h.alive) for h in cl.handles] \
        == [(h.role, h.alive) for h in jax_cl.handles]


def assert_drained(cl, n) -> None:
    assert cl.done()
    term = sum(1 for rec in cl.reqs.values()
               if rec["state"] in ("done", "aborted"))
    assert term == n == len(cl.reqs)
    for h in cl.handles:
        if not h.alive:
            continue
        eng = h.eng
        assert eng.batcher.done() and eng._inflight is None
        assert eng.alloc.pages_in_use == 0
        assert not eng.rsnaps and not eng.deadline_t and not eng._abort_req


def run_both(models, ccfg, faults=None, *, n=6, max_new=5, snap=None):
    jax_cl, cl = both(models, ccfg, faults, snap=snap)
    ps = prompts(n)
    submit_all(jax_cl, JaxRequest, ps, max_new)
    submit_all(cl, Request, ps, max_new)
    jax_cl.run(2000)
    cl.run(2000)
    assert_same(jax_cl, cl)
    assert_drained(cl, n)
    return cl


@pytest.mark.parametrize("kind", ["handoff_torn", "handoff_corrupt"])
def test_handoff_damage_retries_like_repro(models, kind):
    cl = run_both(models, {}, dict(seed=5, **{f"{kind}_p": 0.5}))
    assert cl.counters["handoff_retries"] >= 1
    assert cl.faults.counts.get(kind, 0) >= 1


def test_all_corrupt_redrives_cold_like_repro(models):
    cl = run_both(models, dict(handoff_retries=3),
                  dict(seed=3, handoff_corrupt_p=1.0))
    assert cl.counters["handoff_ok"] == 0
    assert cl.counters["handoff_redrives"] == 6
    assert cl.counters["handoff_retries"] == 6 * 4


def test_timeout_redispatch_like_repro(models):
    """Kill the destination of the first pending transfers: the deadline
    fires and the handoffs move to the surviving decode engine."""
    ccfg = dict(n_prefill=1, n_decode=2, transfer_ticks=3, handoff_timeout=2)
    jax_cl, cl = both(models, ccfg)
    ps = prompts(4)
    submit_all(jax_cl, JaxRequest, ps, 5)
    submit_all(cl, Request, ps, 5)
    for c in (jax_cl, cl):
        while not c._pending:
            c.tick()
    victims = [{ho.dst_ix for ho in c._pending} for c in (jax_cl, cl)]
    assert victims[0] == victims[1] and victims[1]
    ix = min(victims[1])
    jax_cl._kill(jax_cl.handles[ix])
    cl._kill(cl.handles[ix])
    jax_cl.run(2000)
    cl.run(2000)
    assert_same(jax_cl, cl)
    assert_drained(cl, 4)
    assert cl.counters["handoff_timeouts"] >= 1
    assert cl.counters["handoff_redispatches"] >= 1
    assert cl.handles[ix].eng.state == {}      # the dead engine released


def test_engine_death_cold_like_repro(models):
    cl = run_both(models, {}, dict(seed=11, engine_death_p=0.05,
                                   start_tick=3, max_faults=1), max_new=8)
    assert cl.counters["engine_deaths"] == 1
    assert cl.counters["engine_restores"] == 0
    assert cl.degraded_mode & 1 and cl.counters["role_collapses"] >= 1
    assert [h.role for h in cl.handles if h.alive] == ["both"]


def test_engine_death_warm_like_repro(models, tmp_path):
    """Per-engine snapshots: the dead engine is rebuilt warm from its last
    step on the same device (its old state released first), no collapse."""
    cl = run_both(models, dict(snapshot_every=2),
                  dict(seed=2, engine_death_p=0.04, start_tick=6,
                       max_faults=1), max_new=8,
                  snap=(tmp_path / "jax", tmp_path / "torch"))
    assert cl.counters["engine_deaths"] == 1
    assert cl.counters["engine_restores"] == 1
    assert cl.degraded_mode == 0
    assert all(h.alive for h in cl.handles)
    assert cl.handles[0].eng.params is cl.handles[1].eng.params is cl.params


def test_all_engines_dead_like_repro(models):
    cl = run_both(models, {}, dict(seed=7, engine_death_p=1.0), n=4)
    assert cl.counters["engine_deaths"] == 2
    assert all(cl.aborted[r] == "engine_death" for r in range(4))


def test_backpressure_sheds_like_repro(models):
    jax_cl, cl = both(models, dict(max_backlog=4))
    ps = prompts(12)
    acc_j = submit_all(jax_cl, JaxRequest, ps, 4)
    acc = submit_all(cl, Request, ps, 4)
    assert acc == acc_j and 0 < sum(acc) < 12
    jax_cl.run(2000)
    cl.run(2000)
    assert_same(jax_cl, cl)
    assert_drained(cl, 12)
    assert cl.counters["shed"] == 12 - sum(acc)


def test_cluster_telemetry_like_repro(models):
    from repro.telemetry import TelemetryConfig as JaxTelemetryConfig
    from repro_torch.telemetry import TelemetryConfig, parse_exposition
    jcfg, jparams, cfg, params = models
    jax_cl = JaxCluster(jcfg, JaxEngineConfig(
        use_pallas=False, telemetry=JaxTelemetryConfig(), **KW),
        JaxClusterConfig(telemetry=JaxTelemetryConfig()), jparams)
    cl = EngineCluster(cfg, EngineConfig(telemetry=TelemetryConfig(), **KW),
                       ClusterConfig(telemetry=TelemetryConfig()), params,
                       device="cpu")
    ps = prompts(4)
    submit_all(jax_cl, JaxRequest, ps, 5)
    submit_all(cl, Request, ps, 5)
    jax_cl.run(2000)
    cl.run(2000)
    assert_same(jax_cl, cl)
    samples = parse_exposition(cl.tel.registry.render())
    assert samples["repro_cluster_handoffs_total"] == 4.0
    g, jg = cl.tel.registry.get, jax_cl.tel.registry.get
    for name in ("cluster_handoff_ok_total", "cluster_engines_healthy",
                 "cluster_pending_handoffs", "cluster_degraded_mode",
                 "cluster_router_queue_depth", "cluster_shed_total"):
        assert g(name) == jg(name), name
    assert g("cluster_engines_healthy") == 2.0
    for ix, h in enumerate(cl.handles):
        assert f"repro_e{ix}_engine_steps_total" \
            in h.eng.tel.registry.render()
