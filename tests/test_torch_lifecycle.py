"""The port's request lifecycle and fault tolerance against repro's, on the
CPU (reduced llama3.2-1b, fp32, the same converted weights).

The scenarios of ``tests/test_robustness.py``, each served by repro's
engine and the port's from one seed: the seeded injector fires the same
events, and tokens, terminal reasons, ``abort_counts``, ``degraded_mode``,
device syncs and the fired-event logs equal repro's. Aborts and deadlines in
slot, batched and chunked prefill, shedding, an abort during speculative
decoding (the draft's coverage dropped), the chaos storm (and its replay),
NaN quarantine and the ladder, the real-logits guard through ``step()``,
row death, spec degrading under pressure, swap failures dropping the host
tier, retry and backoff, and ``step()`` interleaved with ``run()``. Every
run also ends leak-free: no page held outside the prefix cache's tree, no
snapshot, deadline or pending abort left.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JMDL
from repro.runtime import faults as JF
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import faults as TF
from repro_torch.serving import DecodeEngine, EngineConfig, Request

PAGE = 4
ENGINES = ("jax", "torch")


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, cfg, params) of the target and of a 1-layer
    draft (repro's PRNGKey(0) and PRNGKey(7) inits, converted)."""
    def pair(layers, seed):
        jcfg = replace(jax_reduced(jax_get_config("llama3.2-1b"),
                                   layers=layers), dtype="float32")
        cfg = replace(reduced(get_config("llama3.2-1b"), layers=layers),
                      dtype="float32")
        jp = JMDL.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
        return jcfg, jp, cfg, params_from_numpy(
            cfg, jax.tree.map(np.asarray, jp), "cpu")
    return {"target": pair(None, 0), "draft": pair(1, 7)}


def _engine(models, which, faults=None, *, draft=False, params=None, **kw):
    base = dict(n_slots=3, page_size=PAGE, n_pages=96, max_context=64,
                eos_token=-1)
    base.update(kw)
    jcfg, jp, cfg, p = models["target"]
    djcfg, djp, dcfg, dp = models["draft"]
    if which == "jax":
        fc = None if faults is None else JF.FaultConfig(**faults)
        return JaxEngine(jcfg, JaxEngineConfig(
            use_pallas=False, faults=fc, draft_config=djcfg if draft else None,
            **base), jp if params is None else params[0],
            draft_params=djp if draft else None)
    fc = None if faults is None else TF.FaultConfig(**faults)
    return DecodeEngine(cfg, EngineConfig(
        faults=fc, draft_config=dcfg if draft else None, **base),
        p if params is None else params[1], device="cpu",
        draft_params=dp if draft else None)


def _submit(eng, which, n, max_new=5, seed=0, vocab=256):
    req = JaxRequest if which == "jax" else Request
    rng = np.random.default_rng(seed)
    for r in range(n):
        eng.submit(req(r, rng.integers(0, vocab,
                                       size=int(rng.integers(3, 20))),
                       max_new))


def _outs(eng) -> dict:
    return {k: list(v) for k, v in eng.outputs.items()}


def _state(eng) -> dict:
    """Everything the two packages must agree on after a run."""
    st = eng.batcher.stats
    return {"outputs": _outs(eng), "aborted": dict(eng.aborted),
            "abort_counts": dict(eng.abort_counts),
            "degraded_mode": eng.degraded_mode,
            "events": list(eng.faults.events),
            "fault_counts": dict(eng.faults.counts),
            "completed": st.completed, "preempted": st.preempted,
            "migrated": st.migrated, "aborted_n": st.aborted,
            "device_syncs": eng.timing.device_syncs,
            "decode_tokens": eng.timing.decode_tokens}


def _leak_free(eng):
    assert eng.alloc.pages_in_use == (
        eng.cache.tree.device_pages() if eng.cache is not None else 0)
    assert not eng.rsnaps
    assert not eng.deadline_t
    assert not eng._abort_req


def _both(models, drive, **engine_kw) -> dict:
    """``drive(eng, which)`` on repro's engine and the port's; returns
    ``{which: engine}`` after asserting their states equal and the port
    leak-free."""
    engs = {}
    for which in ENGINES:
        eng = _engine(models, which, **engine_kw)
        drive(eng, which)
        engs[which] = eng
    assert _state(engs["torch"]) == _state(engs["jax"])
    _leak_free(engs["torch"])
    return engs


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 42])
def test_injector_sequences_match_repro(seed):
    """One seed fires the same events in both packages: the same hash, the
    same per-kind probabilities, start tick and budget."""
    for extra in ({}, {"start_tick": 5}, {"max_faults": 9}):
        ps = {f"{k}_p": 0.3 for k in JF.KINDS}
        inj = [JF.FaultInjector(JF.FaultConfig(seed=seed, **ps, **extra)),
               TF.FaultInjector(TF.FaultConfig(seed=seed, **ps, **extra))]
        for _ in range(30):
            for f in inj:
                f.on_tick()
                for kind in JF.KINDS:
                    for key in range(4):
                        f.fire(kind, key=key)
        assert inj[1].events == inj[0].events and inj[0].events
        assert inj[1].counts == inj[0].counts
    assert TF.KINDS == JF.KINDS
    grid = [(s, k, t, key) for s in (0, 3, 2**40) for k in range(10)
            for t in (0, 1, 999) for key in (0, 5, 2**33)]
    assert [TF._hash01(*g) for g in grid] == [JF._hash01(*g) for g in grid]


def test_injector_order_free_budget_and_null():
    def drive(order):
        f = TF.FaultInjector(TF.FaultConfig(seed=42, client_abort_p=0.3,
                                            row_death_p=0.2))
        hits = {}
        for _ in range(20):
            f.on_tick()
            for kind, key in order:
                hits[(kind, f.tick, key)] = f.fire(kind, key=key)
        return hits, sorted(f.events, key=lambda d: (d["kind"], d["tick"],
                                                     d["key"]))
    a = [("client_abort", 1), ("client_abort", 2), ("row_death", 0)]
    assert drive(a) == drive(list(reversed(a)))
    f = TF.FaultInjector(TF.FaultConfig(seed=0, slow_tick_p=1.0,
                                        max_faults=3))
    for _ in range(10):
        f.on_tick()
        f.fire("slow_tick")
    assert f.total_fired == 3
    assert TF.make_faults(None) is TF.NULL_FAULTS
    assert TF.make_faults(f) is f
    assert not TF.NULL_FAULTS.enabled and not TF.NULL_FAULTS.fire("slow_tick")
    with pytest.raises(TypeError):
        TF.make_faults(42)


def test_zero_probability_faults_are_identity(models):
    """An armed injector that never fires changes nothing: tokens and
    device syncs equal the run without one, and repro's."""
    runs = {}
    for label, which, faults in (("jax", "jax", None),
                                 ("off", "torch", None),
                                 ("armed", "torch", {"seed": 1})):
        eng = _engine(models, which, faults)
        _submit(eng, which, 6)
        eng.run(500)
        runs[label] = eng
    assert _outs(runs["armed"]) == _outs(runs["off"]) == _outs(runs["jax"])
    assert runs["armed"].timing.device_syncs == \
        runs["off"].timing.device_syncs == runs["jax"].timing.device_syncs
    assert runs["armed"].faults.total_fired == 0
    assert runs["armed"].nan_guard and not runs["off"].nan_guard
    _leak_free(runs["armed"])


# ---------------------------------------------------------------------------
# lifecycle: abort / deadline / shed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["slot", "batched", "chunked"])
def test_abort_and_deadline_all_prefill_modes(models, mode):
    def drive(eng, which):
        _submit(eng, which, 6, max_new=20)
        req = JaxRequest if which == "jax" else Request
        eng.submit(req(9, np.arange(1, 10), 20, deadline_s=1e-6))
        for _ in range(2):
            eng.tick()
        assert eng.abort(0)
        eng.run(500)
        assert not eng.abort(0)             # already terminal
    engs = _both(models, drive, prefill_mode=mode, prefill_chunk=5)
    eng = engs["torch"]
    assert eng.aborted.get(0) == "client"
    assert eng.aborted.get(9) == "deadline"
    assert eng.batcher.stats.completed + len(eng.aborted) == 7


def test_abort_with_horizon_and_deadline_survivors(models):
    """A horizon of 4 crosses the abort safe point; survivors' generous
    deadlines never fire and their tokens equal a clean run's."""
    clean = _engine(models, "torch", decode_horizon=4)
    _submit(clean, "torch", 5, max_new=8)
    clean.run(500)
    ref = _outs(clean)

    def drive(eng, which):
        _submit(eng, which, 5, max_new=8)
        eng.tick()
        eng.abort(2)
        eng.run(500)
    engs = _both(models, drive, decode_horizon=4, default_deadline_s=60.0)
    outs = _outs(engs["torch"])
    assert engs["torch"].aborted == {2: "client"}
    assert all(outs[r] == ref[r] for r in range(5) if r != 2)
    assert len(outs[2]) < len(ref[2])


def test_load_shed_bounded_queue(models):
    def drive(eng, which):
        req = JaxRequest if which == "jax" else Request
        rng = np.random.default_rng(0)
        oks = [eng.submit(req(r, rng.integers(0, 256, size=5), 3))
               for r in range(8)]
        assert sum(oks) == 2
        eng.run(500)
    engs = _both(models, drive, max_queue=2)
    eng = engs["torch"]
    assert eng.abort_counts["shed"] == 6
    assert eng.batcher.stats.completed == 2
    assert all(eng.aborted[r] == "shed" for r in range(2, 8))


def test_abort_during_spec_decode_cleans_draft_pool(models):
    def drive(eng, which):
        _submit(eng, which, 4, max_new=10)
        eng.tick()
        eng.abort(1)
        eng.run(500)
    engs = _both(models, drive, draft=True, spec_horizon=3)
    eng, jeng = engs["torch"], engs["jax"]
    assert eng.aborted == {1: "client"}
    assert 1 not in eng._dlen and not eng._dlen
    assert (eng.spec_rounds, eng.spec_proposed, eng.spec_accepted) == \
        (jeng.spec_rounds, jeng.spec_proposed, jeng.spec_accepted)


# ---------------------------------------------------------------------------
# chaos: seeded storms, quarantine, the ladder
# ---------------------------------------------------------------------------

STORM = dict(seed=7, client_abort_p=0.02, row_death_p=0.01,
             alloc_exhaust_p=0.05, nan_logits_p=0.01, slow_tick_p=0.05,
             slow_tick_s=0.0)


def test_chaos_storm_matches_repro_and_replays(models):
    def drive(eng, which):
        _submit(eng, which, 6, max_new=8)
        eng.run(2000)
    engs = _both(models, drive, faults=STORM, n_rows=2, n_shards=2)
    eng = engs["torch"]
    assert eng.faults.events and eng.batcher.stats.completed \
        + len(eng.aborted) == 6
    again = _engine(models, "torch", STORM, n_rows=2, n_shards=2)
    drive(again, "torch")
    assert _state(again) == _state(eng)         # the seed replays the run


def test_nan_quarantine_and_degradation_ladder(models):
    def drive(eng, which):
        _submit(eng, which, 6, max_new=6)
        eng.run(2000)
    engs = _both(models, drive, faults=dict(seed=3, nan_logits_p=0.25),
                 degrade_after=3)
    eng = engs["torch"]
    assert eng.abort_counts["nan"] >= 3
    assert all(r == "nan" for r in eng.aborted.values())
    assert eng.degraded_mode & 1                # horizon pinned to 1


def test_real_nan_guard_through_step(models):
    """The opt-in real-logits guard: a request whose embedding is NaN gets
    non-finite decode logits; ``step()`` quarantines it (reason ``nan``)
    only when the guard is armed, as repro's does (the NaN reaches the
    other rows too, through the pad writes' shared trash page, in both
    packages); unguarded, every request samples as-is and completes."""
    jcfg, jp, cfg, p = models["target"]
    bad = 5
    emb = np.asarray(jp["embed"]).copy()
    emb[bad] = np.nan
    jpn = dict(jp, embed=jnp.asarray(emb))
    pn = params_from_numpy(cfg, jax.tree.map(np.asarray, jpn), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(6, 256, size=8) for _ in range(3)]
    prompts[1][3] = bad

    def drive(eng, which):
        req = JaxRequest if which == "jax" else Request
        for r, pr in enumerate(prompts):
            eng.submit(req(r, pr, 6))
        n = 0
        while not eng.batcher.done() and n < 200:
            eng.step()
            n += 1
    assert _engine(models, "torch").nan_guard is False
    assert _engine(models, "torch", {"seed": 1}).nan_guard is True
    engs = _both(models, drive, params=(jpn, pn), nan_guard=True)
    eng = engs["torch"]
    assert eng.aborted.get(1) == "nan"
    assert set(eng.aborted.values()) == {"nan"}
    assert eng.batcher.stats.completed + len(eng.aborted) == 3
    open_ = _engine(models, "torch", params=(jpn, pn))
    drive(open_, "torch")
    assert not open_.aborted and open_.batcher.stats.completed == 3


def test_row_death_migrates_and_preserves_outputs(models):
    clean = _engine(models, "torch", n_rows=2, n_shards=2, n_slots=4)
    _submit(clean, "torch", 8, max_new=8)
    clean.run(2000)

    def drive(eng, which):
        _submit(eng, which, 8, max_new=8)
        eng.run(2000)
    engs = _both(models, drive, faults=dict(seed=3, row_death_p=0.1,
                                            max_faults=1),
                 n_rows=2, n_shards=2, n_slots=4)
    eng = engs["torch"]
    assert eng.faults.counts["row_death"] == 1
    assert eng.batcher.stats.migrated >= 1
    assert _outs(eng) == _outs(clean)


def test_spec_degrades_to_plain_decode_under_pressure(models):
    clean = _engine(models, "torch", draft=True, spec_horizon=3, n_slots=4)
    _submit(clean, "torch", 6, max_new=8)
    clean.run(2000)

    def drive(eng, which):
        _submit(eng, which, 6, max_new=8)
        eng.run(2000)
    engs = _both(models, drive, faults=dict(seed=5, alloc_exhaust_p=0.15),
                 draft=True, spec_horizon=3, n_slots=4, degrade_after=2)
    eng, jeng = engs["torch"], engs["jax"]
    assert eng.degraded_mode & 2
    assert _outs(eng) == _outs(clean)
    assert (eng.spec_rounds, eng.spec_proposed, eng.spec_accepted) == \
        (jeng.spec_rounds, jeng.spec_proposed, jeng.spec_accepted)
    # plain horizons took over from the speculative rounds
    assert any(not spec for _, _, spec in eng.horizons.outs)


def _swap_drive(eng, which):
    req = JaxRequest if which == "jax" else Request
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 256, size=12)
    for r in range(8):
        eng.submit(req(r, np.concatenate(
            [shared, rng.integers(0, 256, size=5)]), 6))
    eng.run(2000)


def test_swap_failure_drops_host_tier(models):
    engs = _both(models, _swap_drive, faults=dict(seed=2, swap_fail_p=0.9),
                 n_pages=32, prefix_cache=True, host_pages=32,
                 offload_high=0.4, offload_low=0.2, degrade_after=2)
    eng, jeng = engs["torch"], engs["jax"]
    assert eng.cache.stats_dict() == jeng.cache.stats_dict()
    assert eng.batcher.stats.completed + len(eng.aborted) == 8
    if eng.degraded_mode & 4:
        assert eng.cache.host is None


def test_swap_retry_backoff_before_degradation(models):
    engs = _both(models, _swap_drive, faults=dict(seed=2, swap_fail_p=0.9),
                 n_pages=32, prefix_cache=True, host_pages=32,
                 offload_high=0.4, offload_low=0.2, degrade_after=2,
                 swap_retry_limit=2, swap_backoff_cap=4)
    eng, jeng = engs["torch"], engs["jax"]
    sd = eng.cache.stats_dict()
    assert sd == jeng.cache.stats_dict()
    fired = eng.faults.counts.get("swap_fail", 0)
    if fired:
        assert sd["swap_retries"] >= 1
        assert sd["swap_retries"] + sd["swap_in_fails"] >= fired


# ---------------------------------------------------------------------------
# step(): the per-token tick, alone and interleaved with run()
# ---------------------------------------------------------------------------

def test_step_interleaves_with_run(models):
    """Three ``step()`` ticks, then ``run()`` at horizon 4: tokens equal a
    ``run()``-only engine's and repro's same interleave, device syncs
    equal repro's."""
    def drive(eng, which):
        _submit(eng, which, 5, max_new=8)
        for _ in range(3):
            eng.step()
        eng.run(500)
    engs = _both(models, drive, decode_horizon=4)
    ref = _engine(models, "torch", decode_horizon=4)
    _submit(ref, "torch", 5, max_new=8)
    ref.run(500)
    assert _outs(engs["torch"]) == _outs(ref)


def test_engine_config_carries_repro_fields_and_defaults():
    """Every field of repro's EngineConfig but its Pallas switches is the
    port's, with repro's default (the lifecycle, telemetry, fault and
    snapshot fields included)."""
    from dataclasses import MISSING, fields
    ours = {f.name: f for f in fields(EngineConfig)}
    for f in fields(JaxEngineConfig):
        if f.name in ("use_pallas", "kernel_interpret"):
            continue
        assert f.name in ours, f.name
        assert ours[f.name].default == f.default \
            or (f.default is MISSING and ours[f.name].default is MISSING), \
            f.name


@pytest.mark.parametrize("name", ["mixed_storm", "swap_faults",
                                  "abort_deadline", "row_death_identity",
                                  "spec_chaos", "kill_restore"])
def test_chaos_soak_scenario_matches_repro(models, name):
    """``launch/chaos_soak.py``'s scenario at seed 0 with repro's weights,
    converted: its invariants hold and its stats (terminal counts, abort
    reasons, fired events, degradation, migrations, preemptions) equal
    ``benchmarks/chaos_soak.py``'s."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                           / "benchmarks"))
    import chaos_soak as jax_soak
    from repro_torch.launch.chaos_soak import ChaosSoak
    p, dp = models["target"][3], models["draft"][3]
    want = getattr(jax_soak, f"scenario_{name}")(0)
    got, _ = getattr(ChaosSoak("cpu", params=p, draft_params=dp), name)(0)
    for k in ("scenario", "submitted", "completed", "aborted",
              "abort_counts", "faults_fired", "fault_counts",
              "degraded_mode", "migrated", "preempted", "events"):
        assert got[k] == want[k], k


def test_chaos_soak_swap_drop_drops_the_tier_and_keeps_outputs(models):
    """The port's own ``swap_drop`` scenario: swap-ins refused past a
    one-retry budget drop the host tier mid-run while client aborts tear
    requests down, the run drains leak-free, and survivors' greedy
    outputs equal a clean run's without the cache (asserted inside)."""
    from repro_torch.launch.chaos_soak import ChaosSoak
    soak = ChaosSoak("cpu", params=models["target"][3],
                     draft_params=models["draft"][3])
    stats, outs = soak.swap_drop(0)
    assert stats["degraded_mode"] & 4
    assert stats["swap_in_fails"] >= 1 and stats["swapped_out_pages"] > 0
    assert stats["abort_counts"]["client"] == 9
    assert stats["completed"] + stats["aborted"] == 36 == len(outs)
    assert [len(e.horizons.outs) > 0 for e in soak.engines] == [True, True]


@pytest.mark.parametrize("name", ["mixed_storm", "spec_chaos",
                                  "kill_restore"])
def test_chaos_soak_at_16_token_pages_and_horizon_4(models, name):
    """The geometry ``chip_smoke.py`` runs at full width, here at reduced
    width: 16-token pages (prompts, new tokens and context 4x), horizon 4.
    Each scenario's invariants hold; the storm's ladder reaches the
    horizon (bit 1), and the speculative engine's plain horizons run at
    K = 4 and then K = 1."""
    from repro_torch.launch.chaos_soak import ChaosSoak
    soak = ChaosSoak("cpu", params=models["target"][3],
                     draft_params=models["draft"][3], page_size=16,
                     decode_horizon=4)
    stats, _ = getattr(soak, name)(0)
    assert all(e.ecfg.page_size == 16 and e.ecfg.max_context == 256
               for e in soak.engines)
    if name == "mixed_storm":
        assert stats["degraded_mode"] & 1
    if name == "spec_chaos":
        assert stats["degraded_mode"] == 3
        keys = set(soak.engines[-1].horizons.outs)
        assert {K for _, K, spec in keys if not spec} == {1, 4}
    if name == "kill_restore":
        assert stats["completed"] > 0
