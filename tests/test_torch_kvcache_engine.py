"""repro_torch's engine with the KV-cache hierarchy against repro's, on the
CPU (reduced llama3.2-1b, fp32, the same converted weights).

With ``prefix_cache=True`` (and a host tier under a tight pool) greedy
tokens must equal repro's engine in the same configuration and the port's
own cache-off run, for slot, batched and chunked prefill at horizons 1 and
4, with ``CacheStats``, ``TierStats``, ``dedup_deferred`` and
``device_syncs`` equal to repro's; sharing, copy-on-write, swap-out and
swap-in each actually occur. The scenarios are those of
``tests/test_kvcache.py``, with the shared system prompt drawn inside the
reduced vocabulary (repro's test uses ids past it, which JAX's gather
clamps and PyTorch's indexing refuses).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JMDL
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import DecodeEngine, EngineConfig, Request

PAGE = 4
MODES = ("slot", "batched", "chunked")


@pytest.fixture(scope="module")
def models():
    jcfg = replace(jax_reduced(jax_get_config("llama3.2-1b")),
                   dtype="float32")
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _requests(n_req, vocab, budget=5):
    """A 38-token system prompt (not a whole number of 4-token pages: a
    hit ends mid-page, so it copies on write) and 2-7 private tokens."""
    rng = np.random.default_rng(1)
    system = np.arange(100, 138, dtype=np.int32)
    return [(r, np.concatenate([system, rng.integers(
        0, vocab, size=int(rng.integers(2, 8)))]).astype(np.int32), budget)
        for r in range(n_req)]


def _ecfg(*, cache, host=0, n_pages=96, mode="batched", horizon=1, **kw):
    return dict(n_slots=3, page_size=PAGE, n_pages=n_pages, max_context=64,
                eos_token=-1, prefill_mode=mode, prefill_chunk=5,
                decode_horizon=horizon, prefix_cache=cache, host_pages=host,
                **kw)


def _serve(models, which, *, n_req=5, **kw):
    jcfg, jparams, cfg, params = models
    if which == "jax":
        eng = JaxEngine(jcfg, JaxEngineConfig(use_pallas=False, **_ecfg(**kw)),
                        jparams)
        req = JaxRequest
    else:
        eng = DecodeEngine(cfg, EngineConfig(**_ecfg(**kw)), params,
                           device="cpu")
        req = Request
    for r, prompt, n in _requests(n_req, cfg.vocab_size):
        eng.submit(req(r, prompt, n))
    out = {k: list(v) for k, v in eng.run(1500).items()}
    assert eng.batcher.stats.completed == n_req
    return out, eng


def _counters(eng) -> dict:
    out = {"cache": eng.cache.stats_dict(),
           "dedup_deferred": eng.batcher.stats.dedup_deferred,
           "device_syncs": eng.timing.device_syncs,
           "decode_tokens": eng.timing.decode_tokens,
           "preempted": eng.batcher.stats.preempted}
    if eng.cache.host is not None:
        out["tier"] = eng.cache.host.stats.as_dict()
    return out


def _balanced(eng) -> None:
    """Every page is free or held by the tree, and the pool kept its
    tensors."""
    assert eng.alloc.pages_in_use == eng.cache.tree.device_pages()


@pytest.fixture(scope="module")
def cache_off(models):
    return _serve(models, "torch", cache=False)[0]


@pytest.fixture(scope="module")
def jax_runs(models):
    """repro's engine once per (prefill mode, horizon)."""
    out = {}
    for mode in MODES:
        for horizon in (1, 4):
            got, eng = _serve(models, "jax", cache=True, mode=mode,
                              horizon=horizon)
            out[mode, horizon] = got, _counters(eng)
    return out


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_prefix_cache_matches_repro(models, cache_off, jax_runs, mode,
                                    horizon):
    want, jcount = jax_runs[mode, horizon]
    got, eng = _serve(models, "torch", cache=True, mode=mode,
                      horizon=horizon)
    assert got == want == cache_off
    assert _counters(eng) == jcount
    st = eng.cache.stats
    assert st.hits > 0 and st.hit_tokens > 0
    assert st.cow_copies > 0                 # 38 % PAGE != 0 -> CoW
    _balanced(eng)


def test_tight_pool_host_tier_matches_repro(models, cache_off):
    """A 40-page pool with a 64-page host tier: watermark offload and
    swap-in on reuse (same-tick dedup off, so the burst lands cold all at
    once and builds the pressure)."""
    kw = dict(cache=True, host=64, n_pages=40, prefill_dedup=False)
    want, jeng = _serve(models, "jax", **kw)
    got, eng = _serve(models, "torch", **kw)
    assert got == want == cache_off
    assert _counters(eng) == _counters(jeng)
    ts = eng.cache.host.stats
    assert ts.swapped_out_pages > 0 and ts.swapped_in_pages > 0
    _balanced(eng)


def test_same_tick_dedup_cold_burst(models):
    """A cold burst of same-prefix requests in ONE tick prefills the shared
    prefix once: followers wait for the leader and re-admit as hits."""
    base, _ = _serve(models, "torch", cache=False, n_req=3)
    want, jeng = _serve(models, "jax", cache=True, n_req=3)
    got, eng = _serve(models, "torch", cache=True, n_req=3)
    assert got == want == base
    assert _counters(eng) == _counters(jeng)
    assert eng.batcher.stats.dedup_deferred >= 2
    cs = eng.cache.stats
    assert cs.hits >= 2 and cs.hit_tokens >= 2 * 36


def test_shared_pages_and_admitted_kv_beyond_pool(models):
    """With shared prompts the engine holds fewer device pages than the
    no-sharing run and sustains an admitted batch whose summed
    per-request KV exceeds the 40-page device pool — driven tick by tick
    (the port has no per-token ``step()``), token-identical to repro's
    engine in the same configuration."""
    jcfg, jparams, cfg, params = models
    system = np.arange(150, 190, dtype=np.int32)      # 10 pages
    rng = np.random.default_rng(2)
    later = [(r, np.concatenate([system, rng.integers(
        0, cfg.vocab_size, size=3)]).astype(np.int32), 6) for r in range(1, 7)]

    def run(which, cache, n_pages):
        ecfg = dict(n_slots=6, page_size=PAGE, n_pages=n_pages,
                    max_context=64, eos_token=-1, prefix_cache=cache,
                    host_pages=64)
        if which == "jax":
            eng = JaxEngine(jcfg, JaxEngineConfig(use_pallas=False, **ecfg),
                            jparams)
            req = JaxRequest
        else:
            eng = DecodeEngine(cfg, EngineConfig(**ecfg), params,
                               device="cpu")
            req = Request
        eng.submit(req(0, system, 2))                  # warm the prefix
        eng.run(100)
        for r, prompt, n in later:
            eng.submit(req(r, prompt, n))
        if which == "jax":
            return {k: list(v) for k, v in eng.run(400).items()}, eng
        peak_pages = peak_kv = 0
        for _ in range(400):
            if eng._inflight is None and eng.batcher.done():
                break
            eng.tick()
            peak_pages = max(peak_pages, eng.alloc.pages_in_use)
            kv = sum(len(eng.alloc.pages_of(r.req_id))
                     for r in eng.batcher.slots if r is not None)
            peak_kv = max(peak_kv, kv)
        assert eng.batcher.stats.completed == 7
        return {k: list(v) for k, v in eng.outputs.items()}, \
            (peak_pages, peak_kv, eng)

    base, (base_pages, _, _) = run("torch", False, 96)
    got, (shared_pages, peak_kv, eng) = run("torch", True, 40)
    want, jeng = run("jax", True, 40)
    assert got == want == base
    assert eng.cache.stats.hits >= 6
    assert eng.cache.stats_dict() == jeng.cache.stats_dict()
    assert shared_pages < base_pages               # measurably fewer pages
    # per-request KV footprint (shared pages counted per owner) exceeds the
    # 40-page device pool: the batch is admissible only because pages are
    # shared / one swap away
    assert peak_kv > 40
    _balanced(eng)
