"""The decode horizon runner (``repro_torch/serving/graphs.py``) on the CPU.

A CPU engine runs the horizon eagerly through the same static buffers and
in-place copies that a CUDA graph replays on the card; these tests hold
that discipline: the capture's neutral pass leaves the live state as it
was, no tensor the runner reads is ever rebound, the launch counters count
each replay once, and the engine's capture-then-replay flow (with
stand-ins for the CUDA graph) gives the eager engine's tokens. The JAX
identity of the runner's path is ``tests/test_torch_engine.py`` and
``tests/test_torch_hybrid.py``. The card's own cases (graphs against eager
and plain engines) are in ``tests/test_torch_gpu.py``.
"""
from contextlib import contextmanager, nullcontext
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.paged_attention import paged_attention_partials
from repro_torch.kernels.ssm_scan import ssm_chunk_scan
from repro_torch.models import model as MDL
from repro_torch.serving import DecodeEngine, EngineConfig, Request
from repro_torch.serving import graphs as G

# 2-token pages and a 41-slot table: the decode table width is bucketed
# (16 or 32 slots), so a run dispatches more than one (width, K)
KW = dict(n_slots=2, page_size=2, n_pages=64, max_context=80, eos_token=-1,
          prefill_mode="batched", decode_horizon=4)


def _arch(name):
    cfg = replace(reduced(get_config(name)), dtype="float32")
    return cfg, MDL.init_params(cfg, 0, torch.float32, "cpu")


@pytest.fixture(scope="module", params=["llama3.2-1b", "zamba2-1.2b",
                                        "mixtral-8x22b"])
def arch(request):
    return _arch(request.param)


# a MoE's tokens depend on the rows each call routes, and a prefix-cache
# hit prefills only its suffix: the cache run is held to a run without
# the cache for the dense and hybrid stacks alone
@pytest.fixture(scope="module", params=["llama3.2-1b", "zamba2-1.2b"])
def cache_arch(request):
    return _arch(request.param)


def _engine(arch, **kw):
    cfg, params = arch
    eng = DecodeEngine(cfg, EngineConfig(**{**KW, **kw}), params,
                       device="cpu")
    rng = np.random.default_rng(7)
    # prompts of 3-29 tokens and 9 new tokens: admissions into freed slots,
    # page growth mid-horizon, frees and both table widths
    for r in range(4):
        eng.submit(Request(r, rng.integers(0, 256, int(rng.integers(3, 30))),
                           9))
    return eng


@pytest.fixture(scope="module")
def eager_run(arch):
    """Outputs and timing of an eager run that never captures."""
    eng = _engine(arch)
    return eng.run(500), eng.timing


def _live_state(eng) -> list[torch.Tensor]:
    """Copies of what a horizon may write: the pool without its trash page,
    every Mamba2 row and the slot state."""
    E = eng.ecfg
    out = [eng.dev.tokens, eng.dev.ctx, eng.dev.rem]
    if "pool" in eng.state:
        out += [eng.state["pool"][k][:, :E.n_pages] for k in ("k", "v")]
    out += [leaf for leaf in _leaves(MDL.rstate_entries(eng.state))]
    return [t.clone() for t in out]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _stand_in_graphs(monkeypatch, runner):
    """The runner's CUDA side replaced by stand-ins: the warm-up runs the
    body, the capture runs it once and records its key, and a replay runs
    the body of that key eagerly, as a graph replay would run it."""
    class Graph:
        key = None

        def replay(self):
            body(self.key)

    body = runner._body

    @contextmanager
    def capture_ctx(graph):
        def record(key):
            graph.key = key
            body(key)
        monkeypatch.setattr(runner, "_body", record)
        try:
            yield
        finally:
            monkeypatch.setattr(runner, "_body", body)

    monkeypatch.setattr(runner, "graphs", True)
    monkeypatch.setattr(runner, "_new_graph", Graph)
    monkeypatch.setattr(runner, "_warmup", lambda b: b())
    monkeypatch.setattr(runner, "_capture_ctx", capture_ctx)
    monkeypatch.setattr(runner, "_sync", lambda: None)


def test_neutral_capture_leaves_the_live_state(arch, eager_run,
                                               monkeypatch):
    """A capture mid-run (the warm-up and capture passes, ``allow`` zeroed)
    leaves the pool (but its trash page), the Mamba2 rows and tokens / ctx
    / rem bit-identical, and the run then ends with the tokens of a run
    that never captured."""
    eng = _engine(arch)
    for _ in range(3):
        eng.tick()
    eng._pending_fin = eng._collect_horizon()
    before = _live_state(eng)
    assert before[1].sum() > 0                 # slots hold live contexts
    runner = eng.horizons
    _stand_in_graphs(monkeypatch, runner)
    for key in ((16, 4, False), (8, 1, False)):
        runner.capture(key)
        for a, b in zip(_live_state(eng), before):
            assert torch.equal(a, b)
    monkeypatch.setattr(runner, "graphs", False)
    assert eng.run(500) == eager_run[0]


def _serve_keeping_addresses(eng) -> None:
    """Tick ``eng`` to the end, checking after every tick that no tensor
    the runner reads or writes was rebound."""
    def ptrs():
        st = eng.state
        out = {n: getattr(eng.dev, n).data_ptr()
               for n in ("bt", "ctx", "tokens", "rem")}
        out["allow"] = eng.horizons.allow.data_ptr()
        if "pool" in st:
            out.update({f"pool {k}": st["pool"][k].data_ptr()
                        for k in ("k", "v")})
        out.update({f"rows {i}": t.data_ptr() for i, t in
                    enumerate(_leaves(MDL.rstate_entries(st)))})
        out.update({f"out {k}": t.data_ptr()
                    for k, t in eng.horizons.outs.items()})
        return out

    first = ptrs()
    state = eng.state
    ticks = 0
    while ticks < 500 and not (eng._inflight is None and eng.batcher.done()):
        eng.tick()
        ticks += 1
        now = ptrs()
        assert {k: now[k] for k in first} == first
        first = now
    assert eng.state is state


def test_runner_buffers_keep_their_addresses(arch):
    """Across a served run (batched, horizon 4, admissions, page growth,
    frees) no tensor the runner reads or writes is rebound."""
    eng = _engine(arch)
    _serve_keeping_addresses(eng)
    assert eng.batcher.stats.completed == 4
    assert len(eng.horizons.outs) >= 2           # several table widths
    assert eng.timing.decode_steps > 4 * 4


def _tight_engine(arch, **kw):
    """llama: a shared 24-token prefix through the prefix cache with a host
    tier under a 20-page pool (hits, copies on write, swap-out and
    swap-in); zamba2: a 24-page pool that preempts, with preemption
    snapshots restored. Either way every write lands in the live pool
    between horizons."""
    cfg, params = arch
    rng = np.random.default_rng(7)
    if "layers" in params:
        kw = {**dict(n_pages=20, prefix_cache=True, host_pages=64,
                     prefill_dedup=False), **kw}
        system = rng.integers(0, 256, 24)
        reqs = [(r, np.concatenate([system, rng.integers(
            0, 256, int(rng.integers(2, 9)))]), 9) for r in range(5)]
    else:
        kw = {"n_pages": 24, **kw}
        reqs = [(r, rng.integers(0, 256, int(rng.integers(3, 30))), 9)
                for r in range(4)]
    eng = DecodeEngine(cfg, EngineConfig(**{**KW, **kw}), params,
                       device="cpu")
    for r, prompt, n in reqs:
        eng.submit(Request(r, prompt, n))
    return eng


def _assert_cache_path_ran(eng) -> None:
    if eng.cache is not None:
        st = eng.cache.stats
        ts = eng.cache.host.stats
        assert st.hits > 0 and st.cow_copies > 0
        assert ts.swapped_out_pages > 0 and ts.swapped_in_pages > 0
        assert eng.alloc.pages_in_use == eng.cache.tree.device_pages()
    else:
        assert eng.rstate_restores > 0 and not eng.rsnaps
        assert eng.alloc.pages_in_use == 0


def test_runner_buffers_keep_their_addresses_with_cache_and_offload(
        cache_arch, monkeypatch):
    """The same over a run whose pool takes copy-on-write copies, swap-in
    scatters and host writes (llama's prefix cache and host tier) or
    snapshot restores (zamba2) between horizons, captured mid-run with
    stand-in graphs: nothing is rebound, the cache paths ran, and the
    tokens are those of an eager run on an ample pool without them."""
    eng = _tight_engine(cache_arch)
    _stand_in_graphs(monkeypatch, eng.horizons)
    _serve_keeping_addresses(eng)
    _assert_cache_path_ran(eng)
    assert eng.timing.graph_captures >= 1
    ample = _tight_engine(cache_arch, prefix_cache=False, state_resume=False,
                          n_pages=64)
    assert eng.outputs == ample.run(500)
    assert eng.batcher.stats.completed == ample.batcher.stats.completed


def test_capture_counts_each_replay_once(monkeypatch):
    """The warm-up's and the capture's launches are taken back off; each
    replay adds the capture pass's launches (a stand-in body that counts
    as the kernel wrappers do, a stand-in graph)."""
    for fn, a in G.LAUNCH_COUNTERS:
        monkeypatch.setattr(fn, a, 7)

    def body():
        paged_attention_partials.launches += 3
        ssm_chunk_scan.launches += 2
        ssm_chunk_scan.launches_step += 2

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    before = G.launch_counts()
    cap = G.capture(body, Graph(), warmup=lambda b: b(),
                    capture_ctx=lambda g: nullcontext())
    assert G.launch_counts() == before
    for _ in range(5):
        cap.replay()
    assert cap.graph.replays == 5
    assert paged_attention_partials.launches == 7 + 5 * 3
    assert ssm_chunk_scan.launches == 7 + 5 * 2
    assert ssm_chunk_scan.launches_step == 7 + 5 * 2
    assert ssm_chunk_scan.launches_chunk == 7


def test_engine_capture_flow_matches_eager(arch, eager_run, monkeypatch):
    """The engine's graph flow (capture at a key's first tick, ``allow``
    written before each replay, capture time kept out of ``decode_s``)
    with stand-ins for the graph gives the eager engine's tokens and
    counters, one capture per (width, K)."""
    want, timing = eager_run
    eng = _engine(arch)
    _stand_in_graphs(monkeypatch, eng.horizons)
    assert eng.run(500) == want
    tm = eng.timing
    assert tm.graph_captures == len(eng.horizons.captured) >= 2
    assert tm.capture_s > 0
    for k in ("device_syncs", "decode_steps", "decode_tokens",
              "prefill_calls"):
        assert getattr(tm, k) == getattr(timing, k)


def test_decode_graphs_rules(arch):
    """``decode_graphs``: None is eager on a CPU engine, True raises there
    (graphs need a card), False is eager."""
    cfg, params = arch
    with pytest.raises(ValueError, match="decode_graphs"):
        DecodeEngine(cfg, EngineConfig(**KW, decode_graphs=True), params,
                     device="cpu")
    for g in (None, False):
        eng = DecodeEngine(cfg, EngineConfig(**KW, decode_graphs=g), params,
                           device="cpu")
        assert not eng.horizons.graphs and eng.horizons.pool is None
