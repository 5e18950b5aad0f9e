"""repro_torch's enc-dec (whisper), M-RoPE (qwen2-vl) families and
sliding-window ring pools against repro's, on the CPU.

Configs: whisper-small and qwen2-vl-7b, full and ``reduced``, field for
field. Blocks: the sinusoidal table and ``sinusoidal_at``, and
``mrope_cos_sin`` at distinct t / h / w ids (a broadcast id would reduce
M-RoPE to rope).

Model level, on weights converted with ``params_from_numpy`` and seeded
numpy inputs (as ``tests/test_models.py::make_inputs`` makes them):
``prefill`` then four ``decode_step`` calls within repro's tolerances
(3e-4 prefill, 4e-3 decode), with ``kernels=None`` and with the kernel
wrappers (their plain versions here: the non-causal flash attention of
the encoder and the cross prefill, the flash-decode partials and merge of
the cross decode). Whisper (2 + 2 layers, ``enc_seq`` 8) gets seeded
frames and its cross rows are held too; qwen2-vl gets ``extra_embeds``
over an image grid of distinct (t, h, w) ids, text at max + 1 on all
three axes. The ring case of ``tests/test_models.py:99`` (mixtral, window
6) holds the port's ring pool to repro's and to the port's full pool.

Engine level (the geometry of ``tests/test_recurrent_prefill.py::_run``):
whisper's greedy tokens in slot, batched and chunked (3) prefill at
horizons 1 and 4 equal one repro slot run, the cross rows written in
place; a preempted request restores its snapshot (``state_resume``) with
repro's tokens and counters; a serving snapshot restores the cross rows;
a 1 + 1 cluster hands the cross rows over. The ring engine holds each
request to ``ring_width`` pages and emits the full pool's tokens (and
repro's full-pool engine's: ROADMAP C.10 records that repro's ring engine
does not). ``serve --arch`` takes both new families.
"""
from dataclasses import asdict, fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.paged_kv import PoolSpec as JaxPoolSpec
from repro.models import layers as JL
from repro.models import model as JMDL
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.core.allocator import PageAllocator
from repro_torch.core.paged_kv import PoolSpec
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import (ClusterConfig, DecodeEngine, EngineCluster,
                                 EngineConfig, Request)

PAGE = 4
KERNELS = {"plain": None, "kernels": KernelConfig()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs tiny shapes here: one intra-op thread a worker keeps
    the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **kw):
    return (replace(jax_reduced(jax_get_config(arch)), dtype="float32",
                    **kw),
            replace(reduced(get_config(arch)), dtype="float32", **kw))


_WEIGHTS = {}


def _weights(arch, **kw):
    """(jcfg, jparams, cfg, params) of the reduced ``arch``, once a
    module."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _WEIGHTS:
        jcfg, cfg = _configs(arch, **kw)
        jp = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
        _WEIGHTS[key] = (jcfg, jp, cfg, params_from_numpy(
            cfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _WEIGHTS[key]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-7b"])
@pytest.mark.parametrize("cut", [False, True], ids=["full", "reduced"])
def test_config_matches_repro(arch, cut):
    """The port's ``ModelConfig`` carries a subset of repro's fields."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if cut:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    want = asdict(jcfg)
    assert asdict(cfg) == {f.name: want[f.name] for f in fields(cfg)}
    assert cfg.param_count() == jcfg.param_count()


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def test_sinusoidal_positions_match_repro():
    """``sinusoidal_at`` (device positions, idle rows at -1) within fp32
    rounding of repro's ``sinusoidal_at`` and of its numpy table, which
    repro's prefill and encoder add."""
    pos = np.asarray([[-1, 0, 5], [447, 1499, 3]], np.int32)
    _close(L.sinusoidal_at(_t(pos), 64), JL.sinusoidal_at(pos, 64), 1e-5)
    _close(L.sinusoidal_at(_t(np.arange(37)), 64),
           JL.sinusoidal_positions(37, 64), 1e-5)


@pytest.mark.parametrize("d_head,sections", [(16, (2, 3, 3)),
                                             (128, (16, 24, 24))])
def test_mrope_cos_sin_distinct_axes(d_head, sections):
    """Distinct t / h / w ids a position: each frequency slot takes its
    section's axis, as repro's ``mrope_cos_sin``; with one id on all three
    axes it is rope."""
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, size=(3, 2, 9)).astype(np.int32)
    got = L.mrope_cos_sin(_t(pos), d_head, 1e6, sections)
    want = JL.mrope_cos_sin(jnp.asarray(pos), d_head, 1e6, sections)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    for g, w in zip(L.mrope_cos_sin(_t(same), d_head, 1e6, sections),
                    L.rope_cos_sin(_t(pos[0]), d_head, 1e6)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert not torch.equal(got[0], L.rope_cos_sin(_t(pos[0]), d_head,
                                                  1e6)[0])


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

def _inputs(cfg, B, S, S_pre):
    """Seeded numpy inputs: token ids, whisper's frames, qwen2-vl's
    ``extra_embeds`` over a 2 x 2 image grid (t 0, h = i // 2, w = i % 2)
    and the text after it at max + 1 on all three axes."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                        * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        n_img = 4
        ee = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(
            np.float32)
        ee[:, n_img:] = 0
        i = np.arange(n_img)
        img = np.stack([np.zeros(n_img, np.int64), i // 2, i % 2])
        txt = np.broadcast_to(img.max() + 1 + np.arange(S - n_img),
                              (3, S - n_img))
        pos = np.concatenate([img, txt], axis=1)
        kw["extra_embeds"] = ee
        kw["positions"] = np.broadcast_to(pos[:, None], (3, B, S)).astype(
            np.int32)
    return toks, kw


def _pools(jcfg, cfg, B, S, page, *, ring=0):
    W = ring or S // page + 1
    jstate = JMDL.init_decode_state(jcfg, JaxPoolSpec(
        cfg.n_layers, 32, page, cfg.n_kv_heads, cfg.d_head, W,
        dtype="float32", ring=bool(ring)), B, dtype="float32")
    state = MDL.init_decode_state(cfg, PoolSpec(
        cfg.n_layers, 32, page, cfg.n_kv_heads, cfg.d_head, W,
        dtype="float32", ring=bool(ring)), B, device="cpu")
    alloc = PageAllocator(32, 1, page, ring_pages=ring or None)
    bts = []
    for b in range(B):
        alloc.admit(b, S)
        bts.append(alloc.block_table(b, W))
    return jstate, state, np.stack(bts).astype(np.int32), alloc


@pytest.mark.parametrize("path", ["plain", "kernels"])
@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-7b"])
def test_prefill_decode_match_repro(arch, path):
    """``prefill`` (with frames / extra_embeds and 3-axis positions) then
    four ``decode_step`` calls (qwen2-vl at explicit text positions)
    against repro's; whisper's cross rows too."""
    jcfg, jp, cfg, params = _weights(arch)
    B, S, S_pre = 2, 12, 8
    toks, kw = _inputs(cfg, B, S, S_pre)
    pre = {k: (v[:, :S_pre] if k == "extra_embeds" else
               v[:, :, :S_pre] if k == "positions" else v)
           for k, v in kw.items()}
    jstate, state, bt, _ = _pools(jcfg, cfg, B, S, PAGE)
    rt = MDL.Runtime(kernels=KERNELS[path])
    want, jstate = JMDL.prefill(jcfg, jp, jstate, jnp.asarray(toks[:, :S_pre]),
                                jnp.asarray(bt),
                                **{k: jnp.asarray(v) for k, v in pre.items()})
    got, state = MDL.prefill(cfg, params, state, _t(toks[:, :S_pre]), _t(bt),
                             rt=rt, **{k: _t(v) for k, v in pre.items()})
    _close(got, want, 3e-4)
    if arch == "whisper-small":
        _close(state["cross_k"], jstate["cross_k"], 3e-4)
        _close(state["cross_v"], jstate["cross_v"], 3e-4)
    for t in range(S_pre, S):
        ctx = np.full((B,), t + 1, np.int32)
        npage = bt[:, t // PAGE].copy()
        noff = np.full((B,), t % PAGE, np.int32)
        pos = kw["positions"][:, :, t:t + 1] if "positions" in kw else None
        want, jstate = JMDL.decode_step(
            jcfg, jp, jstate, jnp.asarray(toks[:, t]), jnp.asarray(bt),
            jnp.asarray(ctx), jnp.asarray(npage), jnp.asarray(noff),
            positions=None if pos is None else jnp.asarray(pos))
        got, state = MDL.decode_step(
            cfg, params, state, _t(toks[:, t]), _t(bt), _t(ctx), _t(npage),
            _t(noff), positions=None if pos is None else _t(pos), rt=rt)
        _close(got, want, 4e-3)


def _ring_cfg():
    # tests/test_models.py::build: mixtral reduced, dropless, window 6
    return dict(sliding_window=6, capacity_factor=8.0)


@pytest.fixture(scope="module")
def repro_ring_logits():
    """repro's ring-pool logits over prefill + decode
    (``tests/test_models.py:99``'s geometry)."""
    jcfg, jp, cfg, _ = _weights("mixtral-8x22b", **_ring_cfg())
    return _ring_run(jcfg, jp, cfg, None, ring=True, jax_side=True)


def _ring_run(jcfg, jp, cfg, params, *, ring, jax_side=False, rt=None):
    B, S, S_pre, page = 1, 16, 10, 2
    W = (cfg.sliding_window + page) // page + 1 if ring else 0
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jstate, state, bt, alloc = _pools(jcfg, cfg, B, S, page, ring=W)
    assert len(alloc.pages_of(0)) == (W or -(-S // page))
    if jax_side:
        fwd = dict(rt=JMDL.Runtime(ring_width=W))
        st, arr, call = jstate, jnp.asarray, JMDL
        p, c = jp, jcfg
    else:
        fwd = dict(rt=MDL.Runtime(ring_width=W, kernels=rt))
        st, arr, call = state, _t, MDL
        p, c = params, cfg
    outs = []
    lg, st = call.prefill(c, p, st, arr(toks[:, :S_pre]), arr(bt), **fwd)
    outs.append(np.asarray(lg))
    for t in range(S_pre, S):
        vp = (t // page) % W if ring else t // page
        lg, st = call.decode_step(
            c, p, st, arr(toks[:, t]), arr(bt),
            arr(np.full((B,), t + 1, np.int32)),
            arr(np.asarray([bt[0, vp]], np.int32)),
            arr(np.full((B,), t % page, np.int32)), **fwd)
        outs.append(np.asarray(lg))
    return np.stack(outs)


@pytest.mark.parametrize("path", ["plain", "kernels"])
def test_sliding_window_ring_pool_matches_repro(repro_ring_logits, path):
    """The window-capped ring pool (``ring_width`` 4 pages of 2 for a
    window of 6, ``PageAllocator(ring_pages=4)``) gives repro's ring
    logits and the port's full pool's, within 2e-4."""
    jcfg, jp, cfg, params = _weights("mixtral-8x22b", **_ring_cfg())
    ring = _ring_run(jcfg, jp, cfg, params, ring=True, rt=KERNELS[path])
    full = _ring_run(jcfg, jp, cfg, params, ring=False, rt=KERNELS[path])
    np.testing.assert_allclose(ring, repro_ring_logits, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ring, full, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# engine level: whisper
# ---------------------------------------------------------------------------

def _requests(nreq=4, budget=5, lo=3, hi=18, seed=0):
    rng = np.random.default_rng(seed)
    return [(r, rng.integers(0, 256, size=int(rng.integers(lo, hi))), budget)
            for r in range(nreq)]


def _ecfg(mode, horizon, n_pages, chunk=3, **kw):
    return dict(n_slots=2, page_size=PAGE, n_pages=n_pages, max_context=64,
                eos_token=-1, prefill_mode=mode, prefill_chunk=chunk,
                decode_horizon=horizon, **kw)


def _serve_jax(arch, mode, horizon, *, n_pages=96, rt=None, requests=None,
               **wkw):
    jcfg, jp, _, _ = _weights(arch, **wkw)
    eng = JaxEngine(jcfg, JaxEngineConfig(
        use_pallas=False, **_ecfg(mode, horizon, n_pages)), jp, rt)
    for r, prompt, n in requests or _requests():
        eng.submit(JaxRequest(r, prompt, n))
    return {k: list(v) for k, v in eng.run(3000).items()}, eng


def _engine(arch, mode, horizon, *, n_pages=96, rt=None, wkw=None, **kw):
    _, _, cfg, params = _weights(arch, **(wkw or {}))
    return DecodeEngine(cfg, EngineConfig(**_ecfg(mode, horizon, n_pages,
                                                  **kw)),
                        params, rt, device="cpu")


def _serve(eng, requests=None):
    for r, prompt, n in requests or _requests():
        eng.submit(Request(r, prompt, n))
    return {k: list(v) for k, v in eng.run(3000).items()}


@pytest.fixture(scope="module")
def whisper_slot():
    """repro's whisper engine once, slot prefill, horizon 1."""
    return _serve_jax("whisper-small", "slot", 1)


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("mode", ["slot", "batched", "chunked"])
def test_whisper_engine_matches_repro_slot(whisper_slot, mode, horizon):
    """Every prefill mode at horizons 1 and 4 emits repro's slot tokens;
    the cross rows are static rows of the decode state (written in place,
    never rebound) and every page comes back."""
    want, jeng = whisper_slot
    eng = _engine("whisper-small", mode, horizon)
    rows = (eng.state["cross_k"].data_ptr(), eng.state["cross_v"].data_ptr())
    assert eng.prefiller.name == mode and not eng.cacheable
    assert _serve(eng) == want
    assert (eng.state["cross_k"].data_ptr(),
            eng.state["cross_v"].data_ptr()) == rows
    assert float(eng.state["cross_k"].abs().max()) > 0
    assert eng.timing.decode_tokens == jeng.timing.decode_tokens
    assert eng.alloc.pages_in_use == 0


@pytest.mark.parametrize("mode", ["batched", "chunked"])
def test_whisper_state_resume_matches_repro(whisper_slot, mode):
    """At 7 pages a request is preempted; its cross rows and KV pages go
    to host memory and come back at re-admission: tokens, snapshots,
    restores and device syncs equal repro's, and the ample pool's."""
    reqs = _requests(nreq=2, budget=12)
    jtight, jeng = _serve_jax("whisper-small", mode, 1, n_pages=7,
                              requests=reqs)
    eng = _engine("whisper-small", mode, 1, n_pages=7, state_resume=True)
    tight = _serve(eng, reqs)
    ample = _serve(_engine("whisper-small", "slot", 1), reqs)
    assert eng.batcher.stats.preempted > 0
    assert eng.rstate_snapshots > 0 and eng.rstate_restores > 0
    assert (eng.rstate_snapshots, eng.rstate_restores) == \
        (jeng.rstate_snapshots, jeng.rstate_restores)
    assert tight == jtight == ample
    assert eng.timing.device_syncs == jeng.timing.device_syncs
    assert eng.alloc.pages_in_use == 0 and not eng.rsnaps


def test_whisper_snapshot_restores_cross_rows(whisper_slot, tmp_path):
    """A serving snapshot carries the cross rows: a fresh engine restores
    them in place and finishes with the uninterrupted run's tokens."""
    want, _ = whisper_slot
    eng = _engine("whisper-small", "batched", 1,
                  snapshot_dir=str(tmp_path), snapshot_every=4)
    for r, prompt, n in _requests():
        eng.submit(Request(r, prompt, n))
    for _ in range(5):
        eng.tick()
    eng2 = _engine("whisper-small", "batched", 1,
                   snapshot_dir=str(tmp_path))
    rows = eng2.state["cross_k"].data_ptr()
    assert eng2.restore_snapshot(step=4) == 4
    eng2.run(3000)
    assert {k: list(v) for k, v in eng2.outputs.items()} == want
    assert eng2.rstate_restores >= 1
    assert eng2.state["cross_k"].data_ptr() == rows


def test_whisper_cluster_hands_cross_rows_over(whisper_slot):
    """A 1 prefill + 1 decode cluster in chunked prefill hands each
    request's KV pages and cross rows over and emits repro's
    single-engine tokens."""
    want, _ = whisper_slot
    _, _, cfg, params = _weights("whisper-small")
    cl = EngineCluster(cfg, EngineConfig(**_ecfg("chunked", 1, 96)),
                       ClusterConfig(n_prefill=1, n_decode=1), params,
                       device="cpu")
    for r, prompt, n in _requests():
        cl.submit(Request(r, prompt, n))
    assert {k: list(v) for k, v in cl.run(3000).items()} == want
    assert cl.counters["handoffs"] == cl.counters["handoff_ok"] == 4


# ---------------------------------------------------------------------------
# engine level: ring pools
# ---------------------------------------------------------------------------

RING_REQS = _requests(nreq=4, budget=12, lo=23, hi=42)


@pytest.fixture(scope="module")
def repro_ring_engines():
    """repro's mixtral engines, full pool and ring (slot prefill, horizon
    4, prompts past the window of 16)."""
    jcfg = _weights("mixtral-8x22b")[0]
    W = (jcfg.sliding_window + PAGE) // PAGE + 1
    return {ring: _serve_jax("mixtral-8x22b", "slot", 4, n_pages=128,
                             rt=JMDL.Runtime(ring_width=ring),
                             requests=RING_REQS)[0] for ring in (0, W)}


@pytest.mark.parametrize("path", ["plain", "kernels"])
def test_ring_engine_matches_full_pool(repro_ring_engines, path):
    """``Runtime(ring_width=W)``: batched prefill degrades to slot (a ring's
    prefill ignores ``valid_len``), each request holds at most W pages,
    and the tokens equal the port's full pool's and repro's full-pool
    engine's."""
    cfg = _weights("mixtral-8x22b")[2]
    W = (cfg.sliding_window + PAGE) // PAGE + 1
    kc = KERNELS[path]
    ring = _engine("mixtral-8x22b", "batched", 4, n_pages=128,
                   rt=MDL.Runtime(ring_width=W, kernels=kc))
    peak = 0
    for r, prompt, n in RING_REQS:
        ring.submit(Request(r, prompt, n))
    while ring._inflight is not None or not ring.batcher.done():
        ring.tick()
        peak = max([peak] + [len(ring.alloc.pages_of(s.req_id))
                             for s in ring.batcher.slots if s is not None])
    got = {k: list(v) for k, v in ring.outputs.items()}
    full = _serve(_engine("mixtral-8x22b", "slot", 4, n_pages=128,
                          rt=MDL.Runtime(kernels=kc)), RING_REQS)
    assert ring.prefiller.name == "slot" and not ring.cacheable
    assert peak == W
    assert got == full == repro_ring_engines[0]
    assert ring.alloc.pages_in_use == 0


def test_repro_ring_engine_aliases_slots_c10(repro_ring_engines):
    """ROADMAP C.10, a fault of the reference, not of the port: repro's
    ring engine builds its allocator without ``ring_pages``, leaves table
    slots past the ring in the table, where they alias ring slots, and
    its tokens differ from its own full pool's. The port's ring engine
    does not copy this (``test_ring_engine_matches_full_pool``); a fix to
    the reference breaks this test and no other."""
    W = (_weights("mixtral-8x22b")[0].sliding_window + PAGE) // PAGE + 1
    assert repro_ring_engines[W] != repro_ring_engines[0]


def test_ring_refuses_speculative_decoding():
    cfg = _weights("mixtral-8x22b")[2]
    with pytest.raises(ValueError, match="ring"):
        DecodeEngine(cfg, EngineConfig(
            n_slots=2, page_size=PAGE, n_pages=32, max_context=32,
            draft_config=replace(cfg, n_layers=1)),
            rt=MDL.Runtime(ring_width=4), device="cpu")


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-7b"])
def test_serve_cli_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", arch, "--requests", "4", "--slots", "2",
                       "--page", "8", "--pages", "48", "--max-context", "64",
                       "--mean-new", "4", "--prefill-mode", "chunked",
                       "--chunk", "8", "--decode-horizon", "4",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert done == 4 and "completed=4/4" in out
    assert "page balance per shard: max=0 min=0" in out
