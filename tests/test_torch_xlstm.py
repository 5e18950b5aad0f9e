"""repro_torch's xLSTM (mLSTM + sLSTM) against repro's, on the CPU.

Blocks: ``gla_step``, ``mlstm_forward`` / ``mlstm_step`` and
``slstm_forward`` (masked and not) / ``slstm_step`` on the same numpy
inputs and converted weights, within 1e-5 of the largest magnitude. The
first step from a fresh carry (``m`` at ``NEG_INF``) is finite in both.

Model level: reduced xlstm-350m (4 layers: two mLSTM + sLSTM cycles) on
weights converted with ``params_from_numpy``: logits and every carry leaf
within 1e-5 of their largest magnitude after ``prefill``,
``prefill_chunk``, ``decode_step`` (a row with ``run`` False keeps its
carry) and ``decode_multi``. The decode state holds no pool.

Engine level: both engines with the geometry of
``tests/test_recurrent_prefill.py::_run`` (2 slots, page 4, 4 requests of
3-17 tokens, 5 new) in slot, batched and chunked (3) prefill at
horizons 1 and 4: greedy tokens, decode tokens and device syncs equal.
A preempted request restores its snapshot (``state_resume``) in batched
and chunked prefill to the ample pool's tokens and to repro's, with equal
snapshot / restore / sync counters; a refilled slot starts from fresh rows;
a 1 prefill + 1 decode cluster hands each request's carry over (no KV
pages) to repro's single-engine tokens, four handoffs and no other router
counter.
Speculative decoding refuses an xLSTM target or draft, as repro does.
"""
from dataclasses import asdict, fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.ops import write_targets as jax_write_targets
from repro.models import model as JMDL
from repro.models import ssm as JSSM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving.sampling import make_scan_sampler as jax_scan_sampler
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as MDL
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.serving import (ClusterConfig, DecodeEngine, EngineCluster,
                                 EngineConfig, Request)
from repro_torch.serving.sampling import make_scan_sampler

B, S, PAGE = 2, 12, 4


def _configs():
    return (replace(jax_reduced(jax_get_config("xlstm-350m")),
                    dtype="float32"),
            replace(reduced(get_config("xlstm-350m")), dtype="float32"))


def _close_scaled(got, want, tol=1e-5):
    """max |got - want| <= tol x max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    gap = float(np.abs(got - want).max())
    assert gap <= tol * max(1.0, float(np.abs(want).max())), gap


def _leaves_close(mine, theirs, n=None):
    a = jax.tree.leaves(MDL.tree_map(lambda t: t.numpy(), mine))
    b = jax.tree.leaves(theirs)
    assert len(a) == len(b) and (n is None or len(a) == n)
    for x, y in zip(a, b):
        _close_scaled(x, y)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs tiny shapes here: one intra-op thread a worker keeps
    the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _configs()
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("cut", [False, True], ids=["full", "reduced"])
def test_config_matches_repro(cut):
    """xlstm-350m and its ``reduced`` form field for field (the port's
    ``ModelConfig`` carries a subset of repro's fields)."""
    jcfg, cfg = jax_get_config("xlstm-350m"), get_config("xlstm-350m")
    if cut:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    want = asdict(jcfg)
    assert asdict(cfg) == {f.name: want[f.name] for f in fields(cfg)}
    assert (cfg.d_inner, cfg.block_kinds()) == (jcfg.d_inner,
                                               jcfg.block_kinds())


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _layer(tree, i=0):
    return {k: v[i] for k, v in tree.items()}


@pytest.mark.parametrize("normalize", [True, False])
def test_gla_step_matches_jax(normalize):
    """The exact single-step recurrence, three steps from a fresh carry."""
    rng = np.random.default_rng(0)
    b, h, dk, dv = 2, 3, 8, 5
    jst = (jnp.zeros((b, h, dk, dv)), jnp.zeros((b, h, dk)),
           jnp.full((b, h), -1e30 if normalize else 0.0))
    st = state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    for _ in range(3):
        q, k = rng.standard_normal((2, b, h, dk), np.float32)
        v = rng.standard_normal((b, h, dv), np.float32)
        la = -np.abs(rng.standard_normal((b, h), np.float32))
        lg = rng.standard_normal((b, h), np.float32)
        jy, jst = JSSM.gla_step(q, k, v, la, lg, jst, normalize=normalize)
        y, st = SSM.gla_step(_t(q), _t(k), _t(v), _t(la), _t(lg), st,
                             normalize=normalize)
        _close_scaled(y, jy)
        _leaves_close(st, jst, 3)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_forward_matches_jax(weights, block, masked):
    """A 12-token forward from a fresh carry and on from the result; with
    the mask, row 1's pads (7 valid) are identity steps."""
    jcfg, jparams, cfg, params = weights
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    mask = np.arange(S)[None] < np.asarray([S, 7])[:, None] if masked \
        else None
    jfn = getattr(JSSM, f"{block}_forward")
    fn = getattr(SSM, f"{block}_forward")
    jinit = getattr(JSSM, f"{block}_init_state")(jcfg, B)
    init = getattr(SSM, f"{block}_init_state")(cfg, B)
    jp, p = _layer(jparams[block]), _layer(params[block])
    kw = dict(chunk=4) if block == "mlstm" else {}
    jy, jst = jfn(jp, jcfg, jnp.asarray(x), state=jinit,
                  mask=None if mask is None else jnp.asarray(mask), **kw)
    y, st = fn(p, cfg, _t(x), state=init,
               mask=None if mask is None else _t(mask), **kw)
    live = np.ones((B, S), bool) if mask is None else mask
    _close_scaled(y.numpy()[live], np.asarray(jy)[live])
    _leaves_close(st, jst)
    jy, _ = jfn(jp, jcfg, jnp.asarray(x[:, :4]), state=jst, **kw)
    y, _ = fn(p, cfg, _t(x[:, :4]), state=st, **kw)
    _close_scaled(y, jy)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_step_matches_jax_from_a_fresh_carry(weights, block):
    """Two single-token steps from the ``NEG_INF`` stabiliser: finite and
    equal to JAX's (the normaliser's ``exp(-m)`` floor and the cell's
    ``max(n, 1e-6)`` at their first use)."""
    jcfg, jparams, cfg, params = weights
    rng = np.random.default_rng(2)
    jst = getattr(JSSM, f"{block}_init_state")(jcfg, B)
    st = getattr(SSM, f"{block}_init_state")(cfg, B)
    jp, p = _layer(jparams[block], 1), _layer(params[block], 1)
    for _ in range(2):
        x = rng.standard_normal((B, cfg.d_model), np.float32)
        jy, jst = getattr(JSSM, f"{block}_step")(jp, jcfg, jnp.asarray(x),
                                                 jst)
        y, st = getattr(SSM, f"{block}_step")(p, cfg, _t(x), st)
        _close_scaled(y, jy)
        _leaves_close(st, jst)


def test_mlstm_forward_pads_lengths_jax_refuses(weights):
    """ROADMAP C.6 for the mLSTM: 37 positions at chunk 32 (JAX asserts
    that the chunk divides S) scan padded to 64 with identity steps, equal
    to JAX's one-chunk scan of the 37 (chunk 37)."""
    jcfg, jparams, cfg, params = weights
    assert SSM.scan_geometry(37, 32) == (32, 64)
    x = np.random.default_rng(3).standard_normal((B, 37, cfg.d_model),
                                                 np.float32)
    jp, p = _layer(jparams["mlstm"]), _layer(params["mlstm"])
    with pytest.raises(AssertionError):
        JSSM.mlstm_forward(jp, jcfg, jnp.asarray(x), chunk=32)
    jy, jst = JSSM.mlstm_forward(jp, jcfg, jnp.asarray(x), chunk=37)
    y, st = SSM.mlstm_forward(p, cfg, _t(x), chunk=32)
    _close_scaled(y, jy)
    _leaves_close(st, jst, 3)


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prefilled(weights):
    """Both models after a length-bucketed prefill of two prompts (12 and
    7 valid tokens); no pool, no block table."""
    jcfg, jparams, cfg, params = weights
    assert cfg.n_layers == 4 and params["slstm"]["r"].shape == (2, 4, 4, 16,
                                                                 16)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.asarray([S, 7], np.int32)
    jstate = JMDL.init_decode_state(jcfg, None, B)
    state = MDL.init_decode_state(cfg, None, B, device="cpu")
    assert "pool" not in state and set(state) == set(jstate)
    jl, jstate = JMDL.prefill(jcfg, jparams, jstate, jnp.asarray(tokens),
                              None, last_idx=jnp.asarray(lens - 1),
                              valid_len=jnp.asarray(lens))
    tl, state = MDL.prefill(cfg, params, state, _t(tokens), None,
                            last_idx=_t(lens - 1), valid_len=_t(lens))
    return dict(weights=weights, lens=lens, jstate=jstate, state=state,
                jlogits=jl, logits=tl)


def _clone(state):
    return MDL.tree_map(lambda t: t.clone(), state)


def test_prefill_matches_jax(prefilled):
    p = prefilled
    _close_scaled(p["logits"], p["jlogits"])
    _leaves_close(p["state"], p["jstate"], 7)


def test_prefill_chunk_matches_jax(prefilled):
    """A 4-token chunk resuming each row from its carried rows, the second
    row padded (valid_len 2)."""
    p = prefilled
    jcfg, jparams, cfg, params = p["weights"]
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 4)).astype(np.int32)
    valid = np.asarray([4, 2], np.int32)
    jl, jstate = JMDL.prefill_chunk(
        jcfg, jparams, p["jstate"], jnp.asarray(toks), None,
        jnp.asarray(p["lens"]), last_idx=jnp.asarray(valid - 1),
        valid_len=jnp.asarray(valid))
    tl, state = MDL.prefill_chunk(
        cfg, params, _clone(p["state"]), _t(toks), None, _t(p["lens"]),
        last_idx=_t(valid - 1), valid_len=_t(valid))
    _close_scaled(tl, jl)
    _leaves_close(state, jstate, 7)


@pytest.mark.parametrize("run", [[True, True], [True, False]],
                         ids=["all", "row1-idle"])
def test_decode_step_matches_jax(prefilled, run):
    p = prefilled
    jcfg, jparams, cfg, params = p["weights"]
    tokens = np.asarray([5, 77], np.int32)
    ctx = p["lens"] + 1
    bt = np.zeros((B, 1), np.int32)
    run = np.asarray(run)
    npage, noff = jax_write_targets(jnp.asarray(bt), jnp.asarray(ctx),
                                    jnp.asarray(run), page_size=PAGE,
                                    n_pages=8)
    jl, jstate = JMDL.decode_step(jcfg, jparams, p["jstate"],
                                  jnp.asarray(tokens), jnp.asarray(bt),
                                  jnp.asarray(ctx), npage, noff,
                                  run=jnp.asarray(run))
    tl, state = MDL.decode_step(
        cfg, params, _clone(p["state"]), _t(tokens), _t(bt), _t(ctx),
        _t(np.array(npage)), _t(np.array(noff)), run=_t(run))
    _close_scaled(tl, jl)
    _leaves_close(state, jstate, 7)
    if not run[1]:
        before = MDL.gather_rstate(p["state"], [1])
        after = MDL.gather_rstate(state, [1])
        for a, b in zip(jax.tree.leaves(MDL.tree_map(np.asarray, after)),
                        jax.tree.leaves(MDL.tree_map(np.asarray, before))):
            np.testing.assert_array_equal(a, b)


def test_decode_multi_matches_jax(prefilled):
    """Three fused greedy steps; row 0 has a budget of two tokens and
    freezes, row 1 may run only two (allow): their carries stay."""
    p = prefilled
    jcfg, jparams, cfg, params = p["weights"]
    tokens = np.asarray([5, 77], np.int32)
    ctx = p["lens"] + 1
    bt = np.zeros((B, 8), np.int32)
    rem = np.asarray([2, 9], np.int32)
    allow = np.asarray([3, 2], np.int32)
    kw = dict(horizon=3, table_width=8, page_size=PAGE, n_pages=16,
              eos_token=-1)
    jout = JMDL.decode_multi(
        jcfg, jparams, p["jstate"], jnp.asarray(tokens), jnp.asarray(bt),
        jnp.asarray(ctx), jnp.asarray(rem), jnp.asarray(allow),
        jax.random.PRNGKey(0), sample=jax_scan_sampler("greedy"), **kw)
    tout = MDL.decode_multi(
        cfg, params, _clone(p["state"]), _t(tokens), _t(bt), _t(ctx),
        _t(rem), _t(allow), sample=make_scan_sampler("greedy"), **kw)
    for got, want in zip(tout[:3] + tout[4:], jout[:3] + jout[4:7]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _leaves_close(tout[3], jout[3], 7)


def test_rstate_gather_scatter_tuple_carries(prefilled):
    """Gather / scatter over the tuple carries agree with JAX's, and
    ``state_from_numpy`` converts JAX rows leaf for leaf."""
    p = prefilled
    jrows = JMDL.gather_rstate(p["jstate"], [1, 0])
    rows = MDL.gather_rstate(p["state"], [1, 0])
    _leaves_close(rows, jrows, 7)
    conv = state_from_numpy(jax.tree.map(np.asarray, jrows), "cpu")
    for a, b in zip(jax.tree.leaves(MDL.tree_map(np.asarray, conv)),
                    jax.tree.leaves(jrows)):
        np.testing.assert_array_equal(a, np.asarray(b))
    st = _clone(p["state"])
    MDL.scatter_rstate(st, [0, 1], rows)          # swap the two rows
    back = MDL.gather_rstate(st, [1, 0])
    for a, b in zip(jax.tree.leaves(MDL.tree_map(np.asarray, back)),
                    jax.tree.leaves(MDL.tree_map(np.asarray, p["state"]))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

MODES = [("slot", 5), ("batched", 5), ("chunked", 3)]
HORIZONS = (1, 4)


def _requests(nreq=4, budget=5):
    rng = np.random.default_rng(0)
    return [(r, rng.integers(0, 256, size=int(rng.integers(3, 18))), budget)
            for r in range(nreq)]


def _ecfg(mode, chunk, horizon, n_pages, n_slots=2):
    return dict(n_slots=n_slots, page_size=PAGE, n_pages=n_pages,
                max_context=64, eos_token=-1, prefill_mode=mode,
                prefill_chunk=chunk, decode_horizon=horizon)


def _serve_jax(weights, mode, chunk, horizon, *, n_pages=96,
               state_resume=True, **rk):
    jcfg, jparams, _, _ = weights
    eng = JaxEngine(jcfg, JaxEngineConfig(
        use_pallas=False, state_resume=state_resume,
        **_ecfg(mode, chunk, horizon, n_pages)), jparams)
    for r, prompt, n in _requests(**rk):
        eng.submit(JaxRequest(r, prompt, n))
    return {k: list(v) for k, v in eng.run(3000).items()}, eng


def _serve_torch(weights, mode, chunk, horizon, *, n_pages=96, n_slots=2,
                 requests=None, **rk):
    _, _, cfg, params = weights
    eng = DecodeEngine(cfg, EngineConfig(
        **_ecfg(mode, chunk, horizon, n_pages, n_slots)), params,
        device="cpu")
    for r, prompt, n in requests or _requests(**rk):
        eng.submit(Request(r, prompt, n))
    return {k: list(v) for k, v in eng.run(3000).items()}, eng


@pytest.fixture(scope="module")
def jax_ref(weights):
    """repro's engine once per (mode, chunk, horizon): its tokens and
    counters."""
    out = {}
    for mode, chunk in MODES:
        for h in HORIZONS:
            got, eng = _serve_jax(weights, mode, chunk, h)
            out[mode, chunk, h] = got, eng.timing
    return out


@pytest.mark.parametrize("horizon", HORIZONS)
@pytest.mark.parametrize("mode,chunk", MODES)
def test_engine_greedy_identity(weights, jax_ref, mode, chunk, horizon):
    want, jtiming = jax_ref[mode, chunk, horizon]
    assert want == jax_ref["slot", 5, 1][0]
    got, eng = _serve_torch(weights, mode, chunk, horizon)
    assert got == want
    assert "pool" not in eng.state and not eng.cacheable
    assert eng.batcher.stats.completed == len(want)
    bal = eng.alloc.shard_balance()
    assert bal.max() == 0 and bal.min() == 0
    assert eng.timing.decode_tokens == jtiming.decode_tokens
    assert eng.timing.device_syncs == jtiming.device_syncs


def test_recurrent_rows_reset_on_slot_refill(weights):
    """Two requests through ONE slot, one after the other: the second
    starts from fresh rows, not the first's carry."""
    rng = np.random.default_rng(1)
    p0, p1 = rng.integers(0, 256, size=9), rng.integers(0, 256, size=11)
    both, eng = _serve_torch(weights, "batched", 5, 4, n_pages=64,
                             n_slots=1, requests=[(0, p0, 6), (1, p1, 6)])
    solo, _ = _serve_torch(weights, "batched", 5, 4, n_pages=64, n_slots=1,
                           requests=[(0, p1, 6)])
    assert eng.batcher.stats.completed == 2
    assert both[1] == solo[0]


@pytest.mark.parametrize("mode", ["batched", "chunked"])
def test_state_resume_restores_the_carry(weights, mode):
    """At 9 pages a request is preempted; its carry rows go to host memory
    and come back at re-admission: tokens equal the ample pool's and
    repro's, with as many snapshots, restores and device syncs; no snapshot
    is left behind."""
    kw = dict(nreq=2, budget=12)
    ample, _ = _serve_torch(weights, "batched", 5, 1, **kw)
    tight, eng = _serve_torch(weights, mode, 5, 1, n_pages=9, **kw)
    jtight, jeng = _serve_jax(weights, mode, 5, 1, n_pages=9, **kw)
    assert eng.batcher.stats.preempted > 0
    assert eng.rstate_snapshots > 0 and eng.rstate_restores > 0
    assert (eng.rstate_snapshots, eng.rstate_restores) == \
        (jeng.rstate_snapshots, jeng.rstate_restores)
    assert tight == ample == jtight
    assert eng.timing.device_syncs == jeng.timing.device_syncs
    assert eng.alloc.pages_in_use == 0 and not eng.rsnaps


def test_disagg_cluster_hands_the_carry_over(weights, jax_ref):
    """``extract_request`` / ``adopt_request`` with an xLSTM carry and no
    pool: a 1 prefill + 1 decode cluster in chunked prefill emits repro's
    single-engine tokens, every request handed off once and no other
    router counter moved (repro's cluster counts the same on this
    traffic)."""
    _, _, cfg, params = weights
    mode, chunk = MODES[2]
    cl = EngineCluster(cfg, EngineConfig(**_ecfg(mode, chunk, 1, 96)),
                       ClusterConfig(n_prefill=1, n_decode=1), params,
                       device="cpu")
    for r, prompt, n in _requests():
        cl.submit(Request(r, prompt, n))
    got = {k: list(v) for k, v in cl.run(3000).items()}
    assert got == jax_ref[mode, chunk, 1][0]
    assert cl.counters == {**dict.fromkeys(cl.counters, 0),
                           "handoffs": 4, "handoff_ok": 4}


@pytest.mark.parametrize("side", ["target", "draft"])
def test_speculative_decoding_refuses_xlstm(weights, side):
    """A recurrent carry cannot roll back past a rejected proposal: an
    xLSTM target or draft is refused before any weights are built, as
    repro refuses it (``tests/test_spec_decode.py``)."""
    _, _, xcfg, params = weights
    llama = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    target, draft = (xcfg, llama) if side == "target" else (llama, xcfg)
    ecfg = EngineConfig(n_slots=2, page_size=PAGE, n_pages=16,
                        max_context=32, draft_config=draft)
    with pytest.raises(ValueError, match="attention-only"):
        DecodeEngine(target, ecfg, device="cpu")


def test_serve_cli_xlstm_on_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", "xlstm-350m", "--requests", "4",
                       "--slots", "2", "--page", "8", "--pages", "48",
                       "--max-context", "96", "--mean-new", "5",
                       "--prefill-mode", "chunked", "--chunk", "8",
                       "--decode-horizon", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert done == 4 and "completed=4/4" in out
    assert "page balance per shard: max=0 min=0" in out
