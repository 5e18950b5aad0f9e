"""repro_torch's zamba2 hybrid (Mamba2 + shared attention) against repro's,
on the CPU.

Model level: reduced zamba2 at its default 38 layers (two cycles, so both
pool layers and the shared block run twice) on weights converted with
``params_from_numpy``: logits within 1e-4, pools on ``[:, :n_pages]`` and
every Mamba2 state leaf within 1e-5 of their largest magnitude, after
``prefill``, ``prefill_chunk``, ``decode_step`` and ``decode_multi``. The
scale: the residual stream passes 18 Mamba2 layers before the first pool
write, each a chain of fp32 products that XLA and PyTorch sum in different
orders, so the gap grows with the values' scale (measured: 1.95e-5 on pool
values up to 3.7, 1.45e-5 on conv rows up to 4.2), not per element.

Engine level: reduced zamba2 at 19 layers (one cycle, as
``tests/test_recurrent_prefill.py``) through both engines — greedy outputs
token-identical for slot, batched and chunked (3/5/8) prefill at horizons 1
and 4, with equal token and sync counters; recurrent rows reset on slot
refill; a preempted request recomputes to the same tokens.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.paged_kv import PoolSpec as JaxPoolSpec
from repro.kernels.ops import write_targets as jax_write_targets
from repro.models import model as JMDL
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving.sampling import make_scan_sampler as jax_scan_sampler
from repro_torch.configs import get_config, reduced
from repro_torch.core.paged_kv import PoolSpec
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.serving import DecodeEngine, EngineConfig, Request
from repro_torch.serving.sampling import make_scan_sampler

B, S, PAGE, N_PAGES, MAXP = 2, 12, 4, 16, 6
RT = MDL.Runtime(kernels=KernelConfig(n_splits=2))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _configs(layers=None):
    jcfg = replace(jax_reduced(jax_get_config("zamba2-1.2b"), layers=layers),
                   dtype="float32")
    cfg = replace(reduced(get_config("zamba2-1.2b"), layers=layers),
                  dtype="float32")
    return jcfg, cfg


def _close_scaled(got, want, tol):
    """max |got - want| <= tol x max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    gap = float(np.abs(got - want).max())
    assert gap <= tol * max(1.0, float(np.abs(want).max())), gap


def _state_close(state, jstate):
    for k in ("k", "v"):
        _close_scaled(state["pool"][k][:, :N_PAGES], jstate["pool"][k], 1e-5)
    mine = jax.tree.leaves(MDL.tree_map(lambda t: t.numpy(),
                                         state["mamba"]))
    theirs = jax.tree.leaves(jstate["mamba"])
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine, theirs):
        _close_scaled(a, b, 1e-5)


def _clone(state):
    return MDL.tree_map(lambda t: t.clone(), state)


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prefilled():
    """Both models with the same weights after a length-bucketed prefill of
    two prompts (12 and 7 valid tokens)."""
    jcfg, cfg = _configs()
    assert cfg.n_layers == 38
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    assert params["mamba"]["wx"].shape[0] == 36
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    bt = rng.permutation(N_PAGES)[:B * MAXP].reshape(B, MAXP).astype(np.int32)
    lens = np.asarray([S, 7], np.int32)
    geo = (2, N_PAGES, PAGE, cfg.n_kv_heads, cfg.d_head, MAXP)
    jstate = JMDL.init_decode_state(jcfg, JaxPoolSpec(*geo, dtype="float32"),
                                    B)
    state = MDL.init_decode_state(cfg, PoolSpec(*geo, dtype="float32"), B,
                                  device="cpu")
    jl, jstate = JMDL.prefill(jcfg, jparams, jstate, jnp.asarray(tokens),
                              jnp.asarray(bt), last_idx=jnp.asarray(lens - 1),
                              valid_len=jnp.asarray(lens))
    tl, state = MDL.prefill(cfg, params, state, torch.from_numpy(tokens),
                            torch.from_numpy(bt),
                            last_idx=torch.from_numpy(lens - 1),
                            valid_len=torch.from_numpy(lens), rt=RT)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params, bt=bt,
                lens=lens, jstate=jstate, state=state, jlogits=jl, logits=tl)


def test_prefill_matches_jax(prefilled):
    p = prefilled
    _close(p["logits"], p["jlogits"], 1e-4)
    _state_close(p["state"], p["jstate"])


def test_prefill_chunk_matches_jax(prefilled):
    """A 4-token chunk resuming each row at its own depth from its carried
    rows, the second row padded (valid_len 2)."""
    p = prefilled
    toks = np.random.default_rng(1).integers(
        0, p["cfg"].vocab_size, (B, 4)).astype(np.int32)
    start, valid = p["lens"], np.asarray([4, 2], np.int32)
    jl, jstate = JMDL.prefill_chunk(
        p["jcfg"], p["jparams"], p["jstate"], jnp.asarray(toks),
        jnp.asarray(p["bt"]), jnp.asarray(start),
        last_idx=jnp.asarray(valid - 1), valid_len=jnp.asarray(valid))
    tl, state = MDL.prefill_chunk(
        p["cfg"], p["params"], _clone(p["state"]), torch.from_numpy(toks),
        torch.from_numpy(p["bt"]), torch.from_numpy(start),
        last_idx=torch.from_numpy(valid - 1),
        valid_len=torch.from_numpy(valid), rt=RT)
    _close(tl, jl, 1e-4)
    _state_close(state, jstate)


@pytest.mark.parametrize("run", [[True, True], [True, False]],
                         ids=["all", "row1-idle"])
def test_decode_step_matches_jax(prefilled, run):
    """One decode step; with ``run`` False a row keeps its carry."""
    p = prefilled
    tokens = np.asarray([5, 77], np.int32)
    ctx = p["lens"] + 1
    run = np.asarray(run)
    npage, noff = jax_write_targets(jnp.asarray(p["bt"]), jnp.asarray(ctx),
                                    jnp.asarray(run), page_size=PAGE,
                                    n_pages=N_PAGES)
    jl, jstate = JMDL.decode_step(p["jcfg"], p["jparams"], p["jstate"],
                                  jnp.asarray(tokens), jnp.asarray(p["bt"]),
                                  jnp.asarray(ctx), npage, noff,
                                  run=jnp.asarray(run))
    tl, state = MDL.decode_step(
        p["cfg"], p["params"], _clone(p["state"]), torch.from_numpy(tokens),
        torch.from_numpy(p["bt"]), torch.from_numpy(ctx),
        torch.from_numpy(np.array(npage)), torch.from_numpy(np.array(noff)),
        run=torch.from_numpy(run), rt=RT)
    _close(tl, jl, 1e-4)
    _state_close(state, jstate)
    if not run[1]:
        before = MDL.gather_rstate(p["state"], [1])
        after = MDL.gather_rstate(state, [1])
        for a, b in zip(jax.tree.leaves(MDL.tree_map(np.asarray, after)),
                        jax.tree.leaves(MDL.tree_map(np.asarray, before))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rt", [RT, MDL.Runtime()], ids=["kernel", "plain"])
def test_decode_multi_matches_jax(prefilled, rt):
    """Three fused greedy steps; row 1 may run only two (allow), row 0 has
    a budget of two tokens and freezes — frozen and paused rows keep their
    carry."""
    p = prefilled
    tokens = np.asarray([5, 77], np.int32)
    ctx = p["lens"] + 1
    rem = np.asarray([2, 9], np.int32)
    allow = np.asarray([3, 2], np.int32)
    kw = dict(horizon=3, table_width=4, page_size=PAGE, n_pages=N_PAGES,
              eos_token=-1)
    jout = JMDL.decode_multi(
        p["jcfg"], p["jparams"], p["jstate"], jnp.asarray(tokens),
        jnp.asarray(p["bt"]), jnp.asarray(ctx), jnp.asarray(rem),
        jnp.asarray(allow), jax.random.PRNGKey(0),
        sample=jax_scan_sampler("greedy"), **kw)
    tout = MDL.decode_multi(
        p["cfg"], p["params"], _clone(p["state"]), torch.from_numpy(tokens),
        torch.from_numpy(p["bt"]), torch.from_numpy(ctx),
        torch.from_numpy(rem), torch.from_numpy(allow),
        sample=make_scan_sampler("greedy"), rt=rt, **kw)
    jtoks, jemit, jfin, jstate, jtok, jctx, jrem, _ = jout
    ttoks, temit, tfin, state, ttok, tctx, trem = tout
    for got, want in ((ttoks, jtoks), (temit, jemit), (tfin, jfin),
                      (ttok, jtok), (tctx, jctx), (trem, jrem)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _state_close(state, jstate)


def test_rstate_gather_scatter_and_convert(prefilled):
    """Row gather / scatter are one index operation per leaf and agree with
    JAX's, and ``state_from_numpy`` converts JAX rows leaf for leaf."""
    p = prefilled
    jrows = JMDL.gather_rstate(p["jstate"], [1, 0])
    rows = MDL.gather_rstate(p["state"], [1, 0])
    conv = state_from_numpy(jax.tree.map(np.asarray, jrows), "cpu")
    for a, b, c in zip(jax.tree.leaves(MDL.tree_map(np.asarray, rows)),
                       jax.tree.leaves(jrows),
                       jax.tree.leaves(MDL.tree_map(np.asarray, conv))):
        _close_scaled(a, b, 1e-5)
        np.testing.assert_array_equal(c, np.asarray(b))
    st = _clone(p["state"])
    MDL.scatter_rstate(st, [0, 1], rows)          # swap the two rows
    back = MDL.gather_rstate(st, [1, 0])
    for a, b in zip(jax.tree.leaves(MDL.tree_map(np.asarray, back)),
                    jax.tree.leaves(MDL.tree_map(np.asarray,
                                                  p["state"]["mamba"]))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

MODES = [("slot", 5), ("batched", 5), ("chunked", 3), ("chunked", 5),
         ("chunked", 8)]
REF_HORIZON = 4


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = _configs(layers=19)
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _requests(nreq=4, budget=5):
    rng = np.random.default_rng(0)
    return [(r, rng.integers(0, 256, size=int(rng.integers(3, 18))), budget)
            for r in range(nreq)]


def _ecfg(mode, chunk, horizon, n_pages, n_slots=2):
    return dict(n_slots=n_slots, page_size=PAGE, n_pages=n_pages,
                max_context=64, eos_token=-1, prefill_mode=mode,
                prefill_chunk=chunk, decode_horizon=horizon)


def _serve_jax(engines, mode, chunk, horizon, *, n_pages=96, **rk):
    jcfg, jparams, _, _ = engines
    eng = JaxEngine(jcfg, JaxEngineConfig(
        use_pallas=False, state_resume=False,
        **_ecfg(mode, chunk, horizon, n_pages)), jparams)
    for r, prompt, n in _requests(**rk):
        eng.submit(JaxRequest(r, prompt, n))
    return {k: list(v) for k, v in eng.run(3000).items()}, eng


def _serve_torch(engines, mode, chunk, horizon, *, n_pages=96, n_slots=2,
                 requests=None, **rk):
    _, _, cfg, params = engines
    eng = DecodeEngine(cfg, EngineConfig(
        **_ecfg(mode, chunk, horizon, n_pages, n_slots)), params,
        device="cpu")
    for r, prompt, n in requests or _requests(**rk):
        eng.submit(Request(r, prompt, n))
    return {k: list(v) for k, v in eng.run(3000).items()}, eng


@pytest.fixture(scope="module")
def jax_ref(engines):
    """The JAX engine once per prefill mode / chunk (greedy outputs are
    horizon invariant; its counters are those of ``REF_HORIZON``)."""
    out = {}
    for mode, chunk in MODES:
        got, eng = _serve_jax(engines, mode, chunk, REF_HORIZON)
        out[mode, chunk] = got, eng.timing
    return out


@pytest.mark.parametrize("horizon", [1, REF_HORIZON])
@pytest.mark.parametrize("mode,chunk", MODES)
def test_engine_greedy_identity(engines, jax_ref, mode, chunk, horizon):
    want, jtiming = jax_ref[mode, chunk]
    assert want == jax_ref["slot", 5][0]
    got, eng = _serve_torch(engines, mode, chunk, horizon)
    assert got == want
    assert eng.batcher.stats.completed == len(want)
    bal = eng.alloc.shard_balance()
    assert bal.max() == 0 and bal.min() == 0
    if horizon == REF_HORIZON:
        assert eng.timing.decode_tokens == jtiming.decode_tokens
        assert eng.timing.device_syncs == jtiming.device_syncs


def test_recurrent_rows_reset_on_slot_refill(engines):
    """Two requests through ONE slot, one after the other: the second must
    start from zero rows, not the dead request's carry — its output equals
    a fresh engine's."""
    rng = np.random.default_rng(1)
    p0, p1 = rng.integers(0, 256, size=9), rng.integers(0, 256, size=11)
    both, eng = _serve_torch(engines, "batched", 5, 4, n_pages=64, n_slots=1,
                             requests=[(0, p0, 6), (1, p1, 6)])
    solo, _ = _serve_torch(engines, "batched", 5, 4, n_pages=64, n_slots=1,
                           requests=[(0, p1, 6)])
    assert eng.batcher.stats.completed == 2
    assert both[1] == solo[0]


@pytest.mark.parametrize("mode", ["slot", "batched"])
def test_preempted_request_recomputes(engines, mode):
    """A pool too small for both requests preempts one; it recomputes (no
    carry snapshot in the port) to the ample pool's tokens — and to JAX's
    ``state_resume=False`` engine. (Chunked prefill on this pool preempts
    forever without snapshots, in JAX's engine as in the port: ROADMAP
    C.4.)"""
    kw = dict(nreq=2, budget=12)
    ample, _ = _serve_torch(engines, "batched", 5, 1, **kw)
    tight, eng = _serve_torch(engines, mode, 5, 1, n_pages=9, **kw)
    assert eng.batcher.stats.preempted > 0
    assert eng.batcher.stats.completed == 2
    assert tight == ample
    assert eng.alloc.pages_in_use == 0
    if mode == "batched":      # (one JAX compile: slot reaches the same)
        jtight, _ = _serve_jax(engines, mode, 5, 1, n_pages=9, **kw)
        assert tight == jtight


def test_state_resume_is_not_ported():
    with pytest.raises(NotImplementedError):
        EngineConfig(state_resume=True, **_ecfg("batched", 5, 1, 96))


def test_mamba_chunk_adapts_to_sequence_length(engines):
    """A prompt length the scan chunk does not divide (slot prefill of 13
    tokens at ``gla_chunk`` 8) runs at the largest chunk that does, with
    the result of a one-chunk scan."""
    _, _, cfg, params = engines
    geo = PoolSpec(1, 16, PAGE, cfg.n_kv_heads, cfg.d_head, 5,
                   dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (1, 13)).astype(np.int32))
    bt = torch.arange(5, dtype=torch.int32)[None]
    outs = []
    for chunk in (8, 128):
        st = MDL.init_decode_state(cfg, geo, 1, device="cpu")
        logits, st = MDL.prefill(cfg, params, st, toks, bt,
                                 rt=MDL.Runtime(gla_chunk=chunk))
        outs.append((logits, st))
    (l8, s8), (l128, s128) = outs
    _close(l8, l128, 1e-5)
    for a, b in zip(jax.tree.leaves(MDL.tree_map(np.asarray, s8)),
                    jax.tree.leaves(MDL.tree_map(np.asarray, s128))):
        _close(a, b, 1e-5)


def test_serve_cli_zamba_on_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", "zamba2-1.2b", "--requests", "4",
                       "--slots", "2", "--page", "8", "--pages", "48",
                       "--max-context", "96", "--mean-new", "5",
                       "--prefill-mode", "chunked", "--chunk", "8",
                       "--decode-horizon", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert done == 4 and "completed=4/4" in out
    assert "page balance per shard: max=0 min=0" in out
