"""Speculative decoding in repro_torch against repro's, on the CPU.

The draft's proposal scan (``draft_propose``) and the one-pass verify
(``decode_verify``) on the same converted weights, pools and tokens:
proposals, candidates, accept lengths and slot state identical, logits
and pools within 1e-5. Then ``repro``'s ``tests/test_spec_decode.py``
matrix on the port's engine: greedy speculative output token-identical to
repro's speculative engine and to the port's target-only engine, with
``spec_rounds``, ``spec_proposed``, ``spec_accepted``, ``device_syncs`` and
``decode_tokens`` equal to repro's, through every prefill mode, EOS and
budget stops inside a round, preemption, prefix sharing and a draft that
never matches. Stochastic kinds are held by seed determinism and the
p == q accept-all property (ROADMAP C.2). Last, the round as the graph
runner dispatches it (a neutral capture pass, stable addresses, the
generators put back after a capture) and K1's row tiling.
"""
import functools
from contextlib import contextmanager
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.paged_kv import PoolSpec as JaxPoolSpec
from repro.models import model as JMDL
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving.sampling import make_scan_sampler as jax_scan_sampler
from repro.serving.sampling import make_verifier as jax_verifier
from repro_torch.configs import get_config, reduced, validate_draft_pair
from repro_torch.core.paged_kv import PoolSpec
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import model as MDL
from repro_torch.models.convert import oracle_draft_pair, params_from_numpy
from repro_torch.serving import DecodeEngine, EngineConfig, Request
from repro_torch.serving.sampling import make_scan_sampler, make_verifier

BUDGETS = [3, 12, 5, 12, 2, 9]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models():
    """The reduced llama target (2 layers) and a REAL 1-layer draft with
    independent weights, in both packages."""
    jcfg = jax_reduced(jax_get_config("llama3.2-1b"))
    jdcfg = jax_reduced(jax_get_config("llama3.2-1b"), layers=1)
    cfg = reduced(get_config("llama3.2-1b"))
    dcfg = reduced(get_config("llama3.2-1b"), layers=1)
    jp = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jdp = JMDL.init_params(jdcfg, jax.random.PRNGKey(7), jnp.float32)
    return dict(jcfg=jcfg, jdcfg=jdcfg, cfg=cfg, dcfg=dcfg, jp=jp, jdp=jdp,
                tp=params_from_numpy(cfg, _np(jp), "cpu"),
                dp=params_from_numpy(dcfg, _np(jdp), "cpu"))


def _draft(kind):
    """(repro cfg, repro params, port cfg, port params) of a draft: "real"
    (independent 1-layer weights) or "oracle" (the target itself, as
    repro's test: identical logits, every proposal accepted)."""
    m = _models()
    if kind == "real":
        return m["jdcfg"], m["jdp"], m["dcfg"], m["dp"]
    return m["jcfg"], m["jp"], m["cfg"], m["tp"]


# ---------------------------------------------------------------------------
# the model: draft_propose and decode_verify against repro's
# ---------------------------------------------------------------------------

B, PAGE, N_PAGES, MAXP, G = 3, 4, 24, 8, 3


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _prefilled(cfg, jcfg, params, jparams, lens):
    """Both packages' pools after a length-bucketed prefill of the same
    prompts over the same block tables."""
    rng = np.random.default_rng(0)
    S = int(max(lens))
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    bt = np.arange(B * MAXP, dtype=np.int32).reshape(B, MAXP)
    geo = (cfg.n_layers, N_PAGES, PAGE, cfg.n_kv_heads, cfg.d_head, MAXP)
    jstate = JMDL.init_decode_state(jcfg, JaxPoolSpec(*geo, dtype="float32"),
                                    B)
    state = MDL.init_decode_state(cfg, PoolSpec(*geo, dtype="float32"), B,
                                  device="cpu")
    _, jstate = JMDL.prefill(jcfg, jparams, jstate, jnp.asarray(tokens),
                             jnp.asarray(bt), last_idx=jnp.asarray(lens - 1),
                             valid_len=jnp.asarray(lens))
    MDL.prefill(cfg, params, state, torch.from_numpy(tokens),
                torch.from_numpy(bt), last_idx=torch.from_numpy(lens - 1),
                valid_len=torch.from_numpy(lens))
    return jstate, state, bt


def _pools_close(state, jstate):
    for k in ("k", "v"):
        _close(state["pool"][k][:, :N_PAGES].numpy(), jstate["pool"][k])


@functools.lru_cache(maxsize=None)
def _round_inputs(draft):
    """A prefilled target and draft (the draft holds the same prompts) and
    the slot state of one round: row 0 runs the whole round, row 1 may
    propose one token, row 2 is idle."""
    m = _models()
    jdcfg, jdp, dcfg, dp = _draft(draft)
    lens = np.asarray([12, 7, 9], np.int32)
    jst, st, bt = _prefilled(m["cfg"], m["jcfg"], m["tp"], m["jp"], lens)
    jdst, dst, _ = _prefilled(dcfg, jdcfg, dp, jdp, lens)
    slot = dict(tokens=np.asarray([5, 77, 9], np.int32), ctx=lens + 1,
                rem=np.asarray([20, 20, 20], np.int32),
                allow=np.asarray([G + 1, 2, 0], np.int32))
    return dict(jst=jst, st=st, jdst=jdst, dst=dst, bt=bt, slot=slot)


def _clone(state):
    return {"pool": {k: v.clone() for k, v in state["pool"].items()}}


def _propose(draft, need_q=True):
    """repro's and the port's greedy proposal scans over the same draft
    pool: (jax proposals, jax qlogits, jax state, port ...)."""
    r = _round_inputs(draft)
    jdcfg, jdp, dcfg, dp = _draft(draft)
    s = r["slot"]
    kw = dict(horizon=G, table_width=MAXP, page_size=PAGE, n_pages=N_PAGES,
              need_q=need_q)
    jprop, jq, jdst, _ = JMDL.draft_propose(
        jdcfg, jdp, r["jdst"], jnp.asarray(s["tokens"]), jnp.asarray(r["bt"]),
        jnp.asarray(s["ctx"]), jnp.asarray(s["allow"]),
        jax.random.PRNGKey(0), sample=jax_scan_sampler("greedy"), **kw)
    tokens = torch.from_numpy(s["tokens"])
    ctx = torch.from_numpy(s["ctx"])
    prop, q, dst = MDL.draft_propose(
        dcfg, dp, _clone(r["dst"]), tokens, torch.from_numpy(r["bt"]), ctx,
        torch.from_numpy(s["allow"]), None,
        sample=make_scan_sampler("greedy"), **kw)
    # the target's slot state is read, never written
    assert torch.equal(tokens, torch.from_numpy(s["tokens"]))
    assert torch.equal(ctx, torch.from_numpy(s["ctx"]))
    return jprop, jq, jdst, prop, q, dst


@pytest.mark.parametrize("draft", ["real", "oracle"])
def test_draft_propose_matches_jax(draft):
    jprop, jq, jdst, prop, q, dst = _propose(draft)
    assert prop.dtype == torch.int32 and prop.shape == (B, G)
    # only the steps each row ran are proposals (the rest are masked
    # garbage both packages compute alike)
    np.testing.assert_array_equal(prop.numpy(), np.asarray(jprop))
    _close(q.numpy(), jq)
    _pools_close(dst, jdst)
    assert _propose(draft, need_q=False)[4] is None


def _verify(draft, *, eos=-1, rem=None):
    r = _round_inputs(draft)
    m = _models()
    s = r["slot"]
    jprop = np.array(_propose(draft, need_q=False)[0])
    rem = s["rem"] if rem is None else np.asarray(rem, np.int32)
    kw = dict(horizon=G, table_width=MAXP, page_size=PAGE, n_pages=N_PAGES,
              eos_token=eos)
    jout = JMDL.decode_verify(
        m["jcfg"], m["jp"], r["jst"], jnp.asarray(s["tokens"]),
        jnp.asarray(jprop), None, jnp.asarray(r["bt"]), jnp.asarray(s["ctx"]),
        jnp.asarray(rem), jnp.asarray(s["allow"]), jax.random.PRNGKey(0),
        verifier=jax_verifier("greedy"), **kw)
    tout = MDL.decode_verify(
        m["cfg"], m["tp"], _clone(r["st"]), torch.from_numpy(s["tokens"]),
        torch.from_numpy(jprop), None, torch.from_numpy(r["bt"]),
        torch.from_numpy(s["ctx"]), torch.from_numpy(rem),
        torch.from_numpy(s["allow"]), None, verifier=make_verifier("greedy"),
        **kw)
    return jout, tout


@pytest.mark.parametrize("draft", ["real", "oracle"])
@pytest.mark.parametrize("stop", ["none", "eos", "budget"])
def test_decode_verify_matches_jax(draft, stop):
    """Candidates, emissions, finish flags, the new tokens / ctx / rem and
    accept lengths identical to repro's, the pools within 1e-5: a plain
    round, then row 0 stopped at candidate j = min(1, its accept length)
    by an EOS or by its budget (inside the accepted run for the oracle)."""
    probe = _verify(draft)[0]
    acc0 = int(np.asarray(probe[-1])[0])
    j = min(1, acc0)
    eos, rem = -1, None
    if stop == "eos":
        eos = int(np.asarray(probe[0])[j, 0])
    elif stop == "budget":
        rem = [j + 1, 20, 20]
    (jcand, jemit, jfin, jst, jtok, jctx, jrem, _, jacc), tout = \
        _verify(draft, eos=eos, rem=rem)
    cand, emit, fin, st, tok, ctx, rem_t, acc = tout
    for got, want in ((cand, jcand), (emit, jemit), (fin, jfin), (tok, jtok),
                      (ctx, jctx), (rem_t, jrem), (acc, jacc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _pools_close(st, jst)
    if draft == "oracle":         # row 0 accepts all, row 1 its one
        assert acc.tolist() == [G, 1, 0]
    if stop != "none":
        assert fin.tolist() == [True, False, False]
        assert emit[:, 0].sum() == j + 1 and not emit[:, 2].any()
        assert ctx[0] == int(_round_inputs(draft)["slot"]["ctx"][0]) + j


# ---------------------------------------------------------------------------
# the engine: repro's tests/test_spec_decode.py matrix
# ---------------------------------------------------------------------------

def _prompts(nreq=6, shared=0, seed=3):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 256, size=shared).astype(np.int32) if shared \
        else None
    out = []
    for _ in range(nreq):
        p = rng.integers(0, 256, size=int(rng.integers(3, 20))).astype(
            np.int32)
        out.append(np.concatenate([pre, p]) if shared else p)
    return out


def _ecfg(mode, draft, *, spec_horizon=3, n_pages=96, cache=False, eos=-1,
          sampler="greedy", seed=0, gentle=False):
    return dict(n_slots=3, page_size=4, n_pages=n_pages, max_context=64,
                prefill_mode=mode, prefill_chunk=5, eos_token=eos,
                sampler=sampler, temperature=0.8,
                top_k=8 if sampler == "top_k" else 0, sample_seed=seed,
                prefix_cache=cache, reserve_gentle=gentle,
                decode_horizon=spec_horizon + 1 if draft is None else 1,
                spec_horizon=spec_horizon)


def _submit(eng, req, nreq, shared, budgets):
    for i, (p, b) in enumerate(zip(_prompts(nreq, shared),
                                   budgets or BUDGETS[:nreq])):
        eng.submit(req(i, p, b))


def _run(mode="batched", *, draft=None, nreq=6, shared=0, budgets=None,
         **kw):
    """The port's engine on the test trace; ``draft`` None (target only),
    "real" or "oracle"."""
    m = _models()
    dcfg = dp = None
    if draft is not None:
        _, _, dcfg, dp = _draft(draft)
    eng = DecodeEngine(m["cfg"], EngineConfig(**_ecfg(mode, draft, **kw),
                                              draft_config=dcfg),
                       m["tp"], device="cpu", draft_params=dp)
    _submit(eng, Request, nreq, shared, budgets)
    out = {k: list(v) for k, v in eng.run(500).items()}
    return out, eng


@functools.lru_cache(maxsize=None)
def _jax_run(mode="batched", *, draft=None, nreq=6, shared=0, budgets=None,
             **kw):
    """repro's engine on the same trace: (outputs, counters)."""
    m = _models()
    dcfg = dp = None
    if draft is not None:
        dcfg, dp, _, _ = _draft(draft)
    eng = JaxEngine(m["jcfg"], JaxEngineConfig(**_ecfg(mode, draft, **kw),
                                               draft_config=dcfg,
                                               use_pallas=False),
                    m["jp"], draft_params=dp)
    _submit(eng, JaxRequest, nreq, shared, budgets and list(budgets))
    out = {k: list(v) for k, v in eng.run(500).items()}
    return out, _counters(eng)


def _counters(eng) -> dict:
    c = {"device_syncs": eng.timing.device_syncs,
         "decode_tokens": eng.timing.decode_tokens}
    if getattr(eng, "draft_cfg", None) is not None:
        c.update(spec_rounds=eng.spec_rounds,
                 spec_proposed=eng.spec_proposed,
                 spec_accepted=eng.spec_accepted)
    return c


def _held_to_jax(mode="batched", **kw):
    """The port's run, with its tokens and counters equal to repro's."""
    out, eng = _run(mode, **kw)
    key = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    jout, jc = _jax_run(mode, **key)
    assert out == jout
    assert _counters(eng) == jc
    return out, eng


@pytest.mark.parametrize("mode", ["slot", "batched", "chunked"])
@pytest.mark.parametrize("draft", ["real", "oracle"])
def test_greedy_token_identity(mode, draft):
    base, _ = _run(mode)
    spec, eng = _held_to_jax(mode, draft=draft)
    assert spec == base, (mode, draft)
    assert eng.spec_rounds > 0
    if draft == "oracle":            # identical logits -> full acceptance
        assert eng.spec_accepted == eng.spec_proposed > 0
    assert eng.alloc.pages_in_use == 0
    assert eng.timing.draft_catchups > 0
    assert not eng._dlen             # every finished request dropped


def test_spec_sync_budget():
    """One host sync a round: the catch-up, the proposal scan and the
    verify share it, so an accepting draft needs no more syncs than the
    target alone at the same horizon."""
    _, base = _run("batched", spec_horizon=3)
    _, spec = _held_to_jax("batched", draft="oracle", spec_horizon=3)
    assert spec.timing.device_syncs <= base.timing.device_syncs
    assert spec.timing.decode_tokens == base.timing.decode_tokens


@pytest.mark.parametrize("draft", ["real", "oracle"])
def test_mid_round_eos(draft):
    probe, _ = _run("batched")
    eos = probe[1][2]                # forces an EOS mid-stream for req 1
    base, _ = _run("batched", eos=eos)
    spec, _ = _held_to_jax("batched", draft=draft, eos=eos)
    assert spec == base
    assert spec[1][-1] == eos and eos not in spec[1][:-1]


def test_budget_truncation_exact():
    """Budgets of 2 / 3 / 5 tokens cut 4-token rounds: every request emits
    its budget + 1 tokens (prefill's first token included)."""
    spec, eng = _held_to_jax("batched", draft="oracle")
    for rid, b in enumerate(BUDGETS):
        assert len(spec[rid]) == b + 1, rid
    assert eng.alloc.pages_in_use == 0


def test_preemption_resume():
    kw = dict(n_pages=12, nreq=3, budgets=[12, 12, 12])
    base, _ = _run("batched", **kw)
    spec, eng = _held_to_jax("batched", draft="oracle", **kw)
    assert spec == base
    assert eng.batcher.stats.preempted > 0
    assert eng.alloc.pages_in_use == 0
    # re-admission reset the draft's coverage: it caught up from scratch
    assert eng.spec_accepted == eng.spec_proposed > 0


def test_prefix_sharing():
    base, _ = _run("batched", cache=True, shared=38)
    spec, eng = _held_to_jax("batched", draft="oracle", cache=True,
                             shared=38)
    assert spec == base
    assert eng.cache.stats.hits > 0
    # shared radix pages get bit-identical draft KV from every borrower
    assert eng.spec_accepted == eng.spec_proposed > 0


def test_rejection_rollback():
    """A draft that (nearly) never matches rolls back every round: stale KV
    past the accepted prefix never reaches later logits, no page leaks."""
    kw = dict(n_pages=12, nreq=3, budgets=[12, 12, 12])
    base, _ = _run("batched", **kw)
    spec, eng = _held_to_jax("batched", draft="real", **kw)
    assert spec == base
    assert eng.spec_proposed > 0
    assert eng.spec_accepted < eng.spec_proposed
    assert eng.alloc.pages_in_use == 0


def test_accept_counters_deterministic():
    r1 = _run("batched", draft="oracle")[1]
    r2 = _run("batched", draft="oracle")[1]
    assert _counters(r1) == _counters(r2)
    assert r1.spec_accepted == r1.spec_proposed > 0
    assert 1 + r1.spec_accepted / r1.spec_rounds > 1.5
    assert r1.timing.decode_tokens <= r1.spec_rounds + r1.spec_accepted \
        + len(BUDGETS)


@pytest.mark.parametrize("sampler,mode", [("temperature", "batched"),
                                          ("top_k", "batched"),
                                          ("top_k", "chunked")])
def test_stochastic_deterministic_and_exact_on_match(sampler, mode):
    """Chunked prefill caps some rounds to no proposal (K = 1): a plain
    one-token verify."""
    s1, e1 = _run(mode, draft="oracle", sampler=sampler)
    s2, _ = _run(mode, draft="oracle", sampler=sampler)
    s3, _ = _run(mode, draft="oracle", sampler=sampler, seed=1)
    assert s1 == s2                  # seed-deterministic
    assert s1 != s3
    # p == q -> u * q <= p always: acceptance is total even when sampling
    assert e1.spec_accepted == e1.spec_proposed > 0
    assert all(len(s1[r]) == b + 1 for r, b in enumerate(BUDGETS))
    if mode == "chunked":
        assert e1.timing.spec_dispatches.get(1, 0) > 0


def test_stochastic_mismatched_draft_runs():
    """The residual path (acc < nprop): valid tokens, deterministic, every
    page released."""
    s1, e1 = _run("batched", draft="real", sampler="top_k")
    s2, _ = _run("batched", draft="real", sampler="top_k")
    assert s1 == s2
    assert e1.spec_rounds > 0 and e1.spec_accepted < e1.spec_proposed
    assert all(0 <= t < 256 for ts in s1.values() for t in ts)
    assert e1.alloc.pages_in_use == 0


@pytest.mark.parametrize("mode", ["batched", "chunked"])
def test_zamba2_top_k_without_draft(mode):
    """The hybrid with a top-k sampler (the K4 paths): seed-deterministic,
    every request complete and every page released."""
    cfg = replace(reduced(get_config("zamba2-1.2b")), dtype="float32")
    params = MDL.init_params(cfg, 0, torch.float32, "cpu")

    def run(seed):
        eng = DecodeEngine(cfg, EngineConfig(
            n_slots=3, page_size=4, n_pages=64, max_context=64,
            prefill_mode=mode, prefill_chunk=5, eos_token=-1,
            decode_horizon=4, sampler="top_k", top_k=8, temperature=0.8,
            sample_seed=seed), params, device="cpu")
        _submit(eng, Request, 4, 0, None)
        return {k: list(v) for k, v in eng.run(500).items()}, eng

    (o1, e1), (o2, _), (o3, _) = run(0), run(0), run(1)
    assert o1 == o2 and o1 != o3
    assert e1.batcher.stats.completed == 4
    assert e1.alloc.pages_in_use == 0
    assert [len(o1[r]) for r in range(4)] == [b + 1 for b in BUDGETS[:4]]


def test_vocab_mismatch_fails_at_construction(monkeypatch):
    """A draft with another tokenizer fails when the engine is built,
    before any params are allocated (the full-size target here would take
    GBs)."""
    target = get_config("llama3.2-1b")
    draft = replace(target, name="other-vocab", vocab_size=151936)
    with pytest.raises(ValueError, match="tokenizer mismatch"):
        validate_draft_pair(target, draft)

    def no_params(*a, **k):
        raise AssertionError("params were allocated")
    monkeypatch.setattr(MDL, "init_params", no_params)
    with pytest.raises(ValueError, match="tokenizer mismatch"):
        DecodeEngine(target, EngineConfig(
            n_slots=2, page_size=4, n_pages=16, max_context=32,
            draft_config=draft), device="cpu")


def test_recurrent_draft_rejected():
    cfg = reduced(get_config("llama3.2-1b"))
    hybrid = reduced(get_config("zamba2-1.2b"))
    with pytest.raises(ValueError, match="attention-only"):
        validate_draft_pair(cfg, hybrid)
    with pytest.raises(ValueError, match="attention-only"):
        validate_draft_pair(hybrid, cfg)
    with pytest.raises(ValueError, match="attention-only"):
        DecodeEngine(hybrid, EngineConfig(
            n_slots=2, page_size=4, n_pages=16, max_context=32,
            draft_config=cfg), device="cpu")


def test_draft_by_registry_name():
    m = _models()
    ecfg = EngineConfig(n_slots=2, page_size=4, n_pages=48, max_context=32,
                        eos_token=-1, draft_config="llama3.2-1b")
    with pytest.raises(ValueError, match="tokenizer mismatch"):
        # reduced target (vocab 256) against the full registry draft
        DecodeEngine(m["cfg"], ecfg, m["tp"], device="cpu")
    # the full-size pair resolves the name and passes validation
    validate_draft_pair(get_config("llama3.2-1b"),
                        replace(get_config("llama3.2-1b"), n_layers=1))


def _stacked(params) -> dict:
    """The port's params as repro's numpy tree (``layers/*`` stacked)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return node.numpy()

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([n.numpy() for n in nodes])
    out = {k: conv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = stack(params["layers"])
    return out


def test_oracle_pair_helper_accepts_everything():
    """``oracle_draft_pair`` (the serving bench's zeroed-layer pair) from
    the port's params: the port's engine accepts every proposal, its
    tokens equal the zeroed target alone and repro's engine over the same
    pair (taken back to repro's numpy tree)."""
    m = _models()
    tp, dcfg, dp = oracle_draft_pair(m["cfg"], m["tp"])
    assert dcfg.n_layers == 1 and len(dp["layers"]) == 1
    assert not torch.any(tp["layers"][1]["attn"]["wo"])
    assert not torch.any(tp["layers"][1]["mlp"]["w2"])
    assert torch.any(m["tp"]["layers"][1]["attn"]["wo"])      # not modified
    assert dp["layers"][0] is tp["layers"][0] is m["tp"]["layers"][0]
    assert dp["embed"] is tp["embed"] is m["tp"]["embed"]
    tnp, dnp = _stacked(tp), _stacked(dp)
    kw = _ecfg("batched", "oracle", spec_horizon=4)
    outs = {}
    for name, dc, dpp in (("spec", dcfg, dp), ("target", None, None)):
        eng = DecodeEngine(m["cfg"], EngineConfig(
            **{**kw, "decode_horizon": 5 if dc is None else 1},
            draft_config=dc), tp, device="cpu", draft_params=dpp)
        _submit(eng, Request, 6, 0, None)
        outs[name] = eng.run(500), eng
    assert outs["spec"][0] == outs["target"][0]
    eng = outs["spec"][1]
    assert eng.spec_accepted == eng.spec_proposed > 0
    jdcfg = jax_reduced(jax_get_config("llama3.2-1b"), layers=1)
    jeng = JaxEngine(m["jcfg"], JaxEngineConfig(
        **kw, draft_config=jdcfg, use_pallas=False),
        jax.tree.map(jnp.asarray, tnp),
        draft_params=jax.tree.map(jnp.asarray, dnp))
    _submit(jeng, JaxRequest, 6, 0, None)
    assert jeng.run(500) == outs["spec"][0]
    assert _counters(jeng) == _counters(eng)


def test_serve_cli_spec_on_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--requests", "5", "--slots", "2", "--page", "8",
                       "--pages", "48", "--max-context", "96", "--mean-new",
                       "6", "--draft", "llama3.2-1b", "--spec-horizon", "3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert done == 5 and "completed=5/5" in out
    assert "page balance per shard: max=0 min=0" in out
    assert "spec: draft=llama3.2-1b rounds=" in out


# ---------------------------------------------------------------------------
# the round as the graph runner dispatches it (CPU: eager, stand-in graphs)
# ---------------------------------------------------------------------------

def _stand_in_graphs(monkeypatch, runner):
    """The runner's CUDA side replaced by stand-ins: the warm-up runs the
    body, the capture runs it once and records its key, a replay runs that
    key's body eagerly; the graph takes generators as a CUDA graph does."""
    body = runner._body

    class Graph:
        key = None
        gens = ()

        def register_generator_state(self, gen):
            self.gens += (gen,)

        def replay(self):
            body(self.key)

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


def _spec_engine(draft="oracle", sampler="greedy", **kw):
    m = _models()
    _, _, dcfg, dp = _draft(draft)
    eng = DecodeEngine(m["cfg"], EngineConfig(
        **{**_ecfg("batched", draft, sampler=sampler), **kw},
        draft_config=dcfg), m["tp"], device="cpu", draft_params=dp)
    _submit(eng, Request, 6, 0, None)
    return eng


def _live(eng):
    E = eng.ecfg
    out = [eng.dev.tokens, eng.dev.ctx, eng.dev.rem]
    for st in (eng.state, eng._dstate):
        out += [st["pool"][k][:, :E.n_pages] for k in ("k", "v")]
    return [t.clone() for t in out]


@pytest.mark.parametrize("draft,sampler", [("oracle", "greedy"),
                                           ("real", "top_k")])
def test_spec_neutral_capture_leaves_the_live_state(draft, sampler,
                                                    monkeypatch):
    """A capture mid-run (warm-up and capture passes of the round, ``allow``
    zeroed) leaves both pools but their trash pages, and tokens / ctx /
    rem, as they were; the generators are registered and put back, so the
    run ends with the tokens of a run that never captured."""
    want = _spec_engine(draft, sampler).run(500)
    eng = _spec_engine(draft, sampler)
    for _ in range(3):
        eng.tick()
    eng._pending_fin = eng._collect_horizon()
    before = _live(eng)
    assert before[1].sum() > 0
    gens = [g.get_state() for g in eng.generators]
    assert len(gens) == (2 if sampler != "greedy" else 0)
    runner = eng.horizons
    _stand_in_graphs(monkeypatch, runner)
    for key in ((16, 4, True), (16, 1, True)):
        runner.capture(key)
        assert runner.captured[key].graph.gens == tuple(eng.generators)
        for a, b in zip(_live(eng), before):
            assert torch.equal(a, b)
        for g, st in zip(eng.generators, gens):
            assert torch.equal(g.get_state(), st)
    monkeypatch.setattr(runner, "graphs", False)
    assert eng.run(500) == want


@pytest.mark.parametrize("sampler", ["greedy", "temperature"])
def test_spec_runner_keeps_addresses_and_matches_eager(sampler,
                                                       monkeypatch):
    """The engine's capture-then-replay flow with stand-in graphs: no tensor
    a round reads or writes is rebound (the draft pool and the round's
    static buffers included), and tokens and counters equal an eager
    run's: the graph path draws what the eager path draws."""
    ref = _spec_engine("real", sampler)
    want = ref.run(500)
    eng = _spec_engine("real", sampler)
    _stand_in_graphs(monkeypatch, eng.horizons)

    def ptrs():
        d = {f"{n} {k}": st["pool"][k].data_ptr()
             for n, st in (("target", eng.state), ("draft", eng._dstate))
             for k in ("k", "v")}
        d.update({n: getattr(eng.dev, n).data_ptr()
                  for n in ("bt", "ctx", "tokens", "rem")})
        d["allow"] = eng.horizons.allow.data_ptr()
        for key, (prop, qlog) in eng.horizons.spec_bufs.items():
            d[f"prop {key}"] = prop.data_ptr()
            if qlog is not None:
                d[f"qlog {key}"] = qlog.data_ptr()
        d.update({f"out {k}": t.data_ptr()
                  for k, t in eng.horizons.outs.items()})
        return d

    seen = ptrs()
    while not (eng._inflight is None and eng.batcher.done()):
        eng.tick()
        now = ptrs()
        assert {k: now[k] for k in seen} == seen
        seen = now
    assert eng.outputs == want
    assert eng.timing.graph_captures == len(eng.horizons.captured) >= 1
    assert _counters(eng) == _counters(ref)
    for k in ("decode_steps", "draft_catchups", "spec_dispatches"):
        assert getattr(eng.timing, k) == getattr(ref.timing, k)
    assert all((qlog is not None) == (sampler != "greedy")
               for _, qlog in eng.horizons.spec_bufs.values())


# ---------------------------------------------------------------------------
# K1's row tiling: more query rows than a block holds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G_,qpos", [(4, 16), (4, 33), (1, 33), (4, 5)],
                         ids=["64 rows", "132 rows qpos 33",
                              "33 rows qpos 33", "20 rows"])
def test_row_tiles_match_one_plain_call(G_, qpos):
    """The blocking the kernel path launches, driven with the plain version
    at each tile's row offset as the launcher, gives the one-call (o, l, m)
    of the whole q: tiles that start mid-group keep their positions."""
    rng = np.random.default_rng(0)
    Bq, KVH, D, page, W = 3, 2, 32, 4, 12
    R = G_ * qpos
    q = torch.from_numpy(rng.standard_normal((Bq, KVH, R, D), np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((Bq * W + 1, page, KVH, D),
                                                   np.float32))
              for _ in range(2))
    bt = torch.from_numpy(rng.permutation(Bq * W)[:Bq * W].reshape(Bq, W)
                          .astype(np.int32))
    ctx = torch.tensor([3, 9, 1], dtype=torch.int32)
    win = torch.zeros(Bq, dtype=torch.int32)
    kw = dict(ring_width=0, windowed_slice=False, n_splits=2, qpos=qpos)
    want = PA.paged_attention_partials_plain(q, kp, vp, bt, ctx, win, **kw)
    tiles = PA.row_tiles(R)
    assert all(n <= PA.MAX_ROWS for _, n in tiles)
    assert sum(n for _, n in tiles) == R and tiles[0][0] == 0
    assert len(tiles) == -(-R // PA.MAX_ROWS)
    if qpos > PA.MAX_ROWS:
        assert any(r0 % qpos for r0, _ in tiles)     # a tile mid-group

    def launch(row0, n, o, l, m):
        po, pl, pm = PA.paged_attention_partials_plain(
            q[:, :, row0:row0 + n], kp, vp, bt, ctx, win, row0=row0, **kw)
        o[:, :, :, row0:row0 + n] = po
        l[..., row0:row0 + n] = pl
        m[..., row0:row0 + n] = pm

    o, l, m = (torch.full_like(t, float("nan")) for t in want)
    got = PA.partials_by_row_tiles(launch, R, o, l, m)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
