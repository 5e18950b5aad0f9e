"""repro_torch's attention model against repro.models.model on the CPU.

Same converted weights (``params_from_numpy``), same tokens, block tables
and write targets: logits within 1e-4 and pools within 1e-5 after
``prefill``, ``prefill_chunk``, ``decode_step`` and ``decode_multi`` (the
K/V values come out of fp32 matrix products that XLA and PyTorch sum in
different orders, so "equal" pools agree to fp32 rounding, not bit for
bit). The port runs with the kernels enabled, i.e. through their plain
versions here.
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
from repro.models import model as JMDL
from repro.serving.sampling import make_scan_sampler as jax_scan_sampler
from repro_torch.configs import get_config, reduced
from repro_torch.core.paged_kv import PoolSpec
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.sampling import make_scan_sampler

B, S, PAGE, N_PAGES, MAXP = 2, 12, 4, 16, 6
RT = MDL.Runtime(kernels=KernelConfig(n_splits=2))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _pools_close(state, jstate):
    for k in ("k", "v"):
        _close(state["pool"][k][:, :N_PAGES].numpy(), jstate["pool"][k],
               1e-5)


@pytest.fixture(scope="module")
def prefilled():
    """Both models with the same weights after a length-bucketed prefill of
    two prompts (12 and 7 valid tokens)."""
    jcfg = replace(jax_reduced(jax_get_config("llama3.2-1b")), dtype="float32")
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    bt = rng.permutation(N_PAGES)[:B * MAXP].reshape(B, MAXP).astype(np.int32)
    lens = np.asarray([S, 7], np.int32)
    geo = (cfg.n_layers, N_PAGES, PAGE, cfg.n_kv_heads, cfg.d_head, MAXP)
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
                lens=lens, jstate=jstate, state=state, jlogits=jl,
                logits=tl)


def test_prefill_matches_jax(prefilled):
    p = prefilled
    _close(p["logits"], p["jlogits"], 1e-4)
    _pools_close(p["state"], p["jstate"])


def _clone(state):
    return {"pool": {k: v.clone() for k, v in state["pool"].items()}}


def test_prefill_chunk_matches_jax(prefilled):
    """A 4-token chunk resuming each row at its own depth (vector
    ctx_start), the second row padded (valid_len 2)."""
    p = prefilled
    rng = np.random.default_rng(1)
    toks = rng.integers(0, p["cfg"].vocab_size, (B, 4)).astype(np.int32)
    start = p["lens"]
    valid = np.asarray([4, 2], np.int32)
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
    _pools_close(state, jstate)


def test_decode_step_matches_jax(prefilled):
    p = prefilled
    from repro.kernels.ops import write_targets
    tokens = np.asarray([5, 77], np.int32)
    ctx = p["lens"] + 1
    run = np.asarray([True, True])
    npage, noff = write_targets(jnp.asarray(p["bt"]), jnp.asarray(ctx),
                                jnp.asarray(run), page_size=PAGE,
                                n_pages=N_PAGES)
    jl, jstate = JMDL.decode_step(p["jcfg"], p["jparams"], p["jstate"],
                                  jnp.asarray(tokens), jnp.asarray(p["bt"]),
                                  jnp.asarray(ctx), npage, noff)
    tl, state = MDL.decode_step(
        p["cfg"], p["params"], _clone(p["state"]), torch.from_numpy(tokens),
        torch.from_numpy(p["bt"]), torch.from_numpy(ctx),
        torch.from_numpy(np.array(npage)),
        torch.from_numpy(np.array(noff)), rt=RT)
    _close(tl, jl, 1e-4)
    _pools_close(state, jstate)


@pytest.mark.parametrize("rt", [RT, MDL.Runtime()], ids=["kernel", "plain"])
def test_decode_multi_matches_jax(prefilled, rt):
    """Three fused greedy steps; row 1 may run only two (allow), row 0 has
    a budget of two tokens and freezes."""
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
    _pools_close(state, jstate)
