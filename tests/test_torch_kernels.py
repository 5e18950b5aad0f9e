"""repro_torch's attention kernels against repro's oracles.

On the CPU each kernel wrapper runs its plain PyTorch version, so these
tests hold the kernels' function — split boundaries, dead-page rules,
partial layout, masks — to ``repro.kernels.ref`` and to the JAX flash
attention (the Pallas kernel in interpret mode and ``layers``' jnp
version). Inputs are made with numpy from a seed and fed to both.
Tolerances: fp32 1e-5 (2e-5 where the JAX side is itself a kernel), bf16
2e-2 — the bf16 side rounds its inputs, the oracle does not.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro.kernels.flash_attention import flash_attention_fwd as pallas_flash
from repro.models.layers import flash_attention as jax_flash
from repro_torch.kernels import ref as REF
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_partials,
                                                 paged_attention_verify)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _pool_case(seed, B, KVH, G, D, page, maxp, *, T=None, ctx_hi=None):
    rng = np.random.default_rng(seed)
    P = B * maxp + 2
    qshape = (B, KVH, G, D) if T is None else (B, KVH, G, T, D)
    q = rng.standard_normal(qshape, np.float32)
    kp = rng.standard_normal((P, page, KVH, D), np.float32)
    vp = rng.standard_normal((P, page, KVH, D), np.float32)
    bt = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    hi = maxp * page + 1 if ctx_hi is None else ctx_hi
    ctx = rng.integers(1, hi, B).astype(np.int32)
    return q, kp, vp, bt, ctx


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KVH,G,D,page,maxp", [
    (2, 1, 1, 8, 4, 3),
    (3, 2, 4, 16, 8, 4),
    (1, 4, 2, 32, 16, 2),
])
def test_paged_attention_matches_ref(dtype, B, KVH, G, D, page, maxp):
    q, kp, vp, bt, ctx = _pool_case(B + D, B, KVH, G, D, page, maxp)
    out = paged_attention(_t(q, dtype), _t(kp, dtype), _t(vp, dtype), _t(bt),
                          _t(ctx))
    want = JREF.paged_attention_ref(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(bt),
                                    jnp.asarray(ctx))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want),
                               atol=TOL[dtype], rtol=TOL[dtype])
    oracle = REF.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(ctx))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_splits", [1, 3])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("B,KVH,G,T,D,page,maxp", [
    (2, 1, 1, 3, 8, 4, 4),
    (3, 2, 2, 5, 16, 4, 5),
])
def test_paged_attention_verify_matches_ref(dtype, n_splits, window, B, KVH,
                                            G, T, D, page, maxp):
    """qpos > 1: T query rows per slot at positions ctx-1..ctx+T-2."""
    q, kp, vp, bt, ctx = _pool_case(3, B, KVH, G, D, page, maxp, T=T,
                                    ctx_hi=maxp * page - T + 2)
    w = None if window is None else np.full((B,), window, np.int32)
    out = paged_attention_verify(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype), _t(bt), _t(ctx),
        window=None if w is None else _t(w), n_splits=n_splits)
    want = JREF.paged_attention_verify_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ctx), window=None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want),
                               atol=TOL[dtype], rtol=TOL[dtype])
    oracle = REF.paged_attention_verify_ref(
        _t(q), _t(kp), _t(vp), _t(bt), _t(ctx),
        window=None if w is None else _t(w))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_partials_are_split_invariant_and_combine_like_jax():
    """Partials land split-major [S, B, KVH, G, ...]; the merged attention
    is the same for every n_splits (tail split padded with dead slots), and
    the port's combine equals repro's on the same partials."""
    B, KVH, G, D, page, maxp = 2, 2, 3, 16, 4, 6
    q, kp, vp, bt, _ = _pool_case(0, B, KVH, G, D, page, maxp)
    ctx = np.asarray([maxp * page, 7], np.int32)
    merged = {}
    for s in (1, 2, 4, 6):
        o, l, m = paged_attention_partials(_t(q), _t(kp), _t(vp), _t(bt),
                                           _t(ctx), n_splits=s)
        assert o.shape == (s, B, KVH, G, D)
        assert l.shape == m.shape == (s, B, KVH, G)
        merged[s] = REF.merge_flash_partials(o, l, m).numpy()
        want = JREF.merge_flash_partials(jnp.asarray(o.numpy()),
                                         jnp.asarray(l.numpy()),
                                         jnp.asarray(m.numpy()))
        np.testing.assert_allclose(merged[s], np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    for s in (2, 4, 6):
        np.testing.assert_allclose(merged[s], merged[1], atol=1e-5,
                                   rtol=1e-5)


def test_all_dead_row_merges_to_zero():
    """An idle slot (ctx 0, all -1 table) has every split dead: finite
    sentinel partials (m=-1e30, l=0, o=0) that merge to 0, never NaN."""
    B, KVH, G, D, page, maxp = 2, 2, 4, 16, 4, 5
    q, kp, vp, bt, _ = _pool_case(1, B, KVH, G, D, page, maxp)
    bt[1] = -1
    ctx = np.asarray([9, 0], np.int32)
    o, l, m = paged_attention_partials(_t(q), _t(kp), _t(vp), _t(bt),
                                       _t(ctx), n_splits=3)
    assert torch.all(m[:, 1] == -1e30) and torch.all(l[:, 1] == 0)
    assert torch.all(o[:, 1] == 0)
    out = paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(ctx), n_splits=3)
    assert torch.isfinite(out).all() and torch.all(out[1] == 0)


def test_windowed_slice_equals_full_table_window():
    """The cond_window slot map: passing only the table slots overlapping
    the window (slot j -> virtual page max(ctx-w,0)//page + j) gives the
    same attention as the full table under the same window."""
    B, KVH, G, D, page, maxp, w = 3, 2, 2, 16, 4, 8, 6
    q, kp, vp, bt, ctx = _pool_case(2, B, KVH, G, D, page, maxp)
    lo = np.maximum(ctx - w, 0) // page
    width = w // page + 2
    sel = lo[:, None] + np.arange(width)[None]
    btw = np.where(sel < maxp, np.take_along_axis(
        bt, np.clip(sel, 0, maxp - 1), axis=1), -1).astype(np.int32)
    wins = _t(np.full((B,), w, np.int32))
    full = REF.merge_flash_partials(*paged_attention_partials(
        _t(q), _t(kp), _t(vp), _t(bt), _t(ctx), window=wins))
    sliced = REF.merge_flash_partials(*paged_attention_partials(
        _t(q), _t(kp), _t(vp), _t(btw), _t(ctx), window=wins,
        windowed_slice=True, n_splits=2))
    np.testing.assert_allclose(sliced.numpy(), full.numpy(), atol=1e-6,
                               rtol=1e-6)


def _flash_case(seed, B, Sq, Skv, H, KVH, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Skv, KVH, D), np.float32),
            rng.standard_normal((B, Skv, KVH, D), np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_flash_matches_pallas_kernel(dtype, causal, window):
    """Against the Pallas TPU kernel run in interpret mode."""
    B, S, H, KVH, D = 2, 64, 4, 2, 16
    q, k, v = _flash_case(7, B, S, S, H, KVH, D)
    out = flash_attention_fwd(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              causal=causal, window=window)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window, q_blk=16, kv_blk=16,
                        interpret=True)
    tol = 2e-5 if dtype == torch.float32 else TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,offsets,window", [
    (24, 56, [0, 32], 0),        # [B] q_offset (chunked prefill)
    (24, 56, [10, 32], 8),       # q_offset + sliding window
    (37, 37, [0, 0], 0),         # ragged Sq (no tile divides it)
])
def test_flash_matches_layers_q_offset(dtype, Sq, Skv, offsets, window):
    """Against repro's jnp flash attention with a per-row q_offset."""
    B, H, KVH, D = 2, 6, 2, 16
    q, k, v = _flash_case(11, B, Sq, Skv, H, KVH, D)
    off = np.asarray(offsets, np.int32)
    out = flash_attention_fwd(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              causal=True, window=window, q_offset=_t(off))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=window, q_offset=jnp.asarray(off),
                     kv_chunk=16)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want),
                               atol=TOL[dtype], rtol=TOL[dtype])
