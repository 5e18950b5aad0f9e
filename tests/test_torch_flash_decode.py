"""repro_torch's ITPP split-K flash decode (K3) and the bench's ops against
repro's.

On the CPU the ``flash_decode`` wrapper runs its plain version, so these
tests hold the kernel's function — split boundaries, the short tail split,
the ctx clamp, the dead-split sentinel, the partial layout — to the Pallas
TPU kernel run in interpret mode and to ``repro.kernels.ref``. Inputs are
made with numpy from a seed and fed to both packages; bf16 cases round the
values to bf16 first and feed the same rounded values to both sides, which
both upcast to fp32.

Tolerances: partials 1e-4 (``tests/test_kernels.py``'s 5 x 2e-5 for the
Pallas kernel), the merged output 2e-5 against JAX's
``layers.decode_attention_ref``, 1e-5 for the tail split (as the JAX test);
the sentinel of a dead split is exact. The ops comparisons are 1e-5
(fp32 products summed in another order) and the pools bit-equal.

The CUDA kernel is held to the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.backend import KernelConfig as JKernelConfig
from repro.kernels.flash_decode import flash_decode as pallas_flash_decode
from repro.models.layers import decode_attention_ref as jax_decode_ref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.kernels.backend import KernelConfig
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.paged_attention import paged_attention

PART_TOL = 1e-4
MERGED_TOL = 2e-5


def _case(seed, B, KVH, G, D, T, ctx=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH, G, D), np.float32)
    k = rng.standard_normal((B, T, KVH, D), np.float32)
    v = rng.standard_normal((B, T, KVH, D), np.float32)
    if ctx is None:
        ctx = rng.integers(1, T + 1, B)
    return q, k, v, np.asarray(ctx, np.int32)


def _both(a, dtype):
    """The same values for both packages: a torch tensor of ``dtype`` and
    a jax array of the matching type (bf16-rounded for bf16)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if dtype == torch.bfloat16:
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return t, jnp.asarray(a)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KVH,G,D,T,S", [
    (2, 2, 3, 16, 32, 4),
    (1, 1, 8, 32, 64, 8),
    (4, 2, 1, 8, 16, 2),
])
def test_plain_matches_pallas_kernel_and_ref(dtype, B, KVH, G, D, T, S):
    q, k, v, ctx = _case(T, B, KVH, G, D, T)
    (tq, jq), (tk, jk), (tv, jv) = (_both(a, dtype) for a in (q, k, v))
    tc, jc = torch.from_numpy(ctx), jnp.asarray(ctx)
    got = flash_decode(tq, tk, tv, tc, n_splits=S)
    pallas = pallas_flash_decode(jq, jk, jv, jc, n_splits=S, interpret=True)
    jf = [x.astype(jnp.float32) for x in (jq, jk, jv)]
    oracle = JREF.flash_decode_ref(*jf, jc, S)
    ported = REF.flash_decode_ref(tq, tk, tv, tc, S)
    for g, p, o, r in zip(got, pallas, oracle, ported):
        assert g.dtype == torch.float32
        _close(g, p, PART_TOL)
        _close(g, o, PART_TOL)
        _close(r, o, PART_TOL)
    merged = REF.merge_flash_partials(*got).reshape(B, KVH * G, D)
    dense = jax_decode_ref(jf[0].reshape(B, KVH * G, D), jf[1], jf[2], jc)
    _close(merged, dense, MERGED_TOL)


def test_tail_split_matches_pallas_kernel():
    """T = 21 over 4 splits of 6: the tail split holds 3 real tokens (JAX
    zero-pads it); the in-kernel ctx mask keeps the pad dead."""
    B, KVH, G, D, T, S = 2, 2, 2, 8, 21, 4
    q, k, v, ctx = _case(0, B, KVH, G, D, T, ctx=[T, 5])
    t = [torch.from_numpy(a) for a in (q, k, v, ctx)]
    j = [jnp.asarray(a) for a in (q, k, v, ctx)]
    got = flash_decode(*t, n_splits=S)
    want = pallas_flash_decode(*j, n_splits=S, interpret=True)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    merged = REF.merge_flash_partials(*got).reshape(B, KVH * G, D)
    dense = jax_decode_ref(j[0].reshape(B, KVH * G, D), *j[1:])
    _close(merged, dense, 1e-5)


def test_dead_splits_and_ctx0_row_hold_the_sentinel():
    """A split with no live token emits exactly m = -1e30, l = 0, o = 0, as
    the Pallas body does; a ctx = 0 row merges to 0 (not NaN) and a ctx
    past T is clamped to T."""
    B, KVH, G, D, T, S = 3, 2, 4, 16, 40, 4
    q, k, v, ctx = _case(2, B, KVH, G, D, T, ctx=[0, 12, 99])
    t = [torch.from_numpy(a) for a in (q, k, v, ctx)]
    o, l, m = flash_decode(*t, n_splits=S)
    po, pl, pm = pallas_flash_decode(*(jnp.asarray(a) for a in
                                       (q, k, v, ctx)), n_splits=S,
                                     interpret=True)
    dead = np.asarray([[s * 10 >= min(c, T) for c in ctx] for s in range(S)])
    assert dead.sum() == 4 + 2               # every split of row 0, 2 of row 1
    assert torch.all(m[dead] == -1e30) and torch.all(l[dead] == 0)
    assert torch.all(o[dead] == 0)
    assert np.all(np.asarray(pm)[dead] == -1e30)
    for g, p in ((o, po), (l, pl), (m, pm)):
        _close(g, p, PART_TOL)
    merged = REF.merge_flash_partials(o, l, m)
    assert torch.isfinite(merged).all() and torch.all(merged[0] == 0)
    full = flash_decode(*t[:3], torch.tensor([0, 12, T], dtype=torch.int32),
                        n_splits=S)
    for a, b in zip((o, l, m), full):
        assert torch.equal(a, b)


def test_merged_output_is_split_invariant():
    B, KVH, G, D, T = 3, 2, 3, 16, 37
    q, k, v, ctx = _case(4, B, KVH, G, D, T, ctx=[37, 1, 20])
    t = [torch.from_numpy(a) for a in (q, k, v, ctx)]
    dense = jax_decode_ref(jnp.asarray(q.reshape(B, KVH * G, D)),
                           jnp.asarray(k), jnp.asarray(v), jnp.asarray(ctx))
    merged = {}
    for S in (1, 2, 4, 8):
        o, l, m = flash_decode(*t, n_splits=S)
        assert o.shape == (S, B, KVH, G, D) and l.shape == (S, B, KVH, G)
        merged[S] = REF.merge_flash_partials(o, l, m)
        _close(merged[S].reshape(B, KVH * G, D), dense, MERGED_TOL)
    for S in (2, 4, 8):
        torch.testing.assert_close(merged[S], merged[1], atol=1e-5,
                                   rtol=1e-5)


def test_plain_paged_kernel_at_page256_d128_matches_ref():
    """K1's plain version at 256-token pages and D 128, the shape of the
    kernel bench's paged row (the CUDA kernel streams such pages in
    64-token sub-tiles)."""
    B, KVH, G, D, page, maxp = 4, 2, 4, 128, 256, 8
    rng = np.random.default_rng(6)
    P = B * maxp
    q = rng.standard_normal((B, KVH, G, D), np.float32)
    kp = rng.standard_normal((P, page, KVH, D), np.float32)
    vp = rng.standard_normal((P, page, KVH, D), np.float32)
    bt = rng.permutation(P).reshape(B, maxp).astype(np.int32)
    ctx = np.asarray([2048, 700, 1200, 300], np.int32)
    want = JREF.paged_attention_ref(*(jnp.asarray(a) for a in
                                      (q, kp, vp, bt, ctx)))
    for S in (1, 3):
        got = paged_attention(*(torch.from_numpy(a) for a in
                                (q, kp, vp, bt, ctx)), n_splits=S)
        _close(got, want, 1e-5)


def test_ops_itpp_partials_and_merge_match_jax():
    B, KVH, G, D, T, S = 2, 2, 2, 32, 500, 8      # the bench's smoke row
    q, k, v, ctx = _case(8, B, KVH, G, D, T, ctx=[500, 100])
    t = [torch.from_numpy(a) for a in (q, k, v, ctx)]
    j = [jnp.asarray(a) for a in (q, k, v, ctx)]
    want = JOPS.itpp_partials(*j, n_splits=S, use_pallas=False)
    for kc in (KernelConfig(), KernelConfig(use_kernels=False)):
        got = ops.itpp_partials(*t, n_splits=S, kernels=kc)
        for g, w in zip(got, want):
            _close(g, w, 1e-5)
    _close(ops.merge_partials(*got), JOPS.merge_partials(*want), 1e-5)
    for g, p in zip(got, flash_decode_plain(*t, n_splits=S)):
        torch.testing.assert_close(g, p, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("H,KVH", [(4, 4), (8, 2)])
def test_cross_attention_decode_matches_jax(H, KVH):
    """The enc-dec cross-attention decode route at T 1500, every position
    valid: with kernels on, the flash-decode partials at ``CROSS_SPLITS``
    (splits of 188, the tail split of 184 padded) and their merge; without,
    ``decode_attention_ref``. Both against JAX's ``decode_attention_ref``,
    the call repro's decode block makes."""
    rng = np.random.default_rng(4)
    B, T, D = 2, 1500, 16
    q = rng.standard_normal((B, H, D), np.float32)
    k = rng.standard_normal((B, T, KVH, D), np.float32)
    v = rng.standard_normal((B, T, KVH, D), np.float32)
    assert ops.CROSS_SPLITS == 8 and T % -(-T // ops.CROSS_SPLITS)
    want = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.full((B,), T, jnp.int32))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    t.append(torch.full((B,), T, dtype=torch.int32))
    for kc in (KernelConfig(), KernelConfig(use_kernels=False), None):
        _close(ops.cross_attention_decode(*t, kernels=kc), want,
               MERGED_TOL)


def test_ops_decode_attention_matches_jax():
    B, KVH, G, D, page, maxp = 2, 2, 2, 32, 16, 4  # the bench's smoke row
    rng = np.random.default_rng(1)
    P = B * maxp
    q = rng.standard_normal((B, KVH, G, D), np.float32)
    kp = rng.standard_normal((P, page, KVH, D), np.float32)
    vp = rng.standard_normal((P, page, KVH, D), np.float32)
    bt = rng.permutation(P).reshape(B, maxp).astype(np.int32)
    ctx = np.asarray([64, 37], np.int32)
    want = JOPS.decode_attention(*(jnp.asarray(a) for a in
                                   (q, kp, vp, bt, ctx)), use_pallas=False)
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, ctx)]
    for kc in (KernelConfig(), KernelConfig(n_splits=3),
               KernelConfig(use_kernels=False)):
        _close(ops.decode_attention(*t, kernels=kc), want, 1e-5)


@pytest.mark.parametrize("ctx_t", [48, 240])
@pytest.mark.parametrize("hot", [False, True])
def test_ops_paged_decode_step_matches_jax(ctx_t, hot):
    """The bench's smoke decode-step case: ``dense_full`` (plain gather
    over the full table) and ``hot_path`` (the paged kernel wrapper over
    the bucketed table) against JAX's ``ops.paged_decode_step`` on the
    plain path; the pools after the token write are bit-equal."""
    from repro_torch.serving.prefill import decode_table_bucket
    page, W, B, KVH, G, D = 16, 32, 2, 1, 2, 16
    rng = np.random.default_rng(ctx_t)
    live = min(-(-ctx_t // page) + 1, W)
    P = B * live + 2
    pk = rng.standard_normal((P, page, KVH, D), np.float32)
    pv = rng.standard_normal((P, page, KVH, D), np.float32)
    q = rng.standard_normal((B, KVH * G, D), np.float32)
    kn = rng.standard_normal((B, KVH, D), np.float32)
    vn = rng.standard_normal((B, KVH, D), np.float32)
    bt = np.full((B, W), -1, np.int32)
    perm = rng.permutation(P - 2)
    for b in range(B):
        bt[b, :live] = perm[b * live:(b + 1) * live]
    ctx = np.asarray([ctx_t, ctx_t - page // 2], np.int32)
    npage = np.asarray([bt[b, (ctx[b] - 1) // page] for b in range(B)],
                       np.int32)
    noff = ((ctx - 1) % page).astype(np.int32)
    jout, jk, jv = JOPS.paged_decode_step(
        *(jnp.asarray(a) for a in (q, kn, vn, pk, pv, bt, ctx, npage, noff)),
        kernels=JKernelConfig(False, True))
    wb = decode_table_bucket(live, W) if hot else W
    t = [torch.from_numpy(a.copy()) for a in (q, kn, vn, pk, pv)]
    out, tk, tv = ops.paged_decode_step(
        *t, torch.from_numpy(bt[:, :wb].copy()), torch.from_numpy(ctx),
        torch.from_numpy(npage), torch.from_numpy(noff),
        kernels=KernelConfig(use_kernels=None if hot else False))
    _close(out, jout, 1e-5)
    n_pages = P - 1                       # the port's trash page is last
    assert np.array_equal(tk[:n_pages].numpy(), np.asarray(jk)[:n_pages])
    assert np.array_equal(tv[:n_pages].numpy(), np.asarray(jv)[:n_pages])
