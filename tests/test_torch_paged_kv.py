"""repro_torch's paged KV pool and single-shard ITPP decode attention
against repro's.

Pools must be bit-equal after the same writes (the port's trailing trash
page, index ``n_pages``, takes what JAX's ``mode="drop"`` scatters drop, so
pools compare on ``[:n_pages]``). Decode attention — the gather path and
the kernel path (the paged kernel's plain version on the CPU) — must match
``repro``'s ``kernels=None`` path to 3e-5, the tolerance of repro's own
kernel-vs-dense test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import itpp as JITPP
from repro.core import paged_kv as JPKV
from repro.kernels import ops as JOPS
from repro.models.layers import decode_attention_ref as jax_decode_ref
from repro_torch.core import paged_kv as PKV
from repro_torch.core.itpp import itpp_decode_attention_shard
from repro_torch.kernels import ops as OPS
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models.layers import decode_attention_ref


def _with_trash(pool: np.ndarray) -> torch.Tensor:
    """[P, ...] numpy pool -> [P+1, ...] tensor with a zero trash page."""
    return torch.from_numpy(np.concatenate([pool, np.zeros_like(pool[:1])]))


@pytest.mark.parametrize("ctx_start,valid", [
    (0, None),                   # whole prompts
    (0, [5, 3, 0]),              # length-bucketed: pad positions dropped
    ([0, 6, 13], [7, 7, 2]),     # vector resume depths (chunked prefill)
    ([0, 6, 20], None),          # positions past the table width: dropped
])
def test_write_prefill_bit_equal(ctx_start, valid):
    rng = np.random.default_rng(0)
    P, page, KVH, D, B, S, W = 20, 4, 2, 8, 3, 7, 6
    pool_k = rng.standard_normal((P, page, KVH, D), np.float32)
    pool_v = rng.standard_normal((P, page, KVH, D), np.float32)
    k = rng.standard_normal((B, S, KVH, D), np.float32)
    v = rng.standard_normal((B, S, KVH, D), np.float32)
    bt = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    bt[1, 2:] = -1                                 # unallocated -> dropped
    vl = None if valid is None else np.asarray(valid, np.int32)
    jk, jv = JPKV.write_prefill(
        jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(bt), ctx_start=jnp.asarray(ctx_start),
        valid_len=None if vl is None else jnp.asarray(vl))
    tk, tv = PKV.write_prefill(
        _with_trash(pool_k), _with_trash(pool_v), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(bt),
        ctx_start=torch.as_tensor(ctx_start),
        valid_len=None if vl is None else torch.from_numpy(vl))
    np.testing.assert_array_equal(tk[:P].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:P].numpy(), np.asarray(jv))


def test_write_token_bit_equal():
    rng = np.random.default_rng(1)
    P, page, KVH, D, B = 6, 4, 2, 8, 4
    pool = rng.standard_normal((P, page, KVH, D), np.float32)
    kn = rng.standard_normal((B, KVH, D), np.float32)
    pids = np.asarray([3, P, 0, 5], np.int32)      # P: idle slot, dropped
    offs = np.asarray([1, 0, 3, 2], np.int32)
    jk, _ = JPKV.write_token(jnp.asarray(pool), jnp.asarray(pool),
                             jnp.asarray(kn), jnp.asarray(kn),
                             jnp.asarray(pids), jnp.asarray(offs))
    tk, _ = PKV.write_token(_with_trash(pool), _with_trash(pool),
                            torch.from_numpy(kn), torch.from_numpy(kn),
                            torch.from_numpy(pids), torch.from_numpy(offs))
    np.testing.assert_array_equal(tk[:P].numpy(), np.asarray(jk))


@pytest.mark.parametrize("window", [0, 5])
def test_gathered_partials_merge_to_decode_attention(window):
    """Partials over two halves of a request's pages, merged with the
    log-sum-exp (EPU) merge, equal dense decode attention — the port's
    ``decode_attention_ref`` and repro's on the contiguous cache."""
    rng = np.random.default_rng(4)
    B, mp, page, KVH, G, D = 3, 4, 4, 2, 3, 8
    q = rng.standard_normal((B, KVH * G, D), np.float32)
    k = rng.standard_normal((B, mp, page, KVH, D), np.float32)
    v = rng.standard_normal((B, mp, page, KVH, D), np.float32)
    ctx = np.asarray([16, 9, 1], np.int32)
    tok = np.arange(mp * page).reshape(mp, page)[None]
    valid = tok < ctx[:, None, None]
    if window:
        valid &= tok >= ctx[:, None, None] - window
    halves = [PKV.partial_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k[:, h]),
        torch.from_numpy(v[:, h]), torch.from_numpy(valid[:, h]))
        for h in (slice(0, 2), slice(2, 4))]
    merged = PKV.merge_partials(*(torch.stack(x) for x in zip(*halves)))
    kc = k.reshape(B, mp * page, KVH, D)
    vc = v.reshape(B, mp * page, KVH, D)
    want = jax_decode_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                          jnp.asarray(ctx), window=window)
    dense = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), torch.from_numpy(ctx),
                                 window=window)
    np.testing.assert_allclose(merged.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("ring_width", [0, 3])
def test_write_targets_bit_equal(ring_width):
    rng = np.random.default_rng(2)
    B, W, page, n_pages = 5, 4, 4, 20
    bt = rng.integers(-1, n_pages, (B, W)).astype(np.int32)
    ctx = np.asarray([0, 1, 4, 9, 17], np.int32)
    run = np.asarray([False, True, True, True, True])
    jn, jo = JOPS.write_targets(jnp.asarray(bt), jnp.asarray(ctx),
                                jnp.asarray(run), page_size=page,
                                n_pages=n_pages, ring_width=ring_width)
    tn, to = OPS.write_targets(torch.from_numpy(bt), torch.from_numpy(ctx),
                               torch.from_numpy(run), page_size=page,
                               n_pages=n_pages, ring_width=ring_width)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert tn.dtype == to.dtype == torch.int32


def _decode_case(*, G, ring, window, partial_ctx, seed=0):
    """A paged decode step (the matrix of repro's tests/test_kernels.py
    ``_decode_case``): pool, tables with -1 pads and one dead batch row,
    ctx spanning partial pages, and the incoming token's K/V + target."""
    page, maxp, KVH, D, B = 4, 5, 2, 8, 3
    H = KVH * G
    P = B * maxp + 2
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    case = dict(pool_k=f(P, page, KVH, D), pool_v=f(P, page, KVH, D),
                q=f(B, H, D), k_new=f(B, KVH, D), v_new=f(B, KVH, D))
    ring_width = maxp if ring else 0
    if ring:
        ctx = np.asarray([maxp * page + 3, maxp * page + 1, 0], np.int32)
    elif partial_ctx:
        ctx = np.asarray([7, maxp * page, 0], np.int32)
    else:
        ctx = np.asarray([page, 2 * page, 0], np.int32)
    perm = rng.permutation(P)
    bt = np.full((B, maxp), -1, np.int32)
    npage = np.full((B,), P, np.int32)                    # dead rows drop
    noff = np.zeros((B,), np.int32)
    pos = 0
    for b in range(B):
        if ctx[b] == 0:
            continue
        n_alloc = min(-(-int(ctx[b]) // page), maxp)
        bt[b, :n_alloc] = perm[pos:pos + n_alloc]
        pos += n_alloc
        t = int(ctx[b]) - 1
        vp = (t // page) % ring_width if ring else t // page
        npage[b] = bt[b, vp]
        noff[b] = t % page
    case.update(bt=bt, ctx=ctx, npage=npage, noff=noff, window=window,
                ring_width=ring_width, page=page, maxp=maxp, P=P)
    return case


def _run_jax(case):
    spec = JITPP.ItppSpec((), (), None, 1, 1, case["page"])
    a = {k: jnp.asarray(case[k]) for k in ("q", "k_new", "v_new", "pool_k",
                                           "pool_v", "bt", "ctx", "npage",
                                           "noff")}
    out, pk, pv = JITPP.itpp_decode_attention_shard(
        a["q"], a["k_new"], a["v_new"], a["pool_k"], a["pool_v"], a["bt"],
        a["ctx"], a["npage"], a["noff"], case["window"], spec=spec,
        mesh_axis_sizes={}, max_pages_per_req=case["maxp"],
        ring_width=case["ring_width"], kernels=None)
    return np.asarray(out), np.asarray(pk), np.asarray(pv)


def _run_torch(case, kernels):
    t = {k: torch.from_numpy(case[k]) for k in ("q", "k_new", "v_new", "bt",
                                                "ctx", "npage", "noff")}
    out, pk, pv = itpp_decode_attention_shard(
        t["q"], t["k_new"], t["v_new"], _with_trash(case["pool_k"]),
        _with_trash(case["pool_v"]), t["bt"], t["ctx"], t["npage"],
        t["noff"], case["window"], max_pages_per_req=case["maxp"],
        ring_width=case["ring_width"], kernels=kernels)
    P = case["P"]
    return out.numpy(), pk[:P].numpy(), pv[:P].numpy()


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("ring,window,partial_ctx", [
    (False, 0, False),            # plain, page-aligned ctx
    (False, 0, True),             # ctx mid-page + exactly-full table
    (False, 6, True),             # sliding-window mask
    (True, 9, False),             # ring pool (slots recycle mod width)
    (True, 0, False),             # ring, unwindowed mask
])
@pytest.mark.parametrize("kernels", [None, KernelConfig(n_splits=1),
                                     KernelConfig(n_splits=3)],
                         ids=["gather", "kernel1", "kernel3"])
def test_itpp_decode_matches_jax(G, ring, window, partial_ctx, kernels):
    case = _decode_case(G=G, ring=ring, window=window,
                        partial_ctx=partial_ctx)
    want, jpk, jpv = _run_jax(case)
    got, pk, pv = _run_torch(case, kernels)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)
    np.testing.assert_array_equal(pk, jpk)
    np.testing.assert_array_equal(pv, jpv)
