"""The ``cond_window`` branches of the port's ITPP shard against repro's.

Mixed local:global stacks (gemma3) bound a windowed layer's work to the
table slots overlapping its window: the kernel path passes K1 only
``cond_window // page + 2`` slots (``windowed_slice``), the plain path
compacts to ``ceil(win_pages / stripe) + 1`` slots. The case is
``tests/test_kernels.py::_decode_case`` (G 2, a mid-page and an
exactly-full table, a dead row) made with numpy: the port's plain and
kernel branches at windows 0 (the full branch) and 6 (the windowed one)
equal repro's ``kernels=None`` shard at ``cond_window=8`` within 3e-5, and
the pools exactly. The per-layer window case of
``tests/test_kernels.py:287-315`` (windows 0 and 6, one after the other,
through the kernel path) is held to ``kernels/ref.py``; and the windowed
branch on a 2 x 4 mesh (striped request, merged over both axes) equals
the unsharded shard.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.itpp import ItppSpec as JItppSpec
from repro.core.itpp import itpp_decode_attention_shard as jax_shard
from repro_torch.core import itpp as IT
from repro_torch.core.allocator import PageAllocator
from repro_torch.distributed import mesh as M
from repro_torch.kernels import ref as REF
from repro_torch.kernels.backend import KernelConfig

KERNELS = {"plain": None, "kernels": KernelConfig()}
PAGE, MAXP, KVH, D, B, G = 4, 5, 2, 8, 3, 2


def _case(seed=0):
    rng = np.random.default_rng(seed)
    P = B * MAXP + 2
    f = np.float32
    case = dict(pool_k=rng.standard_normal((P, PAGE, KVH, D)).astype(f),
                pool_v=rng.standard_normal((P, PAGE, KVH, D)).astype(f),
                q=rng.standard_normal((B, KVH * G, D)).astype(f),
                k_new=rng.standard_normal((B, KVH, D)).astype(f),
                v_new=rng.standard_normal((B, KVH, D)).astype(f))
    ctx = np.asarray([7, MAXP * PAGE, 0], np.int32)  # mid-page, full, dead
    perm = rng.permutation(P)
    bt = np.full((B, MAXP), -1, np.int32)
    npage = np.full((B,), P, np.int32)
    noff = np.zeros((B,), np.int32)
    pos = 0
    for b in range(B):
        if ctx[b] == 0:
            continue
        n = min(-(-int(ctx[b]) // PAGE), MAXP)
        bt[b, :n] = perm[pos:pos + n]
        pos += n
        t = int(ctx[b]) - 1
        npage[b], noff[b] = bt[b, t // PAGE], t % PAGE
    case.update(bt=bt, ctx=ctx, npage=npage, noff=noff)
    return case


def _port(case, kernels, window, cond_window, n_pages=None):
    """The port's shard; repro's [P] pool gets the trash page appended (the
    dead row's write target ``P`` is that page)."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    pk = torch.cat([t["pool_k"], torch.zeros_like(t["pool_k"][:1])])
    pv = torch.cat([t["pool_v"], torch.zeros_like(t["pool_v"][:1])])
    out, pk, pv = IT.itpp_decode_attention_shard(
        t["q"], t["k_new"], t["v_new"], pk, pv, t["bt"], t["ctx"],
        t["npage"], t["noff"], window, max_pages_per_req=MAXP,
        cond_window=cond_window, kernels=kernels)
    return out, pk, pv


def _repro(case, window, cond_window):
    spec = JItppSpec((), (), None, 1, 1, PAGE)
    a = {k: jnp.asarray(v) for k, v in case.items()}
    out, pk, pv = jax_shard(
        a["q"], a["k_new"], a["v_new"], a["pool_k"], a["pool_v"], a["bt"],
        a["ctx"], a["npage"], a["noff"], window, spec=spec,
        mesh_axis_sizes={}, max_pages_per_req=MAXP,
        cond_window=cond_window, kernels=None)
    return np.asarray(out), np.asarray(pk), np.asarray(pv)


@pytest.mark.parametrize("path", list(KERNELS))
@pytest.mark.parametrize("window", [0, 6])
def test_cond_window_branches_match_repro(window, path):
    """Both branches (window 0: the whole table; window 6: the windowed
    bound) on the port's plain and kernel paths against repro's
    ``kernels=None`` shard at ``cond_window=8``."""
    case = _case()
    out, pk, pv = _port(case, KERNELS[path], window, 8)
    ref, rk, rv = _repro(case, window, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=3e-5)
    P = case["pool_k"].shape[0]
    np.testing.assert_array_equal(pk[:P].numpy(), rk)
    np.testing.assert_array_equal(pv[:P].numpy(), rv)
    full, _, _ = _port(case, KERNELS[path], window, 0)
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("cond_window", [0, 8])
def test_per_layer_window_scan(cond_window):
    """Per-layer windows (gemma3's local and global layers) through the
    kernel path, one after the other on the same pool, each held to
    ``kernels/ref.py``'s paged attention with that window."""
    case = _case()
    for w in (0, 6):
        out, pk, pv = _port(case, KernelConfig(), w, cond_window)
        q = torch.from_numpy(case["q"]).reshape(B, KVH, G, 1, D)
        want = REF.paged_attention_verify_ref(
            q, pk, pv, torch.from_numpy(case["bt"]),
            torch.from_numpy(case["ctx"]), window=w)
        live = case["ctx"] > 0
        np.testing.assert_allclose(
            out.numpy()[live], want.reshape(B, KVH * G, D).numpy()[live],
            atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("path", list(KERNELS))
def test_cond_window_sharded_equals_unsharded(path):
    """A 57-token request striped over a 2 x 4 mesh: the windowed branch
    (window 6, ``cond_window`` 8) and the full one merged over both axes
    equal the unsharded shard."""
    n_pages, maxp, H, ctx_prev = 64, 16, 4, 57
    alloc = PageAllocator(n_pages, 8, PAGE, policy="striped")
    alloc.admit(0, ctx_prev + 1)
    bt = torch.from_numpy(alloc.block_table(0, maxp)[None])
    g = torch.Generator().manual_seed(0)
    pool_k = torch.randn((n_pages + 1, PAGE, 1, 16), generator=g)
    pool_v = torch.randn((n_pages + 1, PAGE, 1, 16), generator=g)
    q = torch.randn((1, H, 16), generator=g)
    kn, vn = torch.randn((2, 1, 1, 16), generator=g)
    ctx = torch.tensor([ctx_prev + 1], dtype=torch.int32)
    npage = bt[:, ctx_prev // PAGE].clone()
    noff = torch.tensor([ctx_prev % PAGE], dtype=torch.int32)
    axes = ("data", "model")
    spec = IT.ItppSpec(axes, axes, None, 8, 8, PAGE)
    for w in (0, 6):
        f = IT.make_itpp_attention(M.LocalMesh((2, 4), axes), spec,
                                   max_pages_per_req=maxp, cond_window=8,
                                   kernels=KERNELS[path])
        pk, pv = pool_k.clone(), pool_v.clone()
        out, pk, pv = f(q, kn, vn, pk, pv, bt, ctx, npage, noff, w)
        rk, rv = pool_k.clone(), pool_v.clone()
        ref, rk, rv = IT.itpp_decode_attention_shard(
            q, kn, vn, rk, rv, bt, ctx, npage, noff, w,
            max_pages_per_req=maxp)
        assert float((out - ref).abs().max()) < 3e-5
        assert torch.equal(pk[:n_pages], rk[:n_pages])
