"""repro_torch's KV-cache hierarchy (``repro_torch/kvcache``) against
repro's, unit by unit, on the CPU.

The radix, policy and cache scenarios of ``tests/test_kvcache.py`` run on
the port's classes with the same operation sequences and the same asserts;
the property test drives repro's cache and the port's in lockstep and
requires every lookup, peek, reclaim and the tree's pages to agree. The
swap-out -> drain -> swap-in -> apply round trip restores page bytes bit
for bit and writes the pool in place. The page operations of
``core/paged_kv.py`` are bit-equal to repro's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:              # graceful fallback: example-based driver
    from _hypothesis_compat import given, settings, strategies as st

from repro.core import paged_kv as JPKV
from repro.core.allocator import PageAllocator as JaxAllocator
from repro.kvcache import PrefixCache as JaxPrefixCache
from repro_torch.core import paged_kv as PKV
from repro_torch.core.allocator import PageAllocator
from repro_torch.kvcache import HostCopier, PrefixCache, RadixTree

PAGE = 4


def make_cache(n_pages=64, page_size=PAGE, host_pages=0):
    alloc = PageAllocator(n_pages, 1, page_size)
    return alloc, PrefixCache(alloc, host_pages=host_pages)


def tree_invariants(cache):
    """Structural invariants that must hold after any op sequence."""
    tree, alloc = cache.tree, cache.alloc
    seen: set[int] = set()
    for node in tree.nodes():
        ps = tree.page_size
        assert len(node.tokens) > 0
        assert len(node.tokens) % ps == 0, "nodes split at page boundaries"
        if node.on_host:
            assert node.pages is None
            assert node.host["k"].shape[1] == len(node.tokens) // ps
        else:
            assert len(node.pages) == len(node.tokens) // ps
            for p in node.pages:
                assert p not in seen, "page owned by two tree nodes"
                assert alloc.ref_of(p) >= 1, "tree page without a reference"
                seen.add(p)
        for tok, child in node.children.items():
            assert child.parent is node
            assert int(child.tokens[0]) == tok
        assert node.ref >= sum(c.ref for c in node.children.values()), \
            "path pins must be monotone toward the root"


def _seq(data, shared, n):
    """Token sequence sharing a prefix of ``shared`` with a common base."""
    base = np.arange(1000, 1000 + shared, dtype=np.int32)
    priv = np.asarray([data.draw(st.integers(0, 500))
                       for _ in range(max(0, n - shared))], np.int32)
    return np.concatenate([base[:min(shared, n)], priv])[:n]


def _tree_shape(cache):
    """The tree as comparable data: (tokens, pages, ref) per node in a
    canonical walk."""
    out = []
    stack = [cache.tree.root]
    while stack:
        n = stack.pop()
        out.append((n.tokens.tolist(), n.pages, n.ref))
        stack.extend(n.children[k] for k in sorted(n.children))
    return out


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_radix_insert_match_evict_invariants(data):
    """Random interleaving of admit(lookup+admit_shared) / insert / free /
    reclaim keeps the tree structurally sound, the page refcounts
    conserved, and every match a true prefix of the inserted corpus — and
    repro's cache, driven by the same operations, agrees at every step."""
    alloc, cache = make_cache(n_pages=48)
    jalloc = JaxAllocator(48, 1, PAGE)
    jcache = JaxPrefixCache(jalloc)
    rng = data
    live: dict[int, np.ndarray] = {}
    next_req = 0
    for _ in range(rng.draw(st.integers(5, 30))):
        action = rng.draw(st.sampled_from(
            ["admit", "finish", "reclaim", "lookup"]))
        assert alloc.available_pages() == jalloc.available_pages()
        if action == "admit" and alloc.available_pages() >= 8:
            shared = rng.draw(st.integers(0, 20))
            n = rng.draw(st.integers(2, 24))
            seq = _seq(rng, shared, n)
            hit = cache.lookup(next_req, seq)
            jhit = jcache.lookup(next_req, seq)
            assert (hit.pages, hit.matched, hit.cow_tokens, hit.cow_src) == \
                (jhit.pages, jhit.matched, jhit.cow_tokens, jhit.cow_src)
            # a hit must be a true prefix of the request's sequence
            assert hit.matched < len(seq)
            try:
                alloc.admit_shared(next_req, hit.pages, len(seq))
            except MemoryError:
                with pytest.raises(MemoryError):
                    jalloc.admit_shared(next_req, jhit.pages, len(seq))
                cache.release(next_req)
                jcache.release(next_req)
                continue
            jalloc.admit_shared(next_req, jhit.pages, len(seq))
            cache.commit(next_req, alloc.pages_of(next_req))
            jcache.commit(next_req, jalloc.pages_of(next_req))
            live[next_req] = seq
            next_req += 1
        elif action == "finish" and live:
            r = rng.draw(st.sampled_from(sorted(live)))
            assert cache.insert(r, live[r]) == jcache.insert(r, live[r])
            cache.release(r)
            jcache.release(r)
            alloc.free(r)
            jalloc.free(r)
            del live[r]
        elif action == "reclaim":
            n = rng.draw(st.integers(1, 8))
            assert cache.reclaim(n) == jcache.reclaim(n)
        elif action == "lookup" and next_req:
            seq = _seq(rng, rng.draw(st.integers(0, 20)),
                       rng.draw(st.integers(2, 24)))
            dev, host = cache.peek(seq)
            assert (dev, host) == jcache.peek(seq)
            assert (dev + host) * PAGE <= len(seq)
        tree_invariants(cache)
        assert _tree_shape(cache) == _tree_shape(jcache)
        assert cache.reclaimable() == jcache.reclaimable()
    for r in sorted(live):
        cache.release(r)
        alloc.free(r)
        jcache.release(r)
        jalloc.free(r)
        tree_invariants(cache)
    # after releasing every request, all remaining pages belong to the tree
    assert alloc.pages_in_use == cache.tree.device_pages()
    # ...and a full reclaim returns the pool to empty
    assert cache.reclaim(alloc.n_pages) == jcache.reclaim(jalloc.n_pages)
    assert alloc.pages_in_use == 0
    assert cache.stats.as_dict() == jcache.stats.as_dict()


def test_match_splits_at_page_boundary_and_cows_midpage():
    alloc, cache = make_cache()
    seq = np.arange(100, 120, dtype=np.int32)          # 20 tokens, 5 pages
    pages = alloc.admit(0, len(seq))
    cache.insert(0, seq)
    alloc.free(0)
    # diverge 18 tokens in: 4 full pages shared + 2-token CoW into page 4
    q = np.concatenate([seq[:18], [7, 8, 9]]).astype(np.int32)
    hit = cache.lookup(1, q)
    assert hit.pages == pages[:4]
    assert hit.matched == 18 and hit.cow_tokens == 2
    assert hit.cow_src == pages[4]
    table = alloc.admit_shared(1, hit.pages, len(q))
    cache.commit(1, table)
    assert table[:4] == pages[:4] and table[4] not in pages
    assert cache.stats.cow_copies == 1
    # fully-cached prompt is capped one token short (first-token logits)
    full = cache.lookup(2, seq)
    assert full.matched == 19 and full.matched < len(seq)
    cache.release(1)
    cache.release(2)
    alloc.free(1)


def test_lru_eviction_spares_pinned_paths():
    alloc, cache = make_cache(n_pages=16)
    a = np.arange(0, 8, dtype=np.int32)
    b = np.arange(100, 108, dtype=np.int32)
    for r, seq in enumerate((a, b)):
        alloc.admit(r, len(seq))
        cache.insert(r, seq)
        alloc.free(r)
    assert cache.reclaimable() == 4
    hit = cache.lookup(9, np.concatenate([a, [1, 2]]).astype(np.int32))
    assert len(hit.pages) == 2                  # pinned while "running"
    assert cache.reclaimable() == 2             # only b's pages evictable
    freed = cache.reclaim(10)
    assert freed == 2                           # b evicted, a survives
    assert cache.tree.device_pages() == 2
    cache.release(9)
    assert cache.reclaimable() == 2


def test_reclaimable_excludes_request_referenced_pages():
    """A tree page a running request still shares would survive eviction,
    so it must not be advertised as reclaimable admission capacity."""
    alloc, cache = make_cache(n_pages=16)
    a = np.arange(0, 8, dtype=np.int32)         # 2 pages into the tree
    alloc.admit(0, len(a))
    cache.insert(0, a)
    alloc.free(0)
    assert cache.reclaimable() == 2             # tree-only refs: evictable
    hit = cache.lookup(1, np.concatenate([a, [1, 2]]).astype(np.int32))
    assert len(hit.pages) == 2
    alloc.admit_shared(1, hit.pages, len(a) + 2)
    cache.release(1)                            # unpinned (node ref == 0)...
    # ...but the request still owns a reference on both shared pages, so
    # evicting the node could not actually free them
    assert cache.reclaimable() == 0
    assert alloc.available_pages() == alloc.free_page_count
    alloc.free(1)                               # request gone: refs drop to
    assert cache.reclaimable() == 2             # the tree's own — capacity


def _pool_with_payload(pages, rng):
    spec = PKV.PoolSpec(n_layers=2, n_pages=16, page_size=PAGE, n_kv_heads=1,
                        d_head=2, max_pages_per_req=6, dtype="float32")
    pool = PKV.init_pool(spec, "cpu")
    payload = torch.from_numpy(
        rng.normal(size=(2, len(pages), PAGE, 1, 2)).astype(np.float32))
    pool["k"][:, pages] = payload
    pool["v"][:, pages] = 2 * payload
    return pool, payload


def test_swap_out_drain_swap_in_restores_page_bytes():
    """swap-out -> drain -> match (swap-in) -> apply restores page bytes
    bit for bit, in the pool's own tensors."""
    alloc, cache = make_cache(n_pages=16, host_pages=8)
    rng = np.random.default_rng(0)
    seq = np.arange(50, 58, dtype=np.int32)            # 2 pages
    pages = alloc.admit(0, len(seq))
    pool, payload = _pool_with_payload(pages, rng)
    ptrs = {k: t.data_ptr() for k, t in pool.items()}
    cache.pool_ref = lambda: pool
    cache.insert(0, seq)
    alloc.free(0)
    # force the pages out to the host tier
    freed = cache.reclaim(2)
    assert freed == 2 and cache.tree.host_pages() == 2
    assert cache.host.used == 2
    cache.maintain()                                   # drain
    # zero the pool: the device copy is gone, only the host copy survives
    for t in pool.values():
        t.zero_()
    hit = cache.lookup(1, np.concatenate([seq, [1, 2]]).astype(np.int32))
    assert hit.matched == 8 and len(hit.pages) == 2
    assert cache.host.used == 0 and cache.has_pending
    out = cache.apply_pending(pool)
    assert out is pool
    assert {k: t.data_ptr() for k, t in pool.items()} == ptrs
    assert torch.equal(pool["k"][:, hit.pages], payload)
    assert torch.equal(pool["v"][:, hit.pages], 2 * payload)
    assert cache.host.stats.swapped_out_pages == 2
    assert cache.host.stats.swapped_in_pages == 2
    cache.release(1)


def test_split_host_node_and_host_cow_write():
    """A host-resident node split at a page boundary keeps each half's
    pages (views of one buffer, nothing copied), and a mid-page
    divergence into a host node writes that page into the request's own
    page with the right bytes."""
    alloc, cache = make_cache(n_pages=16, host_pages=8)
    rng = np.random.default_rng(1)
    seq = np.arange(60, 72, dtype=np.int32)            # 3 pages
    pages = alloc.admit(0, len(seq))
    pool, payload = _pool_with_payload(pages, rng)
    cache.pool_ref = lambda: pool
    cache.insert(0, seq)
    alloc.free(0)
    assert cache.reclaim(3) == 3
    cache.maintain()
    node = next(cache.tree.nodes())
    buf = node.host["k"]
    # 1 full page then a 2-token divergence into the second: split + CoW
    q = np.concatenate([seq[:6], [1, 2, 3]]).astype(np.int32)
    hit = cache.lookup(1, q)
    assert hit.matched == 6 and hit.cow_tokens == 2
    upper = hit.deepest
    assert upper.pages is not None and len(upper.pages) == 1
    lower = next(iter(upper.children.values()))
    assert lower.on_host and lower.host["k"].shape[1] == 2
    assert lower.host["k"].untyped_storage().data_ptr() == \
        buf.untyped_storage().data_ptr()
    table = alloc.admit_shared(1, hit.pages, len(q))
    cache.commit(1, table)
    for t in pool.values():
        t.zero_()
    cache.apply_pending(pool)
    assert torch.equal(pool["k"][:, table[0]], payload[:, 0])
    assert torch.equal(pool["k"][:, table[1]], payload[:, 1])
    assert torch.equal(pool["v"][:, table[1]], 2 * payload[:, 1])
    cache.release(1)
    alloc.free(1)


def test_host_copier_on_cpu_tensors_is_identity():
    """On the CPU the copier keeps payloads as they are (no pinned memory,
    no stream): the gathered pages are the host copy."""
    cp = HostCopier()
    rng = np.random.default_rng(2)
    pool, payload = _pool_with_payload([3, 5], rng)
    host = cp.pages_to_host(pool, [5, 3])
    assert torch.equal(host["k"], pool["k"][:, [5, 3]])
    back = cp.to_device(host, "cpu")
    assert back["k"] is host["k"]
    cp.settle()
    assert cp.stats.d2h_bytes == 0 and cp.stats.h2d_bytes == 0


@pytest.mark.parametrize("ids", [[3, 0, 7], [5], [2, 16, -1]],
                         ids=["three", "one", "out-of-range"])
def test_page_ops_match_jax(ids):
    """``gather_pages`` / ``scatter_pages`` / ``copy_page`` are bit-equal to
    repro's on the real pages (out-of-range ids: JAX drops the write, the
    port sends it to the trash page), and write the pool in place."""
    rng = np.random.default_rng(3)
    L, P, S, H, D = 2, 16, PAGE, 2, 4
    pk = rng.standard_normal((L, P, S, H, D), np.float32)
    pv = rng.standard_normal((L, P, S, H, D), np.float32)
    tk = torch.from_numpy(np.concatenate([pk, np.zeros_like(pk[:, :1])], 1))
    tv = torch.from_numpy(np.concatenate([pv, np.zeros_like(pv[:, :1])], 1))
    ptr = tk.data_ptr()
    real = [i for i in ids if 0 <= i < P]
    gk, gv = PKV.gather_pages(tk, tv, real)
    jk, jv = JPKV.gather_pages(jnp.asarray(pk), jnp.asarray(pv),
                               jnp.asarray(real))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
    dk = rng.standard_normal((L, len(ids), S, H, D), np.float32)
    dv = rng.standard_normal((L, len(ids), S, H, D), np.float32)
    PKV.scatter_pages(tk, tv, ids, torch.from_numpy(dk), torch.from_numpy(dv))
    jids = np.asarray([i if 0 <= i < P else P for i in ids])
    jk, jv = JPKV.scatter_pages(jnp.asarray(pk), jnp.asarray(pv),
                                jnp.asarray(jids), jnp.asarray(dk),
                                jnp.asarray(dv))
    PKV.copy_page(tk, tv, 9, 11)
    jk, jv = JPKV.copy_page(jk, jv, 9, 11)
    np.testing.assert_array_equal(tk[:, :P].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:, :P].numpy(), np.asarray(jv))
    assert tk.data_ptr() == ptr


def test_radix_tree_is_repro_s():
    """The framework-free tree is a copy: the same walk on the same
    inserts gives the same matches."""
    from repro.kvcache import RadixTree as JaxRadixTree
    trees = (RadixTree(PAGE), JaxRadixTree(PAGE))
    rng = np.random.default_rng(4)
    base = rng.integers(0, 50, 40).astype(np.int32)
    for r in range(6):
        seq = np.concatenate([base[:int(rng.integers(3, 40))],
                              rng.integers(0, 50, 5)]).astype(np.int32)
        pages = list(range(10 * r, 10 * r + len(seq) // PAGE))
        got = [[(n.tokens.tolist(), p) for n, p in t.insert(seq, pages)]
               for t in trees]
        assert got[0] == got[1]
    for _ in range(10):
        q = np.concatenate([base[:int(rng.integers(1, 40))],
                            rng.integers(0, 50, 3)]).astype(np.int32)
        a, b = (t.match(q) for t in trees)
        assert [n.pages for n in a.path] == [n.pages for n in b.path]
        assert a.cow_tokens == b.cow_tokens
        assert trees[0].peek(q) == trees[1].peek(q)
