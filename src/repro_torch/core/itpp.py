"""ITPP — intra-module token-parallel partitioning over a mesh of shards.

Port of ``repro/core/itpp.py`` (the paper's §4.3): the K/V pool is sharded
over the *token* (page) axis, not heads and not batch; each shard computes
partial attention over its own pages and the partials merge in
log-sum-exp form (``paged_kv.merge_partials``, the EPU aggregation), so
head count and batch size never bound the parallelism. A "PIM module" is
a mesh shard (``distributed/mesh.py``). Per layer and decode step each
shard

 1. writes the incoming token's K/V if it owns the target page,
 2. translates the global Va2Pa block table to its local pages,
 3. computes masked partials over them, either
    * through the paged split-K kernel (``kernels.paged_attention``) on the
      shard-local table: owned pages by local id, ``-1`` elsewhere, so
      the kernel skips every page it does not hold; or
    * by the plain gather-then-dense path (``kernels=None`` or
      ``use_kernels=False``): compaction (owned pages first), gather,
      masked partials,
 4. merges the partials over ``merge_axes``.

Requests either stripe pages across a data row's model shards
(decode_32k: the batch sharded over ``data``, merged over ``model``) or
across the whole mesh (long_500k: one request, merged over every axis):
the allocator's ``row_affine`` / ``striped`` policies.

``cond_window`` (mixed local:global stacks, gemma3): a windowed layer
touches only the table slots overlapping its window — the kernel gets the
``cond_window // page + 2`` slots from ``lo = max(ctx - w, 0) // page``
(``windowed_slice``), the plain path compacts to ``ceil(win_pages /
stripe) + 1`` slots — and a global layer the whole table. The window is a
Python int per layer, so the choice is an ``if`` (repro: a ``lax.cond``
on the traced window).

Shard-local pool layout. A pool carries one trash page last
(``core/paged_kv.py``) and a shard owns ``P_loc`` consecutive pages:
shard ``my`` holds global pages ``[my * P_loc, (my + 1) * P_loc)``. A
shard body gets pool STORAGE ``[N + 1, page, KVH, D]``, trash page last,
in one of two layouts (``pool_layout``):

* ``"local"`` — the shard's own pages, ``N = P_loc``, local page ``i`` at
  index ``i`` (a ``ProcessMesh``: each process holds its pages, and its
  own trash page);
* ``"global"`` — the whole pool, ``N = n_pages``, the shard's pages at
  ``[my * P_loc, (my + 1) * P_loc)`` (the single-process ``LocalMesh``:
  every shard views the one pool and nothing is copied).

Either way the shard's pages are the view ``storage[base : base +
P_loc]``, and a write the shard does not own goes to the trash page
``storage[N]`` (under ``"global"`` that one page takes every shard's
dropped writes; nothing reads it). The kernel needs no trash page (it
skips ``-1`` slots) and gets the view with local page ids. An unsharded
call (``spec.page_axes == ()``, the single-device ``Runtime`` of earlier
slices) is ``my = 0``, ``P_loc = N``.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from repro_torch.core.paged_kv import merge_partials, partial_decode_attention
from repro_torch.distributed import mesh as M
from repro_torch.kernels.backend import KernelConfig


@dataclass(frozen=True)
class ItppSpec:
    page_axes: tuple[str, ...]      # mesh axes sharding the pool's page dim
    merge_axes: tuple[str, ...]     # axes to merge partials over
    batch_axis: str | None          # axis sharding the request batch (or None)
    n_page_shards: int              # product of page_axes sizes
    stripe: int                     # shards each request stripes over
    page_size: int

    def max_local_pages(self, max_pages_per_req: int) -> int:
        return -(-max_pages_per_req // self.stripe) + 1


def _my_page_shard(spec: ItppSpec) -> int:
    """Linear shard index over the page axes (row-major over page_axes)."""
    return M.axis_index(spec.page_axes)


def _shard_pages(spec: ItppSpec, storage, pool_layout: str):
    """(my, P_loc, base) of the calling shard over ``storage`` (the module
    docstring's layouts)."""
    N = storage.shape[0] - 1
    if not spec.page_axes:
        return 0, N, 0
    my = _my_page_shard(spec)
    if pool_layout == "global":
        P_loc = N // spec.n_page_shards
        return my, P_loc, my * P_loc
    if pool_layout != "local":
        raise ValueError(f"pool_layout {pool_layout!r}: 'local' or 'global'")
    return my, N, 0


def _floordiv(x, n: int):
    return torch.div(x, n, rounding_mode="floor")


def _gather_partial(q, local_k, local_v, block_table, ctx_len, owned, my,
                    P_loc, w: int, ring_width: int, mp_width: int,
                    window_only: bool):
    """Va2Pa compaction -> gather -> masked partials over ``mp_width``
    table slots (owned and, for a windowed layer, in-window pages first)."""
    B, maxp = block_table.shape
    page = local_k.shape[1]
    dev = q.device
    ctx = ctx_len.long()
    vpage = torch.arange(maxp, device=dev)[None].expand(B, maxp)
    pri = owned
    if window_only:
        lo_page = _floordiv((ctx[:, None] - w).clamp_min(0), page)
        pri = owned & (vpage >= lo_page)
    order = torch.argsort(torch.where(pri, vpage, maxp + vpage), dim=1,
                          stable=True)[:, :mp_width]
    bt_loc = block_table.long().gather(1, order) - my * P_loc
    vp_loc = vpage.gather(1, order)
    ok_loc = pri.gather(1, order)                                 # [B,mp]
    bt_safe = torch.where(ok_loc, bt_loc, 0)
    k_pages = local_k[bt_safe]                    # [B, mp, page, KVH, D]
    v_pages = local_v[bt_safe]
    if ring_width:
        cur_vp = _floordiv(ctx - 1, page)[:, None]
        vp_eff = cur_vp - torch.remainder(cur_vp - vp_loc, ring_width)
        ok_loc = ok_loc & (vp_eff >= 0)
    else:
        vp_eff = vp_loc
    tok = vp_eff[:, :, None] * page + torch.arange(page, device=dev)
    valid = ok_loc[:, :, None] & (tok < ctx[:, None, None])
    if w > 0:
        valid = valid & (tok >= ctx[:, None, None] - w)
    return partial_decode_attention(q, k_pages, v_pages, valid)


def _kernel_partial(q, local_k, local_v, bt_loc, ctx_len, w: int,
                    ring_width: int, n_splits: int, mp_width: int,
                    window_only: bool):
    """The paged kernel over the shard-local table; with ``window_only``
    only the ``mp_width`` slots from the window's first page ride the
    grid (``windowed_slice``: slot j is virtual page lo + j in-kernel)."""
    from repro_torch.kernels.paged_attention import paged_attention_partials
    from repro_torch.kernels.ref import combine_partials
    B, H = q.shape[:2]
    maxp = bt_loc.shape[1]
    page, KVH = local_k.shape[1], local_k.shape[2]
    if window_only:
        lo = _floordiv((ctx_len.long() - w).clamp_min(0), page)     # [B]
        sel = lo[:, None] + torch.arange(mp_width, device=q.device)
        btk = bt_loc.gather(1, sel.clamp(0, maxp - 1))
        btk = torch.where(sel < maxp, btk, -1)
    else:
        btk = bt_loc
    o4, l4, m4 = paged_attention_partials(
        q.reshape(B, KVH, H // KVH, -1), local_k, local_v, btk, ctx_len,
        window=w, ring_width=ring_width, windowed_slice=window_only,
        n_splits=n_splits)
    o4, l4, m4 = combine_partials(o4, l4, m4)
    return o4.reshape(B, H, -1), l4.reshape(B, H), m4.reshape(B, H)


def itpp_decode_attention_shard(q, k_new, v_new, pool_k, pool_v, block_table,
                                ctx_len, new_page, new_off, window=0, *,
                                spec: ItppSpec | None = None,
                                max_pages_per_req: int, ring_width: int = 0,
                                cond_window: int = 0,
                                kernels: KernelConfig | None = None,
                                pool_layout: str = "local"):
    """One shard's decode attention (a ``shard_map`` body, or the whole
    computation when ``spec`` is None or unsharded).

    q [B,H,D]; k_new/v_new [B,KVH,D]; pool_{k,v} the shard's storage [N+1,
    page, KVH, D] in ``pool_layout`` (module docstring); block_table [B,
    maxp] GLOBAL page ids, -1 pad; ctx_len [B] incl. the current token;
    new_page/new_off [B] global write target (outside the shard's pages:
    drop); ``window`` int (0 = full attention). The pool is written in
    place. Returns (out [B,H,D], pool_k, pool_v).
    """
    B, maxp = block_table.shape
    page = pool_k.shape[1]
    if spec is None:
        spec = ItppSpec((), (), None, 1, 1, page)
    my, P_loc, base = _shard_pages(spec, pool_k, pool_layout)
    trash = pool_k.shape[0] - 1

    # ---- 1. write the incoming token where owned (else the trash page) --
    owned_w = _floordiv(new_page, P_loc) == my
    loc_w = torch.where(owned_w, new_page - my * P_loc + base, trash).long()
    offs = new_off.long()
    pool_k[loc_w, offs] = k_new.to(pool_k.dtype)
    pool_v[loc_w, offs] = v_new.to(pool_v.dtype)

    owned = (block_table >= 0) & (_floordiv(block_table, P_loc) == my)
    local_k = pool_k.narrow(0, base, P_loc)
    local_v = pool_v.narrow(0, base, P_loc)
    w = int(window)
    windowed = cond_window > 0 and w > 0

    if kernels is not None and kernels.enabled:
        bt_loc = torch.where(owned, block_table - my * P_loc, -1).long()
        width = min(cond_window // page + 2, maxp) if windowed else maxp
        o, l, m = _kernel_partial(q, local_k, local_v, bt_loc, ctx_len, w,
                                  ring_width, kernels.n_splits, width,
                                  windowed)
    else:
        if windowed:
            win_pages = cond_window // page + 2  # pages spanning a window
            width = min(-(-win_pages // spec.stripe) + 1, maxp)
        else:
            width = min(spec.max_local_pages(max_pages_per_req), maxp)
        o, l, m = _gather_partial(q, local_k, local_v, block_table, ctx_len,
                                  owned, my, P_loc, w, ring_width, width,
                                  windowed)

    # ---- 4. stable merge (EPU aggregation) ------------------------------
    if spec.page_axes and spec.merge_axes:
        out = merge_partials(o, l, m, axis=spec.merge_axes)
    else:
        out = o / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype), pool_k, pool_v


def make_prefill_writer(spec: ItppSpec, *, pool_layout: str = "local",
                        ring_width: int = 0):
    """A sequence-parallel prefill shard's pool writes (repro's §Perf P1:
    the scatter never crosses shards), for a body that runs as a shard of
    ``spec``'s mesh (``distributed/sharding.make_prefill_step``). Returns
    f(pool_k, pool_v, k, v, bt, valid_len=None) -> (pool_k, pool_v), per
    layer: pools [N+1, page, KVH, D] (``pool_layout`` as
    ``_shard_pages`` reads it) written in place; k/v [B, S, KVH, D] the
    rows' whole sequences, of which the shard writes the pages it owns
    (any allocator policy; with ``blocked_chunk`` those are its own block
    of the sequence); ``valid_len`` [B] keeps pad positions out (repro's
    writer has none and writes them where a page exists; they lie past
    the context and every decode write precedes its read). ``ring_width``
    > 0 writes a ring pool's last ``ring_width`` pages of tokens as
    ``write_prefill`` does (``valid_len`` ignored, as the unsharded ring
    write ignores it)."""

    def write(pool_k, pool_v, k, v, bt, valid_len=None):
        B, S = k.shape[:2]
        page, W = pool_k.shape[1], bt.shape[1]
        my, P_loc, base = _shard_pages(spec, pool_k, pool_layout)
        trash = pool_k.shape[0] - 1
        t = torch.arange(S, device=k.device)
        vpage = t // page
        if ring_width:
            vpage = vpage % ring_width
        vpage = vpage.expand(B, S)
        offs = (t % page).expand(B, S)
        pids = bt.long().gather(1, vpage.clamp(max=W - 1))
        owned = (pids >= 0) & (vpage < W) & (_floordiv(pids, P_loc) == my)
        if ring_width:
            owned = owned & (t[None] >= S - min(ring_width * page, S))
        elif valid_len is not None:
            owned = owned & (t[None] < valid_len.long()[:, None])
        loc = torch.where(owned, pids - my * P_loc + base, trash)
        pool_k[loc, offs] = k.to(pool_k.dtype)
        pool_v[loc, offs] = v.to(pool_v.dtype)
        return pool_k, pool_v

    return write


def make_itpp_attention(mesh, spec: ItppSpec, *, max_pages_per_req: int,
                        ring_width: int = 0, cond_window: int = 0,
                        kernels: KernelConfig | None = None):
    """The sharded decode attention op: f(q, k_new, v_new, pool_k, pool_v,
    bt, ctx, new_page, new_off, window) -> (out, pool_k, pool_v), one
    ``itpp_decode_attention_shard`` per shard of ``mesh`` (plain when
    ``mesh`` is None or the spec unsharded). The pools are resident in
    and out (``mesh.Resident``: on a ``ProcessMesh`` the rank's block of
    pages with its own trash page, ``mesh.shard``, written in place; the
    global pool on a ``LocalMesh``); the other tensors are global.
    ``kernels`` picks the shard-local compute."""
    layout = mesh.pool_layout if mesh is not None else "local"
    body = partial(itpp_decode_attention_shard, spec=spec,
                   max_pages_per_req=max_pages_per_req,
                   ring_width=ring_width, cond_window=cond_window,
                   kernels=kernels, pool_layout=layout)
    if mesh is None or not spec.page_axes:
        return body
    b = M.P(spec.batch_axis)
    pool = M.Resident(M.P(M.Paged(spec.page_axes)))
    return M.shard_map(body, mesh,
                       in_specs=(b, b, b, pool, pool, b, b, b, b, None),
                       out_specs=(b, pool, pool))
