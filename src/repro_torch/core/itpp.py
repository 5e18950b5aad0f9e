"""ITPP decode attention on a single shard.

Port of ``repro/core/itpp.py::itpp_decode_attention_shard`` for one shard
(the paper's §4.3 token-partitioned attention with its log-sum-exp merge;
here the partition is the kernel's split-K, not a mesh). Per layer and
decode step it

 1. writes the incoming token's K/V (idle slots onto the trash page),
 2. computes attention over the slot's pages, either
    * through the paged split-K kernel (``kernels.paged_attention``): K/V
      read straight out of the pool, dead pages skipped, partials merged
      by ``combine_partials`` and normalised; or
    * by the plain gather-then-dense path (``kernels=None`` or
      ``use_kernels=False``): Va2Pa compaction, gather, masked partials.

Sharded specs (queue A.10) and the ``cond_window`` branch of mixed
local:global stacks (queue A.6, gemma3) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.paged_kv import partial_decode_attention
from repro_torch.kernels.backend import KernelConfig


def itpp_decode_attention_shard(q, k_new, v_new, pool_k, pool_v, block_table,
                                ctx_len, new_page, new_off, window=0, *,
                                max_pages_per_req: int, ring_width: int = 0,
                                cond_window: int = 0,
                                kernels: KernelConfig | None = None):
    """q [B,H,D]; k_new/v_new [B,KVH,D]; pool_{k,v} [P+1, page, KVH, D]
    (trash page last); block_table [B, maxp] (-1 pad); ctx_len [B] incl.
    the current token; new_page/new_off [B] write target (``P`` = drop);
    ``window`` int (0 = full attention). The pool is written in place.
    Returns (out [B,H,D], pool_k, pool_v).
    """
    if cond_window:
        raise NotImplementedError(
            "cond_window (mixed local:global stacks) is ROADMAP queue A.6")
    B, maxp = block_table.shape
    P_loc, page = pool_k.shape[0] - 1, pool_k.shape[1]
    dev = q.device

    # ---- 1. write the incoming token (out-of-range targets -> trash) ----
    loc_w = torch.where((new_page >= 0) & (new_page < P_loc), new_page,
                        P_loc).long()
    offs = new_off.long()
    pool_k[loc_w, offs] = k_new.to(pool_k.dtype)
    pool_v[loc_w, offs] = v_new.to(pool_v.dtype)

    owned = (block_table >= 0) & (block_table < P_loc)           # [B,maxp]
    w = int(window)

    if kernels is not None and kernels.enabled:
        from repro_torch.kernels.paged_attention import \
            paged_attention_partials
        from repro_torch.kernels.ref import combine_partials
        H = q.shape[1]
        KVH = pool_k.shape[2]
        bt_loc = torch.where(owned, block_table, -1).to(torch.int32)
        o4, l4, m4 = paged_attention_partials(
            q.reshape(B, KVH, H // KVH, -1), pool_k, pool_v, bt_loc,
            ctx_len, window=w, ring_width=ring_width,
            n_splits=kernels.n_splits)
        o4, l4, _ = combine_partials(o4, l4, m4)
        o, l = o4.reshape(B, H, -1), l4.reshape(B, H)
    else:
        # ---- 2. compaction: owned pages first, in virtual-page order ----
        vpage = torch.arange(maxp, device=dev)[None].expand(B, maxp)
        order = torch.argsort(torch.where(owned, vpage, maxp + vpage), dim=1,
                              stable=True)
        bt_loc = block_table.long().gather(1, order)
        vp_loc = vpage.gather(1, order)
        ok_loc = owned.gather(1, order)                           # [B,mp]
        bt_safe = torch.where(ok_loc, bt_loc, 0)

        # ---- 3. gather + masked partial attention --------------------
        k_pages = pool_k[bt_safe]            # [B, mp, page, KVH, D]
        v_pages = pool_v[bt_safe]
        ctx = ctx_len.long()
        if ring_width:
            cur_vp = torch.div(ctx - 1, page, rounding_mode="floor")[:, None]
            vp_eff = cur_vp - torch.remainder(cur_vp - vp_loc, ring_width)
            ok_loc = ok_loc & (vp_eff >= 0)
        else:
            vp_eff = vp_loc
        tok = vp_eff[:, :, None] * page + torch.arange(page, device=dev)
        valid = ok_loc[:, :, None] & (tok < ctx[:, None, None])
        if w > 0:
            valid = valid & (tok >= ctx[:, None, None] - w)
        o, l, _ = partial_decode_attention(q, k_pages, v_pages, valid)

    out = o / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype), pool_k, pool_v
