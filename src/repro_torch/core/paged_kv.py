"""DPA-style paged KV cache: page pool + Va2Pa block tables.

Port of ``repro/core/paged_kv.py``. The pool is a fixed set of pages;
block tables and context lengths are runtime data, so one program serves
every context length and memory grows page by page.

The port updates the pool IN PLACE (the JAX functions return new arrays;
here they return the same tensors they were given, written).

Trash page. JAX scatters with ``mode="drop"`` so writes aimed out of bounds
(idle slots, pad positions, ``-1`` table entries) vanish. PyTorch has no
drop mode, and neither clamping to a real page (duplicate indices race with
the real write on the GPU) nor boolean-mask indexing (a host sync per
layer) will do. So every pool carries ONE spare page at index ``n_pages``
that no block table ever names: dropped writes are routed there and nothing
reads it. Pools are ``[L, n_pages + 1, page, KVH, D]``; compare them with a
JAX pool on ``[:, :n_pages]``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import NEG_INF

_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class PoolSpec:
    """Static geometry of the paged pool."""
    n_layers: int          # attention layers holding KV
    n_pages: int           # real pages (the trash page comes on top)
    page_size: int         # tokens per page
    n_kv_heads: int
    d_head: int
    max_pages_per_req: int # block-table width
    dtype: str = "bfloat16"
    ring: bool = False     # sliding-window pool: table slots recycle mod width

    @property
    def tokens(self) -> int:
        return self.n_pages * self.page_size

    def bytes(self, bytes_per_el: int = 2) -> int:
        return (2 * self.n_layers * self.n_pages * self.page_size
                * self.n_kv_heads * self.d_head * bytes_per_el)


def init_pool(spec: PoolSpec, device=None):
    """Zeroed K and V pools [L, n_pages + 1, page, KVH, D] (the last page is
    the trash page)."""
    shape = (spec.n_layers, spec.n_pages + 1, spec.page_size,
             spec.n_kv_heads, spec.d_head)
    dt = _DTYPE[spec.dtype]
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _to_trash(page_ids, trash: int):
    """Route every id outside [0, trash) to the trash page."""
    return torch.where((page_ids < 0) | (page_ids >= trash), trash,
                       page_ids).long()


def write_token(pool_layer_k, pool_layer_v, k_new, v_new, page_ids, offsets):
    """Append one token's K/V per request, in place.

    pool_layer_{k,v} [P+1, page, KVH, D]; k_new/v_new [B, KVH, D];
    page_ids/offsets [B] — physical page + in-page slot of each request's
    current token. Ids outside the real pages land on the trash page.
    """
    pids = _to_trash(page_ids, pool_layer_k.shape[0] - 1)
    offs = offsets.long()
    pool_layer_k[pids, offs] = k_new.to(pool_layer_k.dtype)
    pool_layer_v[pids, offs] = v_new.to(pool_layer_v.dtype)
    return pool_layer_k, pool_layer_v


def write_prefill(pool_layer_k, pool_layer_v, k_seq, v_seq, block_table,
                  ctx_start=0, ring_width: int = 0, valid_len=None):
    """Scatter a whole prefilled sequence into the pool, in place.

    k_seq/v_seq [B, S, KVH, D]; block_table [B, maxp]. Token t of request b
    goes to page block_table[b, (ctx_start+t)//page] slot
    (ctx_start+t)%page. ``ring_width`` > 0 recycles table slots mod
    ring_width. ``valid_len`` [B]: only the first valid_len[b] tokens are
    written. ``ctx_start`` is a scalar or a [B] vector. Pad positions,
    ``-1`` table entries and positions past the table width go to the trash
    page (the JAX gather fills them negative, and the scatter drops them).
    """
    B, S = k_seq.shape[:2]
    trash = pool_layer_k.shape[0] - 1
    page = pool_layer_k.shape[1]
    W = block_table.shape[1]
    dev = k_seq.device
    start = (ctx_start.long() if torch.is_tensor(ctx_start)
             else torch.full((1,), int(ctx_start), device=dev))
    t = start.reshape(-1, 1) + torch.arange(S, device=dev)[None]   # [1|B, S]
    vpage = t // page
    if ring_width:
        vpage = vpage % ring_width
    off = (t % page).expand(B, S)
    vpage = vpage.expand(B, S)
    pids = block_table.long().gather(1, vpage.clamp(0, W - 1))
    drop = (pids < 0) | (vpage >= W)
    if valid_len is not None:
        drop = drop | (torch.arange(S, device=dev)[None]
                       >= valid_len.long()[:, None])
    pids = torch.where(drop, trash, pids)
    pool_layer_k[pids, off] = k_seq.to(pool_layer_k.dtype)
    pool_layer_v[pids, off] = v_seq.to(pool_layer_v.dtype)
    return pool_layer_k, pool_layer_v


def gather_kv(pool_layer_k, pool_layer_v, block_table):
    """[B, maxp] -> contiguous [B, maxp*page, KVH, D] (-1 entries read page
    0; callers mask by context)."""
    B, maxp = block_table.shape
    safe = block_table.clamp_min(0).long()
    k = pool_layer_k[safe]                                # [B, maxp, page, KVH, D]
    v = pool_layer_v[safe]
    page = k.shape[2]
    return (k.reshape(B, maxp * page, *k.shape[3:]),
            v.reshape(B, maxp * page, *v.shape[3:]))


def partial_decode_attention(q, k_pages, v_pages, token_valid):
    """Masked partial attention over gathered pages -> (o, l, m).

    q [B, H, D]; k_pages/v_pages [B, mp, page, KVH, D]; token_valid
    [B, mp, page] bool. Returns fp32 partials o [B, H, D], l [B, H],
    m [B, H] for the stable merge (the EPU aggregation of ITPP).
    """
    B, mp, page, KVH, D = k_pages.shape
    H = q.shape[1]
    G = H // KVH
    qf = q.reshape(B, KVH, G, D).float()
    kf = k_pages.reshape(B, mp * page, KVH, D).float()
    vf = v_pages.reshape(B, mp * page, KVH, D)
    s = torch.einsum("bkgd,btkd->bkgt", qf, kf) / math.sqrt(D)
    mask = token_valid.reshape(B, 1, 1, mp * page)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                    # [B,KVH,G]
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v_pages.dtype).float(),
                     vf.float())
    return o.reshape(B, H, D), l.reshape(B, H), m.reshape(B, H)


def merge_partials(o, l, m):
    """Stable softmax merge of a leading stacked dim of partials
    (o [N, B, H, D] etc.) — the single-device form of the ITPP/EPU
    aggregation."""
    mg = m.amax(dim=0)
    corr = torch.exp(m - mg[None])
    lg = (l * corr).sum(dim=0)
    og = (o * corr[..., None]).sum(dim=0)
    return og / lg.clamp_min(1e-30)[..., None]
