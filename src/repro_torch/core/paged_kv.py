"""DPA-style paged KV cache: page pool + Va2Pa block tables.

Port of ``repro/core/paged_kv.py``. The pool is a fixed set of pages;
block tables and context lengths are runtime data, so one program serves
every context length and memory grows page by page.

The port updates the pool IN PLACE (the JAX functions return new arrays;
here they return the same tensors they were given, written). That covers
the page operations of the KV-cache hierarchy too (``gather_pages``,
``scatter_pages``, ``copy_page``): the pool is never rebound, because
every captured decode horizon (``serving/graphs.py``) holds its address.

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


def pool_spec_for(cfg, shape, parallel, *, n_shards: int,
                  slack_pages: int = 0) -> PoolSpec:
    """Pool geometry of a (ModelConfig, ShapeConfig, ParallelConfig) cell
    over ``n_shards`` page shards (repro's ``pool_spec_for``, which reads
    the shard count from its ParallelConfig): a page a request beyond its
    tokens, the page count rounded up to the shards; a stack whose
    attention layers are all windowed gets a ring capped by the window."""
    kinds = cfg.block_kinds()
    n_attn = sum(1 for k in kinds if k in ("attn", "local"))
    if cfg.family == "encdec":
        n_attn = cfg.n_layers
    ps = parallel.page_size
    all_windowed = n_attn > 0 and all(
        k == "local" for k in kinds if k in ("attn", "local"))
    ring = bool(all_windowed and cfg.sliding_window
                and shape.seq_len > cfg.sliding_window)
    eff_len = min(shape.seq_len, cfg.sliding_window + ps) if ring \
        else shape.seq_len
    per_req = -(-eff_len // ps) + 1          # ceil + 1 growth page
    n_pages = shape.global_batch * per_req + slack_pages
    n_pages = -(-n_pages // n_shards) * n_shards
    return PoolSpec(n_layers=max(n_attn, 1), n_pages=n_pages, page_size=ps,
                    n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                    max_pages_per_req=per_req, dtype=cfg.dtype, ring=ring)


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


def _page_index(page_ids, pool) -> torch.Tensor:
    """Page ids as a long index on the pool's device; ids outside the real
    pages name the trash page."""
    ids = torch.as_tensor(page_ids, dtype=torch.long)
    return _to_trash(ids.to(pool.device, non_blocking=True),
                     pool.shape[1] - 1)


def gather_pages(pool_k, pool_v, page_ids):
    """Lift whole pages out of the pool (host-offload swap-out, preemption
    snapshots).

    pool_{k,v} [L, P+1, page, KVH, D]; page_ids [n]. Returns NEW tensors
    k, v [L, n, page, KVH, D] on the pool's device: a snapshot that later
    writes to those pages do not touch (stream order makes the gather read
    them first). Ids outside the real pages read the trash page.
    """
    ix = _page_index(page_ids, pool_k)
    return pool_k.index_select(1, ix), pool_v.index_select(1, ix)


def scatter_pages(pool_k, pool_v, page_ids, k_data, v_data):
    """Write whole pages back into the pool, in place (swap-in, snapshot
    restore, host-side copy-on-write).

    page_ids [n]; k_data/v_data [L, n, page, KVH, D] on the pool's device.
    Ids outside the real pages land on the trash page. The pool tensors
    are never rebound: captured decode graphs hold their addresses.
    """
    ix = _page_index(page_ids, pool_k)
    pool_k.index_copy_(1, ix, k_data.to(pool_k.dtype))
    pool_v.index_copy_(1, ix, v_data.to(pool_v.dtype))
    return pool_k, pool_v


def copy_page(pool_k, pool_v, src: int, dst: int):
    """Device-side page copy (copy-on-write divergence): page ``dst`` :=
    page ``src`` across all layers, in place."""
    pool_k[:, dst].copy_(pool_k[:, src])
    pool_v[:, dst].copy_(pool_v[:, src])
    return pool_k, pool_v


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


def merge_partials(o, l, m, *, axis=None):
    """Stable softmax merge of partials (the ITPP/EPU aggregation).

    With ``axis`` (a mesh axis name or tuple) it merges across the shards
    of that axis from inside a shard body (``distributed/mesh.py``: pmax,
    then psum of the rescaled l and o, from one all-gather). With
    ``axis=None`` it merges a leading stacked dim (o [N, B, H, D] etc.),
    the single-device form."""
    if axis is None:
        mg = m.amax(dim=0)
        corr = torch.exp(m - mg[None])
        lg = (l * corr).sum(dim=0)
        og = (o * corr[..., None]).sum(dim=0)
    else:
        from repro_torch.distributed import mesh as M
        # one all-gather of the packed partials, then the pmax and the
        # psums of the rescaled l and o over the members, in group order
        n = M.axis_size(axis)
        parts = M.all_gather(torch.cat([o.flatten(), l.flatten(),
                                        m.flatten()]), axis)
        og_, lg_, mg_ = parts.split([o.numel(), l.numel(), m.numel()], 1)
        o_all = og_.reshape(n, *o.shape)
        l_all = lg_.reshape(n, *l.shape)
        m_all = mg_.reshape(n, *m.shape)
        corr = torch.exp(m_all - m_all.amax(0)[None])
        lg = (l_all * corr).sum(0)
        og = (o_all * corr[..., None]).sum(0)
    return og / lg.clamp_min(1e-30)[..., None]
