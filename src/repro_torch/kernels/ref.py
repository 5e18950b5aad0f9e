"""Plain PyTorch oracles for the kernels (ports of ``repro/kernels/ref.py``):
the ground truth the tests hold both packages to."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gather_tokens(pages, block_tables):
    """[P, page, KVH, D] pool, [B, W] table -> [B, W*page, KVH, D] fp32
    (-1 entries read page 0; callers mask them by context)."""
    B, W = block_tables.shape
    safe = block_tables.clamp_min(0).long()
    page = pages.shape[1]
    return pages[safe].reshape(B, W * page, *pages.shape[2:]).float()


def paged_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens):
    """Decode attention over a paged pool.

    q [B, KVH, G, D]; k_pages/v_pages [P, page, KVH, D];
    block_tables [B, maxp]; ctx_lens [B] (valid tokens incl. current).
    Returns [B, KVH, G, D] fp32.
    """
    D = q.shape[-1]
    k = _gather_tokens(k_pages, block_tables)
    v = _gather_tokens(v_pages, block_tables)
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k) / math.sqrt(D)
    tok = torch.arange(k.shape[1], device=q.device)[None]
    ok = tok < ctx_lens.long()[:, None]
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p, v)


def paged_attention_verify_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                               window=None):
    """Multi-query verify attention over a paged pool (speculative decode).

    q [B, KVH, G, T, D] — T consecutive query positions per slot, query t
    sitting at position ``ctx - 1 + t``; ctx_lens [B] counts tokens
    INCLUDING the first query token, so query t attends to tok < ctx + t
    (and >= ctx + t - window when windowed). Returns [B, KVH, G, T, D] fp32.
    """
    B, KVH, G, T, D = q.shape
    k = _gather_tokens(k_pages, block_tables)
    v = _gather_tokens(v_pages, block_tables)
    s = torch.einsum("bkgqd,btkd->bkgqt", q.float(), k) / math.sqrt(D)
    tok = torch.arange(k.shape[1], device=q.device)[None, None]
    hi = (ctx_lens.long()[:, None, None]
          + torch.arange(T, device=q.device)[None, :, None])
    ok = tok < hi                                        # [B, T, W*page]
    if torch.is_tensor(window):
        w = window.to(device=q.device, dtype=torch.long)
        w = w.reshape(-1).expand(B)[:, None, None]
        ok = ok & torch.where(w > 0, tok >= hi - w, True)
    elif window:
        # an int window stays a host scalar: a captured verify pass copies
        # nothing to the card
        ok = ok & (tok >= hi - int(window))
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqt,btkd->bkgqd", p, v)


def flash_decode_ref(q, k, v, ctx_len, n_splits: int):
    """ITPP split-K decode partials oracle.

    q [B, KVH, G, D]; k/v [B, T, KVH, D]; ctx_len [B]. ``T`` need not divide
    ``n_splits``: the tail split is zero-padded and masked (same split
    boundaries as the kernel, so partials compare elementwise).
    Returns per-split partials (o [S,B,KVH,G,D], l [S,B,KVH,G], m [S,...])
    whose stable merge equals full attention.
    """
    B, KVH, G, D = q.shape
    T = k.shape[1]
    w = -(-T // n_splits)
    if w * n_splits != T:
        pad = (0, 0, 0, 0, 0, w * n_splits - T)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    ctx_len = ctx_len.long().clamp_max(T)     # pad tokens are never live
    outs, ls, ms = [], [], []
    for s in range(n_splits):
        ks = k[:, s * w:(s + 1) * w].float()
        vs = v[:, s * w:(s + 1) * w].float()
        sc = torch.einsum("bkgd,btkd->bkgt", q.float(), ks) / math.sqrt(D)
        tok = s * w + torch.arange(w, device=q.device)
        ok = (tok[None] < ctx_len[:, None])[:, None, None, :]
        sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
        m = sc.amax(-1)
        p = torch.where(ok, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        outs.append(torch.einsum("bkgt,btkd->bkgd", p, vs))
        ls.append(p.sum(-1))
        ms.append(m)
    return torch.stack(outs), torch.stack(ls), torch.stack(ms)


def combine_partials(o, l, m):
    """Merge the leading split axis of (o, l, m) partials WITHOUT
    normalizing — the result is itself a valid partial (associativity of
    the EPU aggregation)."""
    mg = m.amax(0)
    c = torch.exp(m - mg[None])
    return (o * c[..., None]).sum(0), (l * c).sum(0), mg


def merge_flash_partials(o, l, m):
    """(S,...) partials -> merged attention output (log-sum-exp merge)."""
    og, lg, _ = combine_partials(o, l, m)
    return og / lg.clamp_min(1e-30)[..., None]


def ssm_chunk_scan_ref(q, k, v, log_a, log_g, h0, chunk: int):
    """Chunked GLA oracle — wraps ``models.ssm.chunked_gla`` with
    normalize=False. ``h0`` = (C, n, m) or None."""
    from repro_torch.models.ssm import chunked_gla
    return chunked_gla(q, k, v, log_a, log_g, chunk=chunk, normalize=False,
                       state=h0)
