"""Kernel dispatch for the model, and the decode write-target resolution.

Port of the parts of ``repro/kernels/ops.py`` this slice runs:

* ``write_targets`` — per-step Va2Pa write-target resolution, bit-exact
  with the JAX version; idle / frozen slots target page ``n_pages``, the
  pool's trash page (see ``core/paged_kv.py``), so their write lands where
  nothing reads it;
* ``attention_fwd`` — prefill attention: the flash-attention kernel
  wrapper (CUDA kernel on a card, plain version on CPU tensors) unless the
  ``KernelConfig`` asks for the plain path;
* ``mamba_mixer`` — the Mamba2 scan: the chunk-scan kernel wrapper under
  the same rule, ``models.ssm.chunked_gla`` on the plain path;
* ``cross_attention_decode`` — an enc-dec decode step's cross-attention
  over the contiguous encoder rows (every position valid): the
  flash-decode kernel's split-K partials (``itpp_partials``) and their
  merge, or ``layers.decode_attention_ref`` on the plain path, as in JAX;
* ``verify_attention`` — a speculative round's multi-query attention:
  the paged split-K kernel in its ``qpos > 1`` mode (one pass scores the
  pending token and every proposal), or ``ref.paged_attention_verify_ref``
  on the plain path;
* ``decode_attention``, ``paged_decode_step``, ``itpp_partials`` and
  ``merge_partials`` — the calls the kernel bench
  (``launch/kernel_bench.py``) times. JAX's ``use_pallas`` maps onto
  ``KernelConfig.use_kernels`` (default: the kernel wrappers, which
  dispatch by tensor device); ``use_kernels=False`` selects the plain
  reference (``kernels/ref.py``, or the gather-then-dense decode).
"""
from __future__ import annotations

import torch

from repro_torch.core.itpp import itpp_decode_attention_shard
from repro_torch.kernels import ref as REF
from repro_torch.kernels.backend import KernelConfig
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_verify)
from repro_torch.kernels.ssm_scan import ssm_chunk_scan
from repro_torch.models.layers import decode_attention_ref, flash_attention
from repro_torch.models.ssm import chunked_gla, mask_log_gates_tail


def write_targets(block_table, ctx, run, *, page_size: int, n_pages: int,
                  ring_width: int = 0):
    """Resolve the KV write target for each slot's incoming token.

    ``block_table`` [B, W] int32 Va2Pa; ``ctx`` [B] context INCLUDING the
    incoming token; ``run`` [B] bool — slots decoding this step. Inactive /
    frozen slots target page ``n_pages`` (the trash page). Returns
    (npage [B], noff [B]) int32.
    """
    B, W = block_table.shape
    t = (ctx.to(torch.int32) - 1).clamp_min(0)
    vp = t // page_size
    if ring_width:
        vp = vp % ring_width
    rows = torch.arange(B, device=block_table.device)
    npage = block_table[rows, vp.clamp_max(W - 1).long()]
    npage = torch.where(run, npage, n_pages).to(torch.int32)
    noff = torch.where(run, t % page_size, 0).to(torch.int32)
    return npage, noff


def attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset=0, kernels: KernelConfig | None = None):
    """Forward attention for prefill: [B,S,H,D] x [B,Skv,KVH,D] -> [B,S,H,D].
    ``kernels=None`` or ``use_kernels=False`` is the plain path."""
    if kernels is not None and kernels.enabled:
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def mamba_mixer(q, k, v, log_a, log_g, *, chunk: int = 128, state=None,
                valid_len=None, kernels: KernelConfig | None = None):
    """Chunked selective scan -> (y [B,S,H,P] fp32, (C, n, m)).

    ``state`` = (C [B,H,N,P], n [B,H,N], m [B,H]) resumes a sequence at a
    chunk boundary (None = fresh); ``m`` passes through unchanged, as in
    ``chunked_gla(normalize=False)``. ``valid_len`` [B] masks
    length-bucketed end-padding out of the returned state. ``kernels=None``
    or ``use_kernels=False`` is the plain path."""
    if valid_len is not None:
        log_a, log_g = mask_log_gates_tail(log_a, log_g, valid_len)
    if kernels is not None and kernels.enabled:
        y, (C, n) = ssm_chunk_scan(q, k, v, log_a, log_g, chunk=chunk,
                                   state=None if state is None
                                   else state[:2])
        m = (torch.zeros(C.shape[:2], dtype=torch.float32, device=C.device)
             if state is None else state[2])
        return y, (C, n, m)
    return chunked_gla(q, k, v, log_a, log_g, chunk=chunk, normalize=False,
                       state=state)


DEFAULT_KERNELS = KernelConfig()


def decode_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                     kernels: KernelConfig = DEFAULT_KERNELS):
    """Full-attention decode over the paged pool: q [B, KVH, G, D] ->
    [B, KVH, G, D] (q.dtype). The paged split-K kernel with
    ``kernels.n_splits`` splits, merged, or the gather-then-dense oracle
    when ``use_kernels=False``."""
    if kernels.enabled:
        return paged_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                               n_splits=kernels.n_splits)
    return REF.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   ctx_lens).to(q.dtype)


def verify_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                     window=None, kernels: KernelConfig | None = None):
    """Speculative-verify multi-query attention over the decode table.

    q [B, KVH, G, T, D]: T consecutive query positions a slot (the pending
    token and the draft's proposals), query t at position ``ctx - 1 + t``;
    ctx_lens counts tokens INCLUDING the first query token. The paged
    split-K kernel scores all T rows in one pass (``qpos = T``);
    ``kernels=None`` or ``use_kernels=False`` is the gather-then-dense
    oracle. Returns [B, KVH, G, T, D] in q.dtype."""
    if kernels is not None and kernels.enabled:
        return paged_attention_verify(q, k_pages, v_pages, block_tables,
                                      ctx_lens, window=window,
                                      n_splits=kernels.n_splits)
    return REF.paged_attention_verify_ref(
        q, k_pages, v_pages, block_tables, ctx_lens,
        window=window).to(q.dtype)


def paged_decode_step(q, k_new, v_new, pool_k, pool_v, block_table, ctx_len,
                      new_page, new_off, window=0, *, ring_width: int = 0,
                      cond_window: int = 0,
                      kernels: KernelConfig = DEFAULT_KERNELS):
    """One decode step's attention against the paged pool, single shard:
    the incoming token's K/V write and the attention in one call.
    q [B, H, D]; k_new/v_new [B, KVH, D]; pool_{k,v} [P+1, page, KVH, D]
    (trash page last, written in place); block_table [B, maxp]; ctx_len
    [B] (INCLUDING the new token). Returns (out [B, H, D], pool_k,
    pool_v)."""
    return itpp_decode_attention_shard(
        q, k_new, v_new, pool_k, pool_v, block_table, ctx_len, new_page,
        new_off, window, max_pages_per_req=block_table.shape[1],
        ring_width=ring_width, cond_window=cond_window, kernels=kernels)


def itpp_partials(q, k, v, ctx_lens, *, n_splits: int = 8,
                  kernels: KernelConfig = DEFAULT_KERNELS):
    """Split-K partials (o, l, m) for the stable ITPP/EPU merge: the
    flash-decode kernel wrapper, or ``ref.flash_decode_ref`` when
    ``use_kernels=False``."""
    if kernels.enabled:
        return flash_decode(q, k, v, ctx_lens, n_splits=n_splits)
    return REF.flash_decode_ref(q, k, v, ctx_lens, n_splits)


def merge_partials(o, l, m):
    return REF.merge_flash_partials(o, l, m)


# the token splits of a cross-attention decode: whisper's 1500 encoder rows
# cut into splits of 188 (the tail split 184, padded), 8 x B x KVH blocks
CROSS_SPLITS = 8


def cross_attention_decode(q, k, v, ctx, *,
                           kernels: KernelConfig | None = None):
    """One query token a row against contiguous cross K/V, every position
    valid: q [B, H, D]; k/v [B, T, KVH, D]; ctx [B] int32, T on every row
    (made once a step by the caller) -> [B, H, D] in q.dtype.

    With kernels on: ``itpp_partials`` at ``CROSS_SPLITS`` splits (the
    flash-decode kernel on a card, its plain version on CPU tensors) and
    ``merge_partials``. ``kernels=None`` or ``use_kernels=False``:
    ``layers.decode_attention_ref``, the call JAX's decode block makes.
    Nothing here reads the host, so it runs inside a captured horizon."""
    B, H, D = q.shape
    KVH = k.shape[2]
    if kernels is not None and kernels.enabled:
        o, l, m = itpp_partials(q.reshape(B, KVH, H // KVH, D).contiguous(),
                                k, v, ctx, n_splits=CROSS_SPLITS,
                                kernels=kernels)
        return merge_partials(o, l, m).reshape(B, H, D).to(q.dtype)
    return decode_attention_ref(q, k, v, ctx)
