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
* ``decode_attention``, ``paged_decode_step``, ``itpp_partials`` and
  ``merge_partials`` — the calls the kernel bench
  (``launch/kernel_bench.py``) times. JAX's ``use_pallas`` maps onto
  ``KernelConfig.use_kernels`` (default: the kernel wrappers, which
  dispatch by tensor device); ``use_kernels=False`` selects the plain
  reference (``kernels/ref.py``, or the gather-then-dense decode).

``verify_attention`` waits for speculative decoding (ROADMAP A.8).
"""
from __future__ import annotations

import torch

from repro_torch.core.itpp import itpp_decode_attention_shard
from repro_torch.kernels import ref as REF
from repro_torch.kernels.backend import KernelConfig
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ssm_scan import ssm_chunk_scan
from repro_torch.models.layers import flash_attention
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
