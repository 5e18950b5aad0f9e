"""Paged split-K decode attention: the CUDA kernel and its plain version.

Port of ``repro/kernels/paged_attention.py`` (the Pallas TPU kernel
``_partials_kernel`` / ``paged_attention_partials``). Decode attention reads
the paged pool through the Va2Pa block table and emits UNNORMALIZED fp32
``(o, l, m)`` partials per split for the log-sum-exp (EPU) merge. A table
slot is dead — it costs nothing — when its page is ``-1``, lies past the
context, lies wholly below the sliding window, or is an unwritten ring
slot.

* CUDA tensors launch ``csrc/paged_attention.cu`` (one thread block per
  (split, batch row, kv head), walking that split's table slots and
  streaming the live pages through a ring of shared-memory stages filled
  by asynchronous copies - several pages a stage, or sub-tiles of a long
  page, so any page size launches; see the note in the source). Rows must
  be whole 16-byte copies (``D * itemsize % 16 == 0``) and the pools
  16-byte aligned. A block holds at most ``MAX_ROWS`` q rows; a call with
  more (``G * qpos``: a speculative verify pass) launches once a row tile
  (``row_tiles``, ``partials_by_row_tiles``), each tile at its row offset.
  The wrapper counts each launch in ``paged_attention_partials.launches``
  (and a ``windowed_slice`` launch also in ``.launches_windowed``).
* CPU tensors take ``paged_attention_partials_plain``: the same function
  with the same split boundaries, tail padding and liveness rules, written
  as dense PyTorch, so the CPU tests exercise the kernel path's
  bookkeeping.

Feature matrix, as on the TPU: a per-row ``[B]`` window, ``ring_width``
pools, the ``windowed_slice`` slot map of the cond_window trick, GQA
(``G >= 1`` query rows per kv head, K/V never repeated) and ``qpos > 1``
multi-query verify, where row ``r`` sits at position ``ctx - 1 + r % qpos``.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import require_aligned, require_hopper
from repro_torch.kernels.ref import NEG_INF, combine_partials

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 128
MAX_ROWS = 32
MAX_SMEM = 232448          # dynamic shared memory a block may use (bytes)
_COUNT_LOCK = threading.Lock()


def _window_rows(window, B: int, device) -> torch.Tensor:
    """int32 [B] window per row (a fill on the device for an int, so the
    decode loop makes no host-to-device copy)."""
    if not torch.is_tensor(window):
        return torch.full((B,), int(window or 0), dtype=torch.int32,
                          device=device)
    return window.to(device=device, dtype=torch.int32).reshape(-1) \
        .expand(B).contiguous()


def _split_geometry(W: int, n_splits: int) -> tuple[int, int]:
    """(S, K): S splits of K table slots each; the tail split is padded with
    dead slots when S*K > W (as the TPU wrapper pads with -1)."""
    S = max(1, min(int(n_splits), W))
    return S, -(-W // S)


def row_tiles(rows: int) -> list[tuple[int, int]]:
    """``(row0, n)`` tiles of at most ``MAX_ROWS`` rows, cut evenly, that
    cover ``[0, rows)``: the launches of one call with more q rows than a
    block holds. A tile may start mid-group (``row0 % qpos != 0``)."""
    n_tiles = max(1, -(-rows // MAX_ROWS))
    size = -(-rows // n_tiles)
    return [(r0, min(size, rows - r0)) for r0 in range(0, rows, size)]


def partials_by_row_tiles(launch, rows: int, o, l, m):
    """Fill the partials ``o [S, B, KVH, rows, D]``, ``l`` and ``m`` ``[S,
    B, KVH, rows]`` one row tile at a time: ``launch(row0, n, o, l, m)``
    writes rows ``[row0, row0 + n)``. The kernel path passes its launch;
    the tests pass the plain version at a row offset."""
    for row0, n in row_tiles(rows):
        launch(row0, n, o, l, m)
    return o, l, m


def paged_attention_partials_plain(q, k_pages, v_pages, block_tables,
                                   ctx_lens, window, *, ring_width: int,
                                   windowed_slice: bool, n_splits: int,
                                   qpos: int, row0: int = 0):
    """The kernel's function in dense PyTorch: same splits, same dead-slot
    rules, same partial layout. ``window`` is an int32 [B] tensor. ``q``'s
    rows are rows ``row0..`` of a larger q (one row tile): row r sits at
    ``ctx - 1 + (row0 + r) % qpos``."""
    B, KVH, R, D = q.shape
    page = k_pages.shape[1]
    W = block_tables.shape[1]
    S, K = _split_geometry(W, n_splits)
    dev = q.device
    bt = block_tables.long()
    if S * K != W:
        bt = torch.cat([bt, bt.new_full((B, S * K - W), -1)], dim=1)
    slot = torch.arange(S * K, device=dev)[None]              # [1, SK]
    ctx = ctx_lens.long()[:, None]                            # [B, 1]
    w = window.long()[:, None]
    if ring_width:
        cur = torch.div(ctx - 1, page, rounding_mode="floor")
        vp = cur - torch.remainder(cur - slot, ring_width)
    elif windowed_slice:
        vp = (ctx - w).clamp_min(0) // page + slot
    else:
        vp = slot.expand(B, -1)
    lo_tok = torch.where(w > 0, ctx - w, 0)
    live = ((bt >= 0) & (vp >= 0) & (vp * page < ctx + qpos - 1)
            & ((vp + 1) * page > lo_tok))                     # [B, SK]
    safe = bt.clamp_min(0)
    k = k_pages[safe].float()                                 # [B,SK,page,KVH,D]
    v = v_pages[safe].float()
    tok = vp[..., None] * page + torch.arange(page, device=dev)  # [B,SK,page]
    hi = ctx + ((row0 + torch.arange(R, device=dev)) % qpos)[None]  # [B, R]
    lo = torch.where(w > 0, hi - w, 0)
    ok = (live[:, None, :, None]
          & (tok[:, None] < hi[:, :, None, None])
          & (tok[:, None] >= lo[:, :, None, None]))          # [B,R,SK,page]
    sc = torch.einsum("bhrd,bjthd->bhrjt", q.float(), k) / math.sqrt(D)
    ok = ok[:, None]                                          # [B,1,R,SK,page]
    sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
    sc = sc.reshape(B, KVH, R, S, K * page)
    ok = ok.reshape(B, 1, R, S, K * page)
    m = sc.amax(-1)                                           # [B,KVH,R,S]
    p = torch.where(ok, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    l = p.sum(-1)
    vs = v.reshape(B, S, K * page, KVH, D)
    o = torch.einsum("bhrsx,bsxhd->bhrsd", p, vs)
    return (o.permute(3, 0, 1, 2, 4).contiguous(),
            l.permute(3, 0, 1, 2).contiguous(),
            m.permute(3, 0, 1, 2).contiguous())


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_partials
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 13 + [ctypes.c_void_p])
        lib.paged_attention_smem.restype = ctypes.c_longlong
        lib.paged_attention_smem.argtypes = [ctypes.c_int] * 2
    return lib


def _launch(q, k_pages, v_pages, bt, ctx, win, *, ring_width, windowed_slice,
            n_splits, qpos):
    require_hopper(q, "paged_attention_partials")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention_partials: q/k/v must share float32 "
                        f"or bfloat16, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    B, KVH, R, D = q.shape
    P, page = k_pages.shape[:2]
    if k_pages.shape != (P, page, KVH, D) or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention_partials: pages {tuple(k_pages.shape)}"
                         f" / {tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if D > MAX_D:
        raise ValueError(f"paged_attention_partials: the kernel takes D <= "
                         f"{MAX_D}, got D={D}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_partials: {name} must be "
                             "contiguous")
    require_aligned("paged_attention_partials", D,
                    {"k_pages": k_pages, "v_pages": v_pages})
    lib = _lib()
    tile = max(n for _, n in row_tiles(R))
    smem = lib.paged_attention_smem(tile, D)
    if smem > MAX_SMEM:
        raise ValueError(f"paged_attention_partials: a tile of {tile} rows "
                         f"at D={D} needs {smem} B of shared memory a block "
                         f"(max {MAX_SMEM})")
    W = bt.shape[1]
    S, K = _split_geometry(W, n_splits)
    bt = bt.to(torch.int32).contiguous()
    ctx = ctx.to(torch.int32).contiguous()
    o = torch.empty((S, B, KVH, R, D), dtype=torch.float32, device=q.device)
    l = torch.empty((S, B, KVH, R), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    p = build.ptr
    stream = build.stream_ptr(q.device)

    def launch(row0, n, o, l, m):
        err = lib.paged_attention_partials(
            _DTYPES[q.dtype], p(q), p(k_pages), p(v_pages), p(bt), p(ctx),
            p(win), p(o), p(l), p(m), B, KVH, n, R, row0, D, page, W, S, K,
            int(ring_width), int(bool(windowed_slice)), int(qpos), stream)
        build.check(err, "paged_attention_partials")
        with _COUNT_LOCK:       # shard threads of a LocalMesh launch too
            paged_attention_partials.launches += 1
            if windowed_slice:
                paged_attention_partials.launches_windowed += 1

    return partials_by_row_tiles(launch, R, o, l, m)


def paged_attention_partials(q, k_pages, v_pages, block_tables, ctx_lens, *,
                             window=None, ring_width: int = 0,
                             windowed_slice: bool = False, n_splits: int = 1,
                             qpos: int = 1):
    """Split-K decode-attention partials over a paged pool.

    q [B, KVH, G, D]; k_pages/v_pages [P, page, KVH, D];
    block_tables [B, W] int32 — physical page per table slot, ``-1`` = dead;
    ctx_lens [B] int32 tokens INCLUDING the current one; ``window`` [B] or
    scalar (0 = full); ``ring_width``/``windowed_slice`` per the module
    docstring (mutually exclusive). ``qpos > 1``: the q axis is read as
    ``G_real * qpos`` rows, row ``r`` attending at ``ctx - 1 + r % qpos``.
    Returns fp32 UNNORMALIZED partials (o [S, B, KVH, G, D],
    l [S, B, KVH, G], m [S, B, KVH, G]). A split with no live slot emits
    ``m = -1e30, l = 0, o = 0``.
    """
    if ring_width and windowed_slice:
        raise ValueError("ring_width and windowed_slice are exclusive")
    if qpos != 1 and (ring_width or windowed_slice):
        raise ValueError("multi-query verify runs on plain paged tables only")
    if windowed_slice and window is None:
        raise ValueError("windowed_slice slot mapping is defined by the "
                         "window bound")
    win = _window_rows(window, q.shape[0], q.device)
    kw = dict(ring_width=ring_width, windowed_slice=windowed_slice,
              n_splits=n_splits, qpos=qpos)
    if q.device.type == "cpu":
        return paged_attention_partials_plain(q, k_pages, v_pages,
                                              block_tables, ctx_lens, win,
                                              **kw)
    return _launch(q, k_pages, v_pages, block_tables, ctx_lens, win, **kw)


paged_attention_partials.launches = 0
paged_attention_partials.launches_windowed = 0   # of them, windowed_slice


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    window=None, ring_width: int = 0, n_splits: int = 1):
    """Full (normalized) decode attention — partials merged on-device.
    q [B, KVH, G, D] -> [B, KVH, G, D] in q.dtype."""
    o, l, m = paged_attention_partials(
        q, k_pages, v_pages, block_tables, ctx_lens, window=window,
        ring_width=ring_width, n_splits=n_splits)
    o, l, _ = combine_partials(o, l, m)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def paged_attention_verify(q, k_pages, v_pages, block_tables, ctx_lens, *,
                           window=None, n_splits: int = 1):
    """Multi-query verify attention for speculative decode (normalized).
    q [B, KVH, G, T, D], query t at position ``ctx - 1 + t`` -> same shape
    in q.dtype. The T axis folds into the kernel's q-row axis (``qpos``)."""
    B, KVH, G, T, D = q.shape
    o, l, m = paged_attention_partials(
        q.reshape(B, KVH, G * T, D), k_pages, v_pages, block_tables,
        ctx_lens, window=window, n_splits=n_splits, qpos=T)
    o, l, _ = combine_partials(o, l, m)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, KVH, G, T, D).to(q.dtype)
