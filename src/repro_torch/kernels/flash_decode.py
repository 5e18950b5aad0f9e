"""ITPP split-K decode partials over a contiguous cache: the CUDA kernel and
its plain version.

Port of ``repro/kernels/flash_decode.py`` (the Pallas TPU kernel
``_kernel`` / ``flash_decode``): the paper's token-partitioned attention.
The cache of each (batch row, kv head) is cut along the token axis into
``n_splits`` splits of ``ceil(T / n_splits)`` tokens, and each split emits
UNNORMALIZED fp32 partials ``(o, l, m)`` for the stable log-sum-exp merge
(``ref.merge_flash_partials``). The tail split is short (JAX zero-pads it)
and the context is clamped to ``T``, so pad tokens are never live. A split
with no live token emits ``m = -1e30, l = 0, o = 0``, so a ``ctx = 0`` row
merges to 0, not NaN.

* CUDA tensors launch ``csrc/flash_decode.cu`` (one thread block per
  (split, batch row, kv head), walking the live part of its split in
  64-token shared-memory tiles; see the note in the source). Each launch is
  counted in ``flash_decode.launches``.
* CPU tensors take ``flash_decode_plain``: the same function with the same
  split boundaries, written as dense PyTorch.

It carries ``ops.itpp_partials``, which the kernel bench
(``launch/kernel_bench.py``) times; no serving path of ``repro`` calls it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import require_hopper
from repro_torch.kernels.ref import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 128
MAX_G = 32
MAX_SMEM = 232448          # dynamic shared memory a block may use (bytes)


def _check(q, k, v, ctx_lens, n_splits: int):
    """(B, KVH, G, D, T, split) after checking the shapes."""
    if q.dim() != 4:
        raise ValueError(f"flash_decode: q must be [B, KVH, G, D], got "
                         f"{tuple(q.shape)}")
    B, KVH, G, D = q.shape
    T = k.shape[1]
    if tuple(k.shape) != (B, T, KVH, D) or v.shape != k.shape \
            or tuple(ctx_lens.shape) != (B,):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} ctx "
                         f"{tuple(ctx_lens.shape)} do not match")
    if n_splits < 1 or T < 1:
        raise ValueError(f"flash_decode: need n_splits >= 1 and T >= 1, got "
                         f"n_splits={n_splits}, T={T}")
    return B, KVH, G, D, T, -(-T // n_splits)


def flash_decode_plain(q, k, v, ctx_lens, *, n_splits: int = 8):
    """The kernel's function in dense PyTorch: the same splits (the tail
    split padded with dead tokens), the same ctx clamp, the same partial
    layout."""
    B, KVH, G, D, T, split = _check(q, k, v, ctx_lens, n_splits)
    S = n_splits
    pad = (0, 0, 0, 0, 0, S * split - T)
    ks = torch.nn.functional.pad(k.float(), pad).reshape(B, S, split, KVH, D)
    vs = torch.nn.functional.pad(v.float(), pad).reshape(B, S, split, KVH, D)
    ctx = ctx_lens.long().clamp_max(T)
    tok = torch.arange(S * split, device=q.device).reshape(S, split)
    ok = (tok[None] < ctx[:, None, None])[:, None, None]     # [B,1,1,S,split]
    sc = torch.einsum("bhgd,bsthd->bhgst", q.float(), ks) / math.sqrt(D)
    sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(-1)                                          # [B,KVH,G,S]
    p = torch.where(ok, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    l = p.sum(-1)
    o = torch.einsum("bhgst,bsthd->bhgsd", p, vs)
    return (o.permute(3, 0, 1, 2, 4).contiguous(),
            l.permute(3, 0, 1, 2).contiguous(),
            m.permute(3, 0, 1, 2).contiguous())


def _lib():
    lib = build.load("flash_decode")
    fn = lib.flash_decode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.flash_decode_smem.restype = ctypes.c_longlong
        lib.flash_decode_smem.argtypes = [ctypes.c_int] * 2
    return lib


def _launch(q, k, v, ctx_lens, *, n_splits: int):
    require_hopper(q, "flash_decode")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    B, KVH, G, D, T, split = _check(q, k, v, ctx_lens, n_splits)
    if D > MAX_D or G > MAX_G:
        raise ValueError(f"flash_decode: the kernel takes D <= {MAX_D} and "
                         f"G <= {MAX_G}, got D={D}, G={G}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
    lib = _lib()
    smem = lib.flash_decode_smem(G, D)
    if smem > MAX_SMEM:
        raise ValueError(f"flash_decode: G={G}, D={D} needs {smem} B of "
                         f"shared memory a block (max {MAX_SMEM})")
    dev = q.device
    ctx = ctx_lens.to(device=dev, dtype=torch.int32).contiguous()
    S = n_splits
    o = torch.empty((S, B, KVH, G, D), dtype=torch.float32, device=dev)
    l = torch.empty((S, B, KVH, G), dtype=torch.float32, device=dev)
    m = torch.empty_like(l)
    p = build.ptr
    err = lib.flash_decode(_DTYPES[q.dtype], p(q), p(k), p(v), p(ctx), p(o),
                           p(l), p(m), B, KVH, G, D, T, S, split,
                           build.stream_ptr(dev))
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return o, l, m


def flash_decode(q, k, v, ctx_lens, *, n_splits: int = 8):
    """q [B, KVH, G, D]; k/v [B, T, KVH, D]; ctx_lens [B].

    ``T`` need not divide ``n_splits``: the tail split is short and
    ``ctx`` is clamped to ``T``, so no pad token is ever live. Returns
    per-split fp32 partials (o [S,B,KVH,G,D], l [S,B,KVH,G],
    m [S,B,KVH,G]) for the stable ITPP merge (``ref.merge_flash_partials``
    / ``core.paged_kv.merge_partials``).
    """
    n_splits = int(n_splits)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, ctx_lens, n_splits=n_splits)
    return _launch(q, k, v, ctx_lens, n_splits=n_splits)


flash_decode.launches = 0
