"""Prefill flash attention: the CUDA kernel and its plain version.

Port of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel
``_kernel`` / ``flash_attention_fwd``): causal / windowed GQA forward
attention with a normalised output, ``[B, Sq, H, D] x [B, Skv, KVH, D]``.
It carries the model's prefill and chunked-prefill attention
(``models/model.py``), where the JAX model calls the jnp
``layers.flash_attention`` — the same function.

* CUDA tensors launch ``csrc/flash_attention.cu`` (one thread block per
  (batch row, kv head, query tile), all G query heads of the kv head
  together; see the note in the source). Each launch is counted in
  ``flash_attention_fwd.launches``.
* CPU tensors take the plain version, ``flash_attention_plain``
  (= ``models.layers.flash_attention``).

Unlike the TPU kernel, this one takes a per-row ``[B]`` ``q_offset`` and
masks a ragged ``Sq`` / ``Skv`` instead of asserting divisibility — both
needed by ``prefill_chunk``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import require_hopper
from repro_torch.models.layers import flash_attention as flash_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 128
MAX_GROUP = 64


def _lib():
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return fn


def _launch(q, k, v, *, causal: bool, window: int, q_offset):
    require_hopper(q, "flash_attention_fwd")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, KVH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if H % KVH or H // KVH > MAX_GROUP or D > MAX_D:
        raise ValueError(f"flash_attention_fwd: the kernel takes H % KVH == "
                         f"0, H / KVH <= {MAX_GROUP} and D <= {MAX_D}; got "
                         f"H={H}, KVH={KVH}, D={D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             "contiguous")
    if torch.is_tensor(q_offset):
        off = q_offset.to(device=q.device, dtype=torch.int32).reshape(-1) \
            .expand(B).contiguous()
    else:
        off = torch.full((B,), int(q_offset), dtype=torch.int32,
                         device=q.device)
    out = torch.empty_like(q)
    p = build.ptr
    err = _lib()(_DTYPES[q.dtype], p(q), p(k), p(v), p(out), p(off), B, Sq,
                 Skv, H, KVH, D, int(bool(causal)), int(window),
                 build.stream_ptr(q.device))
    build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset=0):
    """q [B, Sq, H, D]; k/v [B, Skv, KVH, D] -> [B, Sq, H, D] in q.dtype.

    ``window`` > 0 keeps the last ``window`` keys (inclusive of self);
    ``q_offset`` is the position of q[:, 0] against k[:, 0], an int or a
    [B] tensor."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    return _launch(q, k, v, causal=causal, window=int(window),
                   q_offset=q_offset)


flash_attention_fwd.launches = 0
