"""Prefill flash attention: the CUDA kernel and its plain version.

Port of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel
``_kernel`` / ``flash_attention_fwd``): causal / windowed GQA forward
attention with a normalised output, ``[B, Sq, H, D] x [B, Skv, KVH, D]``.
It carries the model's prefill and chunked-prefill attention
(``models/model.py``: causal self-attention, and the enc-dec encoder and
cross-attention prefill without the causal mask), where the JAX model
calls the jnp ``layers.flash_attention`` — the same function.

* CUDA tensors launch ``csrc/flash_attention.cu`` (one thread block per
  (batch row, kv head, query tile), all G query heads of the kv head
  together, K/V tiles streamed by TMA; bf16 inputs on ``wgmma``, fp32
  inputs as three TF32 tensor-core products, see ``tf32_split`` and the
  note in the source). Each launch is counted in
  ``flash_attention_fwd.launches``, a ``causal=False`` one (the enc-dec
  encoder and cross prefill) also in ``.launches_noncausal``.
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
from repro_torch.kernels.backend import require_aligned, require_hopper
from repro_torch.models.layers import flash_attention as flash_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 128
MAX_GROUP = 64


def tf32_split(x: torch.Tensor):
    """``x = hi + lo`` as the kernel splits an fp32 operand for its three
    TF32 products: ``hi = cvt.rna.tf32(x)``, ``lo = cvt.rna.tf32(x - hi)``
    (the kernel rounds with integer operations that give the same values).

    ``cvt.rna.tf32.f32`` keeps TF32's 10 mantissa bits of the fp32 value,
    rounded to nearest with ties away from zero: add half of the 13
    dropped bits' weight to the magnitude and clear them (the sign bit is
    untouched; a carry out of the mantissa bumps the exponent, and the
    largest finite values round to infinity). NaN passes through. A plain
    model on the fp32 bit pattern, for the CPU tests of the kernel's
    numerics."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        r = ((bits + 0x1000) & -0x2000).view(torch.float32)
        return torch.where(torch.isnan(t), t, r)
    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.flash_attention_smem.restype = ctypes.c_longlong
        lib.flash_attention_smem.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_tf32_split.restype = ctypes.c_int
        lib.flash_attention_tf32_split.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return lib


def tf32_split_on_card(x: torch.Tensor, *, by_cvt: bool = False):
    """The kernel's own split of an fp32 CUDA tensor (its device code, the
    rounding done with integer operations), or with ``by_cvt`` the same
    split by the ``cvt.rna.tf32`` instruction, for the tests that hold the
    two and ``tf32_split`` to one another. Not counted as a launch of the
    attention kernel."""
    require_hopper(x, "tf32_split_on_card")
    x = x.float().contiguous()
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    p = build.ptr
    build.check(_lib().flash_attention_tf32_split(
        p(x), p(hi), p(lo), x.numel(), int(by_cvt),
        build.stream_ptr(x.device)), "tf32_split_on_card")
    return hi, lo


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
    require_aligned("flash_attention_fwd", D, {"q": q, "k": k, "v": v})
    if torch.is_tensor(q_offset):
        off = q_offset.to(device=q.device, dtype=torch.int32).reshape(-1) \
            .expand(B).contiguous()
    else:
        off = torch.full((B,), int(q_offset), dtype=torch.int32,
                         device=q.device)
    out = torch.empty_like(q)
    p = build.ptr
    err = _lib().flash_attention_fwd(
        _DTYPES[q.dtype], p(q), p(k), p(v), p(out), p(off), B, Sq, Skv, H,
        KVH, D, int(bool(causal)), int(window), build.stream_ptr(q.device))
    build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    if not causal:
        flash_attention_fwd.launches_noncausal += 1
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
flash_attention_fwd.launches_noncausal = 0
