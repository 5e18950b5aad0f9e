"""The numerics of K2's fp32 route, checked on the CPU.

For fp32 inputs the prefill flash-attention kernel (``csrc/
flash_attention.cu``) computes every product on the TF32 tensor cores as
three products of split operands, ``x = hi + lo`` with ``hi =
cvt.rna.tf32(x)`` and ``lo = cvt.rna.tf32(x - hi)``, summing ``hi.hi +
hi.lo + lo.hi`` in fp32. ``kernels.flash_attention.tf32_split`` models the
split on the fp32 bit pattern. These tests hold:

* the model to the PTX rounding rule (round to nearest, ties away from
  zero, on the 13 bits below TF32's 10-bit mantissa) at hand-picked bit
  patterns (ties, carries into the exponent, subnormals, +-inf, NaN); on
  the card ``tests/test_torch_gpu.py`` holds it to the kernel's own
  ``cvt.rna.tf32``;
* attention computed with split products to the fp32 plain version and to
  JAX's flash attention within the kernel's fp32 tolerance, 2e-5, at the
  reduced llama3.2-1b and zamba2-1.2b shapes (GQA and MHA, a ragged
  length, a chunked per-row offset);
* attention with one TF32 product (``hi.hi``) to miss that tolerance: the
  reason for the split.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention as jax_flash
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 tf32_split)
from repro_torch.models.layers import NEG_INF

TOL = 2e-5           # K2's fp32 tolerance against its plain version


def _bits(vals):
    return torch.tensor(np.array(vals, dtype=np.uint32).view(np.int32)) \
        .view(torch.float32)


def _as_bits(t):
    return t.contiguous().view(torch.int32).numpy().view(np.uint32).tolist()


@pytest.mark.parametrize("x,hi", [
    (0x3F800000, 0x3F800000),   # 1.0: already TF32
    (0x3F800FFF, 0x3F800000),   # below half of the dropped bits: down
    (0x3F801000, 0x3F802000),   # a tie: away from zero
    (0xBF801000, 0xBF802000),   # a negative tie: away from zero
    (0x3F801001, 0x3F802000),   # above half: up
    (0x3FFFF000, 0x40000000),   # the carry runs into the exponent: 2.0
    (0x7F7FFFFF, 0x7F800000),   # the largest finite value rounds to inf
    (0x7F800000, 0x7F800000),   # +inf
    (0xFF800000, 0xFF800000),   # -inf
    (0x00000FFF, 0x00000000),   # subnormal, below half: to +0
    (0x00001000, 0x00002000),   # subnormal tie: away from zero
    (0x80003000, 0x80004000),   # negative subnormal tie: away from zero
    (0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000),   # -0
])
def test_tf32_split_rounds_as_cvt_rna(x, hi):
    h, lo = tf32_split(_bits([x]))
    assert _as_bits(h) == [hi]
    assert _as_bits(lo)[0] & 0x1FFF == 0      # lo is TF32 too


def test_tf32_split_keeps_nan_and_is_near_exact():
    h, lo = tf32_split(_bits([0x7FC00000, 0xFFC00001, 0x7F800001]))
    assert torch.isnan(h).all()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096, np.float32) * 100)
    h, lo = tf32_split(x)
    assert all(b & 0x1FFF == 0 for b in _as_bits(h) + _as_bits(lo))
    # hi + lo leaves at most ~2^-22 of |x| (lo keeps 11 of x - hi's bits)
    assert ((x - (h + lo)).abs() <= 2.0 ** -21 * x.abs()).all()
    # one TF32 value alone keeps ~3 digits
    assert ((x - h).abs() / x.abs()).max() > 1e-4


def _mm(a, b, terms):
    """a @ b as the kernel's tensor cores compute it: 3 = hi.hi + hi.lo +
    lo.hi (the fp32 route), 1 = hi.hi (a single TF32 product). Each
    product of two TF32 values is exact in fp32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _split_attention(q, k, v, q_offset, terms):
    """Causal GQA attention, [B, Sq, H, D] x [B, Skv, KVH, D], with every
    product taken as ``_mm`` takes it, the softmax in fp32."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qt = q.reshape(B, Sq, KVH, G, D).permute(0, 2, 3, 1, 4)   # [B,KVH,G,Sq,D]
    kt = k.permute(0, 2, 3, 1)[:, :, None]                    # [B,KVH,1,D,Skv]
    vt = v.permute(0, 2, 1, 3)[:, :, None]                    # [B,KVH,1,Skv,D]
    s = _mm(qt, kt, terms) / D ** 0.5
    pos = q_offset[:, None] + torch.arange(Sq)[None]           # [B, Sq]
    ok = torch.arange(Skv)[None, None] <= pos[..., None]       # [B, Sq, Skv]
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _mm(p, vt, terms) / p.sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def _case(arch, Sq, Skv, offs, seed):
    cfg = reduced(get_config(arch))
    rng = np.random.default_rng(seed)
    B = len(offs)
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Skv, KVH, D), np.float32)
    v = rng.standard_normal((B, Skv, KVH, D), np.float32)
    return q, k, v, np.asarray(offs, np.int32)


CASES = [("llama3.2-1b", 96, 96, (0, 0)), ("zamba2-1.2b", 96, 96, (0, 0)),
         ("llama3.2-1b", 40, 136, (0, 96)), ("zamba2-1.2b", 40, 136, (96, 0))]
IDS = ["llama", "zamba2", "llama-chunked", "zamba2-chunked"]


@pytest.mark.parametrize("arch,Sq,Skv,offs", CASES, ids=IDS)
def test_3xtf32_attention_holds_fp32_tolerance(arch, Sq, Skv, offs):
    q, k, v, off = _case(arch, Sq, Skv, offs, seed=Sq + Skv)
    tq, tk, tv, toff = (torch.from_numpy(a) for a in (q, k, v, off))
    got = _split_attention(tq, tk, tv, toff, terms=3)
    plain = flash_attention_plain(tq, tk, tv, causal=True, q_offset=toff)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                q_offset=jnp.asarray(off)))
    assert (got - plain).abs().max().item() <= TOL
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("arch,Sq,Skv,offs", CASES, ids=IDS)
def test_single_tf32_product_misses_fp32_tolerance(arch, Sq, Skv, offs):
    q, k, v, off = _case(arch, Sq, Skv, offs, seed=Sq + Skv)
    tq, tk, tv, toff = (torch.from_numpy(a) for a in (q, k, v, off))
    one = _split_attention(tq, tk, tv, toff, terms=1)
    plain = flash_attention_plain(tq, tk, tv, causal=True, q_offset=toff)
    assert (one - plain).abs().max().item() > TOL
