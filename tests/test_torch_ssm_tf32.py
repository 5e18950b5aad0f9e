"""The numerics of K4's chunk route, checked on the CPU.

The Mamba2 chunk-scan kernel (``csrc/ssm_scan.cu``, chunk > 1) computes
its four products per chunk (q k^T, (S . W) v, q C and (k sc)^T v) on the
TF32 tensor cores from split operands: ``x = hi + lo`` with ``hi =
cvt.rna.tf32(x)`` (``kernels.flash_attention.tf32_split`` models the
rounding bit for bit) and ``lo = x - hi`` handed to the tensor core whole,
which reads its TF32 bits (truncation), summing ``lo.hi + hi.lo + hi.hi``
in fp32. A bf16 input value is exact in TF32 (its ``lo`` is 0), so the
kernel issues only the terms whose ``lo`` is not zero: two TF32 products
for a product with one bf16 side; q k^T of bf16 inputs takes exact
products (a bf16 mma) with fp32 accumulation. The model below takes every
product that way. These tests hold:

* the model, at reduced zamba2-1.2b shapes with outputs of the engine's
  magnitude (sums of ~100), to the fp32 plain version
  (``ssm_chunk_scan_plain``) and to JAX's Pallas ``ssm_chunk_scan`` in
  interpret mode within the kernel's tolerance, 2e-5 of the largest
  magnitude, for fp32 and bf16 inputs, with a carried state, a
  ``valid_len`` tail and chunks that are not multiples of 16;
* the same scan with one TF32 product (``hi.hi``) to miss that tolerance:
  the reason for the split.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_chunk_scan as jax_ssm_chunk_scan
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import tf32_split
from repro_torch.kernels.ssm_scan import ssm_chunk_scan_plain
from repro_torch.models.ssm import mask_log_gates_tail

TOL = 2e-5           # K4's tolerance, of the largest magnitude


def _halves(x):
    """(hi, lo) as the kernel hands them to the tensor core: hi rounded
    as cvt.rna.tf32 rounds, lo = x - hi cut to its TF32 bits."""
    hi = tf32_split(x)[0]
    lo = (x - hi).contiguous().view(torch.int32) & -0x2000   # 0xFFFFE000
    return hi, lo.view(torch.float32)


def _mm(a, b, terms):
    """a @ b as the kernel's tensor cores take it: 3 = lo.hi + hi.lo +
    hi.hi (a side whose lo is 0, a bf16 value, adds nothing to its term),
    1 = hi.hi alone. Each product of two TF32 values is exact in fp32."""
    ah, al = _halves(a)
    bh, bl = _halves(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _split_scan(q, k, v, log_a, log_g, chunk, state, terms):
    """``ssm_chunk_scan_plain`` with each of its four products taken as
    ``_mm`` takes it."""
    B, S, H, N = q.shape
    C, n = state
    idx = torch.arange(chunk)
    below = (idx[:, None] >= idx[None, :])[None, None]
    ys = []
    for t0 in range(0, S, chunk):
        qb, kb, vb = (x[:, t0:t0 + chunk].transpose(1, 2).float()
                      for x in (q, k, v))
        la, lg = (x[:, t0:t0 + chunk].transpose(1, 2).float()
                  for x in (log_a, log_g))
        bcum = torch.cumsum(la, dim=-1)
        btot = bcum[..., -1:]
        wlog = bcum[..., :, None] - bcum[..., None, :] + lg[..., None, :]
        w = torch.where(below, torch.exp(wlog.clamp(-1e30, 60.0)),
                        torch.zeros_like(wlog))
        scores = _mm(qb, kb.transpose(-1, -2), terms) * w
        y = (_mm(scores, vb, terms)
             + torch.exp(bcum)[..., None] * _mm(qb, C, terms))
        ys.append(y.transpose(1, 2))
        ks = kb * torch.exp((btot - bcum + lg).clamp(-1e30, 60.0))[..., None]
        carry = torch.exp(btot)
        C = C * carry[..., None] + _mm(ks.transpose(-1, -2), vb, terms)
        n = n * carry + ks.sum(dim=-2)
    return torch.cat(ys, dim=1), (C, n)


def _case(S, B, seed, bf16):
    """Mamba2-like inputs at the reduced zamba2-1.2b widths: q / k shared
    by every head, decays -softplus(z), gains exp(dt) ~ 1, and inputs
    scaled so the outputs reach the engine's magnitude (~100)."""
    cfg = reduced(get_config("zamba2-1.2b"))
    H, N, P = cfg.ssm_n_heads, cfg.ssm_state, cfg.ssm_head_dim
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = np.repeat(f(B, S, 1, N) * 2.0, H, axis=2)
    k = np.repeat(f(B, S, 1, N) * 2.0, H, axis=2)
    v = f(B, S, H, P)
    la = -np.log1p(np.exp(f(B, S, H) - 2.0))
    lg = f(B, S, H) * 0.1
    C0, n0 = f(B, H, N, P) * 3.0, f(B, H, N) * 3.0
    if bf16:     # the values a bf16 input holds, exact in fp32
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
                   for x in (q, k, v))
    return q, k, v, la, lg, C0, n0


def _gap(got, want):
    got, want = (torch.as_tensor(np.array(x)) for x in (got, want))
    return ((got - want).abs().max() / want.abs().max().clamp_min(1)).item()


CASES = [(256, 2, 128, False), (200, 2, 100, False), (24, 3, 24, False),
         (256, 2, 128, True), (200, 1, 100, True)]
IDS = ["chunk128", "chunk100-tail", "chunk24", "bf16-chunk128",
       "bf16-chunk100-tail"]


@pytest.mark.parametrize("S,B,chunk,bf16", CASES, ids=IDS)
def test_split_route_holds_the_kernel_tolerance(S, B, chunk, bf16):
    q, k, v, la, lg, C0, n0 = _case(S, B, S + chunk, bf16)
    vl = np.full(B, S, np.int32)
    vl[0] = S - 7                            # a masked tail on row 0
    tq, tk, tv, tla, tlg = (torch.from_numpy(x) for x in (q, k, v, la, lg))
    mla, mlg = mask_log_gates_tail(tla, tlg, torch.from_numpy(vl))
    if bf16:                                 # bf16 values have no lo half
        assert all(torch.all(_halves(x)[1] == 0) for x in (tq, tk, tv))
    st = (torch.from_numpy(C0), torch.from_numpy(n0))
    y, (C, n) = _split_scan(tq, tk, tv, mla, mlg, chunk, st, terms=3)
    yp, (Cp, np_) = ssm_chunk_scan_plain(tq, tk, tv, mla, mlg, chunk=chunk,
                                         state=st)
    jy, jC = jax_ssm_chunk_scan(*map(jnp.asarray, (q, k, v, la, lg)),
                                chunk=chunk, state=jnp.asarray(C0),
                                valid_len=jnp.asarray(vl), interpret=True)
    assert 30.0 < yp.abs().max().item() < 1000.0      # the engine's scale
    live = torch.arange(S)[None] < torch.from_numpy(vl)[:, None]
    for got, want in ((y[live], yp[live]), (C, Cp), (n, np_),
                      (y[live], np.asarray(jy)[live.numpy()]), (C, jC)):
        assert _gap(got, want) <= TOL


@pytest.mark.parametrize("S,B,chunk,bf16", CASES[:2] + CASES[3:4],
                         ids=IDS[:2] + IDS[3:4])
def test_single_tf32_product_misses_the_kernel_tolerance(S, B, chunk, bf16):
    q, k, v, la, lg, C0, n0 = _case(S, B, S + chunk, bf16)
    tq, tk, tv, tla, tlg = (torch.from_numpy(x) for x in (q, k, v, la, lg))
    st = (torch.from_numpy(C0), torch.from_numpy(n0))
    y, (C, _) = _split_scan(tq, tk, tv, tla, tlg, chunk, st, terms=1)
    yp, (Cp, _) = ssm_chunk_scan_plain(tq, tk, tv, tla, tlg, chunk=chunk,
                                       state=st)
    assert max(_gap(y, yp), _gap(C, Cp)) > TOL


def test_p_slice_rule_and_cpu_path():
    """The P columns a chunk-kernel block owns: 64, unless P fits in 32 or
    the blocks of 64 columns fill at most half the SMs. CPU tensors take
    the plain version and count no launch."""
    from repro_torch.kernels import ssm_scan as K
    # zamba2 (H 64, P 64) on 132 SMs: one row, two, eight
    assert [K.default_p_slice(64, 64 * B, 132) for B in (1, 2, 8)] == [
        32, 64, 64]
    assert K.default_p_slice(32, 512, 132) == 32
    assert K.default_p_slice(128, 64, 132) == 64    # 128 blocks of 64
    q, k, v, la, lg, C0, n0 = _case(16, 1, 5, False)
    ins = [torch.from_numpy(x) for x in (q, k, v, la, lg)]
    fn = K.ssm_chunk_scan
    before = (fn.launches, fn.launches_chunk, fn.launches_step)
    y, (C, n) = K.ssm_chunk_scan(*ins, chunk=8)
    yp, (Cp, np_) = ssm_chunk_scan_plain(*ins, chunk=8)
    assert torch.equal(y, yp) and torch.equal(C, Cp) and torch.equal(n, np_)
    assert (fn.launches, fn.launches_chunk, fn.launches_step) == before
