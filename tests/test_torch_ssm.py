"""repro_torch's Mamba2 scan and SSM module against repro's, on the CPU.

The same numpy inputs go through both packages. The port's
``ssm_chunk_scan`` runs its plain version here (CPU tensors) and is held to
the JAX Pallas kernel in interpret mode and to ``ref.ssm_chunk_scan_ref``
at atol 1e-4, as ``tests/test_kernels.py`` holds the Pallas kernel. The
port's ``chunked_gla`` and Mamba2 block are held to ``repro.models.ssm``
at 1e-5: fp32 products that XLA and PyTorch sum in different orders, on
inputs of unit scale.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels import ref as JREF
from repro.kernels.ssm_scan import ssm_chunk_scan as jax_ssm_chunk_scan
from repro.models import ssm as JSSM
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.kernels.backend import KernelConfig
from repro_torch.kernels.ssm_scan import ssm_chunk_scan, ssm_chunk_scan_plain
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import params_from_numpy, state_from_numpy


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _scan_inputs(seed, B, S, H, N, P, gain=0.1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    la = -np.log1p(np.exp(f(B, S, H)))                        # -softplus
    return f(B, S, H, N), f(B, S, H, N), f(B, S, H, P), la, f(B, S, H) * gain


# ---------------------------------------------------------------------------
# K4: the chunk scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,N,P,chunk", [
    (2, 32, 3, 8, 16, 8),
    (1, 64, 1, 4, 4, 16),
    (3, 16, 2, 16, 8, 4),
    (2, 1, 3, 8, 16, 1),                 # decode: S = chunk = 1
])
def test_ssm_scan_matches_pallas_and_ref(B, S, H, N, P, chunk):
    q, k, v, la, lg = _scan_inputs(S + B, B, S, H, N, P)
    jy, jC = jax_ssm_chunk_scan(*map(jnp.asarray, (q, k, v, la, lg)),
                                chunk=chunk, interpret=True)
    ry, (rC, rn, _) = JREF.ssm_chunk_scan_ref(q, k, v, la, lg, None, chunk)
    y, (C, n) = ssm_chunk_scan(*map(_t, (q, k, v, la, lg)), chunk=chunk)
    for got, want in ((y, jy), (C, jC), (y, ry), (C, rC), (n, rn)):
        _close(got, want, 1e-4)
    # the port's own oracle agrees with JAX's
    oy, (oC, on, _) = REF.ssm_chunk_scan_ref(*map(_t, (q, k, v, la, lg)),
                                             None, chunk)
    for got, want in ((oy, ry), (oC, rC), (on, rn)):
        _close(got, want, 1e-4)


def test_ssm_scan_state_carry_and_tail_mask():
    """Two half-scans from a carried (C, n) equal one full scan, and
    ``valid_len`` stops a row's state at its last valid token — the JAX
    test's cases, against the Pallas kernel in interpret mode."""
    B, S, H, N, P = 2, 16, 2, 8, 8
    q, k, v, la, lg = _scan_inputs(7, B, S, H, N, P, gain=0.2)
    rng = np.random.default_rng(8)
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32) * 0.3
    n0 = rng.standard_normal((B, H, N)).astype(np.float32) * 0.3
    ins = [_t(x) for x in (q, k, v, la, lg)]
    half = [x[:, :8] for x in ins], [x[:, 8:] for x in ins]
    y1, s1 = ssm_chunk_scan(*half[0], chunk=4, state=(_t(h0), _t(n0)))
    y2, s2 = ssm_chunk_scan(*half[1], chunk=4, state=s1)
    jy, jC = jax_ssm_chunk_scan(*map(jnp.asarray, (q, k, v, la, lg)),
                                chunk=4, state=jnp.asarray(h0),
                                interpret=True)
    h0_ref = (h0, n0, np.zeros((B, H), np.float32))
    _, (_, rn, _) = JREF.ssm_chunk_scan_ref(q, k, v, la, lg, h0_ref, 4)
    _close(torch.cat([y1, y2], 1), jy, 1e-4)
    _close(s2[0], jC, 1e-4)
    _close(s2[1], rn, 1e-4)

    # masked tail: row 0 valid to 10, row 1 full
    vl = np.asarray([10, S], np.int32)
    _, (Cm, nm) = ssm_chunk_scan(*ins, chunk=4, state=(_t(h0), _t(n0)),
                                 valid_len=torch.from_numpy(vl))
    _, jCm = jax_ssm_chunk_scan(*map(jnp.asarray, (q, k, v, la, lg)),
                                chunk=4, state=jnp.asarray(h0),
                                valid_len=jnp.asarray(vl), interpret=True)
    _, (C10, n10, _) = JREF.ssm_chunk_scan_ref(
        q[:1, :10], k[:1, :10], v[:1, :10], la[:1, :10], lg[:1, :10],
        tuple(x[:1] for x in h0_ref), 2)
    _close(Cm, jCm, 1e-4)
    _close(Cm[0], C10[0], 1e-4)
    _close(nm[0], n10[0], 1e-4)
    _close(Cm[1], s2[0][1], 1e-4)


def test_ssm_scan_takes_head_broadcast_views():
    """Mamba2 passes q/k as stride-0 views over heads: the wrapper takes
    them as they are, with the result of materialised copies."""
    B, S, H, N, P = 2, 8, 4, 8, 16
    q, k, v, la, lg = _scan_inputs(3, B, S, 1, N, P)
    qv = _t(q).expand(B, S, H, N)
    kv = _t(k).expand(B, S, H, N)
    assert qv.stride(2) == 0
    v4, la4, lg4 = (_t(np.repeat(x, H, axis=2)) for x in (v, la, lg))
    y, (C, n) = ssm_chunk_scan(qv, kv, v4, la4, lg4, chunk=4)
    y2, (C2, n2) = ssm_chunk_scan_plain(qv.contiguous(), kv.contiguous(), v4,
                                        la4, lg4, chunk=4)
    for got, want in ((y, y2), (C, C2), (n, n2)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_ssm_scan_rejects_bad_chunks():
    q, k, v, la, lg = map(_t, _scan_inputs(0, 1, 12, 1, 4, 4))
    with pytest.raises(ValueError):
        ssm_chunk_scan(q, k, v, la, lg, chunk=5)       # 12 % 5
    q, k, v, la, lg = map(_t, _scan_inputs(0, 1, 256, 1, 4, 4))
    with pytest.raises(ValueError):                   # chunk > 128
        ssm_chunk_scan(q, k, v, la, lg, chunk=256)


# ---------------------------------------------------------------------------
# chunked_gla, both modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("chunk,n_chunks", [(1, 3), (4, 2), (8, 1)])
def test_chunked_gla_matches_jax(normalize, chunk, n_chunks):
    B, H, dk, dv = 2, 3, 4, 5
    S = chunk * n_chunks
    q, k, v, la, lg = _scan_inputs(chunk * 10 + n_chunks, B, S, H, dk, dv,
                                   gain=0.5)
    rng = np.random.default_rng(1)
    st = (rng.standard_normal((B, H, dk, dv)).astype(np.float32) * 0.3,
          rng.standard_normal((B, H, dk)).astype(np.float32) * 0.3,
          rng.standard_normal((B, H)).astype(np.float32) * 0.3)
    for state in (None, st):
        jy, jst = JSSM.chunked_gla(*map(jnp.asarray, (q, k, v, la, lg)),
                                   chunk=chunk, normalize=normalize,
                                   state=None if state is None
                                   else tuple(map(jnp.asarray, state)))
        y, tst = SSM.chunked_gla(*map(_t, (q, k, v, la, lg)), chunk=chunk,
                                 normalize=normalize,
                                 state=None if state is None
                                 else tuple(map(_t, state)))
        _close(y, jy, 1e-5)
        for a, b in zip(tst, jst):
            _close(a, b, 1e-5)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    jcfg = replace(jax_reduced(jax_get_config("zamba2-1.2b")),
                   dtype="float32")
    cfg = replace(reduced(get_config("zamba2-1.2b")), dtype="float32")
    jp = JSSM.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.float32)
    p = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, p


def _states_close(st, jst, tol=1e-5):
    _close(st["conv"], jst["conv"], tol)
    for a, b in zip(st["ssm"], jst["ssm"]):
        _close(a, b, tol)


@pytest.mark.parametrize("kernels", [None, KernelConfig()],
                         ids=["plain", "kernel-wrapper"])
def test_mamba_forward_and_step_match_jax(mamba, kernels):
    """Parallel forward (fresh, carried state, masked end-padding) and the
    single-token step equal JAX's block, every state leaf (``n`` too)."""
    jcfg, cfg, jp, p = mamba
    B, T = 2, 8
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32) * 0.5
    jy, jst = JSSM.mamba_forward(jp, jcfg, jnp.asarray(x), chunk=4)
    y, st = SSM.mamba_forward(p, cfg, _t(x), chunk=4, kernels=kernels)
    _close(y, jy, 1e-5)
    _states_close(st, jst)

    # carried state, then a masked (end-padded) continuation
    x2 = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32) * 0.5
    mask = np.arange(T)[None] < np.asarray([5, T])[:, None]
    jy2, jst2 = JSSM.mamba_forward(jp, jcfg, jnp.asarray(x2), state=jst,
                                   chunk=4, mask=jnp.asarray(mask))
    y2, st2 = SSM.mamba_forward(p, cfg, _t(x2),
                                state=state_from_numpy(
                                    jax.tree.map(np.asarray, jst), "cpu"),
                                chunk=4, mask=torch.from_numpy(mask),
                                kernels=kernels)
    _close(y2[0, :5], jy2[0, :5], 1e-5)
    _close(y2[1], jy2[1], 1e-5)
    _states_close(st2, jst2)

    # decode steps from the carried state
    jstep, tstep = jst2, st2
    for t in range(3):
        xt = x2[:, t]
        jyt, jstep = JSSM.mamba_step(jp, jcfg, jnp.asarray(xt), jstep)
        yt, tstep = SSM.mamba_step(p, cfg, _t(xt), tstep, kernels=kernels)
        _close(yt, jyt, 1e-5)
        _states_close(tstep, jstep)


def test_mamba_parallel_equals_steps(mamba):
    """As ``tests/test_ssm.py``: the chunked forward equals token-by-token
    steps from zero state, in the port alone."""
    _, cfg, _, p = mamba
    B, T = 2, 8
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32) * 0.5)
    y_par, _ = SSM.mamba_forward(p, cfg, x, SSM.mamba_init_state(cfg, B),
                                 chunk=4)
    st = SSM.mamba_init_state(cfg, B)
    ys = []
    for t in range(T):
        yt, st = SSM.mamba_step(p, cfg, x[:, t], st)
        ys.append(yt)
    _close(y_par, torch.stack(ys, 1), 1e-5)


def test_masked_forward_matches_unpadded_state(mamba):
    """As ``tests/test_recurrent_prefill.py``: pad positions are identity
    steps — the padded+masked batch returns each row's unpadded state."""
    _, cfg, _, p = mamba
    B, T, pad = 2, 6, 5
    vl = torch.tensor([4, 6])
    mask = torch.arange(T + pad)[None] < vl[:, None]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32) * 0.5)
    xp = torch.cat([x, torch.zeros(B, pad, cfg.d_model)], 1)
    _, st = SSM.mamba_forward(p, cfg, xp, SSM.mamba_init_state(cfg, B),
                              chunk=128, mask=mask, kernels=KernelConfig())
    for b, n in enumerate([4, 6]):
        _, ref = SSM.mamba_forward(p, cfg, x[b:b + 1, :n],
                                   SSM.mamba_init_state(cfg, 1), chunk=128)
        _close(st["conv"][b], ref["conv"][0], 1e-5)
        for a, r in zip(st["ssm"], ref["ssm"]):
            _close(a[b], r[0], 1e-5)


def test_mamba_mixer_paths_agree():
    """``ops.mamba_mixer`` gives the same (y, C, n, m) through the kernel
    wrapper and through ``chunked_gla``; ``m`` passes through."""
    q, k, v, la, lg = map(_t, _scan_inputs(11, 2, 12, 3, 4, 6))
    rng = np.random.default_rng(12)
    st = tuple(_t(rng.standard_normal(s) * 0.3)
               for s in ((2, 3, 4, 6), (2, 3, 4), (2, 3)))
    vl = torch.tensor([7, 12])
    a = ops.mamba_mixer(q, k, v, la, lg, chunk=4, state=st, valid_len=vl,
                        kernels=KernelConfig())
    b = ops.mamba_mixer(q, k, v, la, lg, chunk=4, state=st, valid_len=vl)
    _close(a[0][1], b[0][1], 1e-5)
    _close(a[0][0, :7], b[0][0, :7], 1e-5)
    for x, y in zip(a[1], b[1]):
        _close(x, y, 1e-5)
    assert torch.equal(a[1][2], st[2])
