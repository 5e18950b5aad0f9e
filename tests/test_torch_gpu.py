"""Each CUDA kernel of repro_torch against its plain PyTorch version, on an
sm_90 card. Skipped where there is none.

The card's machine has no jax, so this file imports none and runs without
the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90)")
    from repro_torch.kernels.backend import on_hopper
    if not on_hopper():
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _pool_case(rng, dtype, B, KVH, rows, D, page, W, ctx_max):
    P = B * W + 1
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, np.float32)).to("cuda", dtype)
    bt = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    ctx = rng.integers(1, ctx_max + 1, B).astype(np.int32)
    bt[-1] = -1                                     # an idle slot
    ctx[-1] = 0
    return (f(B, KVH, rows, D), f(P, page, KVH, D), f(P, page, KVH, D),
            torch.from_numpy(bt).cuda(), torch.from_numpy(ctx).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [
    dict(), dict(n_splits=3), dict(window=6), dict(ring_width=5),
    dict(window=6, windowed_slice=True), dict(qpos=4)],
    ids=["plain", "splits", "window", "ring", "windowed_slice", "qpos"])
def test_paged_kernel_matches_plain(dtype, kw):
    _card()
    from repro_torch.kernels.paged_attention import (
        paged_attention_partials, paged_attention_partials_plain)
    rng = np.random.default_rng(5)
    # a ring of 5 pages wraps past 80 tokens; plain tables cover 80
    q, kp, vp, bt, ctx = _pool_case(rng, dtype, 3, 2, 4 * kw.get("qpos", 1),
                                    64, 16, 5, 150 if "ring_width" in kw
                                    else 70)
    win = torch.full((3,), kw.pop("window", 0), dtype=torch.int32,
                     device="cuda")
    got = paged_attention_partials(q, kp, vp, bt, ctx, window=win, **kw)
    want = paged_attention_partials_plain(
        q, kp, vp, bt, ctx, win, ring_width=kw.get("ring_width", 0),
        windowed_slice=kw.get("windowed_slice", False),
        n_splits=kw.get("n_splits", 1), qpos=kw.get("qpos", 1))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.all(got[0][:, -1] == 0) and torch.all(got[1][:, -1] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,offs,window", [
    (128, 128, [0, 0], 0), (100, 164, [0, 64], 48)])
def test_flash_kernel_matches_plain(dtype, Sq, Skv, offs, window):
    _card()
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
               for s in ((2, Sq, 8, 64), (2, Skv, 2, 64), (2, Skv, 2, 64)))
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    got = flash_attention_fwd(q, k, v, window=window, q_offset=off)
    want = flash_attention_plain(q, k, v, window=window, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
