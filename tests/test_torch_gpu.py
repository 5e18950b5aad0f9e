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


def _scan_case(gen, dtype, B, S, H, N, P, *, state=True, bcast=True):
    """Mamba2-like scan inputs on the card: q/k shared by every head
    (stride-0 views, as ``mamba_forward`` passes them) unless ``bcast`` is
    False, decays -softplus(z), gains ~1."""
    f = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    if bcast:
        q, k = (f(B, S, 1, N).to(dtype).expand(B, S, H, N) for _ in "qk")
    else:
        q, k = f(B, S, H, N).to(dtype), f(B, S, H, N).to(dtype)
    v = f(B, S, H, P).to(dtype)
    la = -torch.nn.functional.softplus(f(B, S, H))
    lg = f(B, S, H) * 0.1
    st = (f(B, H, N, P) * 0.3, f(B, H, N) * 0.3) if state else None
    return q, k, v, la, lg, st


def _scaled_gap(got, want):
    """max |got - want| over the scale of ``want`` (the two sum fp32
    products in different orders; bf16 inputs are upcast exactly on both
    sides, so one tolerance serves both input types)."""
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1.0)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,N,P,chunk,bcast", [
    (2, 32, 3, 8, 16, 8, False),        # small, dense heads
    (3, 1, 5, 8, 16, 1, True),          # decode: S = chunk = 1
    (2, 48, 4, 16, 8, 16, True),
    (8, 1024, 64, 64, 64, 128, True),   # the zamba2 prefill shape
])
def test_ssm_kernel_matches_plain(dtype, B, S, H, N, P, chunk, bcast):
    _card()
    from repro_torch.kernels.ssm_scan import (ssm_chunk_scan,
                                              ssm_chunk_scan_plain)
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, la, lg, st = _scan_case(g, dtype, B, S, H, N, P, bcast=bcast)
    vl = torch.full((B,), S, dtype=torch.int32, device="cuda")
    vl[0] = max(1, S - 5)                   # a masked tail on row 0
    y, (C, n) = ssm_chunk_scan(q, k, v, la, lg, chunk=chunk, state=st,
                               valid_len=vl)
    from repro_torch.models.ssm import mask_log_gates_tail
    ma, mg = mask_log_gates_tail(la, lg, vl)
    yp, (Cp, np_) = ssm_chunk_scan_plain(q, k, v, ma, mg, chunk=chunk,
                                         state=st)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(C).all()
    for got, want in ((y[1:], yp[1:]), (y[0, :int(vl[0])],
                                        yp[0, :int(vl[0])]),
                      (C, Cp), (n, np_)):
        assert _scaled_gap(got, want) <= 2e-5


@pytest.mark.gpu
def test_ssm_cuda_tensor_launches_kernel_never_plain(monkeypatch):
    _card()
    from repro_torch.kernels import ssm_scan as K
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.kernels.ops import mamba_mixer

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(K, "ssm_chunk_scan_plain", boom)
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, la, lg, st = _scan_case(g, torch.float32, 2, 16, 4, 8, 8)
    before = K.ssm_chunk_scan.launches
    K.ssm_chunk_scan(q, k, v, la, lg, chunk=8, state=st)
    mamba_mixer(q, k, v, la, lg, chunk=8, kernels=KernelConfig())
    torch.cuda.synchronize()
    assert K.ssm_chunk_scan.launches == before + 2


@pytest.mark.gpu
def test_ssm_kernel_raises_off_hopper_or_unbuilt(monkeypatch, tmp_path):
    _card()
    from repro_torch.kernels import build
    from repro_torch.kernels import ssm_scan as K
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, la, lg, _ = _scan_case(g, torch.float32, 1, 8, 2, 8, 8,
                                    state=False)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "get_device_capability", lambda *a: (8, 0))
        with pytest.raises(RuntimeError, match="sm_90a"):
            K.ssm_chunk_scan(q, k, v, la, lg, chunk=8)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    before = K.ssm_chunk_scan.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        K.ssm_chunk_scan(q, k, v, la, lg, chunk=8)
    assert K.ssm_chunk_scan.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_page256_d128_matches_plain(dtype):
    """256-token pages at D 128 (the JAX default page size, the kernel
    bench's paged row): the kernel streams pages in 64-token sub-tiles, so
    it launches and matches its plain version."""
    _card()
    from repro_torch.kernels.paged_attention import (
        paged_attention_partials, paged_attention_partials_plain)
    rng = np.random.default_rng(9)
    q, kp, vp, bt, ctx = _pool_case(rng, dtype, 4, 2, 4, 128, 256, 8, 2048)
    win = torch.zeros(4, dtype=torch.int32, device="cuda")
    for n_splits in (1, 3):
        got = paged_attention_partials(q, kp, vp, bt, ctx, n_splits=n_splits)
        want = paged_attention_partials_plain(
            q, kp, vp, bt, ctx, win, ring_width=0, windowed_slice=False,
            n_splits=n_splits, qpos=1)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=TOL[dtype],
                                       rtol=TOL[dtype])


def _decode_case(gen, dtype, B, KVH, G, D, T, ctx):
    f = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    return (f(B, KVH, G, D).to(dtype), f(B, T, KVH, D).to(dtype),
            f(B, T, KVH, D).to(dtype),
            torch.tensor(ctx, dtype=torch.int32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KVH,G,D,T,S,ctx", [
    (2, 2, 3, 16, 32, 4, [11, 32]),          # the JAX sweep
    (1, 1, 8, 32, 64, 8, [43]),
    (4, 2, 1, 8, 16, 2, [2, 16, 13, 9]),
    (2, 2, 2, 8, 21, 4, [21, 5]),            # tail split
    (3, 2, 4, 64, 100, 4, [0, 30, 500]),     # ctx 0, dead splits, ctx > T
    (4, 2, 4, 128, 4001, 8, [4001, 100, 222, 64]),   # the bench shape
])
def test_flash_decode_kernel_matches_plain(dtype, B, KVH, G, D, T, S, ctx):
    _card()
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.ref import merge_flash_partials
    g = torch.Generator(device="cuda").manual_seed(T + S)
    q, k, v, c = _decode_case(g, dtype, B, KVH, G, D, T, ctx)
    got = flash_decode(q, k, v, c, n_splits=S)
    want = flash_decode_plain(q, k, v, c, n_splits=S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[2], want[2], atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(got[0], want[0], atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(got[1], want[1], atol=TOL[dtype],
                               rtol=TOL[dtype])
    dead = torch.arange(S, device="cuda")[:, None] * (-(-T // S)) \
        >= c.clamp_max(T)[None]                              # [S, B]
    assert torch.all(got[2][dead] == -1e30) and torch.all(got[1][dead] == 0)
    assert torch.all(got[0][dead] == 0)
    merged = merge_flash_partials(*got)
    assert torch.isfinite(merged).all()
    assert torch.all(merged[c == 0] == 0)


@pytest.mark.gpu
def test_flash_decode_cuda_tensor_launches_kernel_never_plain(monkeypatch):
    _card()
    from repro_torch.kernels import flash_decode as K
    from repro_torch.kernels import ops
    from repro_torch.kernels.backend import KernelConfig

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(K, "flash_decode_plain", boom)
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, c = _decode_case(g, torch.float32, 2, 2, 4, 32, 50, [50, 7])
    before = K.flash_decode.launches
    K.flash_decode(q, k, v, c, n_splits=4)
    ops.itpp_partials(q, k, v, c, n_splits=4, kernels=KernelConfig())
    torch.cuda.synchronize()
    assert K.flash_decode.launches == before + 2


@pytest.mark.gpu
def test_flash_decode_kernel_raises_off_hopper_or_unbuilt(monkeypatch,
                                                          tmp_path):
    _card()
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as K
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, c = _decode_case(g, torch.float32, 1, 2, 2, 16, 20, [20])
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "get_device_capability", lambda *a: (8, 0))
        with pytest.raises(RuntimeError, match="sm_90a"):
            K.flash_decode(q, k, v, c, n_splits=2)
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                       v, c, n_splits=2)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    before = K.flash_decode.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        K.flash_decode(q, k, v, c, n_splits=2)
    assert K.flash_decode.launches == before
