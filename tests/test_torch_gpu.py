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
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,offs,window", [
    (2, 128, 128, 8, 2, 64, [0, 0], 0),
    (2, 100, 164, 8, 2, 64, [0, 64], 48),
    (2, 1024, 1024, 32, 8, 64, [0, 0], 0),       # llama prefill, G 4
    (2, 1024, 1024, 32, 32, 64, [0, 0], 0),      # zamba2 prefill, G 1
    (1, 256, 256, 8, 1, 64, [0], 0),             # G 8
    (2, 300, 300, 16, 2, 128, [0, 0], 0),        # G 8, D 128
    (2, 1000, 1000, 8, 2, 64, [0, 0], 0),        # ragged Sq = Skv
    (2, 100, 164, 4, 4, 128, [0, 64], 48),       # ragged, offsets, window
    (2, 128, 1536, 32, 8, 64, [1024, 512], 0),   # chunked prefill
    (2, 200, 200, 8, 2, 64, [0, 0], 64),         # window
    (2, 77, 77, 4, 2, 32, [0, 0], 0),            # D 32
], ids=["small", "offsets-window", "llama", "zamba2", "G8", "G8-D128",
        "ragged1000", "ragged100-D128", "chunked", "window", "D32"])
def test_flash_kernel_matches_plain(dtype, B, Sq, Skv, H, KVH, D, offs,
                                    window):
    """K2 (wgmma for bf16, 3xTF32 mma.sync for fp32) at the shapes the
    prefill paths give it, G 1 to 8, D 32 to 128."""
    _card()
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(Sq + Skv + H)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
               for s in ((B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D)))
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    got = flash_attention_fwd(q, k, v, window=window, q_offset=off)
    want = flash_attention_plain(q, k, v, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
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
@pytest.mark.parametrize("B,S,H,N,P,chunk,bcast,state", [
    (2, 32, 3, 8, 16, 8, False, True),        # small, dense heads
    (3, 1, 5, 8, 16, 1, True, True),          # decode: S = chunk = 1
    (2, 48, 4, 16, 8, 16, True, True),
    (8, 1024, 64, 64, 64, 128, True, True),   # the zamba2 prefill shape
    (8, 1, 64, 64, 64, 1, True, True),        # the zamba2 decode step
    (1, 1, 64, 64, 64, 1, True, False),       # one row, fresh state
    (1, 1024, 64, 64, 64, 128, True, False),  # slot prefill, one row
    (8, 128, 64, 64, 64, 128, True, True),    # chunked prefill
    (2, 200, 3, 64, 64, 100, True, True),     # chunk off 16
    (3, 24, 2, 32, 32, 24, False, False),     # chunk off 16, dense heads
    (2, 64, 2, 8, 8, 16, True, True),         # N = P = 8
    (2, 64, 2, 16, 16, 32, False, True),      # N = P = 16
    (2, 128, 2, 128, 64, 64, False, True),    # N 128: one stage
    (2, 128, 2, 64, 128, 128, True, False),   # P 128: two P slices
    (2, 200, 2, 128, 128, 100, True, True),   # both 128, chunk 100
    (2, 7, 3, 64, 64, 1, True, True),         # chunk 1 over 7 tokens
    (2, 9, 3, 12, 20, 3, False, True),        # N, P off 16
    (2, 6, 2, 6, 6, 1, False, True),          # the step kernel at P % 4
])
def test_ssm_kernel_matches_plain(dtype, B, S, H, N, P, chunk, bcast, state):
    """Both routes (chunk kernel for chunk > 1, step kernel for chunk 1)
    against the plain version, with and without a carried state, with a
    valid_len tail on row 0."""
    _card()
    from repro_torch.kernels.ssm_scan import (ssm_chunk_scan,
                                              ssm_chunk_scan_plain)
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, la, lg, st = _scan_case(g, dtype, B, S, H, N, P, bcast=bcast,
                                     state=state)
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
        if want.numel():                    # B = 1 has no rows past row 0
            assert _scaled_gap(got, want) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("p_slice", [32, 64])
def test_ssm_p_slice_does_not_change_the_result(monkeypatch, p_slice):
    """The P columns a chunk-kernel block owns are a schedule, not a
    different function."""
    _card()
    from repro_torch.kernels import ssm_scan as K
    from repro_torch.kernels.ssm_scan import (ssm_chunk_scan,
                                              ssm_chunk_scan_plain)
    monkeypatch.setattr(K, "default_p_slice", lambda *_: p_slice)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, la, lg, st = _scan_case(g, torch.float32, 2, 256, 4, 64, 96)
    y, (C, n) = ssm_chunk_scan(q, k, v, la, lg, chunk=128, state=st)
    yp, (Cp, np_) = ssm_chunk_scan_plain(q, k, v, la, lg, chunk=128,
                                         state=st)
    for got, want in ((y, yp), (C, Cp), (n, np_)):
        assert _scaled_gap(got, want) <= 2e-5


@pytest.mark.gpu
def test_ssm_cuda_tensor_launches_kernel_never_plain(monkeypatch):
    """Both routes launch their kernel (counted in total and by route) and
    never reach the plain version, directly and through mamba_mixer."""
    _card()
    from repro_torch.kernels import ssm_scan as K
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.kernels.ops import mamba_mixer

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(K, "ssm_chunk_scan_plain", boom)
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, la, lg, st = _scan_case(g, torch.float32, 2, 16, 4, 8, 8)
    fn = K.ssm_chunk_scan
    before = (fn.launches, fn.launches_chunk, fn.launches_step)
    K.ssm_chunk_scan(q, k, v, la, lg, chunk=8, state=st)
    mamba_mixer(q, k, v, la, lg, chunk=8, kernels=KernelConfig())
    K.ssm_chunk_scan(q[:, :1], k[:, :1], v[:, :1], la[:, :1], lg[:, :1],
                     chunk=1, state=st)
    mamba_mixer(q[:, :1], k[:, :1], v[:, :1], la[:, :1], lg[:, :1],
                chunk=1, kernels=KernelConfig())
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_chunk, fn.launches_step) == (
        before[0] + 4, before[1] + 2, before[2] + 2)


@pytest.mark.gpu
def test_ssm_layouts_without_16_byte_copies_run_right(monkeypatch):
    """Layouts that forbid 16-byte copies (a base 4 bytes off, rows of 12
    or 7 bf16 values, a value stride not 1) take value-by-value staging,
    and an unaligned carried state is copied for the step kernel: every
    one matches the plain version and none reaches it."""
    _card()
    from repro_torch.kernels import ssm_scan as K
    g = torch.Generator(device="cuda").manual_seed(4)
    B, S, H = 2, 64, 3

    def r(*s, dtype=torch.float32):
        return torch.randn(s, generator=g, device="cuda").to(dtype)
    la = -torch.nn.functional.softplus(r(B, S, H))
    lg = r(B, S, H) * 0.1
    cases = []
    big = r(B * S * H * 16 + 1)
    cases.append(("base 4 B off", big[1:].view(B, S, H, 16), r(B, S, H, 16),
                  r(B, S, H, 16)))
    cases.append(("bf16 N 12", r(B, S, H, 12, dtype=torch.bfloat16),
                  r(B, S, H, 12, dtype=torch.bfloat16),
                  r(B, S, H, 8, dtype=torch.bfloat16)))
    cases.append(("bf16 N 7", r(B, S, H, 7, dtype=torch.bfloat16),
                  r(B, S, H, 7, dtype=torch.bfloat16),
                  r(B, S, H, 8, dtype=torch.bfloat16)))
    cases.append(("value stride 2", r(B, S, H, 32)[..., ::2],
                  r(B, S, H, 16), r(B, S, H, 32)[..., ::2]))
    want = {}
    for name, q, k, v in cases:
        N, P = q.shape[-1], v.shape[-1]
        st = (r(B, H, N, P), r(B, H, N))
        for chunk in (16, 1):
            want[name, chunk] = K.ssm_chunk_scan_plain(
                q, k, v, la, lg, chunk=chunk, state=st), st

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(K, "ssm_chunk_scan_plain", boom)
    for name, q, k, v in cases:
        for chunk in (16, 1):
            (yp, (Cp, np_)), st = want[name, chunk]
            if chunk == 1:       # a state 4 bytes off 16-byte alignment
                C0 = torch.empty(st[0].numel() + 1, device="cuda")[1:]
                C0.copy_(st[0].reshape(-1))
                st = (C0.view(st[0].shape), st[1])
            y, (C, n) = K.ssm_chunk_scan(q, k, v, la, lg, chunk=chunk,
                                         state=st)
            for got, ref in ((y, yp), (C, Cp), (n, np_)):
                assert _scaled_gap(got, ref) <= 2e-5, (name, chunk)


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
        with pytest.raises(RuntimeError, match="sm_90a"):
            K.ssm_chunk_scan(q[:, :1], k[:, :1], v[:, :1], la[:, :1],
                             lg[:, :1], chunk=1)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    before = K.ssm_chunk_scan.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        K.ssm_chunk_scan(q, k, v, la, lg, chunk=8)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.ssm_chunk_scan(q[:, :1], k[:, :1], v[:, :1], la[:, :1],
                         lg[:, :1], chunk=1)
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
    (8, 8, 4, 64, 32768, 16, [0, 8192, 11702, 15213, 18724, 22235, 25746,
                              32768]),                # long context
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


@pytest.mark.gpu
def test_tf32_split_model_matches_the_card():
    """The wrapper's plain model of the fp32 operand split equals the
    kernel's split and the cvt.rna.tf32 instruction's, bit for bit (NaN
    stays NaN)."""
    _card()
    from repro_torch.kernels.flash_attention import (tf32_split,
                                                     tf32_split_on_card)
    bits = np.array([0x3F800FFF, 0x3F801000, 0xBF801000, 0x3FFFF000,
                     0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x00000FFF,
                     0x00001000, 0x80003000, 0x80000000],
                    dtype=np.uint32).view(np.float32)
    rnd = np.random.default_rng(0).standard_normal(1 << 16, np.float32)
    x = torch.from_numpy(np.concatenate([bits, rnd * 100]))
    want = tf32_split(x)
    fin = torch.isfinite(x)     # lo of +-inf: NaN for cvt, -0 for the kernel
    got = [(h, fin) for h in tf32_split_on_card(x.cuda())] + [
        (h, torch.ones_like(fin)) for h in tf32_split_on_card(x.cuda(),
                                                              by_cvt=True)]
    for (g, on), w in zip(got, want + want):   # NaN payloads not compared
        g, w, x_on = g.cpu()[on], w[on], x[on]
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        keep = ~torch.isnan(w)
        bad = (g[keep].view(torch.int32) != w[keep].view(torch.int32))
        assert not bad.any(), (
            [hex(v) for v in x_on[keep][bad][:8].view(torch.int32).tolist()],
            g[keep][bad][:8].tolist(), w[keep][bad][:8].tolist())
    nan = tf32_split_on_card(torch.tensor([float("nan")], device="cuda"))[0]
    assert torch.isnan(nan).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page,D,W,ctx_max", [(16, 64, 40, 600),
                                              (256, 128, 6, 1400)],
                         ids=["page16", "page256"])
@pytest.mark.parametrize("n_splits", [1, 4])
@pytest.mark.parametrize("kw", [dict(), dict(window=100),
                                dict(ring_width=4)],
                         ids=["plain", "window", "ring"])
def test_paged_kernel_pages_splits_match_plain(dtype, page, D, W, ctx_max,
                                               n_splits, kw):
    """K1's page walk: several pages a stage at page 16, sub-tiles of a
    256-token page, with and without splits, windows and ring tables."""
    _card()
    from repro_torch.kernels.paged_attention import (
        paged_attention_partials, paged_attention_partials_plain)
    rng = np.random.default_rng(page + n_splits)
    ring = kw.get("ring_width", 0)
    q, kp, vp, bt, ctx = _pool_case(rng, dtype, 3, 2, 4, D, page,
                                    ring or W, ctx_max)
    win = torch.full((3,), kw.get("window", 0), dtype=torch.int32,
                     device="cuda")
    got = paged_attention_partials(q, kp, vp, bt, ctx, window=win,
                                   ring_width=ring, n_splits=n_splits)
    want = paged_attention_partials_plain(
        q, kp, vp, bt, ctx, win, ring_width=ring, windowed_slice=False,
        n_splits=n_splits, qpos=1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.all(got[0][:, -1] == 0) and torch.all(got[1][:, -1] == 0)


@pytest.mark.gpu
def test_kernels_raise_on_misaligned_rows_and_never_take_plain(monkeypatch):
    """Rows that are not whole 16-byte copies (D 36 in bf16) and bases off
    16 bytes are refused by every wrapper, with no launch; a CUDA tensor
    never reaches a plain version."""
    _card()
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import paged_attention as PA

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(FA, "flash_attention_plain", boom)
    monkeypatch.setattr(FD, "flash_decode_plain", boom)
    monkeypatch.setattr(PA, "paged_attention_partials_plain", boom)
    g = torch.Generator(device="cuda").manual_seed(6)

    def r(*s, dtype=torch.bfloat16):
        return torch.randn(s, generator=g, device="cuda").to(dtype)
    before = (FA.flash_attention_fwd.launches, FD.flash_decode.launches,
              PA.paged_attention_partials.launches)
    with pytest.raises(ValueError, match="16"):
        FA.flash_attention_fwd(r(1, 8, 4, 36), r(1, 8, 2, 36),
                               r(1, 8, 2, 36))
    with pytest.raises(ValueError, match="16"):
        FD.flash_decode(r(1, 2, 2, 36), r(1, 20, 2, 36), r(1, 20, 2, 36),
                        torch.tensor([20], dtype=torch.int32,
                                     device="cuda"), n_splits=2)
    bt = torch.arange(2, dtype=torch.int32, device="cuda")[None]
    ctx = torch.tensor([20], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16"):
        PA.paged_attention_partials(r(1, 2, 4, 36), r(3, 16, 2, 36),
                                    r(3, 16, 2, 36), bt, ctx)
    # a base 4 bytes off alignment (fp32, rows of 64 values)
    big = r(1 * 8 * 2 * 64 + 1, dtype=torch.float32)
    k_off = big[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention_fwd(r(1, 8, 4, 64, dtype=torch.float32), k_off,
                               k_off)
    assert before == (FA.flash_attention_fwd.launches,
                      FD.flash_decode.launches,
                      PA.paged_attention_partials.launches)
    # aligned inputs launch the kernels (the plain versions would raise)
    q = r(2, 64, 8, 64, dtype=torch.float32)
    kv = r(2, 64, 2, 64, dtype=torch.float32)
    FA.flash_attention_fwd(q, kv, kv)
    PA.paged_attention_partials(r(1, 2, 4, 64), r(3, 16, 2, 64),
                                r(3, 16, 2, 64), bt, ctx)
    torch.cuda.synchronize()
    assert FA.flash_attention_fwd.launches == before[0] + 1
    assert PA.paged_attention_partials.launches == before[2] + 1


# ---------------------------------------------------------------------------
# the decode horizon as CUDA graphs (serving/graphs.py)
# ---------------------------------------------------------------------------

# 2-token pages and a 41-slot table: the decode table width is bucketed (16
# or 32 slots), so runs dispatch more than one (width, K)
ENGINE_KW = dict(n_slots=2, page_size=2, n_pages=64, max_context=80,
                 eos_token=-1)


def _engines(arch, ways, params=None, **kw):
    """One engine per entry of ``ways`` (EngineConfig overrides; a
    ``sample`` entry is the engine's ``sample=``) on the card, all serving
    the same reduced ``arch`` weights (``params``, default seed 0) and
    requests."""
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_params
    from repro_torch.serving import DecodeEngine, EngineConfig, Request
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    if params is None:
        params = init_params(cfg, 0, torch.float32, "cuda")
    rng = np.random.default_rng(7)
    reqs = [(r, rng.integers(0, 256, int(rng.integers(3, 30))), 9)
            for r in range(5)]
    engs = []
    for way in ways:
        way = dict(way)
        sample = way.pop("sample", None)
        eng = DecodeEngine(cfg, EngineConfig(**{**ENGINE_KW, **kw, **way}),
                           params, device="cuda", sample=sample)
        for r, prompt, n in reqs:
            eng.submit(Request(r, prompt, n))
        engs.append(eng)
    return engs


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
@pytest.mark.parametrize("mode,horizon", [("batched", 4), ("chunked", 1),
                                          ("slot", 8)])
def test_graph_engine_matches_eager_and_plain(arch, mode, horizon):
    """The default engine replays its horizons as CUDA graphs; its tokens
    and sync counts equal the eager (``decode_graphs=False``) and plain
    (``use_kernels=False``) engines'."""
    _card()
    graphs, eager, plain = _engines(
        arch, ({}, dict(decode_graphs=False), dict(use_kernels=False)),
        prefill_mode=mode, decode_horizon=horizon, prefill_chunk=8)
    outs = [e.run(1000) for e in (graphs, eager, plain)]
    assert outs[0] == outs[1] == outs[2]
    assert graphs.horizons.graphs and graphs.timing.graph_captures >= 1
    assert not eager.horizons.graphs and eager.timing.graph_captures == 0
    assert (graphs.timing.device_syncs == eager.timing.device_syncs
            == plain.timing.device_syncs)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_graph_engine_tracks_eager_tick_by_tick(arch):
    """Tick by tick, the graph engine's device slot state equals the eager
    engine's: dirty-row patches (admissions into freed slots, page growth)
    made between two replays of one graph are read by the next replay,
    and a table-width change mid-run captures a new graph."""
    _card()
    graphs, eager = _engines(arch, ({}, dict(decode_graphs=False)),
                             prefill_mode="batched", decode_horizon=4)
    patches = []
    patch = graphs.dev.patch
    graphs.dev.patch = lambda *a: patches.append(1) or patch(*a)
    patched_before_replay = 0
    for _ in range(1000):
        if graphs._inflight is None and graphs.batcher.done():
            break
        n_captured, n_patches = len(graphs.horizons.captured), len(patches)
        graphs.tick()
        eager.tick()
        # this tick patched rows and replayed a graph captured before it
        if n_captured == len(graphs.horizons.captured) >= 1 \
                and len(patches) > n_patches:
            patched_before_replay += 1
        for name in ("bt", "ctx", "tokens", "rem"):
            assert torch.equal(getattr(graphs.dev, name),
                               getattr(eager.dev, name)), name
    assert eager._inflight is None and eager.batcher.done()
    assert graphs.outputs == eager.outputs
    assert patched_before_replay > 0
    widths = {w for w, _, _ in graphs.horizons.captured}
    assert len(widths) >= 2, graphs.horizons.captured


# ---------------------------------------------------------------------------
# the KV-cache hierarchy on the card (kvcache/offload.py)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_host_tier_pinned_side_stream_round_trip():
    """A swap-out lands in pinned host memory through the copy stream; the
    pool is overwritten while the copy may still run (the gather read it
    first); a swap-in copies it back into the pool's own tensors bit for
    bit. The copier times both directions."""
    _card()
    from repro_torch.core.allocator import PageAllocator
    from repro_torch.core.paged_kv import PoolSpec, init_pool
    from repro_torch.kvcache import PrefixCache
    page = 16
    alloc = PageAllocator(64, 1, page)
    cache = PrefixCache(alloc, host_pages=32)
    pool = init_pool(PoolSpec(4, 64, page, 8, 64, 8, dtype="float32"),
                     "cuda")
    ptrs = {k: t.data_ptr() for k, t in pool.items()}
    cache.pool_ref = lambda: pool
    seq = np.arange(10, 10 + 5 * page, dtype=np.int32)     # 5 pages
    pages = alloc.admit(0, len(seq))
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = torch.randn((4, 5, page, 8, 64), generator=gen, device="cuda")
    pool["k"][:, pages] = data
    pool["v"][:, pages] = -data
    cache.insert(0, seq)
    alloc.free(0)
    assert cache.reclaim(5) == 5
    node = next(cache.tree.nodes())
    assert node.on_host and node.host["k"].is_pinned()
    for t in pool.values():             # enqueued after the gather
        t.fill_(7.0)
    cache.maintain()                    # drain: waits on the copy's event
    assert torch.equal(node.host["k"], data.cpu())
    hit = cache.lookup(1, np.concatenate([seq, [1]]).astype(np.int32))
    assert hit.matched == 5 * page
    cache.apply_pending(pool)
    assert {k: t.data_ptr() for k, t in pool.items()} == ptrs
    assert torch.equal(pool["k"][:, hit.pages], data)
    assert torch.equal(pool["v"][:, hit.pages], -data)
    cache.host.copier.settle()
    st = cache.host.copier.stats
    assert st.d2h_bytes == st.h2d_bytes == 2 * data.nbytes
    assert st.d2h_ms > 0 and st.h2d_ms > 0
    cache.release(1)


@pytest.mark.gpu
def test_cow_copies_between_replays_of_a_captured_horizon():
    """With the prefix cache on, admissions after a horizon's capture copy
    pages on write (and borrow shared pages) between its replays: the
    graph engine's tokens equal the eager engine's and a cache-off
    engine's, and the pool keeps its address."""
    _card()
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_params
    from repro_torch.serving import DecodeEngine, EngineConfig, Request
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    params = init_params(cfg, 0, torch.float32, "cuda")
    rng = np.random.default_rng(7)
    system = rng.integers(0, 256, 25)            # ends mid-page: CoW
    reqs = [(r, np.concatenate([system, rng.integers(0, 256, 4)]), 12)
            for r in range(6)]
    kw = dict(n_slots=2, page_size=2, n_pages=64, max_context=80,
              eos_token=-1, prefill_mode="batched", decode_horizon=4)
    engs = []
    for way in (dict(prefix_cache=True), dict(prefix_cache=True,
                                              decode_graphs=False), {}):
        eng = DecodeEngine(cfg, EngineConfig(**kw, **way), params,
                           device="cuda")
        for r, prompt, n in reqs:
            eng.submit(Request(r, prompt, n))
        engs.append(eng)
    graphs = engs[0]
    ptr = graphs.state["pool"]["k"].data_ptr()
    cow_after_capture = 0
    for _ in range(1000):
        if graphs._inflight is None and graphs.batcher.done():
            break
        captured = len(graphs.horizons.captured)
        cow = graphs.cache.stats.cow_copies
        graphs.tick()
        if captured and graphs.cache.stats.cow_copies > cow:
            cow_after_capture += 1
    outs = [graphs.outputs] + [e.run(1000) for e in engs[1:]]
    assert outs[0] == outs[1] == outs[2]
    assert graphs.horizons.graphs and cow_after_capture > 0
    assert graphs.cache.stats.hits > 0
    assert graphs.state["pool"]["k"].data_ptr() == ptr


# ---------------------------------------------------------------------------
# speculative decoding: K1's verify mode, the round as a CUDA graph
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,qpos,n_splits", [(4, 5, 1), (4, 16, 1),
                                             (4, 16, 3), (1, 33, 2),
                                             (4, 33, 1)],
                         ids=["20 rows", "64 rows", "64 rows splits",
                              "33 rows qpos 33", "132 rows qpos 33"])
def test_paged_kernel_spec_verify_rows_match_plain(dtype, G, qpos, n_splits):
    """K1 in its multi-query verify mode past one block's 32 rows: one
    launch a row tile, each tile at its row offset, against the plain
    version of the whole q (2e-5 fp32, 2e-2 bf16)."""
    _card()
    from repro_torch.kernels import paged_attention as PA
    rng = np.random.default_rng(11)
    q, kp, vp, bt, ctx = _pool_case(rng, dtype, 4, 2, G * qpos, 64, 16, 8,
                                    90)
    win = torch.zeros(4, dtype=torch.int32, device="cuda")
    before = PA.paged_attention_partials.launches
    got = PA.paged_attention_partials(q, kp, vp, bt, ctx, window=win,
                                      n_splits=n_splits, qpos=qpos)
    torch.cuda.synchronize()
    assert PA.paged_attention_partials.launches - before == \
        len(PA.row_tiles(G * qpos))
    want = PA.paged_attention_partials_plain(
        q, kp, vp, bt, ctx, win, ring_width=0, windowed_slice=False,
        n_splits=n_splits, qpos=qpos)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])


def _spec_engines(ways, **kw):
    """Reduced llama on the card: the zeroed-layer oracle target and its
    1-layer draft (``models.convert.oracle_draft_pair``); one engine per
    entry of ``ways``, all serving the same requests."""
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import oracle_draft_pair
    from repro_torch.models.model import init_params
    from repro_torch.serving import DecodeEngine, EngineConfig, Request
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    params, dcfg, dparams = oracle_draft_pair(
        cfg, init_params(cfg, 0, torch.float32, "cuda"))
    rng = np.random.default_rng(7)
    reqs = [(r, rng.integers(0, 256, int(rng.integers(3, 30))), 9)
            for r in range(5)]
    engs = []
    for way in ways:
        way = dict(way)
        draft = way.pop("draft", True)
        eng = DecodeEngine(
            cfg, EngineConfig(**ENGINE_KW, **kw, **way,
                              draft_config=dcfg if draft else None),
            params, device="cuda", draft_params=dparams if draft else None)
        for r, prompt, n in reqs:
            eng.submit(Request(r, prompt, n))
        engs.append(eng)
    return engs


@pytest.mark.gpu
@pytest.mark.parametrize("mode,spec", [("batched", 4), ("chunked", 4),
                                       ("batched", 15)])
def test_spec_engine_graphs_match_target_only(mode, spec):
    """The speculative round as a CUDA graph: greedy tokens equal the
    target alone (graphs) and the eager round's, with equal counters; the
    oracle pair accepts proposals; K1 served the verify rows."""
    _card()
    from repro_torch.kernels import paged_attention as PA
    kw = dict(prefill_mode=mode, prefill_chunk=8, spec_horizon=spec)
    graphs, eager, target = _spec_engines(
        ({}, dict(decode_graphs=False),
         dict(draft=False, decode_horizon=spec + 1)), **kw)
    before = PA.paged_attention_partials.launches
    outs = [e.run(1000) for e in (graphs, eager, target)]
    assert PA.paged_attention_partials.launches > before
    assert outs[0] == outs[1] == outs[2]
    assert graphs.horizons.graphs and graphs.timing.graph_captures >= 1
    for k in ("spec_rounds", "spec_proposed", "spec_accepted"):
        assert getattr(graphs, k) == getattr(eager, k), k
    assert graphs.timing.device_syncs == eager.timing.device_syncs
    assert graphs.spec_accepted > 0
    assert graphs.alloc.pages_in_use == 0


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["temperature", "top_k"])
def test_spec_engine_stochastic_graphs_draw_as_eager(sampler):
    """Stochastic rounds as graphs: the generators are registered with
    each graph and put back after its capture, so the graph path's tokens
    equal the eager path's for one seed, and the oracle pair accepts
    (nearly) every proposal (p == q up to the products' rounding)."""
    _card()
    kw = dict(prefill_mode="batched", spec_horizon=4, sampler=sampler,
              top_k=8, temperature=0.8, sample_seed=5)
    graphs, eager = _spec_engines(({}, dict(decode_graphs=False)), **kw)
    assert graphs.run(1000) == eager.run(1000)
    assert graphs.timing.graph_captures >= 1
    assert graphs.spec_accepted > 0.9 * graphs.spec_proposed


# ---------------------------------------------------------------------------
# the model zoo's head shapes (D 128) and the MoE engine on the graph path
# ---------------------------------------------------------------------------

# (kv heads, query heads a kv head) at D 128: qwen1.5-7b (no GQA), gemma3-27b,
# phi3.5-moe and mixtral, yi-34b (56 / 8)
ZOO_HEADS = {"qwen1.5-7b": (32, 1), "gemma3-27b": (16, 2),
             "phi3.5-moe": (8, 4), "yi-34b": (8, 7)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,window,qpos,n_splits", [
    ("qwen1.5-7b", 0, 1, 4), ("gemma3-27b", 1024, 1, 4),
    ("gemma3-27b", 0, 1, 1), ("phi3.5-moe", 0, 1, 4), ("yi-34b", 0, 1, 4),
    ("qwen1.5-7b", 0, 5, 4), ("yi-34b", 0, 5, 1)],
    ids=["qwen", "gemma3-local", "gemma3-global", "phi3.5", "yi",
         "qwen-verify", "yi-verify"])
def test_paged_kernel_zoo_heads_match_plain(dtype, heads, window, qpos,
                                            n_splits):
    """K1 at the model zoo's decode (and qpos 5 verify) head layouts, D 128,
    page 16, contexts up to 2048 (gemma3's local layers cut at 1024): the
    kernel launches once a row tile (yi's verify: 35 rows, two tiles) and
    matches its plain version (2e-5 fp32, 2e-2 bf16)."""
    _card()
    from repro_torch.kernels import paged_attention as PA
    KVH, G = ZOO_HEADS[heads]
    rng = np.random.default_rng(KVH * G + qpos)
    q, kp, vp, bt, ctx = _pool_case(rng, dtype, 8, KVH, G * qpos, 128, 16,
                                    128, 2048)
    win = torch.full((8,), window, dtype=torch.int32, device="cuda")
    before = PA.paged_attention_partials.launches
    got = PA.paged_attention_partials(q, kp, vp, bt, ctx, window=win,
                                      n_splits=n_splits, qpos=qpos)
    torch.cuda.synchronize()
    assert PA.paged_attention_partials.launches - before == \
        len(PA.row_tiles(G * qpos))
    want = PA.paged_attention_partials_plain(
        q, kp, vp, bt, ctx, win, ring_width=0, windowed_slice=False,
        n_splits=n_splits, qpos=qpos)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,Skv,offs,window", [
    ("qwen1.5-7b", 1024, [0, 0], 0), ("gemma3-27b", 1024, [0, 0], 1024),
    ("gemma3-27b", 1024, [0, 0], 0), ("gemma3-27b", 2048, [1024, 512], 1024),
    ("phi3.5-moe", 1024, [0, 0], 0), ("yi-34b", 1024, [0, 0], 0)],
    ids=["qwen", "gemma3-local", "gemma3-global", "gemma3-offset",
         "phi3.5", "yi"])
def test_flash_kernel_zoo_heads_match_plain(dtype, heads, Skv, offs, window):
    """K2 at the model zoo's prefill head layouts, D 128, Sq 1024 (G 1, 2,
    4 and 7; gemma3's 1024-token window; a chunk resuming at per-row
    offsets against 2048 keys)."""
    _card()
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    KVH, G = ZOO_HEADS[heads]
    g = torch.Generator(device="cuda").manual_seed(KVH * G + Skv)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
               for s in ((2, 1024, KVH * G, 128), (2, Skv, KVH, 128),
                         (2, Skv, KVH, 128)))
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    got = flash_attention_fwd(q, k, v, window=window, q_offset=off)
    want = flash_attention_plain(q, k, v, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("mode,horizon", [("batched", 4), ("chunked", 1)])
def test_moe_graph_engine_matches_eager_and_plain(arch, mode, horizon):
    """A reduced MoE engine on the card: the routed experts inside the
    captured horizon give the eager and plain engines' tokens and device
    syncs, and K1 and K2 served it."""
    _card()
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    graphs, eager, plain = _engines(
        arch, ({}, dict(decode_graphs=False), dict(use_kernels=False)),
        prefill_mode=mode, decode_horizon=horizon, prefill_chunk=8)
    before = (PA.paged_attention_partials.launches,
              FA.flash_attention_fwd.launches)
    outs = [graphs.run(1000)]
    assert PA.paged_attention_partials.launches > before[0]
    assert FA.flash_attention_fwd.launches > before[1]
    outs += [e.run(1000) for e in (eager, plain)]
    assert outs[0] == outs[1] == outs[2]
    assert graphs.horizons.graphs and graphs.timing.graph_captures >= 1
    assert (graphs.timing.device_syncs == eager.timing.device_syncs
            == plain.timing.device_syncs)
    assert graphs.alloc.pages_in_use == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["batched", "chunked"])
def test_spec_with_moe_target_on_the_card(mode):
    """Speculative decoding with a MoE target (reduced mixtral) and a
    1-layer llama draft, as a captured round (graphs), an eager round and
    the plain path. The graph and eager rounds give the same tokens and
    counters, and K1 served the verify passes. Batched prefill carries no
    idle slot into a verify pass, so the plain path agrees too. Chunked
    prefill does (ROADMAP C.7): an idle slot's verify rows see no token,
    K1 gives them 0 and the plain path the mean of the dead pages' V; the
    rows route and take expert capacity, so the live rows' drops, and
    their tokens, differ from the plain path's."""
    _card()
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.model import init_params
    from repro_torch.serving import DecodeEngine, EngineConfig, Request
    cfg = replace(reduced(get_config("mixtral-8x22b")), dtype="float32")
    dcfg = replace(reduced(get_config("llama3.2-1b"), layers=1),
                   dtype="float32")
    params = init_params(cfg, 0, torch.float32, "cuda")
    dparams = init_params(dcfg, 7, torch.float32, "cuda")
    rng = np.random.default_rng(3)
    reqs = [(r, rng.integers(0, 256, int(rng.integers(4, 25))), 9)
            for r in range(6)]
    engs = []
    for way in ({}, dict(decode_graphs=False), dict(use_kernels=False)):
        eng = DecodeEngine(
            cfg, EngineConfig(n_slots=4, page_size=4, n_pages=64,
                              max_context=40, eos_token=-1, prefill_chunk=4,
                              prefill_mode=mode, decode_horizon=1,
                              draft_config=dcfg,
                              spec_horizon=3, **way),
            params, device="cuda", draft_params=dparams)
        for r, prompt, n in reqs:
            eng.submit(Request(r, prompt, n))
        engs.append(eng)
    graphs, eager, plain = engs
    before = PA.paged_attention_partials.launches
    outs = [graphs.run(1000)]
    assert PA.paged_attention_partials.launches > before
    outs += [e.run(1000) for e in (eager, plain)]
    counters = [(e.timing.decode_tokens, e.timing.device_syncs,
                 e.spec_rounds, e.spec_proposed, e.spec_accepted)
                for e in engs]
    assert graphs.horizons.graphs and graphs.timing.graph_captures >= 1
    assert outs[0] == outs[1] and counters[0] == counters[1]
    assert all(e.alloc.pages_in_use == 0 for e in engs)
    if mode == "batched":
        assert outs[0] == outs[2] and counters[0] == counters[2]
    else:
        assert outs[0] != outs[2], "ROADMAP C.7 no longer shows: close it"


# ---------------------------------------------------------------------------
# the request lifecycle, telemetry and serving snapshots on the card
# ---------------------------------------------------------------------------

def _lifecycle_state(eng) -> dict:
    return {"outputs": {k: list(v) for k, v in eng.outputs.items()},
            "aborted": dict(eng.aborted), "events": list(eng.faults.events),
            "degraded_mode": eng.degraded_mode,
            "device_syncs": eng.timing.device_syncs,
            "migrated": eng.batcher.stats.migrated}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
@pytest.mark.parametrize("mode,horizon", [("batched", 4), ("chunked", 1)])
def test_lifecycle_storm_graphs_match_eager_and_plain(arch, mode, horizon):
    """A seeded storm (exhaustion, row death, NaN quarantine, client
    aborts, a deadline) on the graph engine: the same fired events,
    terminal reasons, degradation, tokens and syncs as the eager and plain
    engines, every request terminal and no page leaked."""
    _card()
    from repro_torch.runtime.faults import FaultConfig
    fc = FaultConfig(seed=7, client_abort_p=0.03, row_death_p=0.02,
                     alloc_exhaust_p=0.08, nan_logits_p=0.02)
    engs = _engines(arch, ({}, dict(decode_graphs=False),
                           dict(use_kernels=False)),
                    prefill_mode=mode, decode_horizon=horizon,
                    prefill_chunk=8, faults=fc, n_rows=2, n_shards=2,
                    degrade_after=2, default_deadline_s=60.0)
    for e in engs:
        e.run(2000)
    states = [_lifecycle_state(e) for e in engs]
    assert states[0] == states[1] == states[2]
    graphs = engs[0]
    assert graphs.faults.total_fired > 0 and graphs.horizons.graphs
    assert graphs.timing.graph_captures == len(graphs.horizons.captured)
    for e in engs:
        assert e.batcher.stats.completed + len(e.aborted) == 5
        assert e.alloc.pages_in_use == 0 and not e.rsnaps
        assert not e.deadline_t and not e._abort_req


@pytest.mark.gpu
def test_lifecycle_spec_degrades_to_a_captured_plain_horizon():
    """Allocation pressure turns speculative decoding off mid-run: the
    graph engine captures a plain horizon of its own, counts it, and its
    tokens equal the eager engine's and the clean target-only run's."""
    _card()
    from repro_torch.runtime.faults import FaultConfig
    fc = FaultConfig(seed=5, alloc_exhaust_p=0.15)
    graphs, eager, clean = _spec_engines(
        (dict(faults=fc, degrade_after=2),
         dict(faults=fc, degrade_after=2, decode_graphs=False),
         dict(draft=False)), prefill_mode="batched", spec_horizon=3)
    outs = [e.run(2000) for e in (graphs, eager, clean)]
    assert outs[0] == outs[1] == outs[2]
    assert graphs.degraded_mode & 2 and eager.degraded_mode & 2
    assert any(not spec for _, _, spec in graphs.horizons.captured)
    assert graphs.timing.graph_captures == len(graphs.horizons.captured)
    for k in ("spec_rounds", "spec_proposed", "spec_accepted"):
        assert getattr(graphs, k) == getattr(eager, k), k
    assert graphs.alloc.pages_in_use == 0 and not graphs._dlen


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_snapshot_kill_restore_on_the_card(arch, tmp_path):
    """Snapshot at tick 3 on the graph engine, abandon it, restore into a
    fresh graph engine (before its first capture): KV pages and carries
    are written in place, and the tokens equal the uninterrupted run's
    (graphs and plain)."""
    _card()
    ref, plain = _engines(arch, ({}, dict(use_kernels=False)),
                          prefill_mode="batched", decode_horizon=4)
    want = ref.run(1000)
    assert plain.run(1000) == want
    (eng,) = _engines(arch, (dict(snapshot_dir=str(tmp_path),
                                  snapshot_every=3),),
                      prefill_mode="batched", decode_horizon=4)
    for _ in range(4):
        eng.tick()
    assert eng.snapshot_saves == 1
    from dataclasses import replace
    from repro_torch.serving import DecodeEngine
    fresh = DecodeEngine(eng.cfg, replace(eng.ecfg, snapshot_every=0),
                         eng.params, device="cuda")
    ptrs = [t.data_ptr() for t in fresh.state["pool"].values()]
    assert fresh.restore_snapshot() == 3
    assert fresh.run(1000) == want
    assert ptrs == [t.data_ptr() for t in fresh.state["pool"].values()]
    assert fresh.horizons.graphs and fresh.alloc.pages_in_use == 0
    with pytest.raises(RuntimeError):
        fresh.restore_snapshot()


@pytest.mark.gpu
def test_telemetry_on_the_card_adds_no_sync():
    """Telemetry on the graph engine: tokens, syncs and kernel launches
    equal the run without it; the trace validates and the tracker's TTFT
    is the engine's."""
    _card()
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.telemetry import TelemetryConfig, validate_trace
    off, on = _engines("llama3.2-1b", ({}, dict(
        telemetry=TelemetryConfig(metrics=True, trace=True))),
        prefill_mode="batched", decode_horizon=4)
    counts = []
    for e in (off, on):
        before = (PA.paged_attention_partials.launches,
                  FA.flash_attention_fwd.launches)
        e.run(1000)
        counts.append((PA.paged_attention_partials.launches - before[0],
                       FA.flash_attention_fwd.launches - before[1]))
    assert off.outputs == on.outputs and counts[0] == counts[1]
    assert off.timing.device_syncs == on.timing.device_syncs
    info = validate_trace(on.tel.trace.to_doc())
    assert info["slices"] > 0
    for r in on.tel.tracker.records:
        assert r.ttft_s == on.first_tok_t[r.req_id] - on.submit_t[r.req_id]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_step_matches_run_on_the_card(arch):
    """``step()`` (one eager decode step, host logits) gives the graph
    engine's ``run()`` tokens, and K1 served it."""
    _card()
    from repro_torch.kernels import paged_attention as PA
    stepped, ran = _engines(arch, ({}, {}), prefill_mode="batched",
                            decode_horizon=4)
    before = PA.paged_attention_partials.launches
    for _ in range(1000):
        if stepped.batcher.done():
            break
        stepped.step()
    assert PA.paged_attention_partials.launches > before
    assert stepped.outputs == ran.run(1000)
    assert stepped.alloc.pages_in_use == 0


# tests/test_cluster.py's geometry: 3 slots, 4-token pages
CLUSTER_KW = dict(n_slots=3, page_size=4, n_pages=96, max_context=64,
                  eos_token=-1, prefill_mode="batched", decode_horizon=4)


def _cluster_case(arch, n=6, **kw):
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_params
    from repro_torch.serving import DecodeEngine, EngineConfig, Request
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = init_params(cfg, 0, torch.float32, "cuda")
    rng = np.random.default_rng(0)
    reqs = [Request(r, rng.integers(0, 256, int(rng.integers(3, 20))), 8)
            for r in range(n)]
    ref = DecodeEngine(cfg, EngineConfig(**{**CLUSTER_KW, **kw}), params,
                       device="cuda")
    for q in reqs:
        ref.submit(q)
    return cfg, params, reqs, {k: list(v) for k, v in ref.run(2000).items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_disagg_matches_colocated_on_the_card(arch):
    """One prefill and one decode engine on one card, both on the graph
    path and the kernels: every request handed off once, tokens equal the
    colocated graph engine's, K1 and K2 launched."""
    _card()
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serving import ClusterConfig, EngineCluster, EngineConfig
    cfg, params, reqs, want = _cluster_case(arch)
    before = (PA.paged_attention_partials.launches,
              FA.flash_attention_fwd.launches)
    cl = EngineCluster(cfg, EngineConfig(**CLUSTER_KW), ClusterConfig(),
                       params, device="cuda")
    for q in reqs:
        cl.submit(q)
    assert {k: list(v) for k, v in cl.run(2000).items()} == want
    assert cl.counters["handoffs"] == cl.counters["handoff_ok"] == len(reqs)
    assert PA.paged_attention_partials.launches > before[0]
    assert FA.flash_attention_fwd.launches > before[1]
    for h in cl.handles:
        assert h.eng.horizons.graphs and h.eng.alloc.pages_in_use == 0
        assert h.eng.timing.graph_captures == len(h.eng.horizons.captured)
    if arch == "zamba2-1.2b":
        assert cl.handles[1].eng.rstate_restores >= 1


@pytest.mark.gpu
def test_engine_death_warm_rebuild_on_the_card(tmp_path):
    """An engine dies mid-run and is rebuilt from its snapshot on the same
    card: the dead engine's graphs and pool are released, the rebuilt
    engine captures its own graphs, the survivor keeps replaying its
    captures, and the tokens equal the colocated run's."""
    _card()
    from repro_torch.runtime.faults import FaultConfig
    from repro_torch.serving import ClusterConfig, EngineCluster, EngineConfig
    # horizon 1: enough ticks for tests/test_cluster.py's death plan
    cfg, params, reqs, want = _cluster_case("llama3.2-1b", decode_horizon=1)
    cl = EngineCluster(cfg, EngineConfig(**{**CLUSTER_KW,
                                            "decode_horizon": 1}),
                       ClusterConfig(
        snapshot_dir=str(tmp_path), snapshot_every=2,
        faults=FaultConfig(seed=2, engine_death_p=0.04, start_tick=6,
                           max_faults=1)), params, device="cuda")
    for q in reqs:
        cl.submit(q)
    survivor_keys = {}
    while not cl.done():
        if not cl.counters["engine_deaths"]:
            survivor_keys = {h.ix: set(h.eng.horizons.captured)
                             for h in cl.handles}
        cl.tick()
    assert {k: list(v) for k, v in cl.outputs.items()} == want
    assert cl.counters["engine_deaths"] == cl.counters["engine_restores"] == 1
    dead = [e for e in cl.engines if not e.state]
    rebuilt = [e for e in cl.engines[2:] if e.snapshot_restores]
    assert len(dead) == 1 and not dead[0].horizons.captured
    assert len(rebuilt) == 1 and rebuilt[0].timing.graph_captures >= 1
    survivor = next(h for h in cl.handles if h.eng not in rebuilt)
    # the survivor's graphs from before the death are still held and were
    # never captured again
    assert survivor_keys[survivor.ix] <= set(survivor.eng.horizons.captured)
    assert survivor.eng.timing.graph_captures \
        == len(survivor.eng.horizons.captured)
    assert all(h.alive and h.eng.alloc.pages_in_use == 0
               for h in cl.handles)


@pytest.mark.gpu
def test_adopt_into_captured_decode_engine_on_the_card():
    """Handoffs adopted after the decode engine's first capture write
    their pages into its pool in place: no tensor a graph reads is
    rebound, no (width, K, spec) key is captured twice, tokens equal the
    colocated run's."""
    _card()
    from repro_torch.serving import ClusterConfig, EngineCluster, EngineConfig
    cfg, params, reqs, want = _cluster_case("llama3.2-1b", n=9)
    cl = EngineCluster(cfg, EngineConfig(**CLUSTER_KW), ClusterConfig(),
                       params, device="cuda")
    dec = cl.handles[1].eng
    captures, late = [], []
    capture, adopt = dec.horizons.capture, dec.adopt_request

    def capture_key(key):
        captures.append(key)
        capture(key)

    def adopt_late(rid, *a, **k):
        if captures:
            late.append(rid)
        return adopt(rid, *a, **k)
    dec.horizons.capture, dec.adopt_request = capture_key, adopt_late

    def ptrs():
        return [t.data_ptr() for t in (
            dec.state["pool"]["k"], dec.state["pool"]["v"], dec.dev.bt,
            dec.dev.ctx, dec.dev.tokens, dec.dev.rem, dec.horizons.allow)]
    before = ptrs()
    for q in reqs:
        cl.submit(q)
    while not cl.done():
        cl.tick()
        assert ptrs() == before
    assert late and captures
    assert len(captures) == len(set(captures)) == len(dec.horizons.captured)
    assert {k: list(v) for k, v in cl.outputs.items()} == want


# ---------------------------------------------------------------------------
# xLSTM on the card (no kernel on its path)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mode,horizon", [("batched", 4), ("chunked", 1),
                                          ("slot", 8)])
def test_xlstm_graph_engine_matches_eager_and_plain(mode, horizon):
    """Reduced xlstm-350m: the graph engine (its mLSTM / sLSTM carries
    written in place inside the captured horizon) against the eager and
    plain engines: tokens and syncs equal, and none of the port's kernels
    launches on the xLSTM path."""
    _card()
    from repro_torch.serving.graphs import launch_counts
    before = launch_counts()
    graphs, eager, plain = _engines(
        "xlstm-350m", ({}, dict(decode_graphs=False),
                       dict(use_kernels=False)),
        prefill_mode=mode, decode_horizon=horizon, prefill_chunk=8)
    outs = [e.run(1000) for e in (graphs, eager, plain)]
    assert outs[0] == outs[1] == outs[2]
    assert launch_counts() == before
    assert graphs.horizons.graphs and graphs.timing.graph_captures >= 1
    assert "pool" not in graphs.state
    assert (graphs.timing.device_syncs == eager.timing.device_syncs
            == plain.timing.device_syncs)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["batched", "chunked"])
def test_xlstm_state_resume_on_the_card(mode):
    """A 24-page pool preempts: the carry rows go to pinned host memory on
    the side stream and come back at re-admission into the rows a captured
    horizon holds; tokens equal the ample pool's."""
    _card()
    (ample,) = _engines("xlstm-350m", ({},), prefill_mode="batched",
                        decode_horizon=4)
    (tight,) = _engines("xlstm-350m", (dict(n_pages=24),),
                        prefill_mode=mode, decode_horizon=4, prefill_chunk=8)
    ptrs = [t.data_ptr() for t in tight.state["mlstm"]]
    assert tight.run(2000) == ample.run(2000)
    assert tight.batcher.stats.preempted and tight.rstate_restores
    assert ptrs == [t.data_ptr() for t in tight.state["mlstm"]]
    assert tight.alloc.pages_in_use == 0 and not tight.rsnaps


@pytest.mark.gpu
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_blocks_on_the_card_match_the_cpu(block):
    """An xLSTM block at xlstm-350m's head widths (mLSTM head dim 512, sLSTM
    256) over 48 masked positions and two steps from a fresh carry, on the
    card and on the CPU: finite, within 1e-5 of the largest magnitude."""
    _card()
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import model as MDL
    from repro_torch.models import ssm as SSM
    cfg = replace(get_config("xlstm-350m"), n_layers=2, dtype="float32")
    params = MDL.init_params(cfg, 0, torch.float32, "cpu")
    p = {k: v[0] for k, v in params[block].items()}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 48, cfg.d_model),
                                             np.float32))
    mask = torch.arange(48)[None] < torch.tensor([48, 30])[:, None]
    fwd = getattr(SSM, f"{block}_forward")
    step = getattr(SSM, f"{block}_step")
    outs = []
    for dev in ("cpu", "cuda"):
        pd = {k: v.to(dev) for k, v in p.items()}
        st = getattr(SSM, f"{block}_init_state")(cfg, 2, device=dev)
        y1, _ = step(pd, cfg, x[:, 0].to(dev), st)
        y2, st = fwd(pd, cfg, x.to(dev), state=st, mask=mask.to(dev))
        y3, st = step(pd, cfg, x[:, 1].to(dev), st)
        outs.append([t.cpu() for t in (y1, y2[mask], y3, *st)])
    for a, b in zip(*outs):
        assert torch.isfinite(b).all()
        gap = float((a - b).abs().max())
        assert gap <= 1e-5 * max(1.0, float(a.abs().max())), gap


# ---------------------------------------------------------------------------
# the enc-dec and M-RoPE families and the ring pool on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_families_cross_decode_kernel_matches_plain(dtype):
    """K3 at whisper-small's cross-attention decode shape (8 slots, 12
    heads, 1500 encoder rows, ``CROSS_SPLITS`` splits, the tail split
    padded): the kernel route against the plain route, eagerly and
    replayed from a CUDA graph."""
    _card()
    from repro_torch.kernels import flash_decode as K
    from repro_torch.kernels import ops
    from repro_torch.kernels.backend import KernelConfig
    g = torch.Generator(device="cuda").manual_seed(1500)
    q = torch.randn(8, 12, 64, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(8, 1500, 12, 64, generator=g, device="cuda")
            .to(dtype) for _ in range(2))
    c = torch.full((8,), 1500, dtype=torch.int32, device="cuda")
    want = ops.cross_attention_decode(q, k, v, c, kernels=KernelConfig(
        use_kernels=False))
    before = K.flash_decode.launches
    got = ops.cross_attention_decode(q, k, v, c, kernels=KernelConfig())
    assert K.flash_decode.launches == before + 1
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.cross_attention_decode(q, k, v, c, kernels=KernelConfig())
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        replayed = ops.cross_attention_decode(q, k, v, c,
                                              kernels=KernelConfig())
    graph.replay()
    torch.cuda.synchronize()
    for out in (got, replayed):
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1500, 416], ids=["encoder", "cross"])
def test_families_flash_noncausal_matches_plain(dtype, Sq):
    """K2 without the causal mask at whisper-small's encoder (Sq = Skv =
    1500, ragged against the 64-token tiles) and cross prefill (a
    416-token prompt against the 1500 frames), counted as non-causal."""
    _card()
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(Sq)
    q = torch.randn(2, Sq, 12, 64, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(2, 1500, 12, 64, generator=g, device="cuda")
            .to(dtype) for _ in range(2))
    before = flash_attention_fwd.launches_noncausal
    got = flash_attention_fwd(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches_noncausal == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("mode,horizon", [("batched", 4), ("chunked", 1),
                                          ("slot", 8)])
def test_families_whisper_graph_engine_matches_eager_and_plain(mode,
                                                                horizon):
    """Reduced whisper-small: the graph engine (the cross rows static rows
    of the captured horizon, K3 inside it; the encoder and the cross
    prefill on K2 without the causal mask) against the eager and plain
    engines: tokens and device syncs equal."""
    _card()
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    graphs, eager, plain = _engines(
        "whisper-small", ({}, dict(decode_graphs=False),
                          dict(use_kernels=False)),
        prefill_mode=mode, decode_horizon=horizon, prefill_chunk=8)
    rows = graphs.state["cross_k"].data_ptr()
    before = (FD.flash_decode.launches,
              FA.flash_attention_fwd.launches_noncausal)
    outs = [graphs.run(1000)]
    assert FD.flash_decode.launches > before[0]
    assert FA.flash_attention_fwd.launches_noncausal > before[1]
    outs += [e.run(1000) for e in (eager, plain)]
    assert outs[0] == outs[1] == outs[2]
    assert graphs.horizons.graphs and graphs.timing.graph_captures >= 1
    assert graphs.state["cross_k"].data_ptr() == rows
    assert (graphs.timing.device_syncs == eager.timing.device_syncs
            == plain.timing.device_syncs)


@pytest.mark.gpu
def test_families_qwen2vl_graph_engine_matches_plain():
    """Reduced qwen2-vl-7b (M-RoPE, one id on all three axes in serving):
    the graph engine against the plain engine."""
    _card()
    graphs, plain = _engines("qwen2-vl-7b", ({}, dict(use_kernels=False)),
                             prefill_mode="batched", decode_horizon=4)
    assert graphs.run(1000) == plain.run(1000)
    assert graphs.horizons.graphs


@pytest.mark.gpu
def test_families_ring_engine_matches_full_pool():
    """Reduced mixtral (window 16) on a ring of 5 pages of 4 tokens
    against the full pool, on the graph path: prompts past the window,
    tokens equal, each request held to the ring."""
    _card()
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    from repro_torch.models.model import init_params
    from repro_torch.serving import DecodeEngine, EngineConfig, Request
    cfg = replace(reduced(get_config("mixtral-8x22b")), dtype="float32")
    params = init_params(cfg, 0, torch.float32, "cuda")
    W = (cfg.sliding_window + 4) // 4 + 1
    rng = np.random.default_rng(3)
    reqs = [(r, rng.integers(0, 256, int(rng.integers(23, 42))), 12)
            for r in range(4)]
    outs = []
    for ring in (0, W):
        eng = DecodeEngine(cfg, EngineConfig(
            n_slots=2, page_size=4, n_pages=128, max_context=64,
            eos_token=-1, prefill_mode="slot", decode_horizon=4,
            kernel_splits=2), params, MDL.Runtime(
                ring_width=ring, kernels=KernelConfig(n_splits=2)),
            device="cuda")
        for r, prompt, n in reqs:
            eng.submit(Request(r, prompt, n))
        outs.append(eng.run(1000))
        assert eng.horizons.graphs and eng.alloc.pages_in_use == 0
        if ring:
            assert eng.alloc.ring_pages == W
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# training on the card; the legacy sample= callable; int8 weight-only quant
# ---------------------------------------------------------------------------

def _train_case(arch, device, seed=0):
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.models.model import init_params
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = init_params(cfg, seed, torch.float32, "cpu")
    pipe = TrainPipeline(cfg.vocab_size, 16, 4)
    return cfg, params, [pipe.batch(i) for i in range(2)]


def _run_steps(cfg, params, batches, device):
    from repro_torch.models import model as MDL
    from repro_torch.models.model import tree_map
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train import make_train_step, to_device
    step = make_train_step(cfg, MDL.DEFAULT_RT, OPT.AdamWConfig(
        lr=1e-3, warmup_steps=1))
    params = tree_map(lambda t: t.to(device), params)
    opt, losses = OPT.init(params), []
    for b in batches:
        params, opt, m = step(params, opt, to_device(b, device))
        losses.append(float(m["loss"]))
    return params, losses


def _leaf_gap(a, b):
    from repro_torch.training.optimizer import tree_leaves
    return max(float((x.cpu() - y.cpu()).abs().max())
               / max(float(y.abs().max()), 1e-30)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b",
                                  "mixtral-8x22b"])
def test_train_step_on_the_card_matches_the_cpu(arch):
    """A reduced train step on the card against the port on the CPU (which
    the CPU tests hold to repro): 2 steps' losses within 1e-5 relative;
    the grads from the same weights within 1e-4 of each leaf's largest
    magnitude; AdamW's update from the same grads within 1e-6; K1-K4
    launch 0 times. (The free-running params are not compared: ROADMAP
    C.11.)"""
    _card()
    from repro_torch.models import model as MDL
    from repro_torch.models.model import tree_map
    from repro_torch.serving.graphs import launch_counts
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train import to_device
    cfg, params, batches = _train_case(arch, "cuda")
    before = launch_counts()
    _, lg = _run_steps(cfg, params, batches, "cuda")
    _, lc = _run_steps(cfg, params, batches, "cpu")
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    grads = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        leaves = [t.detach().requires_grad_(True)
                  for t in OPT.tree_leaves(p)]
        loss, _ = MDL.train_loss(cfg, OPT.tree_unflatten(p, leaves),
                                 to_device(batches[0], dev))
        grads[dev] = OPT.tree_unflatten(
            p, list(torch.autograd.grad(loss, leaves)))
    assert launch_counts() == before
    assert _leaf_gap(grads["cuda"], grads["cpu"]) <= 1e-4
    ocfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1)
    cuda_p = tree_map(lambda t: t.cuda(), params)
    up = OPT.apply(ocfg, cuda_p, tree_map(lambda t: t.cuda(), grads["cpu"]),
                   OPT.init(cuda_p))[0]
    want = OPT.apply(ocfg, params, grads["cpu"], OPT.init(params))[0]
    assert _leaf_gap(up, want) <= 1e-6


@pytest.mark.gpu
def test_train_loss_with_kernels_raises_on_the_card():
    _card()
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    from repro_torch.models.model import tree_map
    from repro_torch.training.train import to_device
    cfg, params, batches = _train_case("llama3.2-1b", "cuda")
    params = tree_map(lambda t: t.cuda(), params)
    with pytest.raises(ValueError, match="no backward"):
        MDL.train_loss(cfg, params, to_device(batches[0], "cuda"),
                       rt=MDL.Runtime(kernels=KernelConfig()))


@pytest.mark.gpu
def test_sample_callable_engine_on_the_card():
    """A host ``sample=`` greedy callable on the card: the eager horizon
    (one logits readback a step, counted apart from device syncs) gives
    the graph engine's greedy tokens; ``decode_graphs=True`` raises."""
    _card()
    from repro_torch.serving import DecodeEngine, EngineConfig
    graphs, eng = _engines("llama3.2-1b",
                           ({}, dict(sample=lambda r: int(np.argmax(r)))),
                           prefill_mode="batched", decode_horizon=4)
    assert eng.run(1000) == graphs.run(1000)
    assert not eng.horizons.graphs and graphs.horizons.graphs
    assert eng.timing.sample_readbacks == eng.timing.decode_steps > 0
    with pytest.raises(ValueError, match="sample= callable"):
        DecodeEngine(graphs.cfg, EngineConfig(decode_graphs=True,
                                              **ENGINE_KW),
                     graphs.params, device="cuda", sample=int)


@pytest.mark.gpu
def test_quantized_decode_on_the_card():
    """int8 weight-only params on the card: logits within repro's bound
    of the fp32 model's, and a quantized engine's graph path (K1 decode,
    K2 prefill) equal to its eager path."""
    _card()
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import quant as Q
    from repro_torch.models import model as MDL
    from repro_torch.models.model import init_params
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    params = init_params(cfg, 0, torch.float32, "cuda")
    qparams = Q.quantize_params(params, min_size=1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        fp = MDL.forward(cfg, params, toks)[0].cpu().numpy()
        qq = MDL.forward(cfg, qparams, toks)[0].cpu().numpy()
    assert np.abs(qq - fp).max() < 0.12 * (fp.max() - fp.min())
    assert (fp.argmax(-1) == qq.argmax(-1)).mean() >= 0.75
    graphs, eager = _engines("llama3.2-1b", ({}, dict(decode_graphs=False)),
                             params=qparams, prefill_mode="batched",
                             decode_horizon=4)
    assert graphs.run(1000) == eager.run(1000)


# ---------------------------------------------------------------------------
# the multi-device serving paths on a single-process mesh
# ---------------------------------------------------------------------------

def _itpp_case(dev, *, B, H, KVH, D, page, maxp, n_pages, ctx_prev, policy,
               n_rows=1):
    from repro_torch.core.allocator import PageAllocator
    alloc = PageAllocator(n_pages, 8, page, policy=policy, n_rows=n_rows)
    bts = []
    for b in range(B):
        alloc.admit(b, int(ctx_prev[b]) + 1,
                    row=b * n_rows // B if policy == "row_affine" else None)
        bts.append(alloc.block_table(b, maxp))
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def r(*s):
        return torch.randn(s, generator=g, device=dev)
    bt = torch.tensor(np.stack(bts), device=dev)
    return dict(q=r(B, H, D), kn=r(B, KVH, D), vn=r(B, KVH, D),
                pk=r(n_pages + 1, page, KVH, D),
                pv=r(n_pages + 1, page, KVH, D), bt=bt,
                ctx=torch.tensor(ctx_prev + 1, dtype=torch.int32,
                                 device=dev),
                npage=bt[torch.arange(B, device=dev),
                         torch.tensor(ctx_prev // page, device=dev)],
                noff=torch.tensor(ctx_prev % page, dtype=torch.int32,
                                  device=dev))


def _itpp_run(c, f):
    pk, pv = c["pk"].clone(), c["pv"].clone()
    out, pk, pv = f(c["q"], c["kn"], c["vn"], pk, pv, c["bt"], c["ctx"],
                    c["npage"], c["noff"])
    return out, pk


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["striped8", "rows2x4"])
def test_sharded_itpp_on_k1_matches_single_shard_and_plain(layout):
    """The sharded ITPP on a LocalMesh, K1 on each shard's local table,
    against the single-shard K1 and the plain gather path: outputs within
    2e-5, the pools bitwise; K1 launches one a shard."""
    _card()
    from repro_torch.core import itpp as IT
    from repro_torch.distributed.mesh import LocalMesh
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.kernels.paged_attention import paged_attention_partials
    page, maxp = 16, 32
    if layout == "striped8":
        mesh = LocalMesh((8,), ("model",))
        spec = IT.ItppSpec(("model",), ("model",), None, 8, 8, page)
        c = _itpp_case("cuda", B=4, H=32, KVH=8, D=64, page=page, maxp=maxp,
                       n_pages=256, ctx_prev=np.array([300, 17, 500, 0]),
                       policy="striped")
    else:
        mesh = LocalMesh((2, 4), ("data", "model"))
        spec = IT.ItppSpec(("data", "model"), ("model",), "data", 8, 4,
                           page)
        c = _itpp_case("cuda", B=8, H=32, KVH=8, D=64, page=page, maxp=maxp,
                       n_pages=256,
                       ctx_prev=np.array([300, 17, 500, 60, 1, 99, 256, 33]),
                       policy="row_affine", n_rows=2)
    kc = KernelConfig(n_splits=4)
    f = IT.make_itpp_attention(mesh, spec, max_pages_per_req=maxp,
                               kernels=kc)
    n0 = paged_attention_partials.launches
    out, pk = _itpp_run(c, lambda *a: f(*a, 0))
    assert paged_attention_partials.launches - n0 == 8
    one, pk1 = _itpp_run(c, lambda *a: IT.itpp_decode_attention_shard(
        *a, 0, max_pages_per_req=maxp, kernels=kc))
    plain, _ = _itpp_run(c, lambda *a: IT.itpp_decode_attention_shard(
        *a, 0, max_pages_per_req=maxp))
    torch.testing.assert_close(out, one, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)
    assert torch.equal(pk[:256], pk1[:256])


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 40])
def test_windowed_slice_through_itpp_shard(window):
    """``cond_window`` on the card: a windowed layer launches K1 in
    ``windowed_slice`` mode over ``cond_window // page + 2`` table slots,
    a global layer over the whole table; both equal the plain path."""
    _card()
    from repro_torch.core import itpp as IT
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.kernels.paged_attention import paged_attention_partials
    page, maxp = 16, 40
    c = _itpp_case("cuda", B=4, H=16, KVH=4, D=128, page=page, maxp=maxp,
                   n_pages=256, ctx_prev=np.array([600, 17, 333, 0]),
                   policy="striped")
    n0 = paged_attention_partials.launches_windowed
    out, _ = _itpp_run(c, lambda *a: IT.itpp_decode_attention_shard(
        *a, window, max_pages_per_req=maxp, cond_window=64,
        kernels=KernelConfig(n_splits=2)))
    plain, _ = _itpp_run(c, lambda *a: IT.itpp_decode_attention_shard(
        *a, window, max_pages_per_req=maxp))
    assert paged_attention_partials.launches_windowed - n0 == \
        (1 if window else 0)
    torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_moe_ep_on_the_card_matches_local():
    """``moe_ep`` over 8 shards of a LocalMesh on the card (reduced
    mixtral, 4 experts x 2 ff slices, dropless) against ``moe_local``."""
    _card()
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import mesh as M
    from repro_torch.models import moe as MOE
    cfg = replace(reduced(get_config("mixtral-8x22b")), dtype="float32",
                  capacity_factor=8.0)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    p = MOE.init_moe(cfg, lambda s, sc: torch.randn(
        s, generator=g, device="cuda") * sc, n_virtual=8)
    x = torch.randn((2, 16, cfg.d_model), generator=g, device="cuda")

    def body(pw, x_loc):
        B, S, D = x_loc.shape
        y, aux = MOE.moe_ep(pw, cfg, x_loc.reshape(-1, D), "model", 8)
        return y.reshape(B, S, D), M.pmean(aux, "model")
    spec = {"router": None, "w1": M.P("model"), "w2": M.P("model"),
            "w3": M.P("model")}
    y, _ = M.shard_map(body, M.LocalMesh((8,), ("model",)),
                       in_specs=(spec, M.P(None, "model")),
                       out_specs=(M.P(None, "model"), None))(p, x)
    ref = MOE.moe_local(p, cfg, x)
    assert float((y - ref).abs().max()) < 2e-5 * float(ref.abs().max())


def _mesh_train_case(arch, B):
    """Reduced fp32 weights from seed 0 and one seeded batch of B x 16."""
    from dataclasses import replace
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as MDL
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    if cfg.is_moe:
        cfg = replace(cfg, capacity_factor=8.0)     # drops nothing
    params = MDL.init_params(cfg, seed=0, device="cuda",
                             moe_virtual=4 if cfg.is_moe else 0)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, 16), generator=g)
    batch = {"tokens": toks, "targets": toks.roll(-1, 1),
             "mask": torch.ones(B, 16)}
    return cfg, params, {k: v.cuda() for k, v in batch.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fsdp", "sp", "moe"])
def test_sharded_train_step_on_the_card(case, monkeypatch):
    """``make_train_step`` on a (data 2, model 4) LocalMesh on the card,
    every divisible leaf cut (``REPLICATE_SMALL`` 0), against the unsharded
    step on the card: loss and grad norm within 1e-5 relative, AdamW's
    first moments (the clipped grads) within 1e-4 of each leaf's scale.
    ``sp`` gathers K/V over ``model`` and the MoE runs ``moe_ep``'s
    all_to_alls inside the shards' backward, which runs on the shard's
    thread (the collectives would deadlock on autograd's device thread);
    the MoE's reference returns the shards' mean aux."""
    _card()
    from repro_torch.configs import ParallelConfig, ShapeConfig
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as MDL
    from repro_torch.models import moe as MOE
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train import make_train_step
    monkeypatch.setattr(SH, "REPLICATE_SMALL", 0)
    B = 2 if case == "sp" else 8
    cfg, params, batch = _mesh_train_case(
        "mixtral-8x22b" if case == "moe" else "llama3.2-1b", B)
    ocfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1)
    plan = SH.make_plan(M.LocalMesh((2, 4), ("data", "model")),
                        ParallelConfig(), ShapeConfig("t", "train", 16, B))
    assert plan.train_layout == ("sp" if case == "sp" else "fsdp")

    def shard_mean_moe(p, cfg_, x):             # fsdp: a row a shard
        return MOE.moe_local(p, cfg, x), torch.stack(
            [MOE.aux_loss(p["router"], cfg, x[r])
             for r in range(x.shape[0])]).mean()
    ref = make_train_step(cfg, MDL.Runtime(
        remat=True, moe=shard_mean_moe if cfg.is_moe else None), ocfg)
    _, o0, m0 = ref(params, OPT.init(params), batch)
    step = make_train_step(cfg, plan.make_runtime(cfg, ParallelConfig(),
                                                  mode="train"), ocfg,
                           specs=plan.param_specs(params, mode="train"))
    _, o1, m1 = step(params, OPT.init(params), batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-5)
    assert _leaf_gap(o1["m"], o0["m"]) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_sharded_prefill_on_the_card(arch):
    """``sharding.make_prefill_step`` on a (data 2, model 4) LocalMesh on
    the card with the kernels (K2 at each shard's ``q_offset``; zamba2's
    Mamba2 on K4 over the gathered sequence) against the unsharded kernel
    prefill: logits and pool pages within 1e-4 of their scale."""
    _card()
    from dataclasses import replace
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_config
    from repro_torch.configs import reduced
    from repro_torch.core import paged_kv as PK
    from repro_torch.core.allocator import PageAllocator
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = MDL.init_params(cfg, seed=0, device="cuda")
    B, S, page = 2, 64, 4
    parallel = ParallelConfig(page_size=page)
    shape = ShapeConfig("p", "prefill", S, B)
    plan = SH.make_plan(M.LocalMesh((2, 4), ("data", "model")), parallel,
                        shape)
    spec = PK.pool_spec_for(cfg, shape, parallel, n_shards=8)
    alloc = PageAllocator(spec.n_pages, 8, page, policy="row_affine",
                          n_rows=2)
    for b in range(B):
        alloc.admit(b, S, row=b)
    bt = torch.from_numpy(np.stack([alloc.block_table(
        b, spec.max_pages_per_req) for b in range(B)])).to(torch.int32).cuda()
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g).cuda()
    lens = torch.tensor([S, S - 7], device="cuda")
    st0 = MDL.init_decode_state(cfg, spec, B, device="cuda")
    lg0, st0 = MDL.prefill(cfg, params, st0, toks, bt, last_idx=lens - 1,
                           valid_len=lens,
                           rt=MDL.Runtime(kernels=KernelConfig()))
    lg1, st1 = SH.make_prefill_step(
        cfg, plan, parallel, spec,
        specs=plan.param_specs(params, mode="train"))(
        params, MDL.init_decode_state(cfg, spec, B, device="cuda"),
        {"tokens": toks, "bt": bt, "valid_len": lens, "last_idx": lens - 1})
    scale = float(lg0.abs().max())
    assert float((lg1 - lg0).abs().max()) <= 1e-4 * scale
    for k in ("k", "v"):
        a, b = st1["pool"][k][:, :spec.n_pages], st0["pool"][k][:, :spec.n_pages]
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-27b",
                                  "phi3.5-moe-42b-a6.6b", "zamba2-1.2b"])
def test_sharded_decode_on_the_card(arch, monkeypatch):
    """``sharding.make_decode_step`` on a (data 2, model 4) LocalMesh on
    the card with the kernels (every divisible leaf cut: Megatron TP over
    ``model``; K1 on each shard's table; zamba2's Mamba2 steps on K4)
    against the unsharded kernel step, 4 greedy steps from the same
    prefill: tokens identical, logits within 1e-5 of their scale."""
    _card()
    from dataclasses import replace
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_config
    from repro_torch.configs import reduced
    from repro_torch.core import paged_kv as PK
    from repro_torch.core.allocator import PageAllocator
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    monkeypatch.setattr(SH, "REPLICATE_SMALL", 0)
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    if cfg.is_moe:
        cfg = replace(cfg, capacity_factor=8.0)
    params = MDL.init_params(cfg, seed=0, device="cuda",
                             moe_virtual=4 if cfg.is_moe else 0)
    B, S, page, steps, n_pages = 4, 24, 4, 4, 64
    maxp = (S + steps) // page + 1
    n_attn = sum(k in ("attn", "local") for k in cfg.block_kinds())
    spec = PK.PoolSpec(n_attn, n_pages, page, cfg.n_kv_heads, cfg.d_head,
                       maxp, dtype="float32")
    parallel = ParallelConfig(page_size=page)
    plan = SH.make_plan(M.LocalMesh((2, 4), ("data", "model")), parallel,
                        ShapeConfig("d", "decode", S + steps, B))
    alloc = PageAllocator(n_pages, 8, page, policy="row_affine", n_rows=2)
    for b in range(B):
        alloc.admit(b, S + steps, row=b // 2)
    bt = torch.from_numpy(np.stack([alloc.block_table(b, maxp)
                                    for b in range(B)])).to(torch.int32).cuda()
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g).cuda()
    rt = MDL.Runtime(kernels=KernelConfig())
    state = MDL.init_decode_state(cfg, spec, B, device="cuda")
    lg, state = MDL.prefill(cfg, params, state, toks, bt, rt=rt)
    state_u = MDL.tree_map(torch.clone, state)
    step = SH.make_decode_step(cfg, plan, parallel, spec,
                               specs=plan.param_specs(params, mode="serve"))
    V = cfg.vocab_size
    tok = lg[:, :V].argmax(-1).to(torch.int32)
    rows = torch.arange(B, device="cuda")
    for j in range(steps):
        pos = torch.full((B,), S + j, dtype=torch.int32, device="cuda")
        batch = {"tokens": tok, "bt": bt, "ctx": pos + 1,
                 "npage": bt[rows, (pos // page).long()].contiguous(),
                 "noff": (pos % page).to(torch.int32)}
        lg_s, state = step(params, state, batch)
        lg_u, state_u = MDL.decode_step(cfg, params, state_u, tok, bt,
                                        batch["ctx"], batch["npage"],
                                        batch["noff"], rt=rt)
        scale = float(lg_u.abs().max())
        assert float((lg_s - lg_u).abs().max()) <= 1e-5 * scale, (arch, j)
        assert torch.equal(lg_s[:, :V].argmax(-1), lg_u[:, :V].argmax(-1))
        tok = lg_s[:, :V].argmax(-1).to(torch.int32)
