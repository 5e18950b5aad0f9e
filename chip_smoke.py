#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device  — a CUDA card of compute capability 9.0; prints its name and
   power limit (``nvidia-smi``).
2. build   — compiles ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a
   (one nvcc per source, in parallel) and prints ptxas' registers, shared
   memory and spills per kernel.
3. kernels — every CUDA kernel against its plain PyTorch version at the
   shapes the serving paths give it (llama3.2-1b and zamba2-1.2b), in fp32
   and with bf16 inputs, with the kernel's time, its bound, the plain
   version's time and a library call's time where one exists (CUDA events
   after warm-up). Tolerances: attention fp32 2e-5 and bf16 2e-2 absolute
   (reduction order; bf16 rounding of the probabilities); the Mamba2 scan
   2e-5 of the output's largest magnitude for both input types (fp32
   arithmetic on both sides — bf16 inputs are upcast exactly — so only the
   reduction order differs, and the sums reach magnitudes of ~100).
   K3 (ITPP split-K flash decode) at the kernel bench's shape, at a tail
   split with dead splits and a ctx = 0 row, and at llama3.2-1b's decode
   geometry over 32768 tokens, with ``F.scaled_dot_product_attention`` as
   its library yardstick (it gives the MERGED output, not the partials);
   K1 also at 256-token pages with D 128 and at the bench's decode-step
   shape (ctx 262144, ``n_splits`` 1 and 64).
4. bench   — ``python -m repro_torch.launch.kernel_bench`` at full size,
   in-process: its asserts must hold and each kernel's launch count must
   equal the calls the bench made of its wrapper (K3 launches only here).
5. engine  — llama3.2-1b and zamba2-1.2b at full width and depth (random
   fp32 weights from a seed, fp32 paged pool) served through
   ``repro_torch.serving.DecodeEngine`` in batched and chunked prefill,
   once with the kernels and once with the plain paths: greedy tokens must
   be identical (a first divergence whose plain-path logit gap is below
   1e-5 is a near tie, ROADMAP C.3: printed, not a fault), every request
   complete, every page released, and each kernel's launch count equal to
   what the run's decode steps and prefill calls imply.
6. profile — each model's batched configuration under ``torch.profiler``:
   device busy time against wall time, and the kernels that take it.

``python3 chip_smoke.py --paged-times SRC`` only times K1 of the package
under ``SRC`` at the engine's page-16 shapes (to compare two K1 versions
in one call).

The last three lines: the card's name and power limit, one JSON object
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
DEV = "cuda"
HBM_BYTES_S = 3.35e12                       # H100 SXM device memory
PEAK = {torch.float32: 67e12,               # fp32 outside the tensor cores
        torch.bfloat16: 989e12}             # bf16 tensor cores, dense
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSM_TOL = 2e-5                              # of the largest magnitude
TIE_GAP = 1e-5                              # ROADMAP C.3 near-tie rule


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("[device] torch.cuda.is_available() is False: no card",
              file=sys.stderr)
        sys.exit(2)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"need compute capability 9.0 (Hopper), got {cap}")
    # fp32 products stay full fp32 (no TF32) so the kernel paths can be
    # held to the plain paths at fp32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} | nvidia-smi: {smi}", flush=True)
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    res = build.build_all()
    dt = time.perf_counter() - t0
    print(f"[build] nvcc {' '.join(build.FLAGS)}: {len(res)} sources in "
          f"{dt:.1f} s (" + ", ".join(f"{n} done at {r['seconds']:.1f} s"
                                      for n, r in res.items()) + ")",
          flush=True)
    # the kernels take their shared memory dynamically (ptxas does not
    # report it), at the main-path shapes: paged_attention G=4 rows at D 64
    # and D 128 (64-token sub-tiles whatever the page size); flash_decode
    # G=4 at D 128 and 64; flash_attention 64 query rows and 32-token K/V
    # tiles; ssm_scan N=P=64 at chunk 128 and at decode's chunk 1
    from repro_torch.kernels.flash_decode import _lib as fd_lib
    from repro_torch.kernels.paged_attention import _lib as pa_lib
    from repro_torch.kernels.ssm_scan import _lib as ssm_lib
    smem = ssm_lib().ssm_chunk_scan_smem
    pa, fd = pa_lib().paged_attention_smem, fd_lib().flash_decode_smem
    print(f"[build] dynamic shared memory: paged_attention {pa(4, 64)} B "
          f"(D 64) / {pa(4, 128)} B (D 128), flash_decode {fd(4, 128)} B "
          f"(D 128) / {fd(4, 64)} B (D 64), flash_attention "
          f"{4 * (64 * 64 + 32 * 65 + 32 * 64)} B, ssm_scan "
          f"{smem(64, 64, 128)} B (chunk 128) / {smem(64, 64, 1)} B "
          f"(chunk 1) per block", flush=True)
    for name, r in res.items():
        for line in r["log"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")
    sys.stdout.flush()


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _pool_case(rng, dev, dtype, B, KVH, G, D, page, W, *, ctx_max, qpos=1,
               ctx_fixed=None):
    P = B * W + 1
    q = torch.randn(B, KVH, G * qpos, D, device=dev).to(dtype)
    kp = torch.randn(P, page, KVH, D, device=dev).to(dtype)
    vp = torch.randn(P, page, KVH, D, device=dev).to(dtype)
    bt = torch.from_numpy(rng.permutation(P)[:B * W].reshape(B, W)
                          .astype(np.int32)).to(dev)
    ctx = (rng.integers(1, ctx_max + 1, B) if ctx_fixed is None
           else np.full(B, ctx_fixed))
    return q, kp, vp, bt, torch.from_numpy(ctx.astype(np.int32)).to(dev)


def check_paged(rng, dtype, *, B=8, KVH=8, G=4, D=64, page=16, W=128,
                ctx_max=2048, n_splits=1, window=0, ring_width=0,
                windowed_slice=False, qpos=1, idle_row=False, time_it=False,
                ctx_fixed=None):
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.ref import combine_partials
    from repro_torch.kernels.backend import decode_hbm_bytes
    dev = DEV
    q, kp, vp, bt, ctx = _pool_case(rng, dev, dtype, B, KVH, G, D, page, W,
                                    ctx_max=ctx_max, qpos=qpos,
                                    ctx_fixed=ctx_fixed)
    if idle_row:                     # ctx 0, all -1 table: every split dead
        bt[-1] = -1
        ctx[-1] = 0
    win = torch.full((B,), window, dtype=torch.int32, device=dev)
    kw = dict(ring_width=ring_width, windowed_slice=windowed_slice,
              n_splits=n_splits, qpos=qpos)

    def kern():
        return PA.paged_attention_partials(q, kp, vp, bt, ctx, window=win,
                                           **kw)

    def plain():
        return PA.paged_attention_partials_plain(q, kp, vp, bt, ctx, win,
                                                 **kw)

    def merged(parts):
        o, l, _ = combine_partials(*parts)
        return o / l.clamp_min(1e-30)[..., None]

    got, want = kern(), plain()
    torch.cuda.synchronize()
    out_k, out_p = merged(got), merged(want)
    if not torch.isfinite(out_k).all():
        fail("paged_attention_partials: non-finite output")
    if idle_row and not torch.all(out_k[-1] == 0):
        fail("paged_attention_partials: idle row is not 0")
    err = (out_k - out_p).abs().max().item()
    lerr = ((got[1] - want[1]).abs() / want[1].abs().clamp_min(1)).max().item()
    merr = (got[2] - want[2]).abs().max().item()
    tol = TOL[dtype]
    ok = err <= tol and lerr <= tol and merr <= tol
    res = {"max_abs_err": err, "ok": ok}
    if time_it:
        res["ms"] = cuda_ms(kern)
        res["plain_ms"] = cuda_ms(plain, iters=5)
        esz = torch.finfo(dtype).bits // 8
        S = max(1, min(n_splits, W))
        live = float(ctx.sum().item())
        nbytes = (decode_hbm_bytes(live, KVH, D, esz) + q.numel() * esz
                  + S * B * KVH * G * qpos * (D + 2) * 4
                  + bt.numel() * 4 + ctx.numel() * 4)
        flops = 4.0 * KVH * G * qpos * D * live
        res["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_S, flops / PEAK[dtype])
        res["bound_by"] = ("bytes" if nbytes / HBM_BYTES_S
                           >= flops / PEAK[dtype] else "operations")
    return res


def _causal_pairs(B, Sq, Skv, offs, window) -> float:
    total = 0
    for b in range(B):
        pos = offs[b] + np.arange(Sq)
        hi = np.minimum(pos, Skv - 1)
        lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
        total += int(np.maximum(hi - lo + 1, 0).sum())
    return float(total)


def check_flash(dtype, *, B=2, Sq=1024, Skv=1024, H=32, KVH=8, D=64,
                offs=(0, 0), window=0, time_it=False):
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    dev = DEV
    q = torch.randn(B, Sq, H, D, device=dev).to(dtype)
    k = torch.randn(B, Skv, KVH, D, device=dev).to(dtype)
    v = torch.randn(B, Skv, KVH, D, device=dev).to(dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)

    def kern():
        return flash_attention_fwd(q, k, v, causal=True, window=window,
                                   q_offset=off)

    def plain():
        return flash_attention_plain(q, k, v, causal=True, window=window,
                                     q_offset=off)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail("flash_attention_fwd: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    res = {"max_abs_err": err, "ok": err <= TOL[dtype]}
    if time_it:
        res["ms"] = cuda_ms(kern)
        res["plain_ms"] = cuda_ms(plain, iters=5)
        esz = torch.finfo(dtype).bits // 8
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * esz
        flops = 4.0 * H * D * _causal_pairs(B, Sq, Skv, offs, window)
        res["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_S, flops / PEAK[dtype])
        res["bound_by"] = ("bytes" if nbytes / HBM_BYTES_S
                           >= flops / PEAK[dtype] else "operations")
        if not any(offs) and not window and Sq == Skv:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            res["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
    return res


def check_ssm(dtype, *, B=8, S=1024, H=64, N=64, P=64, chunk=128,
              masked=False, time_it=False):
    """K4 against its plain version on Mamba2-like inputs: q/k shared by
    every head (stride-0 views, as ``mamba_forward`` passes them), decays
    -softplus(z), a non-zero carried (C, n) state."""
    from repro_torch.kernels.ssm_scan import (ssm_chunk_scan,
                                              ssm_chunk_scan_plain)
    from repro_torch.models.ssm import mask_log_gates_tail
    g = torch.Generator(device=DEV).manual_seed(S + B)

    def f(*shape):
        return torch.randn(shape, generator=g, device=DEV)
    q, k = (f(B, S, 1, N).to(dtype).expand(B, S, H, N) for _ in "qk")
    v = f(B, S, H, P).to(dtype)
    la, lg = -F.softplus(f(B, S, H)), f(B, S, H) * 0.1
    st = (f(B, H, N, P) * 0.3, f(B, H, N) * 0.3)
    vl = (torch.randint(1, S + 1, (B,), generator=g, device=DEV)
          if masked else None)
    ma, mg = (la, lg) if vl is None else mask_log_gates_tail(la, lg, vl)

    def kern():
        return ssm_chunk_scan(q, k, v, la, lg, chunk=chunk, state=st,
                              valid_len=vl)

    def plain():
        return ssm_chunk_scan_plain(q, k, v, ma, mg, chunk=chunk, state=st)

    (y, (C, n)), (yp, (Cp, np_)) = kern(), plain()
    torch.cuda.synchronize()
    if not (torch.isfinite(y).all() and torch.isfinite(C).all()
            and torch.isfinite(n).all()):
        fail("ssm_chunk_scan: non-finite output")
    if vl is not None:          # pad rows of y are garbage by contract
        live = torch.arange(S, device=DEV)[None] < vl[:, None]
        y, yp = y[live], yp[live]
    err = max((a - b).abs().max().item()
              for a, b in ((y, yp), (C, Cp), (n, np_)))
    rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1)).item()
              for a, b in ((y, yp), (C, Cp), (n, np_)))
    res = {"max_abs_err": err, "max_rel_err": rel, "ok": rel <= SSM_TOL}
    if time_it:
        res["ms"] = cuda_ms(kern)
        res["plain_ms"] = cuda_ms(plain, iters=5)
        esz = torch.finfo(dtype).bits // 8
        # each input read once (q/k hold B*S*N values: one row shared by
        # the heads), y and the state written once
        nbytes = (esz * (2 * B * S * N + B * S * H * P) + 4 * 2 * B * S * H
                  + 4 * 2 * (B * H * N * P + B * H * N) + 4 * B * S * H * P)
        # per chunk and (b, h): q k^T and S v on the causal half, q C and
        # k^T v in full; fp32 arithmetic for either input type
        c = min(chunk, S)
        flops = B * H * (S // c) * (c * (c + 1) * (N + P) + 4 * c * N * P)
        fp32 = PEAK[torch.float32]
        res["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_S, flops / fp32)
        res["bound_by"] = ("bytes" if nbytes / HBM_BYTES_S >= flops / fp32
                           else "operations")
    return res


def check_flash_decode(dtype, *, B, KVH, G, D, T, S, ctx, time_it=False):
    """K3 against its plain version on the same partials: the merged
    output, l (relative to max(|l|, 1)) and m; dead splits must hold the
    exact sentinel (m = -1e30, l = 0, o = 0) and a ctx = 0 row must merge
    to 0. Timed cases add the bound by live bytes and, as ``library_ms``,
    one ``F.scaled_dot_product_attention`` call on the same tensors, which
    gives the MERGED output (GQA, boolean length mask)."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.ref import merge_flash_partials
    from repro_torch.launch.kernel_bench import attention_bound_us
    g = torch.Generator(device=DEV).manual_seed(T + S)
    q = torch.randn(B, KVH, G, D, generator=g, device=DEV).to(dtype)
    k = torch.randn(B, T, KVH, D, generator=g, device=DEV).to(dtype)
    v = torch.randn(B, T, KVH, D, generator=g, device=DEV).to(dtype)
    c = torch.tensor(ctx, dtype=torch.int32, device=DEV)

    def kern():
        return flash_decode(q, k, v, c, n_splits=S)

    def plain():
        return flash_decode_plain(q, k, v, c, n_splits=S)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    out_k, out_p = merge_flash_partials(*got), merge_flash_partials(*want)
    if not torch.isfinite(out_k).all():
        fail("flash_decode: non-finite merged output")
    dead = (torch.arange(S, device=DEV)[:, None] * -(-T // S)
            >= c.clamp_max(T)[None])                          # [S, B]
    if not (torch.all(got[2][dead] == -1e30) and torch.all(got[1][dead] == 0)
            and torch.all(got[0][dead] == 0)):
        fail("flash_decode: a dead split is not m=-1e30, l=0, o=0")
    if not torch.all(out_k[c == 0] == 0):
        fail("flash_decode: a ctx = 0 row does not merge to 0")
    err = (out_k - out_p).abs().max().item()
    lerr = ((got[1] - want[1]).abs() / want[1].abs().clamp_min(1)).max().item()
    merr = (got[2] - want[2]).abs().max().item()
    tol = TOL[dtype]
    res = {"max_abs_err": err, "ok": err <= tol and lerr <= tol
           and merr <= tol, "dead_splits": int(dead.sum()) * KVH}
    if time_it:
        res["ms"] = cuda_ms(kern)
        res["plain_ms"] = cuda_ms(plain, iters=5)
        esz = torch.finfo(dtype).bits // 8
        live = float(c.clamp_max(T).sum())
        res["bound_ms"] = 1e-3 * attention_bound_us(live, q, S, esz,
                                                    4 * B)
        flops = 4.0 * KVH * G * D * live
        nbytes = 2.0 * live * KVH * D * esz
        res["bound_by"] = ("bytes" if nbytes / HBM_BYTES_S
                           >= flops / PEAK[torch.float32] else "operations")
        qt = q.reshape(B, KVH * G, 1, D)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(T, device=DEV)[None] < c[:, None].long()
                )[:, None, None]

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        res["library_ms"] = cuda_ms(sdpa)
        lib_err = (sdpa().float().reshape(out_k.shape) - out_k).abs().max()
        res["library_err"] = lib_err.item()
    return res


def phase_kernels() -> dict:
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    cases, main = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for name, kw in (
                ("main n_splits=1", dict(n_splits=1, time_it=True)),
                ("main n_splits=4", dict(n_splits=4, time_it=True)),
                ("window=100", dict(window=100, ctx_max=512, W=32)),
                ("ring_width=8", dict(ring_width=8, ctx_max=400, W=8)),
                ("windowed_slice", dict(window=100, windowed_slice=True,
                                        ctx_max=512, W=8, n_splits=2)),
                ("qpos=4", dict(qpos=4, ctx_max=500, W=32, n_splits=3)),
                ("idle row", dict(idle_row=True, ctx_max=300, W=32,
                                  n_splits=4))):
            r = check_paged(rng, dtype, **kw)
            cases.append(("paged_attention", tag, name, r))
            if tag == "fp32" and name == "main n_splits=4":
                main["paged_attention"] = r
        r = check_paged(rng, dtype, KVH=32, G=1, W=81, ctx_max=1056,
                        n_splits=4, time_it=True)
        cases.append(("paged_attention", tag,
                      "zamba2 G=1 KVH=32 n_splits=4", r))
        for name, kw in (
                ("page256 D128 B4 KVH2 G4 W8 (bench)",
                 dict(B=4, KVH=2, G=4, D=128, page=256, W=8, ctx_max=2048,
                      time_it=True)),
                ("page256 D128 n_splits=3", dict(B=4, KVH=2, G=4, D=128,
                                                 page=256, W=8, ctx_max=2048,
                                                 n_splits=3))):
            r = check_paged(rng, dtype, **kw)
            cases.append(("paged_attention", tag, name, r))
        if tag == "fp32":
            # the bench's decode-step shape at ctx 262144: a measurement
            # of the split count (B x KVH = 2 blocks at n_splits 1)
            for S in (1, 64):
                r = check_paged(rng, dtype, B=2, KVH=1, G=4, D=32, page=256,
                                W=1025, ctx_max=0, ctx_fixed=262144,
                                n_splits=S, time_it=True)
                cases.append(("paged_attention", tag,
                              f"decode-step ctx=262144 n_splits={S}", r))
        for name, kw in (
                ("bench B4 KVH2 G4 D128 T4001 S8",
                 dict(B=4, KVH=2, G=4, D=128, T=4001, S=8,
                      ctx=[4001, 100, 222, 64], time_it=True)),
                ("tail/dead/ctx=0 B4 KVH2 G4 D64 T1001 S8",
                 dict(B=4, KVH=2, G=4, D=64, T=1001, S=8,
                      ctx=[0, 130, 1001, 5000])),
                ("llama decode B8 KVH8 G4 D64 T32768 S16",
                 dict(B=8, KVH=8, G=4, D=64, T=32768, S=16,
                      ctx=[int(x) for x in np.linspace(8192, 32768, 8)],
                      time_it=True))):
            r = check_flash_decode(dtype, **kw)
            cases.append(("flash_decode", tag, name, r))
            if tag == "fp32" and name.startswith("bench"):
                main["flash_decode"] = r
        for name, kw in (
                ("main Sq=1024", dict(time_it=True)),
                ("zamba2 H=KVH=32 Sq=1024", dict(KVH=32, time_it=True)),
                ("q_offset=[0,512] Skv=1536", dict(offs=(0, 512), Skv=1536,
                                                   time_it=True)),
                ("window=256", dict(window=256)),
                ("ragged Sq=1000", dict(Sq=1000, Skv=1000))):
            r = check_flash(dtype, **kw)
            cases.append(("flash_attention", tag, name, r))
            if tag == "fp32" and name == "main Sq=1024":
                main["flash_attention"] = r
        for name, kw in (
                ("zamba2 prefill B=8 S=1024 chunk=128",
                 dict(time_it=True)),
                ("zamba2 decode B=8 S=1 chunk=1",
                 dict(S=1, chunk=1, time_it=True)),
                ("chunked-prefill S=128 chunk=128", dict(S=128)),
                ("valid_len tail S=1024 chunk=128", dict(masked=True))):
            r = check_ssm(dtype, **kw)
            cases.append(("ssm_scan", tag, name, r))
            if tag == "fp32" and name.startswith("zamba2 prefill"):
                main["ssm_scan"] = r
    bad = []
    for kern, tag, name, r in cases:
        line = (f"[kernels] {kern} {tag} {name}: max_abs_err="
                f"{r['max_abs_err']:.3e}")
        if "max_rel_err" in r:
            line += f" max_rel_err={r['max_rel_err']:.3e}"
        line += " ok" if r["ok"] else " FAIL"
        if "ms" in r:
            line += (f" ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                     f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
                     f"library_ms={r.get('library_ms', 'none')}")
            if "library_err" in r:
                line += (" (library: scaled_dot_product_attention, merged "
                         f"output; its max_abs_err {r['library_err']:.3e})")
        if "dead_splits" in r:
            line += f" dead_blocks={r['dead_splits']}"
        print(line, flush=True)
        if not r["ok"]:
            bad.append(f"{kern} {tag} {name}")
    status = {k: ("fail" if any(b.startswith(k) for b in bad) else "ok")
              for k in ("paged_attention", "flash_attention", "flash_decode",
                        "ssm_scan")}
    print("[kernels] " + json.dumps({k: {
        "status": status[k], "max_abs_err": max(
            r["max_abs_err"] for kk, t, _, r in cases
            if kk == k and t == "fp32"),
        "max_abs_err_bf16": max(r["max_abs_err"] for kk, t, _, r in cases
                                if kk == k and t == "bf16"),
        "launches": ("counted on the bench run below" if k == "flash_decode"
                     else "counted on the engine run below")}
        for k in status}), flush=True)
    if bad:
        fail("kernels disagree with their plain versions: " + ", ".join(bad))
    return main


# ---------------------------------------------------------------------------
# 4. the kernel bench entry point
# ---------------------------------------------------------------------------

def phase_bench(smi: str) -> dict:
    """``repro_torch.launch.kernel_bench`` at full size on the card: its
    asserts must hold (it raises otherwise), its JSON must carry the JAX
    bench's keys, and each kernel's launches must equal the calls the
    bench made of its wrapper. Returns the launch counts."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch import kernel_bench
    fns = dict(_kernel_fns(), flash_decode=flash_decode)
    path = HERE / "build" / "kernel_bench.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for fn in fns.values():
        fn.launches = 0
    out = kernel_bench.main(["--json", str(path)])
    la = {k: fn.launches for k, fn in fns.items()}
    dt = time.perf_counter() - t0
    doc = json.loads(path.read_text())
    if sorted(doc) != ["bench", "decode_step", "maxerr", "rows"]:
        fail(f"kernel_bench JSON keys {sorted(doc)}")
    want = dict(out["calls"], flash_attention=0)
    print(f"[bench] kernel_bench: {len(doc['rows'])} rows in {dt:.1f} s, "
          f"maxerr {doc['maxerr']}, launches " + " ".join(
              f"{k}={la[k]} (calls {want[k]})" for k in la) + f" | {smi}",
          flush=True)
    if la != want or not la["flash_decode"]:
        fail(f"kernel_bench: kernel launches {la} do not match the bench's "
             f"calls {want}")
    return la


# ---------------------------------------------------------------------------
# 5. full-width engine
# ---------------------------------------------------------------------------

def serve(cfg, params, *, mode, horizon, splits, n_req, use_kernels, chunk,
          prompts, max_prefill=64):
    from repro_torch.serving import DecodeEngine, EngineConfig, Request
    ecfg = EngineConfig(n_slots=8, page_size=16, n_pages=1024,
                        max_context=1280, eos_token=-1, prefill_mode=mode,
                        prefill_chunk=chunk, decode_horizon=horizon,
                        kernel_splits=splits, use_kernels=use_kernels,
                        max_prefill=max_prefill)
    eng = DecodeEngine(cfg, ecfg, params, device=DEV)
    for i, p in enumerate(prompts[:n_req]):
        eng.submit(Request(i, p, 32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run(100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.batcher.stats
    bal = eng.alloc.shard_balance()
    tm = eng.timing
    ttft = [eng.first_tok_t[r] - eng.submit_t[r] for r in out]
    m = {"completed": st.completed, "n": n_req,
         "bal_max": int(bal.max()), "bal_min": int(bal.min()),
         "tokens": sum(len(v) for v in out.values()), "wall_s": wall,
         "ttft_mean_ms": 1e3 * float(np.mean(ttft)),
         "ttft_max_ms": 1e3 * float(np.max(ttft)),
         "decode_steps": tm.decode_steps, "prefill_calls": tm.prefill_calls,
         "decode_tokens": tm.decode_tokens, "device_syncs": tm.device_syncs,
         "decode_s": tm.decode_s, "prefill_s": tm.prefill_s}
    del eng
    torch.cuda.empty_cache()
    return {k: list(v) for k, v in out.items()}, m


def _kernel_fns():
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention_partials
    from repro_torch.kernels.ssm_scan import ssm_chunk_scan
    return {"paged_attention": paged_attention_partials,
            "flash_attention": flash_attention_fwd,
            "ssm_scan": ssm_chunk_scan}


def expected_launches(cfg, m) -> dict:
    """Launches the main path implies: one paged-decode launch per
    attention layer and decode step, one flash launch per attention layer
    and prefill call, one scan launch per Mamba2 layer and call of
    either."""
    kinds = cfg.block_kinds()
    n_attn = sum(1 for k in kinds if k in ("attn", "local"))
    n_mamba = sum(1 for k in kinds if k == "mamba")
    return {"paged_attention": n_attn * m["decode_steps"],
            "flash_attention": n_attn * m["prefill_calls"],
            "ssm_scan": n_mamba * (m["decode_steps"] + m["prefill_calls"])}


def near_tie_gap(cfg, params, seq) -> float:
    """Top-1 minus top-2 logit of the plain-path model after ``seq``."""
    from repro_torch.core.paged_kv import PoolSpec
    from repro_torch.models import model as MDL
    from repro_torch.kernels.backend import KernelConfig
    n_attn = sum(1 for k in cfg.block_kinds() if k in ("attn", "local"))
    W = -(-len(seq) // 16)
    spec = PoolSpec(max(n_attn, 1), W, 16, cfg.n_kv_heads, cfg.d_head, W,
                    dtype="float32")
    state = MDL.init_decode_state(cfg, spec, 1, device=DEV)
    tok = torch.tensor(np.asarray(seq, np.int32)[None], device=DEV)
    bt = torch.arange(W, dtype=torch.int32, device=DEV)[None]
    logits, _ = MDL.prefill(cfg, params, state, tok, bt, rt=MDL.Runtime(
        kernels=KernelConfig(use_kernels=False)))
    top = logits[0, :cfg.vocab_size].topk(2).values
    return float(top[0] - top[1])


def compare_tokens(label, cfg, params, prompts, out_k, out_p) -> None:
    """Greedy tokens of the kernel and plain engines must agree; a first
    divergence whose plain-path logit gap is below ``TIE_GAP`` is a near
    tie (ROADMAP C.3) and is printed, anything else fails."""
    faults = []
    for r in sorted(out_k):
        a, b = out_k[r], out_p[r]
        if a == b:
            continue
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = near_tie_gap(cfg, params, list(prompts[r]) + b[:t])
        print(f"[engine] {label}: request {r} diverges at step {t} "
              f"(kernels {a[t:t + 1]} vs plain {b[t:t + 1]}), plain-path "
              f"logit gap {gap:.3e}"
              + (" - a near tie" if gap < TIE_GAP else " - a fault"),
              flush=True)
        if gap >= TIE_GAP:
            faults.append(r)
    if faults:
        fail(f"{label}: greedy tokens differ between the kernel and plain "
             f"engines for requests {faults}")
    print(f"[engine] {label}: greedy tokens identical (kernels vs plain) "
          f"for {sum(out_k[r] == out_p[r] for r in out_k)}/{len(out_k)} "
          f"requests", flush=True)


def run_arch(arch: str, smi: str, launches: dict, **serve_kw) -> None:
    """Serve ``arch`` at full width in batched and chunked prefill, kernels
    and plain, then profile the batched configuration."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count_actual
    cfg = replace(get_config(arch), dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    torch.cuda.synchronize()
    n = param_count_actual(params)
    print(f"[engine] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.d_head} "
          f"vocab={cfg.vocab_size} params={n} fp32 "
          f"({4 * n / 2**30:.2f} GiB) init {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(256, 1025, 8)]
    fns = _kernel_fns()
    # first use of each matmul shape, allocator growth: paid here, unreported
    serve(cfg, params, use_kernels=None, prompts=prompts, mode="batched",
          horizon=4, splits=4, n_req=2, chunk=32, **serve_kw)
    for label, kw in (("batched", dict(mode="batched", horizon=4, splits=4,
                                       n_req=8, chunk=32)),
                      ("chunked", dict(mode="chunked", horizon=1, splits=4,
                                       n_req=4, chunk=128))):
        label = f"{arch} {label}"
        for fn in fns.values():
            fn.launches = 0
        out_k, mk = serve(cfg, params, use_kernels=None, prompts=prompts,
                          **kw, **serve_kw)
        la = {k: fn.launches for k, fn in fns.items()}
        out_p, mp = serve(cfg, params, use_kernels=False, prompts=prompts,
                          **kw, **serve_kw)
        if any(fn.launches != la[k] for k, fn in fns.items()):
            fail(f"{label}: the plain-path engine launched a kernel")
        for lbl, m in (("kernels", mk), ("plain", mp)):
            dec = m["decode_tokens"]
            print(f"[engine] {label} {lbl}: completed={m['completed']}/"
                  f"{m['n']} page balance max={m['bal_max']} "
                  f"min={m['bal_min']} tokens={m['tokens']} "
                  f"wall={m['wall_s']:.3f} s "
                  f"tok/s={m['tokens'] / m['wall_s']:.1f} "
                  f"decode tok/s={dec / max(m['decode_s'], 1e-9):.1f} "
                  f"ttft mean/max={m['ttft_mean_ms']:.1f}/"
                  f"{m['ttft_max_ms']:.1f} ms decode step "
                  f"ms={1e3 * m['decode_s'] / max(1, m['decode_steps']):.2f}"
                  f" syncs/token={m['device_syncs'] / max(1, dec):.4f} "
                  f"decode_steps={m['decode_steps']} "
                  f"prefill_calls={m['prefill_calls']} | {smi}", flush=True)
        want = expected_launches(cfg, mk)
        print(f"[engine] {label} launches: " + " ".join(
            f"{k}={la[k]} (expected {want[k]})" for k in la)
            + f" for decode steps {mk['decode_steps']}, prefill calls "
            f"{mk['prefill_calls']}", flush=True)
        compare_tokens(label, cfg, params, prompts, out_k, out_p)
        for lbl, m in (("kernels", mk), ("plain", mp)):
            if m["completed"] != m["n"] or m["bal_max"] or m["bal_min"]:
                fail(f"{label} {lbl}: completed {m['completed']}/{m['n']}, "
                     f"page balance {m['bal_max']}/{m['bal_min']}")
        if la != want or not all(la[k] for k in la if want[k]):
            fail(f"{label}: kernel launches {la} do not match the main "
                 f"path's {want}")
        for k, v in la.items():
            launches[k] = launches.get(k, 0) + v
    phase_profile(cfg, params, prompts, smi, serve_kw)
    del params
    torch.cuda.empty_cache()


def phase_engine(smi: str) -> dict:
    launches: dict = {}
    run_arch("llama3.2-1b", smi, launches)
    # pow2 prefill buckets (256/512/1024): the Mamba2 scan runs at chunk
    # 128 in every bucket
    run_arch("zamba2-1.2b", smi, launches, max_prefill=1024)
    return launches


def phase_profile(cfg, params, prompts, smi: str, serve_kw) -> None:
    """Where the time goes: the batched configuration with the kernels
    under torch.profiler — device busy time against wall time, and the
    kernels that take it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, m = serve(cfg, params, use_kernels=None, prompts=prompts,
                     mode="batched", horizon=4, splits=4, n_req=8, chunk=32,
                     **serve_kw)

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    from torch.autograd import DeviceType
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not ka:
        print(f"[profile] {cfg.name}: the profiler recorded no device "
              "kernels; device time not measured", flush=True)
        return
    busy = sum(dev_us(e) for e in ka) / 1e3
    wall = 1e3 * m["wall_s"]
    print(f"[profile] {cfg.name} batched kernels under torch.profiler: "
          f"wall={wall:.1f} ms device busy={busy:.1f} ms idle share="
          f"{1 - busy / wall:.3f} (prefill {1e3 * m['prefill_s']:.1f} ms, "
          f"decode {1e3 * m['decode_s']:.1f} ms) | {smi}", flush=True)
    for e in sorted(ka, key=dev_us, reverse=True)[:12]:
        print(f"[profile] {cfg.name} {dev_us(e) / 1e3:9.3f} ms "
              f"{e.count:6d} calls {e.key[:90]}")
    sys.stdout.flush()


def paged_times(src: str, smi: str) -> None:
    """``--paged-times SRC``: K1 of the ``repro_torch`` under ``SRC`` (this
    checkout's ``src`` or another's, e.g. an unpacked parent commit) at
    the engine's page-16 shapes, timed as in phase 3, then stop. Run
    parent, change, change, parent in one call to compare two K1s."""
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    for name, kw in (("llama n_splits=4", dict(n_splits=4)),
                     ("llama n_splits=1", dict(n_splits=1)),
                     ("zamba2 G=1 KVH=32 n_splits=4",
                      dict(KVH=32, G=1, W=81, ctx_max=1056, n_splits=4))):
        r = check_paged(rng, torch.float32, time_it=True, **kw)
        print(f"[paged-times] {Path(repro_torch.__file__).parents[1]} "
              f"{name}: ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"max_abs_err={r['max_abs_err']:.3e} | {smi}", flush=True)
        if not r["ok"]:
            fail(f"paged_attention {name} disagrees with its plain version")


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    if sys.argv[1:2] == ["--paged-times"]:
        paged_times(sys.argv[2], smi)
        return 0
    sys.path.insert(0, str(HERE / "src"))
    phase_build()
    main_cases = phase_kernels()
    bench_launches = phase_bench(smi)
    launches = phase_engine(smi)
    launches["flash_decode"] = bench_launches["flash_decode"]
    meta = {
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:130"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:77"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:48"),
        "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan.py:73"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = main_cases[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms")})
    print(f"[done] every phase passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
