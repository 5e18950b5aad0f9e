"""Kernel validation and the decode hot-path microbenchmark.

Port of ``benchmarks/kernel_bench.py`` with the same sections, shapes, row
names and JSON keys::

    python -m repro_torch.launch.kernel_bench [--smoke] [--json PATH] \
        [--device cuda|cpu]

Kernel rows (``kernel_paged_attention``, ``kernel_flash_decode``,
``kernel_ssm_scan``): each kernel wrapper against the oracle of
``kernels/ref.py`` (``maxerr``, held below 1e-2 as in JAX) and against its
plain PyTorch version (``plain_maxerr``). On the card ``us`` is the
kernel's time (CUDA events after warm-up) and ``derived`` adds the plain
version's time and the H100 bound (the larger of the live bytes over
3.35 TB/s and the operations over 67 TFLOP/s fp32, computed from the
shapes).

``decode_step`` rows: one decode step's paged attention with the token
write folded in (``ops.paged_decode_step``) as

  * ``dense_full`` (``us``) — gather-then-dense over the FULL block table
    (``use_kernels=False``): work and traffic scale with the table width
    whatever the live context;
  * ``hot_path`` (``hot_us``) — what the engine dispatches: the table
    bucketed to the live pages (``serving/prefill.decode_table_bucket``)
    and the default ``KernelConfig()`` (the paged split-K kernel,
    ``n_splits=1``). The two outputs agree below 1e-3.

It runs on ``cuda`` unless ``--device cpu`` is given, and raises when no
card is there; on the CPU every wrapper runs its plain version and the
times are the CPU's. Inputs come from ``torch.Generator``s seeded as the
JAX bench numbers its keys, so shapes and masks equal JAX's and values do
not. A failed check raises (non-zero exit).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.kernels.backend import (KernelConfig, decode_hbm_bytes,
                                         resolve_device)
from repro_torch.kernels.flash_decode import flash_decode_plain
from repro_torch.kernels.paged_attention import (
    paged_attention_partials, paged_attention_partials_plain)
from repro_torch.kernels.ssm_scan import ssm_chunk_scan_plain

HBM_BW = 3.35e12            # H100 SXM device memory, bytes/s
FP32_PEAK = 67e12           # H100 SXM fp32 outside the tensor cores, FLOP/s
WARMUP, ITERS = 3, 10       # card timing: calls before and inside the events
CPU_ITERS = 3
KERNELS = ("paged_attention", "flash_decode", "ssm_scan")


def _normal(shape, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


def _time_us(fn, dev) -> float:
    """Mean microseconds of one call: CUDA events after warm-up on a card,
    the host clock on the CPU."""
    if dev.type == "cuda":
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        return 1e3 * start.elapsed_time(end) / ITERS
    fn()
    t0 = time.perf_counter()
    for _ in range(CPU_ITERS):
        fn()
    return 1e6 * (time.perf_counter() - t0) / CPU_ITERS


def bound_us(nbytes: float, flops: float) -> float:
    """The least time the H100 could take: bytes over its memory rate or
    fp32 operations over its peak, whichever is larger."""
    return 1e6 * max(nbytes / HBM_BW, flops / FP32_PEAK)


def attention_bound_us(live_tokens: float, q, n_out_splits: int,
                       kv_el: int, extra_bytes: float = 0.0) -> float:
    """Bound of a split-K decode-attention call: live K and V read once, q
    read once, the fp32 (o, l, m) partials written once; 4 FLOP per
    (query row, live token, channel)."""
    B, KVH, G, D = q.shape
    nbytes = (decode_hbm_bytes(live_tokens, KVH, D, kv_el)
              + q.numel() * q.element_size()
              + 4 * n_out_splits * B * KVH * G * (D + 2) + extra_bytes)
    return bound_us(nbytes, 4.0 * KVH * G * D * live_tokens)


def ssm_bound_us(q, v, chunk: int) -> float:
    """Bound of the chunk scan: q, k, v and the gates read once, y and the
    final state written once; per chunk and (b, h) the causal half of
    q k^T and S v plus q C and k^T v in full."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    el = q.element_size()
    nbytes = (el * (2 * B * S * H * N + B * S * H * P) + 4 * 2 * B * S * H
              + 4 * (B * S * H * P + B * H * N * P + B * H * N))
    c = min(chunk, S)
    flops = B * H * (S // c) * (c * (c + 1) * (N + P) + 4 * c * N * P)
    return bound_us(nbytes, flops)


def _max_err(pairs) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)


def decode_step_bench(emit, dev, calls, *, smoke: bool = False):
    """Decode-step latency and modeled KV bytes, gathered-dense against the
    context-adaptive hot path, across live context lengths in a
    max-context-sized table (live pages << table width is the paper's
    long-context serving regime)."""
    from repro_torch.serving.prefill import decode_table_bucket
    if smoke:
        page, W, B, KVH, G, D = 16, 32, 2, 1, 2, 16
        ctxs = (48, 240)
    else:
        page, W, B, KVH, G, D = 256, 1025, 2, 1, 4, 32
        ctxs = (2048, 32768, 262144)
    H = KVH * G
    kc_hot = KernelConfig()
    out = {}
    for ctx_t in ctxs:
        live = min(-(-ctx_t // page) + 1, W)
        P = B * live + 2          # the last page is the pool's trash page
        pool_k = _normal((P, page, KVH, D), ctx_t, dev)
        pool_v = _normal((P, page, KVH, D), 1, dev)
        q = _normal((B, H, D), 2, dev)
        k_new = _normal((B, KVH, D), 3, dev)
        v_new = _normal((B, KVH, D), 4, dev)
        bt = np.full((B, W), -1, np.int32)
        perm = np.random.default_rng(0).permutation(P - 2)
        for b in range(B):
            bt[b, :live] = perm[b * live:(b + 1) * live]
        ctx_np = np.asarray([ctx_t, max(1, ctx_t - page // 2)], np.int32)[:B]
        npage = torch.tensor([bt[b, (int(ctx_np[b]) - 1) // page]
                              for b in range(B)], dtype=torch.int32,
                             device=dev)
        noff = torch.tensor([(int(ctx_np[b]) - 1) % page for b in range(B)],
                            dtype=torch.int32, device=dev)
        ctx = torch.from_numpy(ctx_np).to(dev)
        bt = torch.from_numpy(bt).to(dev)
        wb = decode_table_bucket(live, W)         # engine's live-page bucket
        bt_hot = bt[:, :wb].contiguous()

        def dense_full():
            return ops.paged_decode_step(q, k_new, v_new, pool_k, pool_v,
                                         bt, ctx, npage, noff,
                                         kernels=KernelConfig(False))

        def hot_path():
            calls["paged_attention"] += 1
            return ops.paged_decode_step(q, k_new, v_new, pool_k, pool_v,
                                         bt_hot, ctx, npage, noff,
                                         kernels=kc_hot)

        err = _max_err([(dense_full()[0], hot_path()[0])])
        t_dense = _time_us(dense_full, dev)
        t_hot = _time_us(hot_path, dev)
        el = 4                                    # fp32 pool
        dense_mb = 3 * decode_hbm_bytes(W * page, KVH, D, el) / 1e6
        hot_mb = decode_hbm_bytes(ctx_t, KVH, D, el) / 1e6
        emit(f"kernel_decode_step_ctx{ctx_t}", t_dense,
             f"hot_us={t_hot:.0f} speedup={t_dense / t_hot:.1f}x "
             f"live_pages={live}/{W} bucket={wb} "
             f"dense_MB/tok={dense_mb:.1f} kernel_MB/tok={hot_mb:.2f} "
             f"maxerr={err:.2e} device={_device_name(dev)}")
        out[ctx_t] = (t_dense, t_hot, err)
    return out


def _device_name(dev) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def run(emit, dev, *, smoke: bool = False):
    """Every section; returns ``{kernel: maxerr, "decode_step": {...},
    "calls": {kernel: calls of its wrapper made here}}``."""
    calls = dict.fromkeys(KERNELS, 0)
    kc = KernelConfig()
    ref_cfg = KernelConfig(use_kernels=False)
    out = {}

    # paged_attention: decode-32k-like tile, 256-token pages at D 128
    B, KVH, G, D, page, maxp = 4, 2, 4, 128, 256, 8
    if smoke:
        B, KVH, G, D, page, maxp = 2, 2, 2, 32, 16, 4
    P_ = B * maxp
    q = _normal((B, KVH, G, D), 0, dev)
    kp = _normal((P_, page, KVH, D), 1, dev)
    vp = _normal((P_, page, KVH, D), 2, dev)
    bt = torch.from_numpy(np.random.default_rng(0).permutation(P_)
                          .reshape(B, maxp).astype(np.int32)).to(dev)
    ctx = torch.from_numpy(np.minimum([maxp * page, 700, 1200, 300][:B],
                                      maxp * page).astype(np.int32)).to(dev)
    win = torch.zeros(B, dtype=torch.int32, device=dev)

    def kern():
        calls["paged_attention"] += 1
        return paged_attention_partials(q, kp, vp, bt, ctx)

    def plain():
        return paged_attention_partials_plain(
            q, kp, vp, bt, ctx, win, ring_width=0, windowed_slice=False,
            n_splits=1, qpos=1)

    calls["paged_attention"] += 1
    got = ops.decode_attention(q, kp, vp, bt, ctx, kernels=kc)
    err = _max_err([(got, REF.paged_attention_ref(q, kp, vp, bt, ctx))])
    perr = _max_err([(ops.merge_partials(*kern()),
                      ops.merge_partials(*plain()))])
    t_k, t_p = _time_us(kern, dev), _time_us(plain, dev)
    live = float(ctx.sum())
    bnd = attention_bound_us(live, q, 1, 4, bt.numel() * 4 + ctx.numel() * 4)
    emit("kernel_paged_attention", t_k,
         f"maxerr={err:.2e} plain_maxerr={perr:.2e} plain_us={t_p:.1f} "
         f"bound_us={bnd:.2f} device={_device_name(dev)}")
    out["paged_attention"] = err

    # flash_decode (ITPP split-K partials): T not divisible by the splits
    # exercises the short tail split
    T, S = (500 if smoke else 4001), 8
    k = _normal((B, T, KVH, D), 3, dev)
    v = _normal((B, T, KVH, D), 4, dev)
    ctx2 = torch.from_numpy(np.minimum([T, 100, 222, 64][:B], T)
                            .astype(np.int32)).to(dev)

    def kern():
        calls["flash_decode"] += 1
        return ops.itpp_partials(q, k, v, ctx2, n_splits=S, kernels=kc)

    def plain():
        return flash_decode_plain(q, k, v, ctx2, n_splits=S)

    o, l, m = kern()
    oref, lref, mref = REF.flash_decode_ref(q, k, v, ctx2, S)
    err = _max_err([(o, oref), (l, lref)])
    perr = _max_err(zip((o, l, m), plain()))
    merged = ops.merge_partials(o, l, m)
    t_k, t_p = _time_us(kern, dev), _time_us(plain, dev)
    live = float(ctx2.clamp_max(T).sum())
    bnd = attention_bound_us(live, q, S, 4, ctx2.numel() * 4)
    emit("kernel_flash_decode", t_k,
         f"maxerr={err:.2e} merged_finite="
         f"{bool(torch.isfinite(merged).all())} plain_maxerr={perr:.2e} "
         f"plain_us={t_p:.1f} bound_us={bnd:.2f} "
         f"device={_device_name(dev)}")
    out["flash_decode"] = err

    # ssm_chunk_scan
    Bs, Sq, H, N, P2 = 2, 512, 4, 64, 64
    if smoke:
        Bs, Sq, H, N, P2 = 2, 128, 2, 16, 16
    qs = _normal((Bs, Sq, H, N), 0, dev)
    ks = _normal((Bs, Sq, H, N), 5, dev)
    vs = _normal((Bs, Sq, H, P2), 6, dev)
    la = -torch.nn.functional.softplus(_normal((Bs, Sq, H), 7, dev))
    lg = _normal((Bs, Sq, H), 8, dev) * 0.1

    def kern():
        calls["ssm_scan"] += 1
        return ops.mamba_mixer(qs, ks, vs, la, lg, chunk=128, kernels=kc)

    def plain():
        return ssm_chunk_scan_plain(qs, ks, vs, la, lg, chunk=128)

    y, (C, _, _) = kern()
    yref, (Cref, _, _) = ops.mamba_mixer(qs, ks, vs, la, lg, chunk=128,
                                         kernels=ref_cfg)
    err = _max_err([(y, yref), (C, Cref)])
    yp, (Cp, _) = plain()
    perr = _max_err([(y, yp), (C, Cp)])
    t_k, t_p = _time_us(kern, dev), _time_us(plain, dev)
    emit("kernel_ssm_scan", t_k,
         f"maxerr={err:.2e} plain_maxerr={perr:.2e} plain_us={t_p:.1f} "
         f"bound_us={ssm_bound_us(qs, vs, 128):.2f} "
         f"device={_device_name(dev)}")
    out["ssm_scan"] = err

    out["decode_step"] = decode_step_bench(emit, dev, calls, smoke=smoke)
    out["calls"] = calls
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the JAX bench's tiny CI shapes")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write results as JSON (BENCH_kernels.json's keys)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu "
                         "(the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # fp32 products stay full fp32, so the oracles are fp32 too
        torch.backends.cuda.matmul.allow_tf32 = False

    rows = []

    def emit(name, us, derived):
        rows.append({"name": name, "us": us, "derived": derived})
        print(f"{name},{us:.2f},{derived}", flush=True)

    out = run(emit, dev, smoke=args.smoke)
    bad = [f"{k} maxerr {out[k]:.3e} >= 1e-2" for k in KERNELS
           if not out[k] < 1e-2]
    bad += [f"decode_step ctx {c} maxerr {e:.3e} >= 1e-3"
            for c, (_, _, e) in out["decode_step"].items() if not e < 1e-3]
    if args.json:
        doc = {"bench": "kernels", "rows": rows,
               "maxerr": {k: float(out[k]) for k in KERNELS},
               "decode_step": {str(c): {"dense_us": d, "hot_us": h,
                                        "maxerr": float(e)}
                               for c, (d, h, e) in out["decode_step"].items()}}
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"# wrote {args.json}")
    if bad:
        raise RuntimeError("kernel_bench checks failed: " + "; ".join(bad))
    print("# kernel_bench OK")
    return out


if __name__ == "__main__":
    main()
