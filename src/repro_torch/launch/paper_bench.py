"""The paper-figure benches of ``benchmarks/run.py``, on the port's
modules.

Port of ``benchmarks/{throughput_scaling, tp_pp_ablation, lazy_alloc,
io_overlap, latency_breakdown, utilization}.py``, one function each, each
``run(emit)`` emitting ``(name, us_per_call, derived)`` rows:

  fig9_*    Fig. 9/10  throughput vs capacity (``throughput_scaling``)
  fig11_*   Fig. 11    TP x PP ablation with and without DPA
  fig4b_*   Fig. 4(b)  lazy vs static batch growth: the port's allocator
                       and scheduler on a LongBench-statistics trace
  fig7_*    Fig. 7(a)  ping-pong I/O overlap latency cuts
  fig12_*   Fig. 12    per-op latency breakdown, standalone vs GPU+PIM,
                       and the modeled decode-attention bytes per token
  table8_*  Table 8    throughput and utilization across scales

All but ``lazy_alloc`` evaluate the analytic PIM model
(``core/pim_model.py``); ``lazy_alloc`` runs the real host machinery
(``core/allocator.py``, ``core/scheduler.py``, ``data/pipeline.py``). None
touches a device, so the rows equal ``benchmarks/run.py``'s for these six
exactly (name, value and derived string).

  PYTHONPATH=src python -m repro_torch.launch.paper_bench

prints ``name,us_per_call,derived`` CSV as ``benchmarks/run.py`` does.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core import pim_model as PM
from repro_torch.core.allocator import PageAllocator
from repro_torch.core.scheduler import ContinuousBatcher, Request
from repro_torch.data.pipeline import LONGBENCH_STATS, request_trace


def _musique_kw() -> dict:
    st = LONGBENCH_STATS["musique"]
    return dict(avg_ctx=st["mean"], max_ctx=32768,
                ctx_cv=st["std"] / st["mean"])


# ---------------------------------------------------------------------------
# Fig. 9 + Fig. 10: decode throughput vs system capacity
# ---------------------------------------------------------------------------

CAPS_GB = (128, 256, 512, 1024)
MODELS = {"7B": PM.QWEN_7B, "72B": PM.QWEN_72B}


def systems(cap_gb: int) -> dict:
    n = cap_gb // 64
    return {
        "gpu-hbm": PM.System(PM.GPU_HBM, max(1, cap_gb // 80)),
        "gpu-gddr": PM.System(PM.GPU_GDDR, n),
        "pim-base": PM.lol_pim(n, level=0),
        "lol-pim": PM.lol_pim(n, level=3),
        "gpu+lol-pim": PM.lol_pim(n, level=3, gpu_hybrid=True),
    }


def throughput_scaling(emit):
    """Standalone (GPU-HBM / GPU-GDDR / baseline PIM / LoL-PIM) and
    heterogeneous GPU+PIM systems, qwen1.5-7b and -72b over the three
    LongBench tasks, 128 GB to 1 TB; the paper's headline ratios at 1 TB
    (§8.2) as ``claim_*`` rows."""
    claims = []
    for mname, model in MODELS.items():
        for task, st in LONGBENCH_STATS.items():
            kw = dict(avg_ctx=st["mean"], max_ctx=32768,
                      ctx_cv=st["std"] / st["mean"])
            by_cap = {}
            for cap in CAPS_GB:
                for sname, sys_ in systems(cap).items():
                    r = PM.throughput(sys_, model, **kw)
                    by_cap[(cap, sname)] = r["tokens_per_s"]
                    emit(f"fig9_{mname}_{task}_{cap}GB_{sname}",
                         r["t_step"] * 1e6, f"{r['tokens_per_s']:.0f}tok/s")
            if task != "musique":
                continue
            lol, base = by_cap[(1024, "lol-pim")], by_cap[(1024, "pim-base")]
            gddr = by_cap[(1024, "gpu-gddr")]
            paper = (4.74, 3.53) if model is PM.QWEN_7B else (2.65, 8.54)
            claims.append((f"{mname} lol/pim-base @1TB",
                           lol / max(base, 1e-9), paper[0]))
            claims.append((f"{mname} lol/gpu-gddr @1TB",
                           lol / max(gddr, 1e-9), paper[1]))
    for name, got, paper in claims:
        emit(f"claim_{name.replace(' ', '_').replace('/', '_over_')}",
             0.0, f"model={got:.2f}x paper={paper}x")
    return claims


# ---------------------------------------------------------------------------
# Fig. 11: tensor- vs pipeline-parallel balance, with and without DPA
# ---------------------------------------------------------------------------

def tp_pp_ablation(emit):
    """qwen1.5-7b on Musique at 512 GB (8 nodes = 64 modules), PP in {1, 2,
    4, 8, 16} (TP = modules / PP), with and without DPA."""
    kw = _musique_kw()
    results = {}
    for dpa in (False, True):
        for pp in (1, 2, 4, 8, 16):
            sys_ = PM.System(PM.PIM_NODE, 8, pp=pp, itpp=True, dpa=dpa,
                             pingpong=True)
            r = PM.throughput(sys_, PM.QWEN_7B, **kw)
            results[(dpa, pp)] = r
            emit(f"fig11_dpa{int(dpa)}_tp{64 // pp}_pp{pp}",
                 r["t_step"] * 1e6,
                 f"{r['tokens_per_s']:.0f}tok/s_B{r['batch']}")
    best_dpa = max(v["tokens_per_s"] for (d, _), v in results.items() if d)
    best_no = max(v["tokens_per_s"] for (d, _), v in results.items()
                  if not d)
    worst_dpa = min(v["tokens_per_s"] for (d, _), v in results.items() if d)
    emit("fig11_claim_combo_spread", 0.0,
         f"model={best_dpa / max(worst_dpa, 1e-9):.2f}x paper<=1.73x")
    emit("fig11_claim_dpa_gain_at_optimum", 0.0,
         f"model={best_dpa / max(best_no, 1e-9):.2f}x paper~1.07x")
    return results


# ---------------------------------------------------------------------------
# Fig. 4(b) / §5.4: lazy vs static allocation, on the real host machinery
# ---------------------------------------------------------------------------

PAGE = 256
MAX_CTX = 32768


def simulate(task: str, n_pages: int, *, static: bool, n_requests: int = 96,
             slots: int = 64, seed: int = 0) -> float:
    """Average decode batch of a LongBench-statistics trace under static
    max-context reservation or DPA lazy allocation."""
    maxp = MAX_CTX // PAGE + 1
    alloc = PageAllocator(n_pages, 1, PAGE,
                          static_max_pages=maxp if static else None)
    sched = ContinuousBatcher(alloc, slots, max_context=MAX_CTX)
    for i, (plen, new) in enumerate(request_trace(
            task, n_requests, seed=seed, max_context=MAX_CTX)):
        sched.submit(Request(i, plen, new))
    finished = None
    for _ in range(200_000):
        if sched.done():
            break
        _, active = (sched.step(finished) if finished is not None
                     else sched.step())
        finished = np.zeros(slots, bool)
        for s in active:
            req = sched.slots[s]
            if req is not None and req.generated >= req.max_new_tokens:
                finished[s] = True
    return sched.stats.avg_batch


def lazy_alloc(emit):
    """Static vs lazy average batch on a pool of ~8 max-context requests
    (the regime where static reservation throttles the batch), against
    the ideal bound."""
    n_pages = 8 * (MAX_CTX // PAGE + 1)
    out = {}
    for task in LONGBENCH_STATS:
        static = simulate(task, n_pages, static=True)
        lazy = simulate(task, n_pages, static=False)
        st = LONGBENCH_STATS[task]
        ideal = min(64.0, n_pages * PAGE / st["mean"])
        out[task] = (static, lazy, ideal)
        emit(f"fig4b_{task}_static", 0.0, f"avg_batch={static:.1f}")
        emit(f"fig4b_{task}_lazy", 0.0, f"avg_batch={lazy:.1f}")
        emit(f"fig4b_{task}_gain", 0.0,
             f"model={lazy / max(static, 1e-9) * 100:.0f}% paper<=380% "
             f"ideal={ideal:.1f}")
    return out


# ---------------------------------------------------------------------------
# Fig. 7(a) / §6: I/O-aware (ping-pong) buffering latency cut per op
# ---------------------------------------------------------------------------

# one AiMX module: 16 channels x 512 GB/s internal; 64 GB/s interface; the
# slow Out-Reg drain (pim_model.OUTREG_BW_GBS)
INT = PM.PIM_NODE.int_bw_gbs / PM.PIM_NODE.modules * 1e9 * PM.DRAM_EFF
IF = PM.PIM_NODE.module_if_gbs * 1e9
OUT = PM.OUTREG_BW_GBS * 1e9
EL = 2
GB_RELOAD = 4          # 2KB GB holds 1/4 of a d_model=4096 input vector


def op_latencies(model: PM.LLM, B: int, ctx: int) -> dict:
    """Per-module per-layer (core, io) seconds for the four ops of Fig. 7."""
    d, ff, nh, nkv, dh = (model.d_model, model.d_ff, model.n_heads,
                          model.n_kv_heads, model.d_head)
    ops = {}
    # QK^T: stream K (ctx x d_h per head); scores drain via Out-Regs
    core = B * ctx * nkv * dh * EL / INT
    io = B * ctx * nh * EL / OUT
    ops["QK^T"] = (core, io)
    # SV: softmaxed scores staged back through the GB, V streamed
    core = B * ctx * nkv * dh * EL / INT
    io = B * ctx * nh * EL / IF * GB_RELOAD
    ops["SV"] = (core, io)
    # FFN1 / FFN2: weight stream; input re-broadcast per GB reload + the
    # big intermediate out through Out-Regs
    core = d * ff * EL / INT * B / PM.FC_REUSE_ITPP
    io = B * (d * EL * GB_RELOAD / IF + ff * EL / OUT / 8)
    ops["FFN1"] = (core, io)
    core = ff * d * EL / INT * B / PM.FC_REUSE_ITPP
    io = B * (ff * EL * GB_RELOAD / IF + d * EL / OUT / 8)
    ops["FFN2"] = (core, io)
    return ops


def io_overlap(emit):
    """Serial vs overlapped (ping-pong) latency of QK^T, SV, FFN1 and FFN2
    for qwen1.5-7b at B 16, context 16384."""
    paper = {"QK^T": 40, "SV": 44, "FFN1": 29, "FFN2": 28}
    out = {}
    for name, (core, io) in op_latencies(PM.QWEN_7B, B=16,
                                         ctx=16384).items():
        serial = core + io
        overlap = max(core, io)
        cut = 100 * (1 - overlap / serial)
        out[name] = cut
        emit(f"fig7_{name.replace('^', '')}_serial", serial * 1e6,
             f"core={core * 1e6:.1f}us io={io * 1e6:.1f}us")
        emit(f"fig7_{name.replace('^', '')}_overlap", overlap * 1e6,
             f"cut={cut:.0f}% paper={paper[name]}%")
    return out


# ---------------------------------------------------------------------------
# Fig. 12: per-operation decode latency breakdown
# ---------------------------------------------------------------------------

def latency_breakdown(emit):
    """qwen1.5-72b, standalone LoL-PIM vs GPU+LoL-PIM at technique levels
    0, 2 and 3; then the modeled decode-attention bytes a token, the
    gathered-dense read of a max-context table against the kernel's read
    of the live context."""
    kw = _musique_kw()
    out = {}
    for hybrid in (False, True):
        base_t = None
        for lvl in (0, 2, 3):
            sys_ = PM.lol_pim(16, level=lvl, gpu_hybrid=hybrid)
            r = PM.throughput(sys_, PM.QWEN_72B, **kw)
            tag = ("gpu+lolpim" if hybrid else "standalone") + f"_lvl{lvl}"
            per_tok = r["t_step"] / max(r["batch"], 1)
            parts = {k: r[k] / max(r["batch"], 1) * 1e6
                     for k in ("t_attn", "t_attn_io", "t_fc", "t_fc_io")}
            emit(f"fig12_{tag}", per_tok * 1e6,
                 "attn={t_attn:.0f}us attn_io={t_attn_io:.0f}us "
                 "fc={t_fc:.0f}us fc_io={t_fc_io:.0f}us".format(**parts))
            if lvl == 0:
                base_t = per_tok
            out[(hybrid, lvl)] = per_tok
        emit(f"fig12_claim_{'gpu+lolpim' if hybrid else 'standalone'}_cut",
             0.0,
             f"model={100 * (1 - out[(hybrid, 3)] / base_t):.0f}% paper>60%")

    page = 256
    max_ctx = 262_144
    table_w = -(-max_ctx // page) + 1
    per_tok = PM.QWEN_72B.kv_bytes_per_token          # all layers, k+v
    for ctx in (2_048, 32_768, 262_144):
        dense_gb = 3 * table_w * page * per_tok / 1e9
        kern_gb = ctx * per_tok / 1e9
        out[("hbm", ctx)] = (dense_gb, kern_gb)
        emit(f"decode_hbm_ctx{ctx}", 0.0,
             f"gathered_dense_GB/tok={dense_gb:.1f} "
             f"kernel_GB/tok={kern_gb:.2f} cut={dense_gb / kern_gb:.0f}x "
             f"live_pages={-(-ctx // page)}/{table_w}")
    return out


# ---------------------------------------------------------------------------
# Table 8: throughput and compute utilization across model scales
# ---------------------------------------------------------------------------

PAPER_TABLE8 = {  # (tok/s, util%) per Table 8
    "7B": {"nodes": 4, "model": PM.QWEN_7B,
           0: (1833, 15.1), 2: (2455, 20.2), 3: (3668, 30.1)},
    "14B": {"nodes": 5, "model": PM.QWEN_14B,
            0: (1309, 15.4), 2: (1737, 20.5), 3: (2553, 30.1)},
    "72B": {"nodes": 16, "model": PM.QWEN_72B,
            0: (737, 12.8), 2: (1211, 21.1), 3: (1740, 30.3)},
}


def utilization(emit):
    """qwen1.5 7B / 14B / 72B on Musique at the paper's node counts, for
    baseline PIM and LoL-PIM levels 2 and 3, against the paper's rows."""
    kw = _musique_kw()
    out = {}
    for name, row in PAPER_TABLE8.items():
        for lvl in (0, 2, 3):
            r = PM.throughput(PM.lol_pim(row["nodes"], level=lvl),
                              row["model"], **kw)
            ptok, putil = row[lvl]
            out[(name, lvl)] = r
            emit(f"table8_{name}_lvl{lvl}", r["t_step"] * 1e6,
                 f"model={r['tokens_per_s']:.0f}tok/s_{r['util'] * 100:.1f}% "
                 f"paper={ptok}tok/s_{putil}% "
                 f"err={abs(r['tokens_per_s'] - ptok) / ptok * 100:.0f}%")
    return out


SUITES = (throughput_scaling, tp_pp_ablation, lazy_alloc, io_overlap,
          latency_breakdown, utilization)


def run_all(emit) -> None:
    """The six suites in ``benchmarks/run.py``'s order."""
    for suite in SUITES:
        suite(emit)


def main() -> int:
    rows = []

    def emit(name: str, us: float, derived: str) -> None:
        rows.append((name, us, derived))
        print(f"{name},{us:.2f},{derived}", flush=True)

    print("name,us_per_call,derived")
    run_all(emit)
    print(f"# {len(rows)} benchmark rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
