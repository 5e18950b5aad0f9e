"""Roofline report: read the dry-run JSONs, emit the per-cell table.

  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod1|pod2|all]

The port's counterpart of ``repro/launch/roofline.py``. Per (arch x shape
x mesh) of ``launch/dryrun.py``'s cells: the three roofline terms (s), the
dominant bottleneck, the MODEL_FLOPS / counted FLOPs usefulness ratio and
the lever that would move the dominant term. ``model_flops`` is repro's
rule (6ND train, 2ND prefill, decode adds the KV read math).

The card's figures (``roofline_terms``' defaults) are the NVIDIA H100 SXM
datasheet's, not measured here: 989 TF/s dense bf16, 3.35 TB/s HBM3, and
NVLink 4 at 900 GB/s both ways, 450 GB/s a direction.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import SHAPES, get_config

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

H100_BF16_FLOPS = 989e12     # dense bf16 tensor cores (datasheet)
H100_HBM_BW = 3.35e12        # HBM3 bytes/s (datasheet)
H100_NVLINK_BW = 450e9       # NVLink 4, bytes/s a direction (datasheet)


def roofline_terms(metrics: dict, *, peak_flops=H100_BF16_FLOPS,
                   hbm_bw=H100_HBM_BW, link_bw=H100_NVLINK_BW,
                   n_links=1) -> dict:
    """Per-card roofline terms in seconds (repro's ``roofline_terms`` with
    the H100's datasheet figures in place of the TPU's)."""
    t_comp = metrics["flops"] / peak_flops
    t_mem = metrics["hbm_bytes"] / hbm_bw
    t_coll = metrics["collective_bytes"] / (link_bw * n_links)
    dom = max(("compute", t_comp), ("memory", t_mem), ("collective", t_coll),
              key=lambda kv: kv[1])
    return {"t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll,
            "bottleneck": dom[0], "t_bound": dom[1]}


def model_flops(arch: str, shape_name: str, n_dev: int) -> float:
    """Useful model FLOPs per device per step (6ND train, 2ND inference)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        tok = shape.global_batch * shape.seq_len
        return 6.0 * n * tok / n_dev
    if shape.kind == "prefill":
        tok = shape.global_batch * shape.seq_len
        return 2.0 * n * tok / n_dev
    # decode: one token per request + the attention KV read math
    tok = shape.global_batch
    attn = (2.0 * shape.global_batch * shape.seq_len
            * cfg.kv_bytes_per_token() / 2)
    return (2.0 * n * tok + attn) / n_dev


def lever(row: dict) -> str:
    b = row["roofline"]["bottleneck"]
    kind = SHAPES[row["shape"]].kind
    if b == "collective":
        return ("shrink the weight gathers: bf16 collectives, fewer "
                "re-gathers under remat" if kind == "train"
                else "fewer collectives a layer: one gather for the TP "
                "inputs, the TP sums fused with the ITPP merge")
    if b == "memory":
        return ("bound gathered KV to the window / fuse attention "
                "intermediates" if kind == "decode" else
                "fused attention and MLP (the unfused op-by-op bytes); "
                "bf16 intermediates")
    return "already compute-bound: raise tensor-core utilization"


def load(mesh_filter: str = "all", results: Path = RESULTS):
    rows = []
    for f in sorted(Path(results).glob("*.json")):
        d = json.loads(f.read_text())
        if not d.get("ok"):
            rows.append(d)
            continue
        mesh = "pod2" if d["multi_pod"] else "pod1"
        if mesh_filter != "all" and mesh != mesh_filter:
            continue
        mf = model_flops(d["arch"], d["shape"], d["devices"])
        d["model_flops_ratio"] = mf / max(d["hlo"]["flops"], 1.0)
        rows.append(d)
    return rows


def emit_markdown(rows, *, include_levers: bool = True) -> str:
    out = ["| arch | shape | mesh | layout | peak GiB/dev | t_comp s | "
           "t_mem s | t_coll s | bottleneck | MODEL/counted flops |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if not d.get("ok"):
            out.append(f"| {d['arch']} | {d['shape']} | - | - | FAIL "
                       "| | | | | |")
            continue
        r = d["roofline"]
        m = d["memory"]
        mesh = ("pod2" if d["multi_pod"] else "pod1") + \
            ("/pp" if d.get("pod_mode") == "pp" else "")
        out.append(
            f"| {d['arch']} | {d['shape']} | {mesh} | {d['layout']} | "
            f"{m['peak_bytes'] / 2**30:.2f} | {r['t_compute']:.3f} | "
            f"{r['t_memory']:.3f} | {r['t_collective']:.3f} | "
            f"{r['bottleneck']} | {d['model_flops_ratio']:.3f} |")
    if include_levers:
        out.append("")
        out.append("Levers for the dominant term (per bottleneck class):")
        seen = set()
        for d in rows:
            if not d.get("ok"):
                continue
            key = (d["roofline"]["bottleneck"], SHAPES[d["shape"]].kind)
            if key in seen:
                continue
            seen.add(key)
            out.append(f"- {key[1]}/{key[0]}-bound: {lever(d)}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "all"])
    ap.add_argument("--results", default=str(RESULTS))
    args = ap.parse_args(argv)
    rows = load(args.mesh, Path(args.results))
    print(emit_markdown(rows))
    n_fail = sum(1 for d in rows if not d.get("ok"))
    print(f"\n{len(rows) - n_fail} cells ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
