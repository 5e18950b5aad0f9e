"""Per-op attribution for one dry-run cell: its top contributors by flops,
bytes or collective bytes.

  PYTHONPATH=src python -m repro_torch.launch.profile_cell --arch \\
      gemma3-27b --shape decode_32k [--multi-pod] [--top 25] \\
      [--kind flops|bytes|coll]

The port's counterpart of ``repro/launch/profile_cell.py``, which reads
the compiled HLO. Here the cell's shard step runs once more on meta
tensors under ``launch/dryrun.py``'s ``Tally``, which keeps each aten
op's flops (``FlopCounterMode``'s rule) and its inputs' and outputs' bytes
(unfused), and ``distributed/mesh.ShapeMesh`` each collective kind's
bytes.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun as DR


def profile(arch, shape, multi_pod=False, pod_mode="dp", parallel=None):
    """(rows, summary): rows of (flops, bytes, calls, op) for every aten op
    the step ran, plus one a collective kind as (0, bytes, 0,
    "collective:<kind>"); summary as the cell's ``hlo``."""
    step, args, _, _, plan = DR.build_cell(
        arch, shape, multi_pod=multi_pod, pod_mode=pod_mode,
        parallel=parallel)
    with DR.counting(plan.mesh) as (tally, extra):
        step(*args)
    rows = [(fl, b, n, op) for op, (b, n, fl) in tally.by_op.items()]
    if extra["steps"]:
        rows.append((extra["flops"], extra["bytes"], extra["steps"],
                     "slstm cell steps (extrapolated)"))
    coll = dict(plan.mesh.collectives)
    rows += [(0.0, b, 0, f"collective:{k}") for k, b in coll.items()]
    summary = {"flops": tally.flops + extra["flops"],
               "hbm_bytes": tally.bytes + extra["bytes"],
               "collectives": coll,
               "collective_bytes": float(sum(coll.values()))}
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--pod-mode", default="dp", choices=["dp", "pp"])
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--kind", default="bytes",
                    choices=["flops", "bytes", "coll"])
    args = ap.parse_args(argv)
    rows, s = profile(args.arch, args.shape, multi_pod=args.multi_pod,
                      pod_mode=args.pod_mode)
    if args.kind == "coll":
        rows = [r for r in rows if r[3].startswith("collective:")]
    else:
        rows = [r for r in rows if not r[3].startswith("collective:")]
    key = 0 if args.kind == "flops" else 1
    rows.sort(key=lambda r: -r[key])
    print(f"== {args.arch} {args.shape} summary: flops={s['flops']:.3e} "
          f"hbm={s['hbm_bytes'] / 2**30:.2f}GiB (unfused) "
          f"coll={s['collective_bytes'] / 2**30:.3f}GiB ==")
    for fl, b, n, op in rows[:args.top]:
        if (fl if key == 0 else b) <= 0:
            continue
        print(f"{fl:11.3e} flops {b / 2**30:9.3f}GiB x{n:7d} {op}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
