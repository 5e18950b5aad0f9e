"""Read the two ends a correctness limit is set between, on the card, and
judge both by the cell's own comparison:

    python3 portbench/calibrate.py --workload <name> --seconds <s> \
        --seeds 11,12,13 [--json out.json]

For each seed, in one process: a run of the cell (its set-up and a window
of ``--seconds`` at its own load), then the reference over the sampled
requests, which reads the program's widest logit gap (the lower reading)
and the control's: the reference in TF32 at the same positions (the upper
reading). Each is judged by ``harness.judge.verdict`` against the limits
of ``cells/<name>.json``, as a run judges the program; a row gives both
verdicts, and the program has to come out correct and the control not.
The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def calibrate(cell, seeds, seconds: float, device="cuda") -> list:
    """One row a seed: the program's verdict and the control's, each by
    ``harness.judge.verdict`` against the cell's own limits."""
    from harness.bench import run
    from harness.judge import verdict
    limits = cell.cell["check"]["limits"]
    rows = []
    for seed in seeds:
        res = run(cell, seed, seconds, False, t_start=time.perf_counter(),
                  device=device, control=True)
        s = res["_served"]
        ctl_checks, ctl_correct = verdict(
            {"logit_gap": s["control_gap"], "positions": s["positions"]},
            limits)
        rows.append({"seed": seed,
                     "program": {"correct": res["correct"],
                                 "checks": res["checks"]},
                     "control": {"correct": ctl_correct,
                                 "checks": ctl_checks},
                     "flips": s["flips"], "control_flips": s["control_flips"],
                     "sampled": s["sampled"], "ref_s": s["ref_s"],
                     "metrics": res["metrics"]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    from harness.spec import resolve
    cell = resolve(a.workload, HERE.parent)
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        rows += calibrate(cell, [seed], a.seconds, a.device)
        print(json.dumps(rows[-1]), flush=True)
    gap = [r["program"]["checks"]["logit_gap"]["value"] for r in rows]
    ctl = [r["control"]["checks"]["logit_gap"]["value"] for r in rows]
    print(json.dumps({"workload": a.workload, "lower": max(gap),
                      "upper": min(ctl),
                      "limit": cell.cell["check"]["limits"]["logit_gap"],
                      "seeds": len(rows),
                      "program_correct": sum(r["program"]["correct"]
                                             for r in rows),
                      "control_correct": sum(r["control"]["correct"]
                                             for r in rows)}), flush=True)
    if a.json:
        Path(a.json).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
