"""Find the knee of a cell with an open part once, by a sweep of fixed
rates on the card:

    python3 portbench/sweep.py --workload <name> --seconds <s> \
        --rates 4,6,8,10 --seed <n>

Each rate is one run of the cell with its open part's ``rate_per_s``
replaced (no correctness check). A row gives the requests due, those answered
(first token) and finished by the close, the backlog (due, not answered),
the output tokens a second and the tails. The knee is the highest rate
whose backlog stays small and whose answered share stays near 1; the cell
then runs at 0.8 x the knee.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def sweep(base, rates, seconds: float, seed: int, device="cuda"):
    """One row a rate: a run of ``base`` with its open part at that rate."""
    from harness.bench import run
    for rate in rates:
        cell = copy.deepcopy(base)
        cell.traffic["open"]["arrival"]["rate_per_s"] = float(rate)
        res = run(cell, seed, seconds, False, t_start=time.perf_counter(),
                  device=device, check=False)
        w = res["_window"]
        due = w.due()
        answered = sum(1 for t in due if t.first_t is not None
                       and t.first_t <= w.t_close)
        tt = 1e3 * w.ttfts()
        tp = 1e3 * w.tpots()
        yield {"rate": float(rate), "due": len(due), "answered": answered,
               "finished": sum(1 for t in due if t.done),
               "backlog": len(due) - answered,
               "tok_s": w.output_tokens() / w.seconds,
               "ttft_p50_ms": float(np.median(tt)),
               "ttft_p95_ms": float(np.percentile(tt, 95)),
               "tpot_p95_ms": (float(np.percentile(tp, 95)) if len(tp)
                               else None),
               "setup_s": res["metrics"]["setup_s"]["value"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from harness.spec import resolve
    base = resolve(a.workload, HERE.parent)
    for row in sweep(base, a.rates.split(","), a.seconds, a.seed, a.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
