"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. The cell, its
configuration, traffic mix, set-up and metrics are found by name from
``BENCHMARK.json`` (``harness.spec``). The last line of standard output is
the result as one JSON object; the last lines of standard error are the
numbers the correctness check compared, each beside its limit. Without a
CUDA card, or with fewer than the cell asks for, it exits 2 and prints no
result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "portbench" / "cache"
# every compile cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
# one process with few host threads: steadier timings on a shared host
os.environ.setdefault("OMP_NUM_THREADS", "2")
sys.path[:0] = [str(HERE), str(ROOT / "src")]

import torch  # noqa: E402

torch.set_num_threads(2)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from harness.spec import resolve
    cell = resolve(a.workload, ROOT)
    import repro_torch  # noqa: F401  (the program under test must be here)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell asks for {cell.chips} CUDA card(s); "
              f"this process sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from harness.bench import run
    res = run(cell, a.seed, a.seconds, bool(a.trace), t_start=T_START)
    w = res["_window"]
    print(f"portbench: {a.workload} seed {a.seed}: setup {w.setup_s:.3f} s,"
          f" window {w.seconds:.3f} s, {len(w.tracks)} requests, "
          f"{w.output_tokens()} tokens; sampled {res['_served']['sampled']}"
          f", flips {res['_served']['flips']}, reference "
          f"{res['_served']['ref_s']:.1f} s; {power_limit()}",
          file=sys.stderr)
    print("portbench: setup " + ", ".join(
        f"{k} {v:.3f} s" for k, v in res["_setup"].items()), file=sys.stderr)
    if w.trace is not None:
        print(f"portbench: trace {w.trace.events} events read in "
              f"{w.trace.read_s:.1f} s, written in {w.trace.export_s:.1f} s"
              f" -> {w.trace.path}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = {k: v for k, v in res.items() if not k.startswith("_")}
    line["checks"] = line.pop("checks")
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
