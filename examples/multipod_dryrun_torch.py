"""Dry-run one production cell on the PyTorch port and print its roofline,
after ``examples/multipod_dryrun.py``.

  PYTHONPATH=src python examples/multipod_dryrun_torch.py [arch] [shape]

The cell runs one shard's step on meta tensors over the (2, 16, 16)
(pod, data, model) mesh with the shape-only backend: nothing is allocated
and no card is needed. The roofline terms use the H100's datasheet
figures. (The full 68-cell sweep: PYTHONPATH=src python -m
repro_torch.launch.dryrun --all --both-meshes.)
"""
import sys

from repro_torch.launch.dryrun import run_cell

arch = sys.argv[1] if len(sys.argv) > 1 else "llama3.2-1b"
shape = sys.argv[2] if len(sys.argv) > 2 else "decode_32k"

res = run_cell(arch, shape, multi_pod=True, save=False)
if res["ok"]:
    r, m = res["roofline"], res["memory"]
    print(f"\ncell {res['cell']} on {res['devices']} devices "
          f"({res['layout']}):")
    print(f"  peak memory/device : {m['peak_bytes'] / 2**30:.2f} GiB")
    print(f"  compute term       : {r['t_compute'] * 1e3:.2f} ms")
    print(f"  memory term        : {r['t_memory'] * 1e3:.2f} ms")
    print(f"  collective term    : {r['t_collective'] * 1e3:.2f} ms")
    print(f"  bottleneck         : {r['bottleneck']}")
else:
    print("FAILED:", res["error"])
    sys.exit(1)
