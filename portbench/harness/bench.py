"""One run of one cell: set-up, the measured window, the correctness check,
the metrics, and the result line.

``run`` is the whole of a run after the look for a card (``run.py``), so
the tests drive it on the CPU at tiny sizes. The order is fixed: the
window closes, the device's peak memory is read, the program's state is
freed, the modules the process holds are checked, and only then does the
reference run.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from harness import judge
from harness import trace as T
from harness.drive import Driver
from harness.spec import ROOT, Cell
from harness.traffic import Traffic
from harness.weights import derived, make_params

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_DIR = ROOT / "build" / "portbench" / "traces"


def forbidden_loaded() -> list:
    """Top-level names of ``FORBIDDEN`` that ``sys.modules`` holds, compared
    whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def model_config(config: dict):
    """The port's ``ModelConfig`` of a config file."""
    from dataclasses import fields

    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in fields(ModelConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in config.items() if k in names}
    return ModelConfig(**kw)


def engine_config(cell: Cell):
    from repro_torch.serving import EngineConfig
    kw = dict(cell.cell["engine"])
    kw.setdefault("eos_token", -1)
    return EngineConfig(**kw)


def run(cell: Cell, seed: int, seconds: float, traced: bool, *,
        t_start: float, device="cuda", control: bool = False,
        check: bool = True) -> dict:
    """One run. ``control`` also reads the control's gap (the calibration
    tool's); ``check=False`` skips the reference (the rate sweep's)."""
    from repro_torch.serving import DecodeEngine
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = model_config(cell.config)
    c = derived(cell.config)
    t0 = time.perf_counter()
    params = make_params(cell.config, seed, dev)
    traffic = Traffic(cell.traffic, seed, c["vocab_size"])
    t1 = time.perf_counter()
    eng = DecodeEngine(cfg, engine_config(cell), params, device=dev)
    t2 = time.perf_counter()
    drv = Driver(eng, traffic, cell.cell, cell.config, seconds)
    drv.setup()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    phases = dict({"start": t0 - t_start, "weights": t1 - t0,
                   "engine": t2 - t1}, **drv.phases)
    prof = T.profiler() if traced else None
    w = drv.window(seconds, prof=prof)
    tracks = w.tracks
    w.setup_s = setup_s
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    if traced:
        w.trace = T.summarize(prof, w.seconds, TRACE_DIR / (
            f"{cell.name}-{seed}.npz"))
        del prof
    sample = judge.pick(tracks, int(cell.cell["check"]["sample"]), seed)
    served = [judge.Served(t.rid, traffic.prompts[t.rid],
                           list(eng.outputs[t.rid][:t.n_close]), t.adopted)
              for t in sample]
    failed = len(eng.aborted)
    attempted = len(tracks)
    eng.release()
    del eng, params, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {', '.join(bad)}")
    chk = {"logit_gap": float("nan"), "positions": 0, "flips": 0}
    t_ref = time.perf_counter()
    if check:
        chk = judge.gaps(cell.config, served, seed,
                         int(cell.cell["engine"]["page_size"]), dev,
                         control=control)
    checks, correct = judge.verdict(chk, cell.cell["check"]["limits"])
    metrics = {}
    for m in cell.metrics_for(traced):
        v = m.read(w)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": info}
    if traced:
        info["busy_s"] = w.trace.busy_s
        info["window_s"] = w.trace.window_s
        out["breakdown"] = {"device_ops": w.trace.device_ops,
                            "idle_gaps": w.trace.idle_gaps}
    out["checks"] = checks
    out["_window"] = w
    out["_setup"] = phases
    out["_served"] = dict(chk, sampled=len(served),
                          ref_s=time.perf_counter() - t_ref)
    return out
