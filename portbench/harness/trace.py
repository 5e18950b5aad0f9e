"""Reading the device trace of a ``--trace 1`` run.

``torch.profiler`` records the card's kernels, copies and sets (kernels
inside a replayed CUDA graph included) and the host's ops and this
benchmark's own spans (``bench.*``). The traced window opens and closes
on an idle card (``drive.Driver`` collects the in-flight horizon first),
so every device operation recorded belongs to it. From the trace:

* ``busy_s``: the length of the union of the device operations'
  intervals;
* kernel time and count by name (the rooflines read these);
* ``breakdown``: the ten device operations that took most time, and the
  ten longest idle gaps of the card, each named by what the host was
  doing at its middle (the innermost host op, under the outermost
  ``bench.*`` span).

The device timeline is written beside the checkout's build outputs
(``build/portbench/traces/<cell>-<seed>.npz``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

SPAN = "bench."             # the prefix of the benchmark's own spans


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)     # name -> [s, count]
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    events: int = 0
    read_s: float = 0.0
    path: str | None = None
    export_s: float = 0.0

    def kernel_s(self, fragment: str) -> tuple[float, int]:
        """Device seconds and launches of every kernel whose name holds
        ``fragment``."""
        s = n = 0
        for name, (sec, cnt) in self.kernels.items():
            if fragment in name:
                s += sec
                n += cnt
        return s, n


def _raw_events(prof):
    """(device, name, start_ns, end_ns) of every event of the trace."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    out = []
    for e in res.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = 1000 * e.start_us(), 1000 * e.duration_us()
        out.append((e.device_type() != DeviceType.CPU, e.name(), s, s + d))
    return out


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge [start, end] rows (sorted by start) into disjoint intervals."""
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return np.asarray(merged, dtype=np.int64).reshape(-1, 2)


def summarize(prof, window_s: float, export: Path | None = None
              ) -> TraceSummary:
    t0 = time.perf_counter()
    evs = _raw_events(prof)
    # the benchmark's own spans are mirrored on the device timeline as
    # annotations: they are host spans, not device work
    dev = [(n, s, e) for d, n, s, e in evs if d and not n.startswith(SPAN)]
    host = [(n, s, e) for d, n, s, e in evs if not d]
    kernels: dict = {}
    for n, s, e in dev:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
    iv = np.asarray(sorted((s, e) for _, s, e in dev),
                    dtype=np.int64).reshape(-1, 2)
    merged = _union(iv)
    busy = float((merged[:, 1] - merged[:, 0]).sum()) / 1e9
    gaps = []
    if len(merged) > 1:
        starts, ends = merged[1:, 0], merged[:-1, 1]
        order = np.argsort(starts - ends)[::-1][:10]
        hs = np.asarray([s for _, s, _ in host], dtype=np.int64)
        he = np.asarray([e for _, _, e in host], dtype=np.int64)
        names = [n for n, _, _ in host]
        for i in order:
            mid = (int(ends[i]) + int(starts[i])) // 2
            gaps.append([_host_at(mid, hs, he, names),
                         (int(starts[i]) - int(ends[i])) / 1e9])
    ops = sorted(([n, v[0]] for n, v in kernels.items()),
                 key=lambda r: -r[1])[:10]
    read_s = time.perf_counter() - t0
    path = None
    if export is not None:
        path = str(_save(export, dev, host))
    return TraceSummary(window_s, busy, kernels, ops, gaps, len(evs),
                        read_s, path, time.perf_counter() - t0 - read_s)


def _save(path: Path, dev: list, host: list) -> Path:
    """The window's device timeline (every operation's name, start and
    end, ns) and the benchmark's own host spans, as one compressed npz: a
    full chrome trace of a 40 s window is millions of events and minutes
    to write."""
    path.parent.mkdir(parents=True, exist_ok=True)
    names = sorted({n for n, _, _ in dev})
    index = {n: i for i, n in enumerate(names)}
    spans = [(n, s, e) for n, s, e in host if n.startswith(SPAN)]
    np.savez_compressed(
        path, names=np.asarray(names),
        op=np.asarray([index[n] for n, _, _ in dev], dtype=np.int32),
        start_ns=np.asarray([s for _, s, _ in dev], dtype=np.int64),
        end_ns=np.asarray([e for _, _, e in dev], dtype=np.int64),
        span=np.asarray([n for n, _, _ in spans]),
        span_start_ns=np.asarray([s for _, s, _ in spans], dtype=np.int64),
        span_end_ns=np.asarray([e for _, _, e in spans], dtype=np.int64))
    return path


def _host_at(t: int, hs, he, names) -> str:
    if not len(hs):
        return "no host event"
    hit = np.nonzero((hs <= t) & (he >= t))[0]
    if not len(hit):
        return "host idle"
    bench = [i for i in hit if names[i].startswith(SPAN)]
    inner = min(hit, key=lambda i: he[i] - hs[i])
    outer = max(bench, key=lambda i: he[i] - hs[i]) if bench else None
    if outer is None or outer == inner:
        return names[inner]
    return f"{names[outer]}/{names[inner]}"


def profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def span(name: str):
    """A host span of the benchmark's own, seen in the trace."""
    return torch.profiler.record_function(SPAN + name)
