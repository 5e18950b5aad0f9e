"""Metrics registry: counters / gauges / histograms behind one namespace.

A copy of ``repro/telemetry/registry.py`` (framework-free).

The serving stack accumulates state in many places — ``EngineTiming``,
``SchedulerStats``, ``PageAllocator`` occupancy, ``CacheStats`` /
``TierStats``, the engine's speculative and rstate counters. The registry
unifies them behind ``repro_*`` metric names without moving any of them:

* **push instruments** (``Counter.inc`` / ``Gauge.set`` /
  ``Histogram.observe``) for values telemetry itself owns (per-request
  latency histograms, modeled PIM byte accounting);
* **pull bindings** (``bind``) for counters that already live in a
  subsystem: a zero-argument callable is read at scrape time, so the hot
  path pays nothing and the authoritative value stays where it always was.

``render()`` emits Prometheus text exposition format (served by
``telemetry.prom``); ``parse_exposition`` is the strict parser the tests
and the CI smoke use to validate it. A ``NullRegistry`` with the same API
backs disabled telemetry: every instrument is a shared no-op.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default latency buckets (seconds): 1ms .. ~100s, multiplicative
LATENCY_BUCKETS = tuple(0.001 * (10 ** (i / 4)) for i in range(21))


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: dict[str, str] | None) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace('"', r"\"") \
            .replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


@dataclass
class Counter:
    name: str
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


@dataclass
class Gauge:
    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, v: float = 1.0) -> None:
        self.value += v


@dataclass
class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` semantics on render)."""
    name: str
    buckets: tuple[float, ...] = LATENCY_BUCKETS
    counts: list[int] = field(default_factory=list)
    sum: float = 0.0
    count: int = 0

    def __post_init__(self):
        self.buckets = tuple(sorted(self.buckets))
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class _NullInstrument:
    """Shared no-op instrument: disabled telemetry costs one attribute call."""
    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    value = 0.0


_NULL = _NullInstrument()


class MetricsRegistry:
    """Instrument factory + scrape surface, one per engine."""

    enabled = True

    def __init__(self, namespace: str = "repro"):
        assert _NAME_RE.match(namespace), namespace
        self.ns = namespace
        # (name, labels-key) -> (kind, help, instrument-or-callable, labels)
        self._metrics: dict[tuple, tuple] = {}
        self._help: dict[str, str] = {}

    # ------------------------------------------------------------------
    def _key(self, name: str, labels: dict | None) -> tuple:
        return (name, tuple(sorted((labels or {}).items())))

    def _register(self, kind: str, name: str, help: str, obj,
                  labels: dict | None):
        name = f"{self.ns}_{name}"
        assert _NAME_RE.match(name), name
        for lk in (labels or {}):
            assert _LABEL_RE.match(lk), lk
        key = self._key(name, labels)
        if key in self._metrics:
            prev = self._metrics[key]
            assert prev[0] == kind, (name, prev[0], kind)
            return prev[2]
        assert self._help.setdefault(name, help) == help or True
        self._metrics[key] = (kind, help, obj, dict(labels or {}))
        return obj

    # ---- push instruments --------------------------------------------
    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._register("counter", name, help, Counter(name), labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._register("gauge", name, help, Gauge(name), labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = LATENCY_BUCKETS,
                  labels: dict | None = None) -> Histogram:
        return self._register("histogram", name, help,
                              Histogram(name, buckets), labels)

    # ---- pull bindings ------------------------------------------------
    def bind(self, name: str, fn, help: str = "", kind: str = "gauge",
             labels: dict | None = None) -> None:
        """Bind a zero-arg callable read at scrape time (``kind`` is the
        Prometheus type it is exposed as: counters that live in subsystem
        stats objects stay there; the registry just reads them)."""
        assert kind in ("counter", "gauge"), kind
        self._register(kind, name, help, fn, labels)

    # ------------------------------------------------------------------
    def collect(self) -> dict[str, float]:
        """Flat snapshot {sample_name+labels: value} — histograms contribute
        ``_sum`` and ``_count``. The tests' counter-exactness surface."""
        out: dict[str, float] = {}
        for (name, _), (kind, _h, obj, labels) in self._metrics.items():
            ls = _labels_str(labels)
            if kind == "histogram":
                out[f"{name}_sum{ls}"] = obj.sum
                out[f"{name}_count{ls}"] = obj.count
            elif callable(obj):
                out[f"{name}{ls}"] = float(obj())
            else:
                out[f"{name}{ls}"] = float(obj.value)
        return out

    def get(self, name: str, labels: dict | None = None) -> float:
        """One sample value by unprefixed name (tests / stats line)."""
        full = f"{self.ns}_{name}"
        kind, _h, obj, _l = self._metrics[self._key(full, labels)]
        if kind == "histogram":
            return float(obj.count)
        return float(obj() if callable(obj) else obj.value)

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        by_name: dict[str, list] = {}
        kinds: dict[str, str] = {}
        for (name, _), (kind, help, obj, labels) in self._metrics.items():
            by_name.setdefault(name, []).append((labels, obj))
            kinds[name] = kind
        lines: list[str] = []
        for name in sorted(by_name):
            kind = kinds[name]
            help = self._help.get(name, "")
            if help:
                esc = help.replace("\\", r"\\").replace("\n", r"\n")
                lines.append(f"# HELP {name} {esc}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, obj in by_name[name]:
                ls = _labels_str(labels)
                if kind == "histogram":
                    cum = 0
                    for i, ub in enumerate(obj.buckets):
                        cum += obj.counts[i]
                        bl = dict(labels, le=_fmt(ub))
                        lines.append(f"{name}_bucket{_labels_str(bl)} {cum}")
                    cum += obj.counts[-1]
                    bl = dict(labels, le="+Inf")
                    lines.append(f"{name}_bucket{_labels_str(bl)} {cum}")
                    lines.append(f"{name}_sum{ls} {_fmt(obj.sum)}")
                    lines.append(f"{name}_count{ls} {obj.count}")
                else:
                    v = obj() if callable(obj) else obj.value
                    lines.append(f"{name}{ls} {_fmt(float(v))}")
        return "\n".join(lines) + "\n"


class NullRegistry(MetricsRegistry):
    """Same API, every instrument a shared no-op, renders empty."""

    enabled = False

    def __init__(self, namespace: str = "repro"):
        super().__init__(namespace)

    def counter(self, name, help="", labels=None):
        return _NULL

    def gauge(self, name, help="", labels=None):
        return _NULL

    def histogram(self, name, help="", buckets=LATENCY_BUCKETS, labels=None):
        return _NULL

    def bind(self, name, fn, help="", kind="gauge", labels=None):
        pass


# ---------------------------------------------------------------------------
# exposition-format validation (tests + CI smoke)
# ---------------------------------------------------------------------------
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?"
    r"\s+(?P<value>[^\s]+)(\s+\d+)?$")
_LABEL_PAIR_RE = re.compile(
    r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')


def parse_exposition(text: str) -> dict[str, float]:
    """Strict-enough parser for Prometheus text format: every non-comment
    line must be ``name[{labels}] value``, every TYPE must be a known kind,
    histogram series must carry _bucket/_sum/_count. Returns
    {sample: value}; raises ValueError on malformed input."""
    samples: dict[str, float] = {}
    types: dict[str, str] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {ln}: bad TYPE line: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            if not line.startswith(("# HELP ", "# TYPE ")):
                raise ValueError(f"line {ln}: bad comment: {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: bad sample: {line!r}")
        if m.group("labels"):
            body = m.group("labels")[1:-1]
            if body:
                for pair in re.split(r",(?=[a-zA-Z_])", body):
                    if not _LABEL_PAIR_RE.match(pair.strip()):
                        raise ValueError(
                            f"line {ln}: bad label {pair!r}")
        v = m.group("value")
        if v not in ("+Inf", "-Inf", "NaN"):
            try:
                float(v)
            except ValueError:
                raise ValueError(f"line {ln}: bad value {v!r}") from None
        samples[m.group("name") + (m.group("labels") or "")] = (
            float("inf") if v == "+Inf" else
            float("-inf") if v == "-Inf" else
            float("nan") if v == "NaN" else float(v))
    # histogram series integrity
    for name, kind in types.items():
        if kind != "histogram":
            continue
        have = {s for s in samples if s.startswith(name)}
        for suffix in ("_bucket", "_sum", "_count"):
            if not any(s.startswith(name + suffix) for s in have):
                raise ValueError(f"histogram {name} missing {suffix} series")
    return samples
