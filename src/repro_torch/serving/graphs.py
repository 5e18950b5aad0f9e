"""The fused decode horizon, or a speculative round, as one CUDA graph per
(table width, horizon, kind).

The port's counterpart of ``repro/serving/engine.py::_make_fused`` and
``_make_spec``: JAX jits the horizon once for each static ``(horizon,
width)`` (a speculative round: the draft's proposal scan and the target's
verify, two jits) and donates the slot state, so a horizon of K steps is
one dispatch. Here the horizon (``models.model.decode_multi`` plus the
copies below) or the round (``draft_propose`` then ``decode_verify``, K =
``spec_horizon + 1``) is captured once per ``(width, K, spec)`` into a
``torch.cuda.CUDAGraph`` and replayed each tick (``spec`` says which of
the two: a speculative engine whose degradation ladder turns spec off,
``degraded_mode`` bit 2, captures plain horizons from then on);
``serving.prefill.decode_table_bucket`` keeps the widths to O(log maxp).
The draft's catch-up prefill stays eager, as prefill does.

Static buffers take the place of donation. A replay reads and writes fixed
addresses, so every tensor the horizon touches keeps its ``data_ptr`` for
the engine's life:

* inputs: ``DeviceSlotState``'s ``bt``, ``ctx``, ``tokens`` and ``rem``
  (the host patches dirty rows in place) and this runner's ``allow``
  ``[n_slots]`` int32, written before each replay;
* the decode state: the paged pool (written in place by the decode step),
  the recurrent rows (Mamba2, mLSTM and sLSTM carries: ``copy_`` into the
  stacked leaves) and whisper's cross K/V rows (read; written in place at
  admission, outside the graph);
* a speculative round's: the draft pool (written in place like the
  target's), the static proposals ``[n, K-1]`` and, for stochastic
  kinds, the draft's logits ``[K-1, n, V]`` that the verify reads;
* outputs: the horizon's new ``tokens``/``ctx``/``rem`` are copied back into
  ``DeviceSlotState``, and ``(toks [K, n], emit [K, n], fin [n])`` (a
  round: and its accept lengths ``acc [n]``) are packed into one int32
  ``[2 K n + n]`` (``[2 K n + 2 n]``) buffer per key, the one readback of
  the horizon.

Random draws (temperature / top-k): the engine's generators are
registered with each graph, so a replay draws at the generator's current
Philox offset and advances it by what the captured draws consume. Their
states are put back after the warm-up and capture passes, so the graph
path draws what an eager run draws: the same seed and call sequence give
the same tokens either way.

Capture runs the horizon with ``allow`` zeroed, so no slot runs: KV writes
land on the trash page, the recurrent rows keep their carry and tokens, ctx
and rem are left as they were. A capture in the middle of serving
therefore leaves the live state unchanged. The warm-up pass runs on a side
stream (as the ``torch.cuda.graphs`` documentation asks), all of an
engine's graphs share one memory pool (they never run at once), and a
capture or replay that fails raises: there is no eager fallback.

Launch counters: the kernel wrappers count in Python where they launch. A
capture pass counts launches that never run and a replay counts nothing,
so ``capture`` takes the warm-up's and the capture's counts back off and
each replay adds the capture pass's counts again: the counters read as if
every horizon had run eagerly.

Without graphs (a CPU engine, or ``EngineConfig.decode_graphs=False``) the
same body runs eagerly through the same static buffers and in-place copies.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.paged_attention import paged_attention_partials
from repro_torch.kernels.ssm_scan import ssm_chunk_scan
from repro_torch.models import model as MDL

# every launch counter of the kernel wrappers: (wrapper, attribute)
LAUNCH_COUNTERS = ((paged_attention_partials, "launches"),
                   (flash_attention_fwd, "launches"),
                   (flash_attention_fwd, "launches_noncausal"),
                   (flash_decode, "launches"),
                   (ssm_chunk_scan, "launches"),
                   (ssm_chunk_scan, "launches_chunk"),
                   (ssm_chunk_scan, "launches_step"))


def launch_counts() -> tuple[int, ...]:
    return tuple(getattr(fn, a) for fn, a in LAUNCH_COUNTERS)


def _set_counts(values) -> None:
    for (fn, a), v in zip(LAUNCH_COUNTERS, values):
        setattr(fn, a, v)


class CapturedHorizon:
    """A captured graph and the launches one replay of it makes."""

    def __init__(self, graph, launches: tuple[int, ...]):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        _set_counts(a + d for a, d in zip(launch_counts(), self.launches))


def capture(body, graph, *, warmup, capture_ctx) -> CapturedHorizon:
    """Run ``warmup(body)``, then capture ``body`` into ``graph`` under
    ``capture_ctx(graph)``. The launch counters end as they began; the
    result's replays add the capture pass's launches.

    Python's cyclic collector is held off until the capture ends: a dead
    engine's graphs (an engine is a reference cycle) would otherwise be
    reset by an automatic collection inside this capture, which CUDA
    refuses and which invalidates the capture (``torch.cuda.graph`` no
    longer collects on entry)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        before = launch_counts()
        warmup(body)
        mid = launch_counts()
        with capture_ctx(graph):
            body()
    finally:
        if enabled:
            gc.enable()
    delta = tuple(a - m for a, m in zip(launch_counts(), mid))
    _set_counts(before)
    return CapturedHorizon(graph, delta)


class HorizonRunner:
    """Dispatches the engine's fused decode horizon or speculative round: a
    graph replay per key ``(width, K, spec)`` when ``graphs``, else the
    same body run eagerly."""

    def __init__(self, engine, *, graphs: bool):
        self.eng = engine
        self.graphs = graphs
        n = engine.ecfg.n_slots
        self.allow = torch.zeros((n,), dtype=torch.int32,
                                 device=engine.device)
        self.outs: dict[tuple[int, int, bool], torch.Tensor] = {}
        # a round's static proposals [n, K-1] and draft logits [K-1, n, V]
        self.spec_bufs: dict[tuple[int, int, bool], tuple] = {}
        self.captured: dict[tuple[int, int, bool], CapturedHorizon] = {}
        self.pool = torch.cuda.graph_pool_handle() if graphs else None

    def _out(self, key) -> torch.Tensor:
        out = self.outs.get(key)
        if out is None:
            n, (_, K, spec) = self.eng.ecfg.n_slots, key
            size = 2 * K * n + (2 * n if spec else n)
            out = self.outs[key] = torch.zeros(
                (size,), dtype=torch.int32, device=self.eng.device)
        return out

    def _spec_buffers(self, key) -> tuple:
        bufs = self.spec_bufs.get(key)
        if bufs is None:
            eng, G = self.eng, key[1] - 1
            n, dev = eng.ecfg.n_slots, eng.device
            qlog = (torch.zeros((G, n, eng.cfg.padded_vocab),
                                dtype=torch.float32, device=dev)
                    if eng.need_q else None)
            bufs = self.spec_bufs[key] = (
                torch.zeros((n, G), dtype=torch.int32, device=dev), qlog)
        return bufs

    def _finish(self, key, toks, emit, fin, tokens, ctx, rem,
                acc=None) -> None:
        """Copy the new slot state back in place and pack the readback."""
        dev, out = self.eng.dev, self._out(key)
        n, K = self.eng.ecfg.n_slots, key[1]
        dev.tokens.copy_(tokens)
        dev.ctx.copy_(ctx)
        dev.rem.copy_(rem)
        out[:K * n].copy_(toks.reshape(-1))
        out[K * n:2 * K * n].copy_(emit.reshape(-1))
        out[2 * K * n:2 * K * n + n].copy_(fin)
        if acc is not None:
            out[2 * K * n + n:].copy_(acc)

    def _body(self, key) -> None:
        """One horizon: ``decode_multi`` on the static buffers (a round:
        ``draft_propose`` then ``decode_verify``), its new slot state
        copied back in place and the readback packed."""
        if key[2]:
            return self._spec_body(key)
        eng, (width, K, _) = self.eng, key
        E, dev = eng.ecfg, eng.dev
        toks, emit, fin, _, tokens, ctx, rem = MDL.decode_multi(
            eng.cfg, eng.params, eng.state, dev.tokens, dev.bt, dev.ctx,
            dev.rem, self.allow, eng.gen, horizon=K, table_width=width,
            page_size=E.page_size, n_pages=E.n_pages, eos_token=E.eos_token,
            sample=eng._scan_sample, rt=eng.rt)
        self._finish(key, toks, emit, fin, tokens, ctx, rem)

    def _spec_body(self, key) -> None:
        """One speculative round: the draft proposes ``K - 1`` tokens a slot
        into the static proposals (its pool written in place), and the
        target verifies them in one multi-query pass."""
        eng, (width, K, _) = self.eng, key
        E, dev = eng.ecfg, eng.dev
        prop, qlog = self._spec_buffers(key)
        geo = dict(horizon=K - 1, table_width=width, page_size=E.page_size,
                   n_pages=E.n_pages, rt=eng.rt)
        p, q, _ = MDL.draft_propose(
            eng.draft_cfg, eng.draft_params, eng._dstate, dev.tokens, dev.bt,
            dev.ctx, self.allow, eng.dgen, sample=eng._scan_sample,
            need_q=qlog is not None, **geo)
        prop.copy_(p)
        if qlog is not None:
            qlog.copy_(q)
        toks, emit, fin, _, tokens, ctx, rem, acc = MDL.decode_verify(
            eng.cfg, eng.params, eng.state, dev.tokens, prop, qlog, dev.bt,
            dev.ctx, dev.rem, self.allow, eng.gen, eos_token=E.eos_token,
            verifier=eng._verifier, **geo)
        self._finish(key, toks, emit, fin, tokens, ctx, rem, acc)

    def needs_capture(self, key) -> bool:
        return self.graphs and key not in self.captured

    def capture(self, key) -> None:
        """Capture the horizon for ``key`` (one-time, like JAX's compile):
        a warm-up pass, then the capture, both with ``allow`` zeroed (set
        here, outside the graph: ``run`` writes it before each replay).
        Ends with the device idle, so the warm-up's device time is the
        capture's, not the next horizon's. The engine's generators are
        registered with the graph and put back as they were (the passes'
        draws are not the run's). K4's host stride array and its
        conditional state clone (``kernels/ssm_scan.py``) are decided once
        per key here; that is sound because a key's shapes and addresses
        never change."""
        self._out(key)
        if key[2]:
            self._spec_buffers(key)
        self.allow.zero_()
        gens = self.eng.generators
        states = [g.get_state() for g in gens]
        graph = self._new_graph()
        for g in gens:
            graph.register_generator_state(g)
        self.captured[key] = capture(
            lambda: self._body(key), graph, warmup=self._warmup,
            capture_ctx=self._capture_ctx)
        for g, st in zip(gens, states):
            g.set_state(st)
        self._sync()

    # the CUDA side of a capture (the tests substitute stand-ins)
    def _new_graph(self):
        return torch.cuda.CUDAGraph()

    def _warmup(self, body) -> None:
        device = self.eng.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(device).wait_stream(side)

    def _capture_ctx(self, graph):
        return torch.cuda.graph(graph, pool=self.pool)

    def _sync(self) -> None:
        torch.cuda.synchronize(self.eng.device)

    def run(self, key, allow: np.ndarray) -> torch.Tensor:
        """Dispatch one horizon without waiting for it; returns the packed
        ``(toks, emit, fin[, acc])`` buffer of ``key`` (valid once the
        device has run the horizon, until the next dispatch of the same
        key). Timed as the engine's ``launch`` phase."""
        with self.eng._phase("launch_s", "dispatch", "launch"):
            self.allow.copy_(torch.from_numpy(np.asarray(allow, np.int32)),
                             non_blocking=True)
            if self.graphs:
                self.captured[key].replay()
            else:
                self._body(key)
        return self._out(key)

