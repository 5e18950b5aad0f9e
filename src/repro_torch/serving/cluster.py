"""Disaggregated serving: a router over a prefill/decode engine pool.

The port of ``repro/serving/cluster.py``. Prefill-role engines run each
request through prefill to its first token(s); the finished prefill's KV
pages and recurrent carry then move to a decode-role engine as a
versioned, checksummed handoff blob (``kvcache/handoff.py``, built on the
engine's snapshot-entry frame), and the decode engine finishes the
request. Greedy outputs are token-identical to one colocated engine: the
handoff carries the exact quiescent frame the serving snapshots already
round-trip.

On a card every engine of the pool, and any engine rebuilt after a death,
shares one device and ONE params dict (full-width llama3.2-1b in fp32 is
~4.9 GB: it is never copied per engine); each engine has its own pool,
slot state and CUDA graphs. An adopted request's pages and carry are
written into the running decode engine's pool and rows in place at its
admission (the preemption-snapshot restore), so its captured graphs stay
valid. A dead engine's graphs, pools and copy stream are released at the
tick boundary it dies on (``DecodeEngine.release``), before a replacement
is built.

The *router* owns the robustness policy:

* **crash-safe handoff**: a transfer is validated end to end before
  anything is applied; torn or corrupted blobs raise and are re-driven
  from the pristine in-router copy, with bounded retries and capped
  exponential backoff, then a cold re-prefill on the destination
  (token-identical either way);
* **per-handoff timeouts**: a handoff whose destination never becomes
  deliverable (engine death) times out and is re-dispatched to another
  healthy decode engine;
* **health-checked engines**: the seeded ``engine_death`` fault kind
  (``runtime/faults.py``) kills pool members at tick boundaries. A dead
  engine's in-flight requests are re-routed by the cold re-prefill path or,
  when the engine kept serving snapshots, restored warm from its last
  snapshot into a replacement engine; token-identical either way;
* **backpressure**: when the decode pool is saturated the router sheds at
  submit (terminal, reason ``shed``) instead of queueing silently;
* **sticky degradation**: when a role has no healthy member left the
  cluster collapses to colocated mode (``runtime/elastic.py``'s
  ``plan_role_collapse``); the rung never un-collapses mid-run.

As in ``repro`` (ROADMAP C.5, copied, not fixed): SLO targets restart after
a handoff (``adopt_request`` stamps a fresh submit time) and the role
collapse is sticky.

Within one ``tick()`` the order is: fault clock and health / recovery, role
collapse, routing, engine ticks, output streaming, prefill extraction,
handoff delivery. Everything the router decides is a pure function of the
seeded fault plan and the submission order, so chaos runs replay exactly.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.kvcache import handoff as HO
from repro_torch.models import model as MDL
from repro_torch.runtime.elastic import plan_role_collapse
from repro_torch.runtime.faults import make_faults
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.policies import route_least_loaded
from repro_torch.serving.request import Request as RequestSpec
from repro_torch.telemetry import TelemetryConfig, make_telemetry


@dataclass
class ClusterConfig:
    """Fleet shape and router robustness policy. Tick-denominated windows
    (backoff, timeout, transfer) keep every decision replayable: the
    router never reads the wall clock."""
    n_prefill: int = 1
    n_decode: int = 1
    colocated: bool = False           # every engine serves both roles
    # ---- handoff state machine ----
    handoff_retries: int = 3          # transmissions before cold re-drive
    handoff_backoff: int = 1          # first retry delay (ticks), doubles
    handoff_backoff_cap: int = 8      # ... up to this cap
    handoff_timeout: int = 8          # ticks waiting on an undeliverable dst
    transfer_ticks: int = 0           # modeled transfer latency
    # ---- router backpressure ----
    # decode-pool saturation bound: submit() sheds once outstanding work
    # (live + queued + in-handoff requests) reaches this; 0 = unbounded
    max_backlog: int = 0
    # per-engine admission-queue depth the router fills to (None = n_slots)
    route_queue_depth: int | None = None
    # ---- engine-death recovery ----
    # when set, every engine snapshots under <snapshot_dir>/e<ix> every
    # snapshot_every ticks and a dead engine is rebuilt warm from its last
    # snapshot; without it death recovery is the cold re-drive path
    snapshot_dir: str | None = None
    snapshot_every: int = 0
    # ---- the router's own fault injection (engine_death, handoff_torn,
    # handoff_corrupt) and telemetry (cluster_* counters) ----
    faults: Any = None
    telemetry: Any = None


@dataclass
class EngineHandle:
    ix: int
    role: str                         # "prefill" | "decode" | "both"
    eng: DecodeEngine
    alive: bool = True


@dataclass
class _PendingHandoff:
    """Router-side state of one in-flight handoff."""
    hid: int
    rid: int
    handoff: HO.Handoff               # pristine in-router copy
    dst_ix: int
    attempts: int = 0
    ready: int = 0                    # deliverable from this tick
    deadline: int = 0                 # dst-undeliverable timeout
    next_try: int = 0                 # backoff gate after a bad transfer


@dataclass
class TransferStats:
    """Host-side cost of the handoffs (wall clock; not a router decision):
    seconds in ``extract_request`` (quiesce, page gather and device-to-host
    copy), ``encode``, ``decode`` and the apply on the destination
    (numpy to tensors, ``adopt_request``; the pages reach the pool at the
    decode engine's next admission, inside its prefill), and the bytes of
    the blobs that were applied."""
    extract_s: float = 0.0
    encode_s: float = 0.0
    decode_s: float = 0.0
    apply_s: float = 0.0
    applied_bytes: int = 0


class EngineCluster:
    """Router and engine pool (see the module docstring). Drive it with
    ``submit`` and ``run`` / ``tick`` as a single engine."""

    def __init__(self, cfg, ecfg, ccfg: ClusterConfig, params=None, *,
                 device=None, draft_params=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.ccfg = ccfg
        self.device = resolve_device(device)
        if params is None:
            params = MDL.init_params(cfg, 0, torch.float32, self.device)
        self.params = params
        self.draft_params = draft_params
        self.faults = make_faults(ccfg.faults)
        if ccfg.colocated:
            roles = ["both"] * max(1, ccfg.n_prefill + ccfg.n_decode)
        else:
            if ccfg.n_prefill < 1 or ccfg.n_decode < 1:
                raise ValueError("disaggregated cluster needs >= 1 prefill "
                                 "and >= 1 decode engine")
            roles = (["prefill"] * ccfg.n_prefill
                     + ["decode"] * ccfg.n_decode)
        # every engine this cluster built, rebuilt ones included, in build
        # order: a dead engine's counters stay readable here
        self.engines: list[DecodeEngine] = []
        self.handles = [EngineHandle(ix, role, self._build_engine(ix, role))
                        for ix, role in enumerate(roles)]
        # rid -> {prompt, max_new, spec, state, engine}; state machine:
        # routed -> prefill -> handoff -> decode -> done      (disagg)
        # routed -> colocated -> done                          (both-role)
        # any    -> aborted                                    (terminal)
        self.reqs: dict[int, dict] = {}
        self.queue: deque[int] = deque()     # router backlog (rids)
        self.outputs: dict[int, list[int]] = {}
        self.aborted: dict[int, str] = {}
        self._pending: list[_PendingHandoff] = []
        self._tick = 0
        self._next_hid = 0
        # sticky cluster degradation bitmask: 1 = collapsed to colocated
        self.degraded_mode = 0
        self.counters: dict[str, int] = {
            "handoffs": 0,            # handoff objects created
            "handoff_ok": 0,          # applied on a decode engine
            "handoff_retries": 0,     # torn / corrupt transmissions retried
            "handoff_timeouts": 0,    # dst-undeliverable deadlines fired
            "handoff_redispatches": 0,  # moved to a different dst engine
            "handoff_redrives": 0,    # gave up on warm: cold re-prefill
            "engine_deaths": 0,
            "engine_restores": 0,     # dead engine rebuilt warm
            "redispatched_requests": 0,  # re-routed off a dead engine
            "role_collapses": 0,
            "shed": 0,
        }
        self.transfer = TransferStats()
        self.tel = make_telemetry(ccfg.telemetry)
        self._bind_metrics()

    # ------------------------------------------------------------------
    def _build_engine(self, ix: int, role: str) -> DecodeEngine:
        E = self.ecfg
        tel = E.telemetry
        if isinstance(tel, TelemetryConfig):
            # per-engine registries: each pool member builds its OWN
            # facade, namespaced by index, so engine metrics never collide
            tel = replace(tel, namespace=f"{tel.namespace}_e{ix}")
        sd = self.ccfg.snapshot_dir or E.snapshot_dir
        ecfg = replace(
            E, role=role, telemetry=tel,
            snapshot_dir=str(Path(sd) / f"e{ix}") if sd else None,
            snapshot_every=(self.ccfg.snapshot_every or E.snapshot_every))
        eng = DecodeEngine(self.cfg, ecfg, self.params, device=self.device,
                           draft_params=self.draft_params)
        self.engines.append(eng)
        return eng

    def _bind_metrics(self) -> None:
        r = self.tel.registry
        c = self.counters
        help_ = {
            "handoffs": "cross-engine KV handoffs created",
            "handoff_ok": "handoffs applied on a decode engine",
            "handoff_retries": "torn/corrupt handoff transmissions retried",
            "handoff_timeouts": "handoff destination timeouts fired",
            "handoff_redispatches": "handoffs moved to a new destination",
            "handoff_redrives": "handoffs degraded to cold re-prefill",
            "engine_deaths": "pool engines killed",
            "engine_restores": "dead engines rebuilt from snapshots",
            "redispatched_requests": "requests re-routed off dead engines",
            "role_collapses": "collapses to colocated mode",
            "shed": "submissions shed at the router (backpressure)",
        }
        for name, h in help_.items():
            r.bind(f"cluster_{name}_total", lambda n=name: c[n], h,
                   kind="counter")
        r.bind("cluster_engines_healthy",
               lambda: sum(1 for h in self.handles if h.alive),
               "pool engines currently alive")
        r.bind("cluster_router_queue_depth", lambda: len(self.queue),
               "requests waiting at the router")
        r.bind("cluster_pending_handoffs", lambda: len(self._pending),
               "handoffs in flight between engines")
        r.bind("cluster_degraded_mode", lambda: self.degraded_mode,
               "sticky cluster degradation bitmask (1=colocated collapse)")

    # ------------------------------------------------------------------
    # public API (a single engine's submit / tick / run surface)
    # ------------------------------------------------------------------
    def submit(self, req: RequestSpec) -> bool:
        """Route a request (a ``serving.Request`` spec) into the cluster.
        Returns False when the decode pool is saturated and the request was
        shed at the router instead (terminal at once, reason ``shed``,
        empty output). The spec rides the request record, so a re-route
        after an engine death re-submits with the same priority and
        targets."""
        req_id = req.req_id
        prompt = np.asarray(req.prompt, np.int32)
        self.outputs[req_id] = []
        rec = {"prompt": prompt, "max_new": req.max_new_tokens,
               "spec": req, "state": "routed", "engine": None}
        self.reqs[req_id] = rec
        if self.ccfg.max_backlog \
                and self._decode_load() >= self.ccfg.max_backlog:
            self.aborted[req_id] = "shed"
            self.counters["shed"] += 1
            rec["state"] = "aborted"
            return False
        self.queue.append(req_id)
        return True

    def tick(self) -> None:
        """One router tick (see the module docstring for the order)."""
        self._tick += 1
        self.faults.on_tick()
        self._health()
        self._route()
        for h in self.handles:
            if h.alive:
                h.eng.tick()
        self._stream()
        self._extract()
        self._deliver()

    def run(self, max_ticks: int = 10_000) -> dict[int, list[int]]:
        for _ in range(max_ticks):
            if self.done():
                break
            self.tick()
        return self.outputs

    def done(self) -> bool:
        if self.queue or self._pending:
            return False
        for h in self.handles:
            if h.alive and not (h.eng.batcher.done()
                                and h.eng._inflight is None):
                return False
        return all(rec["state"] in ("done", "aborted")
                   for rec in self.reqs.values())

    # ------------------------------------------------------------------
    # health: engine death and recovery, sticky role collapse
    # ------------------------------------------------------------------
    def _health(self) -> None:
        for h in self.handles:
            if h.alive and self.faults.fire("engine_death", key=h.ix):
                self._kill(h)
        healthy = {h.ix for h in self.handles if h.alive}
        if not healthy:
            # nothing left to serve on: every non-terminal request aborts
            for rid, rec in self.reqs.items():
                if rec["state"] not in ("done", "aborted"):
                    rec["state"] = "aborted"
                    rec["engine"] = None
                    self.aborted[rid] = "engine_death"
            self.queue.clear()
            self._pending.clear()
            return
        plan = plan_role_collapse({h.ix: h.role for h in self.handles},
                                  healthy)
        if plan:
            self.degraded_mode |= 1
            self.counters["role_collapses"] += 1
            for h in self.handles:
                if h.ix in plan:
                    h.role = plan[h.ix]

    def _owned_by(self, h: EngineHandle) -> list[int]:
        return [rid for rid, rec in self.reqs.items()
                if rec["engine"] is h
                and rec["state"] in ("prefill", "decode", "colocated")]

    def _kill(self, h: EngineHandle) -> None:
        """An engine died at the tick boundary: its uncollected horizon is
        lost (never streamed, so nothing the client saw disappears) and its
        device state is released at once. Try a warm rebuild from its last
        serving snapshot on the same device; whatever the snapshot does
        not cover is re-routed cold from the router's streamed-output
        frame. Deterministic greedy makes both paths token-identical."""
        h.alive = False
        self.counters["engine_deaths"] += 1
        owned = self._owned_by(h)
        restored: set[int] = set()
        h.eng.release()
        if h.eng.ecfg.snapshot_dir:
            eng2 = self._build_engine(h.ix, h.role)
            if eng2.restore_snapshot() is not None:
                # requests the cluster no longer routes here (handed off,
                # finished, re-routed) must not re-run on the rebuilt
                # engine: tear the stale restores down at the quiescent
                # start frame
                for rid in list(eng2.prompts):
                    if rid not in owned:
                        eng2._teardown(rid, "stale")
                h.eng = eng2
                h.alive = True
                self.counters["engine_restores"] += 1
                for rid in owned:
                    if rid in eng2.aborted:
                        continue
                    if eng2.outputs.get(rid) is None:
                        continue        # submitted after the snapshot
                    # rewind the stream cursor to the snapshot's frame;
                    # the resumed run regenerates the identical suffix
                    self.outputs[rid] = list(eng2.outputs[rid])
                    restored.add(rid)
            else:
                eng2.release()
        for rid in owned:
            if rid in restored:
                continue
            rec = self.reqs[rid]
            rec["engine"] = None
            if self._complete(rec, self.outputs[rid]):
                # the engine died after streaming the final token but
                # before retiring the slot: nothing left to regenerate
                rec["state"] = "done"
                continue
            rec["state"] = "routed"
            self.counters["redispatched_requests"] += 1
            self.queue.appendleft(rid)

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    @staticmethod
    def _engine_load(h: EngineHandle) -> int:
        return (sum(1 for r in h.eng.batcher.slots if r is not None)
                + len(h.eng.batcher.queue))

    def _decode_load(self) -> int:
        load = len(self.queue) + len(self._pending)
        for h in self.handles:
            if h.alive and h.role in ("decode", "both"):
                load += self._engine_load(h)
        return load

    def _pick(self, want: tuple[str, ...],
              bound: bool = False) -> EngineHandle | None:
        qd = self.ccfg.route_queue_depth or self.ecfg.n_slots
        loads = {h.ix: self._engine_load(h) for h in self.handles
                 if h.alive and h.role in want
                 and (not bound or len(h.eng.batcher.queue) < qd)}
        ix = route_least_loaded(loads)
        return None if ix is None else self.handles[ix]

    def _route(self) -> None:
        """Drain the router queue onto prefill-capable engines, least
        loaded first, bounded by the per-engine queue depth (requests the
        bound refuses wait HERE, visibly, not in an engine queue)."""
        while self.queue:
            h = self._pick(("prefill", "both"), bound=True)
            if h is None:
                return
            rid = self.queue.popleft()
            rec = self.reqs[rid]
            out = self.outputs[rid]
            if out and self._complete(rec, out):
                rec["state"] = "done"   # re-queued after its final token
                continue
            rec["engine"] = h
            rec["state"] = "colocated" if h.role == "both" else "prefill"
            if out:
                # re-drive of a partly run request (engine death or a
                # handoff given up): cold re-prefill of the streamed
                # context, drain_slot's arithmetic
                h.eng.adopt_request(rid, self._cold_entry(rec, out),
                                    rec["prompt"], out)
            else:
                h.eng.submit(rec["spec"])

    def _complete(self, rec: dict, out: list[int]) -> bool:
        """True when the streamed output is already the full response
        (budget spent or EOS sampled): re-driving such a request would
        fabricate tokens past what the clean run produces."""
        return bool(out) and (len(out) > rec["max_new"]
                              or out[-1] == self.ecfg.eos_token)

    @staticmethod
    def _cold_entry(rec: dict, out: list[int]) -> dict:
        g = max(0, len(out) - 1)        # last sample's KV never landed
        ent = {"prompt_len": len(rec["prompt"]) + g,
               "max_new": max(1, rec["max_new"] - g), "state": "cold"}
        if rec["spec"].priority:
            ent["priority"] = rec["spec"].priority
        return ent

    # ------------------------------------------------------------------
    # streaming and terminal detection
    # ------------------------------------------------------------------
    def _stream(self) -> None:
        for rid, rec in self.reqs.items():
            if rec["state"] not in ("prefill", "decode", "colocated"):
                continue
            h = rec["engine"]
            if h is None or not h.alive:
                continue
            eout = h.eng.outputs.get(rid)
            if eout is not None and len(eout) > len(self.outputs[rid]):
                self.outputs[rid] = list(eout)
            if rid in h.eng.aborted:
                reason = h.eng.aborted[rid]
                if reason != "handoff":       # a handoff teardown is
                    rec["state"] = "aborted"  # routing, not an outcome
                    self.aborted[rid] = reason
            elif h.eng._find_request(rid) == (None, None):
                rec["state"] = "done"

    # ------------------------------------------------------------------
    # prefill extraction -> handoff creation
    # ------------------------------------------------------------------
    def _extract(self) -> None:
        for rid, rec in self.reqs.items():
            if rec["state"] != "prefill":
                continue
            h = rec["engine"]
            if h is None or not h.alive:
                continue
            if h.role == "both":
                # collapsed mid-prefill: the survivor finishes it in place
                rec["state"] = "colocated"
                continue
            s, req = h.eng._find_request(rid)
            if req is None or s is None or not req.prefill_done \
                    or not h.eng.outputs.get(rid):
                continue
            t0 = time.perf_counter()
            res = h.eng.extract_request(rid)
            self.transfer.extract_s += time.perf_counter() - t0
            if res is None:
                continue                # finished during the quiesce
            ent, arrs = res
            self.outputs[rid] = [int(t) for t in np.asarray(arrs["out"])]
            dst = self._pick(("decode", "both"))
            if dst is None:
                # no decode-capable member (transient): re-drive cold
                rec["engine"] = None
                rec["state"] = "routed"
                self.counters["handoff_redrives"] += 1
                self.queue.appendleft(rid)
                continue
            hid = self._next_hid
            self._next_hid += 1
            t = self.ccfg.transfer_ticks
            self._pending.append(_PendingHandoff(
                hid, rid, HO.pack(rid, ent, arrs), dst.ix,
                ready=self._tick + t,
                deadline=self._tick + t + self.ccfg.handoff_timeout))
            self.counters["handoffs"] += 1
            rec["engine"] = None
            rec["state"] = "handoff"

    # ------------------------------------------------------------------
    # handoff delivery state machine
    # ------------------------------------------------------------------
    def _deliver(self) -> None:
        C = self.ccfg
        T = self.transfer
        still: list[_PendingHandoff] = []
        for ho in self._pending:
            rec = self.reqs[ho.rid]
            if rec["state"] != "handoff":
                continue                # went terminal at the router
            if self._tick < ho.ready:
                still.append(ho)
                continue
            dst = self.handles[ho.dst_ix]
            if not dst.alive:
                if self._tick < ho.deadline:
                    still.append(ho)    # waiting out the timeout window
                    continue
                self.counters["handoff_timeouts"] += 1
                nd = self._pick(("decode", "both"))
                if nd is None:
                    self._redrive_routed(ho, rec)
                    continue
                ho.dst_ix = nd.ix
                ho.ready = self._tick + C.transfer_ticks
                ho.deadline = ho.ready + C.handoff_timeout
                self.counters["handoff_redispatches"] += 1
                still.append(ho)
                continue
            if self._tick < ho.next_try:
                still.append(ho)        # backing off after a bad transfer
                continue
            t0 = time.perf_counter()
            blob = HO.encode(ho.handoff)
            T.encode_s += time.perf_counter() - t0
            if self.faults.fire("handoff_torn", key=ho.hid):
                blob = HO.tear(blob, self._tick + ho.hid)
            if self.faults.fire("handoff_corrupt", key=ho.hid):
                blob = HO.flip(blob, self._tick + ho.hid)
            t0 = time.perf_counter()
            try:
                got = HO.decode(blob)
            except HO.HandoffError:
                T.decode_s += time.perf_counter() - t0
                ho.attempts += 1
                self.counters["handoff_retries"] += 1
                if ho.attempts > C.handoff_retries:
                    # give up on the warm path: the pristine frame
                    # re-drives as a cold re-prefill on the destination
                    self.counters["handoff_redrives"] += 1
                    self._apply_cold(ho, dst, rec)
                    continue
                back = min(C.handoff_backoff_cap,
                           C.handoff_backoff << (ho.attempts - 1))
                ho.next_try = self._tick + max(1, back)
                ho.deadline = max(ho.deadline, ho.next_try
                                  + C.handoff_timeout)
                still.append(ho)
                continue
            T.decode_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            self._apply(got, dst, rec)
            T.apply_s += time.perf_counter() - t0
            T.applied_bytes += len(blob)
            self.counters["handoff_ok"] += 1
        self._pending = still

    def _apply(self, got: HO.Handoff, dst: EngineHandle, rec: dict) -> None:
        """Adopt a validated handoff warm: its pages become host tensors in
        the destination pool's dtype (they crossed the wire as numpy, bf16
        widened to f32) and its carry is rebuilt against the destination's
        row structure; both are written in place at admission."""
        eng = dst.eng
        nested = HO.nested_arrays(got)
        kv = None
        if "kv_k" in nested:
            dtype = eng.state["pool"]["k"].dtype
            kv = {name: torch.from_numpy(np.ascontiguousarray(
                nested[f"kv_{name}"])).to(dtype) for name in ("k", "v")}
        rows = (eng._rows_from_nested(nested["rows"])
                if "rows" in nested else None)
        eng.adopt_request(got.req_id, got.entry, nested["prompt"],
                          [int(t) for t in nested["out"]], kv=kv, rows=rows)
        rec["engine"] = dst
        rec["state"] = "decode"

    def _apply_cold(self, ho: _PendingHandoff, dst: EngineHandle,
                    rec: dict) -> None:
        """Adopt from the pristine in-router frame, but cold: drop the KV
        and carry and re-prefill the streamed context on the destination
        (the entry's requeue arithmetic already matches)."""
        ent = dict(ho.handoff.entry)
        ent["state"] = "cold"
        out = [int(t) for t in np.asarray(ho.handoff.arrays["out"])]
        dst.eng.adopt_request(ho.rid, ent, ho.handoff.arrays["prompt"], out)
        rec["engine"] = dst
        rec["state"] = "decode"

    def _redrive_routed(self, ho: _PendingHandoff, rec: dict) -> None:
        """No decode-capable destination at all: hand the request back to
        the router queue for a cold re-drive wherever routing lands it."""
        self.counters["handoff_redrives"] += 1
        rec["engine"] = None
        rec["state"] = "routed"
        self.queue.appendleft(ho.rid)

    # ------------------------------------------------------------------
    def stats_dict(self) -> dict:
        out = dict(self.counters)
        out["engines_healthy"] = sum(1 for h in self.handles if h.alive)
        out["degraded_mode"] = self.degraded_mode
        out["router_queue_depth"] = len(self.queue)
        out["pending_handoffs"] = len(self._pending)
        return out
