"""Driving ``repro_torch.serving.DecodeEngine`` through set-up and the
measured window, from outside it: ``submit`` / ``adopt_request``, then
``tick``. The benchmark stamps each request itself on the host clock
after the tick that brought its tokens back.

Set-up takes each part of the mix (``harness.traffic``) in turn:

* ``adopted``: each row's context K/V is made on the card and handed over
  with ``adopt_request`` (a few rows a tick, so the hand-over buffers stay
  small), and the rows decode;
* ``closed``: every client's first request is submitted and prefilled;
* ``open``: a warm-up burst of one request a slot from the open part's
  sizes, prefilled and decoded for two tokens, then dropped.

Then every decode table width the window can reach is captured as the
engine would capture it at first use (``HorizonRunner.capture``), and the
engine ticks for ``WARM_S`` seconds. The window opens and closes on an
idle card: the in-flight horizon is collected first (``quiesce``).
"""
from __future__ import annotations

import time

import torch

from harness import trace as T
from harness.traffic import Traffic
from harness.weights import context_kv
from harness.window import Track, Window

WARM_S = 2.0        # ticks after the captures, before the window opens

def _sync(eng) -> None:
    eng.quiesce()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


class Driver:
    def __init__(self, eng, traffic: Traffic, cell: dict, config: dict,
                 seconds: float):
        self.eng = eng
        self.seconds = float(seconds)
        self.accepting = True            # a closed loop's clients send on
        self.traffic = traffic
        self.cell = cell
        self.config = config
        self.tracks: dict[int, Track] = {}
        self.live: dict[int, Track] = {}
        self.clients: set[int] = set()   # a closed loop's live requests
        self.pending: list = []          # open loop: requests not yet due
        self.t_open = 0.0

    # ---- requests in and tokens out -----------------------------------
    def _submit(self, req, due: float | None = None) -> None:
        from repro_torch.serving import Request
        tr = Track(req.rid, len(req.prompt), req.max_new, due_t=due)
        self.tracks[req.rid] = self.live[req.rid] = tr
        if req.part == "closed":
            self.clients.add(req.rid)
        self.eng.submit(Request(req.rid, req.prompt, req.max_new))

    def _adopt(self, req, now: float) -> None:
        P = len(req.prompt)
        kv = context_kv(self.config, self.traffic.seed, req.rid, P,
                        self.eng.ecfg.page_size, self.eng.device)
        ent = {"prompt_len": P, "max_new": req.max_new, "state": "warm",
               "depth": P}
        self.eng.adopt_request(req.rid, ent, req.prompt, [req.first_token],
                               kv=kv)
        self.tracks[req.rid] = self.live[req.rid] = Track(
            req.rid, P, req.max_new, adopted=True, first_t=now, last_t=now,
            n=1)

    def _stamp(self, now: float) -> None:
        outs = self.eng.outputs
        for rid, tr in list(self.live.items()):
            n = len(outs[rid])
            if n > tr.n:
                if tr.first_t is None:
                    tr.first_t = now
                    tr.first_in_window = now >= self.t_open > 0
                tr.last_t = now
                tr.n = n
            if tr.done or rid in self.eng.aborted:
                del self.live[rid]
                if rid in self.clients:
                    self.clients.discard(rid)
                    if self.accepting:
                        self._submit(self.traffic.request("closed"))

    def _tick(self) -> None:
        with T.span("tick"):
            self.eng.tick()
        self._stamp(time.perf_counter())

    def _idle(self) -> bool:
        return self.eng._inflight is None and self.eng.batcher.done()

    # ---- set-up ----------------------------------------------------------
    def setup(self) -> None:
        """Bring the engine to the window's opening; ``self.phases`` holds
        the seconds each part took."""
        now = time.perf_counter
        parts = self.traffic.parts
        t0 = now()
        if "adopted" in parts:
            group = int(self.cell.get("adopt_group", 2))
            reqs = self.traffic.adopted()
            for i in range(0, len(reqs), group):
                for r in reqs[i:i + group]:
                    self._adopt(r, now())
                self._tick()
        if "closed" in parts:
            for r in self.traffic.first_wave():
                self._submit(r)
        while self.eng.batcher.queue:
            self._tick()
        if "open" in parts:
            warm = self.traffic.warm_burst(self.eng.ecfg.n_slots, 2)
            for r in warm:
                self._submit(r)
            while any(r.rid in self.live for r in warm):
                self._tick()
            for r in warm:
                del self.tracks[r.rid]
        t1 = now()
        self.capture_widths()
        t2 = now()
        end = now() + WARM_S
        while now() < end and not self._idle():
            self._tick()
        if "open" in parts:
            self.pending = self.traffic.arrivals(self.seconds)
        self.phases = {"requests": t1 - t0, "captures": t2 - t1,
                       "warm": now() - t2}

    def capture_widths(self) -> None:
        """Capture every (table width, horizon) the window can dispatch:
        from the widest table the live rows need now up to the full
        width."""
        eng = self.eng
        _sync(eng)
        self._stamp(time.perf_counter())
        E = eng.ecfg
        W = eng.pool_spec.max_pages_per_req
        widths = {W}
        if E.decode_bucket and W > 16:
            from repro_torch.serving.prefill import decode_table_bucket
            lo = max(1, eng.batcher.max_live_pages())
            widths = {decode_table_bucket(p, W) for p in range(lo, W + 1)}
        K = max(1, E.decode_horizon)
        for w in sorted(widths):
            key = (int(w), K, False)
            if eng.horizons.needs_capture(key):
                eng.horizons.capture(key)

    # ---- the window --------------------------------------------------------
    def window(self, seconds: float, *, prof=None) -> Window:
        """Run the window, under the profiler where one is given, and close
        it on an idle card."""
        eng = self.eng
        _sync(eng)
        self._stamp(time.perf_counter())
        timing0 = eng.timing.as_dict()
        for tr in self.tracks.values():
            tr.n_open = tr.n
        if prof is not None:
            prof.__enter__()
        self.t_open = t0 = time.perf_counter()
        end = t0 + seconds
        pending = list(self.pending)
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            while pending and t0 + pending[0].arrival <= now:
                r = pending.pop(0)
                self._submit(r, due=t0 + r.arrival)
            if self._idle():
                nxt = t0 + pending[0].arrival if pending else end
                with T.span("wait"):
                    time.sleep(max(0.0, min(nxt, end) - now))
                continue
            self._tick()
        self.accepting = False
        return self._close(t0, timing0, pending, prof)

    def _close(self, t0: float, timing0: dict, pending: list, prof
               ) -> Window:
        """Collect the in-flight horizon, stop the profiler, and freeze a
        window from ``t0`` to now: each track's token count at this close,
        and the requests due by now but never sent."""
        eng = self.eng
        with T.span("close"):
            _sync(eng)
        t1 = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        self._stamp(t1)
        tracks = list(self.tracks.values())
        for tr in tracks:
            tr.n_close = tr.n
        for r in pending:              # due before the close, never sent
            if t0 + r.arrival < t1:
                tracks.append(Track(r.rid, len(r.prompt), r.max_new,
                                    due_t=t0 + r.arrival))
        return Window(t1 - t0, t0, t1, self.config,
                      tracks=tracks, timing0=timing0,
                      timing1=eng.timing.as_dict())
