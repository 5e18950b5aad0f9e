"""Decode engine: tick = schedule -> prefill -> fused decode horizon.

Port of the fused multi-step path of ``repro/serving/engine.py`` for
greedy serving of attention-only stacks and the zamba2 hybrid. The host
loop mirrors the paper's Fig. 2(c): each tick the host updates the
"configuration buffer" (block tables, context lengths) and dispatches
decode work; finished requests release their pages and their slots refill
from the queue.

* scheduling — ``core.scheduler.ContinuousBatcher`` (a framework-free copy)
  with a pluggable admission policy (``serving.policies``);
* prefill — ``serving.prefill``: slot, length-bucketed batched, or chunked
  DCS-style interleave with decode;
* decode — ``EngineConfig.decode_horizon`` decode steps per tick
  (``models.model.decode_multi``): decode, on-device greedy sampling, KV
  write-position advance and per-slot EOS/budget masking stay on the card.

The per-slot state (block table, context, current token, remaining budget)
lives on the device (``DeviceSlotState``), is advanced in place by the
horizon, and is patched only in the rows the scheduler marked dirty. The
tick is pipelined: the horizon is dispatched without blocking and collected
at the start of the next tick, in ONE readback of ``(toks, emit, fin)`` —
the only host<->device rendezvous of decode, counted in
``EngineTiming.device_syncs``.

Recurrent rows (hybrids): the Mamba2 carry of each slot lives in the
decode state as ``[L, n_slots, ...]`` rows. Admission resets a slot's rows
to zero; group prefill gathers the group's rows, runs, and scatters them
back; the decode horizon's ``run`` mask keeps idle, paused and
mid-chunk-prefill rows unchanged.

Not ported yet (ROADMAP queue A): speculative decode, the prefix cache and
host tier, telemetry, fault injection, serving snapshots, cluster roles,
stochastic sampling, the per-token ``step()`` API and preemption snapshots
of the recurrent carry (``state_resume``: a preempted hybrid request
recomputes, JAX's ``state_resume=False`` path). Their config fields keep
the port's defaults; setting another value raises.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, fields
from typing import Any

import numpy as np
import torch

from repro_torch.core.allocator import PageAllocator
from repro_torch.core.paged_kv import PoolSpec
from repro_torch.core.scheduler import ContinuousBatcher, Request
from repro_torch.kernels.backend import KernelConfig, resolve_device
from repro_torch.models import model as MDL
from repro_torch.serving.policies import make_policy
from repro_torch.serving.prefill import decode_table_bucket, make_prefiller
from repro_torch.serving.request import Request as RequestSpec
from repro_torch.serving.sampling import make_sampler, make_scan_sampler

# EngineConfig fields of features the port does not serve yet, with the
# only value it accepts (see the module docstring)
_UNPORTED = {"sampler": "greedy", "draft_config": None,
             "prefix_cache": False, "host_pages": 0, "telemetry": None,
             "faults": None, "snapshot_dir": None, "snapshot_every": 0,
             "role": "both", "state_resume": False}


@dataclass
class EngineConfig:
    n_slots: int
    page_size: int
    n_pages: int
    max_context: int
    n_shards: int = 1
    n_rows: int = 1
    policy: str = "striped"           # page placement: striped | row_affine
    static_alloc: bool = False        # baseline-PIM static max-ctx allocation
    eos_token: int = 1
    max_prefill: int = 64             # batched-prefill bucket cap
    prefill_mode: str = "batched"     # slot | batched | chunked
    prefill_chunk: int = 32           # tokens per chunk in chunked mode
    sched_policy: str = "fcfs"        # fcfs | sjf | memory_aware | edf | slo
    sampler: str = "greedy"           # stochastic kinds: ROADMAP C.2
    # fused multi-step decode: steps per tick, one host sync per horizon.
    # Greedy outputs are horizon-invariant; clamped to 1 while chunked
    # prefill is streaming.
    decode_horizon: int = 1
    # attention kernels (kernels/backend.py KernelConfig): None/True = the
    # hand-written kernels on a card (their plain versions on CPU tensors),
    # False = the plain reference paths
    use_kernels: bool | None = None
    kernel_splits: int = 1
    # pow2 bucketing of the decode block-table width by live-page count
    decode_bucket: bool = True
    # ---- features not ported yet: must keep these defaults ----
    draft_config: Any = None
    prefix_cache: bool = False
    host_pages: int = 0
    telemetry: Any = None
    faults: Any = None
    snapshot_dir: str | None = None
    snapshot_every: int = 0
    role: str = "both"
    # preemption snapshots of the recurrent carry (ROADMAP A.7); JAX's
    # default is True, the port recomputes (ROADMAP C.4)
    state_resume: bool = False

    def __post_init__(self):
        for f in fields(self):
            if f.name in _UNPORTED and \
                    getattr(self, f.name) != _UNPORTED[f.name]:
                raise NotImplementedError(
                    f"EngineConfig.{f.name}={getattr(self, f.name)!r}: "
                    "not ported to repro_torch yet (ROADMAP queue A)")


@dataclass
class EngineTiming:
    """Wall-clock split of the serving loop (host bookkeeping vs device)."""
    steps: int = 0
    host_s: float = 0.0               # schedule + config-buffer assembly
    prefill_s: float = 0.0
    decode_s: float = 0.0             # decode dispatch + horizon readback
    device_syncs: int = 0             # host<->device decode rendezvous
    decode_tokens: int = 0            # tokens emitted by decode dispatches
    decode_steps: int = 0             # decode steps dispatched (sum of K)
    prefill_calls: int = 0            # model prefill / prefill_chunk calls

    def as_dict(self) -> dict:
        n = max(1, self.steps)
        return {"steps": self.steps, "host_us_per_step": 1e6 * self.host_s / n,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "host_s": self.host_s, "device_syncs": self.device_syncs,
                "decode_tokens": self.decode_tokens,
                "decode_steps": self.decode_steps,
                "prefill_calls": self.prefill_calls,
                "syncs_per_token": self.device_syncs
                / max(1, self.decode_tokens)}


class DeviceSlotState:
    """Device-resident per-slot decode state for the fused multi-step path:
    block table [n_slots, W], context lengths, current tokens and remaining
    budgets, all int32 on the engine's device. The horizon advances them in
    place; the host only patches the rows the scheduler marked dirty
    (admission / page growth / free)."""

    def __init__(self, n_slots: int, width: int, device):
        self.bt = torch.full((n_slots, width), -1, dtype=torch.int32,
                             device=device)
        self.ctx = torch.zeros((n_slots,), dtype=torch.int32, device=device)
        self.tokens = torch.zeros_like(self.ctx)
        self.rem = torch.zeros_like(self.ctx)

    def patch(self, slots: list[int], bt_rows, ctx_v, tok_v, rem_v) -> None:
        dev = self.bt.device
        idx = torch.as_tensor(np.asarray(slots, np.int64)).to(
            dev, non_blocking=True)
        for dst, src in ((self.bt, bt_rows), (self.ctx, ctx_v),
                         (self.tokens, tok_v), (self.rem, rem_v)):
            rows = torch.as_tensor(np.asarray(src, np.int32))
            dst.index_copy_(0, idx, rows.to(dev, non_blocking=True))


class DecodeEngine:
    def __init__(self, cfg, ecfg: EngineConfig, params=None, rt=None, *,
                 policy=None, device=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = resolve_device(device)
        if rt is None:
            rt = MDL.Runtime(kernels=KernelConfig(
                use_kernels=ecfg.use_kernels, n_splits=ecfg.kernel_splits))
        self.rt = rt
        if params is None:
            params = MDL.init_params(cfg, 0, torch.float32, self.device)
        elif params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        maxp = -(-ecfg.max_context // ecfg.page_size) + 1
        n_attn = sum(k in ("attn", "local") for k in cfg.block_kinds())
        self.pool_spec = PoolSpec(
            max(n_attn, 1), ecfg.n_pages, ecfg.page_size, cfg.n_kv_heads,
            cfg.d_head, maxp, dtype="float32")
        static_pages = maxp if ecfg.static_alloc else None
        self.alloc = PageAllocator(
            ecfg.n_pages, ecfg.n_shards, ecfg.page_size, policy=ecfg.policy,
            n_rows=ecfg.n_rows, static_max_pages=static_pages)
        self.clock = time.perf_counter
        self.batcher = ContinuousBatcher(
            self.alloc, ecfg.n_slots, max_context=ecfg.max_context,
            n_rows=ecfg.n_rows, policy=make_policy(policy or ecfg.sched_policy),
            bt_width=maxp)
        self.state = MDL.init_decode_state(cfg, self.pool_spec, ecfg.n_slots,
                                           device=self.device)
        # recurrent per-slot rows ([L, n_slots, ...] leaves of self.state)
        self.has_rstate = bool(MDL.rstate_entries(self.state))
        self._zero_rows = (MDL.init_rstate(cfg, 1, device=self.device)
                           if self.has_rstate else None)
        self.tokens = np.zeros((ecfg.n_slots,), np.int32)
        self.prompts: dict[int, np.ndarray] = {}
        self.outputs: dict[int, list[int]] = {}
        # TTFT bookkeeping: wall-clock of submit and of the first token
        self.submit_t: dict[int, float] = {}
        self.first_tok_t: dict[int, float] = {}
        self.sampler = make_sampler(ecfg.sampler)
        self._scan_sample = make_scan_sampler(ecfg.sampler)
        self.prefiller = make_prefiller(ecfg.prefill_mode, self)
        self.timing = EngineTiming()
        self.dev = DeviceSlotState(ecfg.n_slots, maxp, self.device)
        # in-flight horizon: (packed device readback, K, [(slot, req)]),
        # collected at the next tick's sync point
        self._inflight: tuple | None = None
        # finished mask of a horizon collected outside the tick loop
        self._pending_fin: np.ndarray | None = None

    def _tensor(self, a) -> torch.Tensor:
        """Host numpy -> a tensor on the engine's device. The copy does not
        wait for the device (``non_blocking``): pageable host memory is
        staged by the driver before the call returns."""
        return torch.as_tensor(np.asarray(a)).to(self.device,
                                                  non_blocking=True)

    @contextmanager
    def _phase(self, acc: str):
        """Accumulate one timed segment into ``EngineTiming.<acc>``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            setattr(self.timing, acc,
                    getattr(self.timing, acc) + time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def submit(self, spec: RequestSpec) -> bool:
        """Enqueue a request described by a ``serving.Request`` spec."""
        req_id = spec.req_id
        prompt = np.asarray(spec.prompt, np.int32)
        self.prompts[req_id] = prompt
        self.outputs[req_id] = []
        now = self.submit_t[req_id] = self.clock()
        sreq = Request(req_id, len(prompt), spec.max_new_tokens,
                       priority=spec.priority, submit_t=now, spec=spec)
        if self.prefiller.name == "chunked":
            sreq.chunked_prefill = True
            sreq.prefill_done = False
        self.batcher.submit(sreq)
        return True

    # ---- helpers shared with the prefillers ---------------------------
    def _prompt_seq(self, req) -> tuple[np.ndarray, bool]:
        """Token sequence to prefill and whether a first token should be
        emitted. After a preemption the re-prefill covers the original
        prompt plus every generated token except the last sampled one
        (whose KV was never written; it re-enters as the next decode
        input)."""
        prompt = self.prompts[req.req_id]
        out = self.outputs[req.req_id]
        if req.prompt_len == len(prompt):
            return prompt, not out
        return np.concatenate(
            [prompt, np.asarray(out[:-1], np.int32)])[:req.prompt_len], False

    def _emit_first(self, slot: int, req, tok: int | None,
                    emit: bool) -> None:
        req.kv_written = True
        if emit:
            self.tokens[slot] = tok
            self.outputs[req.req_id].append(int(tok))
            self.first_tok_t.setdefault(req.req_id, self.clock())
        else:
            self.tokens[slot] = self.outputs[req.req_id][-1]
        self.batcher.dirty.add(slot)

    # ---- recurrent rows: reset at admission, group gather / scatter ----
    def _begin_prefill_group(self, admitted) -> None:
        """Reset the admitted slots' recurrent rows to zero in ONE scatter
        (a row may still hold a freed request's carry), so group prefill
        gathers a clean carry."""
        if not (self.has_rstate and admitted):
            return
        slots = [slot for slot, _ in admitted]
        MDL.scatter_rstate(self.state, slots, MDL.tree_map(
            lambda z: z.expand(z.shape[0], len(slots), *z.shape[2:]),
            self._zero_rows))

    def _group_prefill_state(self, slots: list[int]) -> dict:
        """State for a group prefill call: the shared pool plus the group's
        recurrent rows gathered from the engine state (zeroed by
        ``_begin_prefill_group``, or mid-stream carries for chunked
        prefill)."""
        gs: dict[str, Any] = {}
        if "pool" in self.state:
            gs["pool"] = self.state["pool"]
        if self.has_rstate:
            gs.update(MDL.gather_rstate(self.state, slots))
        return gs

    def _merge_group_state(self, slots: list[int], gstate: dict) -> None:
        """Fold a group prefill's result back: the pool was written in
        place; scatter the group's recurrent rows into their slots."""
        if self.has_rstate:
            MDL.scatter_rstate(self.state, slots, MDL.rstate_entries(gstate))

    def _first_tokens(self, logits, emits) -> np.ndarray:
        """Sample the first token for a prefill group in ONE batched call
        (only rows that emit are sampled)."""
        toks = np.zeros((len(emits),), np.int32)
        idx = [i for i, e in enumerate(emits) if e]
        if idx:
            toks[idx] = self.sampler(logits[idx])
        return toks

    # ---- fused multi-step path ---------------------------------------
    def _sync_device_slots(self) -> None:
        """Mirror the scheduler's dirty rows into the device-resident slot
        state — the incremental config-buffer update (continuing slots were
        already advanced on the device by the previous horizon)."""
        dirty = self.batcher.take_dirty()
        if not dirty:
            return
        W = self.pool_spec.max_pages_per_req
        rows = np.ascontiguousarray(self.batcher.block_tables(W)[dirty])
        ctx_v = self.batcher.context_lens()[dirty]
        tok_v = self.tokens[dirty]
        rem_v = np.zeros((len(dirty),), np.int32)
        for i, s in enumerate(dirty):
            req = self.batcher.slots[s]
            if req is not None and req.prefill_done:
                rem_v[i] = max(0, req.max_new_tokens - req.generated + 1)
        self.dev.patch(dirty, rows, ctx_v, tok_v, rem_v)

    def _collect_horizon(self):
        """Sync point: ONE readback of the in-flight horizon's packed
        ``(toks, emit, fin)`` and fold the emissions into the outputs and
        request bookkeeping."""
        if self._inflight is None:
            return None
        packed, K, pairs = self._inflight
        self._inflight = None
        n = self.ecfg.n_slots
        with self._phase("decode_s"):
            host = packed.cpu().numpy()
        self.timing.device_syncs += 1
        toks = host[:K * n].reshape(K, n)
        emit = host[K * n:2 * K * n].reshape(K, n).astype(bool)
        fin = host[2 * K * n:].astype(bool)
        tnow = self.clock()
        finished = np.zeros((n,), bool)
        for slot, req in pairs:
            ts = toks[emit[:, slot], slot]
            if not len(ts):            # pool-starved to zero steps
                continue
            self.outputs[req.req_id].extend(int(t) for t in ts)
            self.first_tok_t.setdefault(req.req_id, tnow)
            # the tick's scheduler step already reserved one token; the rest
            # of the horizon's emissions land here
            req.generated += len(ts) - 1
            self.tokens[slot] = int(ts[-1])
            finished[slot] = bool(fin[slot])
            self.timing.decode_tokens += int(len(ts))
        return finished

    def _step_fused(self) -> None:
        """One pipelined tick: collect the previous horizon, schedule and
        prefill, then dispatch the next horizon WITHOUT blocking on it."""
        E = self.ecfg
        finished = self._collect_horizon()
        if finished is None:
            finished, self._pending_fin = self._pending_fin, None

        with self._phase("host_s"):
            admitted, active = self.batcher.step(finished)
        if admitted or self.prefiller.busy:
            with self._phase("prefill_s"):
                active = self.prefiller.run(admitted, active)
        self.timing.steps += 1
        if not active:
            return

        with self._phase("host_s"):
            K = max(1, E.decode_horizon)
            cap = self.prefiller.max_horizon
            if cap is not None:
                K = min(K, cap)
            allow = self.batcher.reserve_horizon(active, K)
            self._sync_device_slots()
            W = self.pool_spec.max_pages_per_req
            width = W
            if E.decode_bucket and W > 16:
                width = decode_table_bucket(self.batcher.max_live_pages(), W)

        with self._phase("decode_s"):
            toks, emit, fin, self.state, self.dev.tokens, self.dev.ctx, \
                self.dev.rem = MDL.decode_multi(
                    self.cfg, self.params, self.state, self.dev.tokens,
                    self.dev.bt, self.dev.ctx, self.dev.rem,
                    self._tensor(np.asarray(allow, np.int32)),
                    horizon=int(K), table_width=int(width),
                    page_size=E.page_size, n_pages=E.n_pages,
                    eos_token=E.eos_token, sample=self._scan_sample,
                    rt=self.rt)
            self.timing.decode_steps += int(K)
            packed = torch.cat([toks.reshape(-1).to(torch.int32),
                                emit.reshape(-1).to(torch.int32),
                                fin.to(torch.int32)])
            self._inflight = (packed, int(K),
                              [(s, self.batcher.slots[s]) for s in active])

    def tick(self) -> None:
        """One pipelined fused tick (public driver API)."""
        self._step_fused()

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        for _ in range(max_steps):
            if self._inflight is None and self.batcher.done():
                break
            self.tick()
        if self._inflight is not None:   # max_steps hit mid-horizon
            self._pending_fin = self._collect_horizon()
        return self.outputs
