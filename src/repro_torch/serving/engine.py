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
  On a card the horizon is one CUDA graph per (table width, horizon),
  captured at first use and replayed (``serving.graphs``): JAX's one jit
  per ``(horizon, width)``.

The per-slot state (block table, context, current token, remaining budget)
lives on the device (``DeviceSlotState``), is advanced in place by the
horizon, and is patched only in the rows the scheduler marked dirty. The
tick is pipelined: the horizon is dispatched without blocking and collected
at the start of the next tick, in ONE readback of ``(toks, emit, fin)`` —
the only host<->device rendezvous of decode, counted in
``EngineTiming.device_syncs``.

KV reuse (``EngineConfig.prefix_cache``, ``host_pages``): the radix
prefix cache and its host tier (``repro_torch.kvcache``). Admission
borrows cached pages and prefill covers only the suffix beyond the hit
(``serving.prefill.prefill_suffix``); swap-ins and copy-on-write copies are
applied to the pool in place after the scheduler step and before prefill;
the tick's overlap window, while the previous horizon still runs, drains
last tick's swap-out copies, applies the occupancy watermarks and peeks
the queue's prefixes. The pool is never rebound: every captured horizon
holds its address.

Recurrent rows (hybrids): the Mamba2 carry of each slot lives in the
decode state as ``[L, n_slots, ...]`` rows. Admission resets a slot's rows
to zero, or restores them from a preemption snapshot
(``EngineConfig.state_resume``: the rows and the written KV pages are
copied to pinned host memory at preemption and back at re-admission, so
the request resumes instead of recomputing); group prefill gathers the
group's rows, runs, and scatters them back; the decode horizon's ``run``
mask keeps idle, paused and mid-chunk-prefill rows unchanged.

Sampling (``EngineConfig.sampler``): greedy, temperature or top-k, on
the device inside the horizon. JAX's key chains become generators on the
engine's device: the first-token sampler's (``sample_seed``), the
decode horizon's (``sample_seed``) and the draft's (``sample_seed + 1``).

Speculative decoding (``draft_config``, ``draft_params``,
``spec_horizon``): a small attention-only draft with its own paged pool,
indexed by the target's block tables (no second allocator), proposes up
to ``spec_horizon`` tokens a slot each tick and ONE multi-query target pass
verifies them (``models.model.draft_propose`` / ``decode_verify``); on a
card the round is one CUDA graph per (table width, K). Before each round
the draft catches up, eagerly, on the context it has not absorbed
(``_draft_catchup``: fresh admissions, resumes, cache hits, the one token
after a partly accepted round). Greedy output is token-identical to
target-only decoding; stochastic kinds use residual rejection sampling.

Not ported yet (ROADMAP queue A): telemetry, fault injection, serving
snapshots, cluster roles, the degradation ladder and the per-token
``step()`` API. Their config fields keep the port's defaults; setting
another value raises.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field, fields
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_config, validate_draft_pair
from repro_torch.core.allocator import PageAllocator
from repro_torch.core.paged_kv import PoolSpec, scatter_pages
from repro_torch.core.scheduler import ContinuousBatcher, Request
from repro_torch.kernels.backend import KernelConfig, resolve_device
from repro_torch.kvcache import (HostCopier, PrefixCache, WatermarkConfig,
                                 make_cache_policy)
from repro_torch.models import model as MDL
from repro_torch.serving.graphs import HorizonRunner
from repro_torch.serving.policies import make_policy
from repro_torch.serving.prefill import (_suffix_bucket,
                                         decode_table_bucket, make_prefiller)
from repro_torch.serving.request import Request as RequestSpec
from repro_torch.serving.sampling import (make_generator, make_sampler,
                                          make_scan_sampler, make_verifier)

# EngineConfig fields of features the port does not serve yet, with the
# only value it accepts (see the module docstring)
_UNPORTED = {"telemetry": None, "faults": None, "snapshot_dir": None,
             "snapshot_every": 0, "role": "both"}


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
    sampler: str = "greedy"           # greedy | temperature | top_k
    temperature: float = 1.0
    top_k: int = 0
    sample_seed: int = 0
    # fused multi-step decode: steps per tick, one host sync per horizon.
    # Greedy outputs are horizon-invariant; clamped to 1 while chunked
    # prefill is streaming.
    decode_horizon: int = 1
    # ---- speculative decoding (draft-propose, one-pass verify) ----
    # a small draft (registry name or ModelConfig; attention-only, sharing
    # the target's tokenizer: configs.base.validate_draft_pair) proposes up
    # to spec_horizon tokens a slot a tick, one multi-query target pass
    # verifies them; supersedes decode_horizon (K = spec_horizon + 1)
    draft_config: Any = None
    spec_horizon: int = 4
    # gentle horizon reservation: decline to evict radix-cached pages for
    # speculative (beyond-next-token) growth, shortening the horizon instead
    reserve_gentle: bool = False
    # ---- KV-cache hierarchy (repro_torch.kvcache) ----
    prefix_cache: bool = False        # radix prefix sharing across requests
    prefill_dedup: bool = True        # same-tick prefix dedup at admission
    host_pages: int = 0               # host offload tier capacity (0 = none)
    offload_high: float = 0.85        # device watermarks driving offload
    offload_low: float = 0.60
    cache_evict: str = "lru"
    # consecutive failed swap-ins (the pool could not take the payload)
    # absorbed by retry + capped exponential backoff (kvcache/cache.py)
    swap_retry_limit: int = 3
    swap_backoff_cap: int = 8
    # attention kernels (kernels/backend.py KernelConfig): None/True = the
    # hand-written kernels on a card (their plain versions on CPU tensors),
    # False = the plain reference paths
    use_kernels: bool | None = None
    kernel_splits: int = 1
    # pow2 bucketing of the decode block-table width by live-page count
    decode_bucket: bool = True
    # the decode horizon as CUDA graphs (serving/graphs.py): None = graphs
    # on a CUDA engine, False = eager dispatch (the counterpart of
    # jax.disable_jit(): the paired comparison, debugging); True on a CPU
    # engine raises
    decode_graphs: bool | None = None
    # ---- recurrent-state preemption snapshots ----
    # a preempted hybrid request's carry rows and written KV pages go to
    # pinned host memory, and re-admission restores them instead of
    # re-prefilling. Off = full recompute on resume. Slot-mode prefill
    # never consumes snapshots (it is the recompute reference path).
    state_resume: bool = True
    # ---- features not ported yet: must keep these defaults ----
    telemetry: Any = None
    faults: Any = None
    snapshot_dir: str | None = None
    snapshot_every: int = 0
    role: str = "both"

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
    capture_s: float = 0.0            # one-time graph captures (not decode)
    graph_captures: int = 0           # (width, horizon) graphs captured
    device_syncs: int = 0             # host<->device decode rendezvous
    decode_tokens: int = 0            # tokens emitted by decode dispatches
    decode_steps: int = 0             # decode steps dispatched (sum of K)
    prefill_calls: int = 0            # model prefill / prefill_chunk calls
    draft_catchups: int = 0           # the draft's catch-up prefill calls
    # speculative rounds dispatched, by K (K - 1 draft steps, one verify
    # pass over K query positions)
    spec_dispatches: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        n = max(1, self.steps)
        return {"steps": self.steps, "host_us_per_step": 1e6 * self.host_s / n,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "capture_s": self.capture_s,
                "graph_captures": self.graph_captures,
                "host_s": self.host_s, "device_syncs": self.device_syncs,
                "decode_tokens": self.decode_tokens,
                "decode_steps": self.decode_steps,
                "prefill_calls": self.prefill_calls,
                "draft_catchups": self.draft_catchups,
                "spec_dispatches": dict(self.spec_dispatches),
                "syncs_per_token": self.device_syncs
                / max(1, self.decode_tokens)}


class DeviceSlotState:
    """Device-resident per-slot decode state for the fused multi-step path:
    block table [n_slots, W], context lengths, current tokens and remaining
    budgets, all int32 on the engine's device. The horizon advances them in
    place; the host only patches the rows the scheduler marked dirty
    (admission / page growth / free). The tensors are never rebound: a
    captured horizon reads them at fixed addresses."""

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
                 policy=None, device=None, draft_params=None):
        self.cfg = cfg
        self.ecfg = ecfg
        # a draft that cannot pair with the target (another tokenizer, a
        # recurrent stack) fails here, before any params are allocated
        self.draft_cfg = None
        if ecfg.draft_config is not None:
            dcfg = ecfg.draft_config
            if isinstance(dcfg, str):
                dcfg = get_config(dcfg)
            validate_draft_pair(cfg, dcfg)
            self.draft_cfg = dcfg
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
        # preemption snapshots: req_id -> {len, rows, kv?}, host copies
        # started at preemption and drained in the next overlap window
        self.rsnaps: dict[int, dict] = {}
        self.rstate_snapshots = 0
        self.rstate_restores = 0
        self._snap_copy = HostCopier()
        self.batcher.rstate_hook = self._rstate_hook
        # prefix cache: uniform-attention stacks with plain lazy allocation
        # only (static reservations can't share pages, row-affine placement
        # would break borrowing across rows, and recurrent families can't
        # resume from shared pages without the matching dense carry: a
        # hybrid's prefix_cache=True serves without a cache, as in repro)
        self.cacheable = "layers" in self.params and cfg.family != "encdec"
        self.cache = None
        if ecfg.prefix_cache and self.cacheable and not ecfg.static_alloc \
                and ecfg.policy == "striped":
            self.cache = PrefixCache(
                self.alloc,
                policy=make_cache_policy(ecfg.cache_evict,
                                         watermark=WatermarkConfig(
                                             ecfg.offload_high,
                                             ecfg.offload_low)),
                host_pages=ecfg.host_pages,
                pool_ref=lambda: self.state["pool"],
                swap_retry_limit=ecfg.swap_retry_limit,
                swap_backoff_cap=ecfg.swap_backoff_cap)
            self.batcher.cache = self.cache
            self.batcher.cache_tokens = self._cache_tokens
            self.batcher.dedup = ecfg.prefill_dedup
        self.tokens = np.zeros((ecfg.n_slots,), np.int32)
        self.prompts: dict[int, np.ndarray] = {}
        self.outputs: dict[int, list[int]] = {}
        # TTFT bookkeeping: wall-clock of submit and of the first token
        self.submit_t: dict[int, float] = {}
        self.first_tok_t: dict[int, float] = {}
        sk = dict(temperature=ecfg.temperature, top_k=ecfg.top_k)
        self.sampler = make_sampler(ecfg.sampler, seed=ecfg.sample_seed,
                                    device=self.device, **sk)
        self._scan_sample = make_scan_sampler(ecfg.sampler, **sk)
        # the decode horizon's key chain (the verify pass's too)
        self.gen = make_generator(ecfg.sample_seed, self.device)
        self.need_q = ecfg.sampler != "greedy"
        # ---- speculative decoding: the draft's pool is indexed by the
        # TARGET's block tables (same page ids, the draft's layers and
        # heads), so draft KV at a page is a function of the token prefix
        # and radix-shared pages stay coherent across borrowers
        self.spec = self.draft_cfg is not None
        self.draft_params = self._dstate = self.dgen = None
        if self.spec:
            dcfg = self.draft_cfg
            self.draft_spec = PoolSpec(
                dcfg.n_layers, ecfg.n_pages, ecfg.page_size, dcfg.n_kv_heads,
                dcfg.d_head, maxp, dtype="float32")
            if draft_params is None:
                draft_params = MDL.init_params(dcfg, 1, torch.float32,
                                               self.device)
            elif draft_params["embed"].device.type != self.device.type:
                raise ValueError(f"draft params live on "
                                 f"{draft_params['embed'].device}, the "
                                 f"engine on {self.device}")
            self.draft_params = draft_params
            self._dstate = MDL.init_decode_state(dcfg, self.draft_spec,
                                                 ecfg.n_slots,
                                                 device=self.device)
            self.dgen = make_generator(ecfg.sample_seed + 1, self.device)
            self._verifier = make_verifier(ecfg.sampler, **sk)
            # req_id -> tokens the draft pool has absorbed (its KV covers
            # [0, dlen)); 0 at every (re)admission: swap-ins, copies on
            # write and snapshot restores rebuild only the target's pages
            self._dlen: dict[int, int] = {}
            self.spec_rounds = 0        # verify passes over running slots
            self.spec_proposed = 0      # draft tokens offered
            self.spec_accepted = 0      # draft tokens accepted
        # the generators a horizon draws from (registered with its graphs)
        self.generators = ([g for g in (self.gen, self.dgen) if g is not None]
                           if self.need_q else [])
        self.prefiller = make_prefiller(ecfg.prefill_mode, self)
        self.timing = EngineTiming()
        self.dev = DeviceSlotState(ecfg.n_slots, maxp, self.device)
        graphs = ecfg.decode_graphs
        if graphs is None:
            graphs = self.device.type == "cuda"
        elif graphs and self.device.type != "cuda":
            raise ValueError("EngineConfig.decode_graphs=True needs a CUDA "
                             f"engine; this one runs on {self.device}")
        self.horizons = HorizonRunner(self, graphs=bool(graphs))
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

    def _cache_tokens(self, req, finished: bool = False) -> np.ndarray:
        """Token-sequence oracle for the prefix cache (the batcher holds no
        token ids). ``finished=False``: the context a (re)admission must
        cover — exactly ``_prompt_seq``. ``finished=True``: every token
        whose KV was written — prompt plus all generated tokens except the
        final sample (EOS / budget hit), whose KV never landed."""
        if not finished:
            return self._prompt_seq(req)[0]
        prompt = self.prompts[req.req_id]
        out = np.asarray(self.outputs[req.req_id], np.int32)
        return np.concatenate([prompt, out])[:req.total_len - 1]

    def _emit_first(self, slot: int, req, tok: int | None,
                    emit: bool) -> None:
        # the whole prompt's KV is in the pool now: publish the prefix to
        # the radix cache so later same-prefix admissions hit while this
        # request is still running
        req.kv_written = True
        if self.cache is not None:
            self.cache.insert(req.req_id, self._prompt_seq(req)[0])
        if emit:
            self.tokens[slot] = tok
            self.outputs[req.req_id].append(int(tok))
            self.first_tok_t.setdefault(req.req_id, self.clock())
        else:
            self.tokens[slot] = self.outputs[req.req_id][-1]
        self.batcher.dirty.add(slot)

    # ---- recurrent rows: snapshots, restore, group gather / scatter ----
    def _rstate_hook(self, req, slot: int, finished: bool) -> None:
        """Scheduler callback at page release. Preemption (finished=False)
        snapshots the slot's recurrent rows plus its written KV pages to
        host memory — the dense-state analogue of the kvcache swap-out — so
        re-admission restores instead of recomputing. Completion drops any
        stored snapshot."""
        if finished:
            self.rsnaps.pop(req.req_id, None)
            return
        if not (self.has_rstate and self.ecfg.state_resume
                and req.kv_written and self.prefiller.name != "slot"):
            return
        if not self.outputs.get(req.req_id):
            # no token ever sampled (prefill finished but the finish-line
            # growth page failed): a pure restore could never produce the
            # first token, so resume must recompute
            return
        # written context: the last sampled token's KV/state never landed
        # (it re-enters as the next decode input), and ``generated`` was
        # pre-incremented this tick
        depth = req.total_len - (1 if req.generated else 0)
        if depth <= 0:
            return
        # the gathers are enqueued here, on the compute stream, so they
        # read the rows and pages before anything rewrites them (the
        # released pages may be handed out this very tick); their copies
        # to pinned host memory run on the side stream and are waited for
        # in the next tick's overlap window (_drain_snapshots)
        snap = {"len": depth, "rows": self._snap_copy.to_host(
            MDL.gather_rstate(self.state, [slot]))}
        if "pool" in self.state:
            n = -(-depth // self.ecfg.page_size)
            pages = np.asarray(self.batcher.block_table_row(slot)[:n])
            snap["kv"] = self._snap_copy.pages_to_host(self.state["pool"],
                                                       pages)
        self.rsnaps[req.req_id] = snap
        self.rstate_snapshots += 1

    def _drain_snapshots(self) -> None:
        """The drain half of the snapshot ping-pong: wait for last tick's
        snapshot copies and drop their device gathers. A restore that
        comes first orders itself after the copy (``HostCopier``)."""
        self._snap_copy.drain()

    def _take_snapshot(self, req) -> dict | None:
        if not self.ecfg.state_resume:
            return None
        return self.rsnaps.pop(req.req_id, None)

    def _begin_prefill_group(self, admitted) -> tuple[dict, set]:
        """Prepare the tick's admitted slots for prefill in ONE rows
        scatter: preemption snapshots restore the carry (and their KV
        pages, in place) at their depth, everything else resets to zero so
        group prefill gathers a clean carry (the row may hold a freed
        request's state). Returns ``({slot: resume_depth}, {restored
        slots})`` — depth is the snapshot depth or the prefix-cache depth
        (0 when cold)."""
        starts: dict[int, int] = {}
        fresh: list[int] = []
        restores: list[tuple[int, dict]] = []
        for slot, req in admitted:
            snap = self._take_snapshot(req)
            if snap is not None:
                restores.append((slot, snap))
                starts[slot] = snap["len"]
            else:
                fresh.append(slot)
                starts[slot] = req.cached_len
        if self.has_rstate and (fresh or restores):
            parts = []
            if fresh:
                parts.append(MDL.tree_map(
                    lambda z: z.expand(z.shape[0], len(fresh), *z.shape[2:]),
                    self._zero_rows))
            parts += [self._snap_copy.to_device(snap["rows"], self.device)
                      for _, snap in restores]
            MDL.scatter_rstate(
                self.state, fresh + [s for s, _ in restores],
                MDL.tree_map(lambda *xs: torch.cat(xs, dim=1), *parts))
        for slot, snap in restores:
            if "kv" in snap:
                kv = self._snap_copy.to_device(snap["kv"], self.device)
                pages = self.batcher.block_table_row(slot)[:kv["k"].shape[1]]
                scatter_pages(self.state["pool"]["k"], self.state["pool"]["v"],
                              np.asarray(pages), kv["k"], kv["v"])
        self.rstate_restores += len(restores)
        return starts, {s for s, _ in restores}

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
        ``(toks, emit, fin[, acc])`` and fold the emissions into the outputs
        and request bookkeeping (a speculative round: also the draft's
        coverage and the accept counters)."""
        if self._inflight is None:
            return None
        packed, K, pairs, nprop = self._inflight
        self._inflight = None
        n = self.ecfg.n_slots
        with self._phase("decode_s"):
            host = packed.cpu().numpy()
        self.timing.device_syncs += 1
        toks = host[:K * n].reshape(K, n)
        emit = host[K * n:2 * K * n].reshape(K, n).astype(bool)
        fin = host[2 * K * n:2 * K * n + n].astype(bool)
        acc = host[2 * K * n + n:]
        tnow = self.clock()
        finished = np.zeros((n,), bool)
        for slot, req in pairs:
            ts = toks[emit[:, slot], slot]
            if not len(ts):            # pool-starved to zero steps
                continue
            self.outputs[req.req_id].extend(int(t) for t in ts)
            self.first_tok_t.setdefault(req.req_id, tnow)
            if nprop is not None:
                # the draft absorbed its proposals' KV up to the emitted
                # frontier (req.total_len is still the dispatch-time
                # context: ``generated`` advances below)
                self._dlen[req.req_id] = req.total_len - 1 \
                    + min(len(ts), int(nprop[slot]))
                self.spec_rounds += 1
                self.spec_proposed += int(nprop[slot])
                self.spec_accepted += int(acc[slot])
            # the tick's scheduler step already reserved one token; the rest
            # of the horizon's emissions land here
            req.generated += len(ts) - 1
            self.tokens[slot] = int(ts[-1])
            finished[slot] = bool(fin[slot])
            if fin[slot] and self.spec:
                self._dlen.pop(req.req_id, None)
            self.timing.decode_tokens += int(len(ts))
        return finished

    def _draft_catchup(self, active) -> None:
        """Bring the draft's pool level with the target before a round: ONE
        draft ``prefill_chunk`` over every active slot's tokens in ``[dlen,
        ctx-1)`` (what the draft has not absorbed: a fresh admission, a
        resume, a cache hit, or the one token after a partly accepted
        round), at ``prefill_suffix``'s bucket shapes; rows padded to a
        power of two repeat the last real row with ``valid_len`` 0."""
        E = self.ecfg
        ctx = self.batcher.context_lens()
        needy = []
        for s in active:
            req = self.batcher.slots[s]
            dlen = self._dlen.get(req.req_id, 0)
            need = int(ctx[s]) - 1 - dlen
            if need > 0:
                needy.append((s, req, dlen, need))
        if not needy:
            return
        blen = _suffix_bucket(max(nd for *_, nd in needy),
                              max(E.max_prefill, E.page_size))
        rows = 1
        while rows < len(needy):
            rows *= 2
        W = self.pool_spec.max_pages_per_req
        host_bt = self.batcher.block_tables(W)
        toks = np.zeros((rows, blen), np.int32)
        starts = np.zeros((rows,), np.int32)
        lens = np.zeros((rows,), np.int32)
        bt_rows = np.zeros((rows, W), np.int32)
        for i, (s, req, dlen, need) in enumerate(needy):
            full = np.concatenate(
                [self.prompts[req.req_id],
                 np.asarray(self.outputs[req.req_id], np.int32)])
            toks[i, :need] = full[dlen:dlen + need]
            starts[i] = dlen
            lens[i] = need
            bt_rows[i] = host_bt[s]
            self._dlen[req.req_id] = dlen + need
        bt_rows[len(needy):] = bt_rows[len(needy) - 1]
        self.timing.draft_catchups += 1
        MDL.prefill_chunk(
            self.draft_cfg, self.draft_params, self._dstate,
            self._tensor(toks), self._tensor(bt_rows), self._tensor(starts),
            last_idx=self._tensor(np.maximum(lens - 1, 0)),
            valid_len=self._tensor(lens), rt=self.rt)

    def _step_fused(self) -> None:
        """One pipelined tick: collect the previous horizon, schedule and
        prefill, then dispatch the next horizon WITHOUT blocking on it."""
        E = self.ecfg
        # ---- overlap window: host work that does not need the horizon's
        # results, done while it runs. Watermark offload gathers pages here
        # with the horizon still queued: stream order puts the gathers
        # after it, and they take only tree pages no running slot writes
        # (a node pinned by a request, or with a queued write, is never a
        # victim: the policy's ``_eligible``; tree pages are whole prompt
        # pages, written once)
        with self._phase("host_s"):
            if self.cache is not None:
                self.cache.maintain()
            self._drain_snapshots()
            if self._inflight is not None and self.batcher.queue:
                self.batcher.prefetch_peeks(limit=2 * E.n_slots)

        finished = self._collect_horizon()
        if finished is None:
            finished, self._pending_fin = self._pending_fin, None

        with self._phase("host_s"):
            admitted, active = self.batcher.step(finished)
            if self.cache is not None and self.cache.has_pending:
                # swap-ins and CoW copies queued by this tick's admissions
                # land, in place, before prefill or decode read the pages
                self.cache.apply_pending(self.state["pool"])
        if admitted or self.prefiller.busy:
            with self._phase("prefill_s"):
                active = self.prefiller.run(admitted, active)
        self.timing.steps += 1
        if not active:
            return

        with self._phase("host_s"):
            if self.spec:
                # the draft re-absorbs every (re)admitted context
                for _s, req in admitted:
                    self._dlen[req.req_id] = 0
                K = max(1, E.spec_horizon + 1)
            else:
                K = max(1, E.decode_horizon)
            cap = self.prefiller.max_horizon
            if cap is not None:
                K = min(K, cap)
            allow = self.batcher.reserve_horizon(active, K,
                                                 gentle=E.reserve_gentle)
            self._sync_device_slots()
            W = self.pool_spec.max_pages_per_req
            width = W
            if E.decode_bucket and W > 16:
                width = decode_table_bucket(self.batcher.max_live_pages(), W)

        key = (int(width), int(K))
        if self.horizons.needs_capture(key):
            with self._phase("capture_s"):
                self.horizons.capture(key)
            self.timing.graph_captures += 1
        nprop = None
        with self._phase("decode_s"):
            if self.spec:
                self._draft_catchup(active)
                nprop = np.clip(np.asarray(allow) - 1, 0, K - 1)
                sd = self.timing.spec_dispatches
                sd[int(K)] = sd.get(int(K), 0) + 1
            packed = self.horizons.run(key, allow)
            self.timing.decode_steps += int(K)
            self._inflight = (packed, int(K),
                              [(s, self.batcher.slots[s]) for s in active],
                              nprop)

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
