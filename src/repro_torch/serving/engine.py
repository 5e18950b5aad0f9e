"""Decode engine: tick = schedule -> prefill -> fused decode horizon.

Port of the fused multi-step path of ``repro/serving/engine.py`` for
attention-only stacks, the zamba2 hybrid, xLSTM and the enc-dec family
(whisper's cross K/V rows ride with the recurrent rows). The host
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

A ``Runtime(ring_width=W)`` (a sliding-window ring pool) holds each
request to W pages (``PageAllocator(ring_pages=W)``) and serves slot
prefill only; speculative decoding and the prefix cache refuse it.

Recurrent rows (zamba2's Mamba2 carry, xLSTM's mLSTM and sLSTM carries,
whisper's cross K/V, computed once a request from stub zero frames):
each slot's carry lives in the decode state as ``[L, n_slots, ...]`` rows
(xLSTM's state has no pool at all). Admission resets a slot's rows to
fresh ones (zeros; xLSTM's stabilisers at ``NEG_INF``), or restores them
from a preemption snapshot
(``EngineConfig.state_resume``: the rows and the written KV pages are
copied to pinned host memory at preemption and back at re-admission, so
the request resumes instead of recomputing); group prefill gathers the
group's rows, runs, and scatters them back; the decode horizon's ``run``
mask keeps idle, paused and mid-chunk-prefill rows unchanged.

Sampling (``EngineConfig.sampler``): greedy, temperature or top-k, on
the device inside the horizon. JAX's key chains become generators on the
engine's device: the first-token sampler's (``sample_seed``), the
decode horizon's (``sample_seed``) and the draft's (``sample_seed + 1``).
A legacy per-row host callable (``DecodeEngine(sample=)``, repro's seed
API) samples instead: prefill's first tokens and ``step()``'s over the
host logits of the rows that emit, the horizon through
``sampling.make_callback_sampler``, which reads each step's logits back
for it. A host call cannot run inside a CUDA graph, so such an engine
runs the eager horizon (``decode_graphs=True`` raises); those per-step
readbacks are counted in ``EngineTiming.sample_readbacks``, and
``device_syncs`` still counts the one readback of ``(toks, emit, fin)``
a horizon. A draft refuses ``sample=``, as in repro.

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

Request lifecycle (as ``repro``'s): ``submit`` sheds past ``max_queue``
and arms deadlines on the engine clock (``EngineConfig.clock``: the wall
clock, or a ``runtime.clock.VirtualClock`` for replay); ``abort`` only
records the request. Every tick has one SAFE POINT after the horizon is
collected (``_process_faults``): the seeded fault plan fires there
(``runtime.faults``: straggler sleeps, client aborts, row deaths), deadlines
expire, requested aborts are torn down (pages, pins, snapshots, draft
coverage) and the sticky degradation ladder moves (``degraded_mode``: 1 =
horizon 1, 2 = speculative decoding off, 4 = host tier dropped). A
horizon whose sampled ids fall outside the vocabulary, or whose slot draws
an injected ``nan_logits``, is quarantined there (reason ``nan``).
``step()`` is the per-token tick on host logits (its real-logits
``isfinite`` guard is ``nan_guard``), interleaving with ``run()``.

Serving snapshots (``save_snapshot`` / ``restore_snapshot``, cadence
``snapshot_every``): ``runtime.checkpoint``'s manifest-gated layout with
``repro``'s entries; a restore writes KV pages and recurrent rows into the
existing pool in place, into a fresh engine before its first capture.

Telemetry (``EngineConfig.telemetry``, ``repro_torch.telemetry``): the
registry's pull bindings, the request tracker as the scheduler's events
hook, the tick's phases as Perfetto slices and each horizon's inferred
device span; the ``NULL`` facade when off. None of it reads the device.

Cross-engine movement (``serving/cluster.py``): ``extract_request`` pulls
a live request out at the quiescent frame (its snapshot entry, written KV
pages and carry) and ``adopt_request`` takes one in, writing the pages and
carry into the running engine's pool and rows in place at admission, as a
preemption snapshot restores; ``release`` drops a dead engine's device
state. ``EngineConfig.role`` only records the engine's role in a cluster:
the cluster's router enforces it.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_config, validate_draft_pair
from repro_torch.core.allocator import PageAllocator
from repro_torch.core.paged_kv import PoolSpec, gather_pages, scatter_pages
from repro_torch.core.scheduler import ContinuousBatcher, Request
from repro_torch.kernels.backend import KernelConfig, resolve_device
from repro_torch.kvcache import (HostCopier, PrefixCache, WatermarkConfig,
                                 make_cache_policy)
from repro_torch.models import model as MDL
from repro_torch.runtime import checkpoint as CKPT
from repro_torch.runtime.elastic import plan_request_migration
from repro_torch.runtime.faults import make_faults
from repro_torch.serving.graphs import HorizonRunner
from repro_torch.serving.policies import make_policy
from repro_torch.serving.prefill import (_suffix_bucket,
                                         decode_table_bucket, make_prefiller)
from repro_torch.serving.request import Request as RequestSpec
from repro_torch.serving.sampling import (make_callback_sampler,
                                          make_generator, make_sampler,
                                          make_scan_sampler, make_verifier)
from repro_torch.telemetry import make_telemetry

# a phase's span in a profiler trace, entered only while one records: a
# function-scope range stays on the host's timeline (a ``record_function``
# is a user annotation, which the profiler mirrors onto the device
# timeline over the kernels it launched, as if it were device work)
_profiling = torch._C._autograd._profiler_enabled
_Span = torch._C._profiler._RecordFunctionFast


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
    # a preempted recurrent request's carry rows and written KV pages go to
    # pinned host memory, and re-admission restores them instead of
    # re-prefilling. Off = full recompute on resume. Slot-mode prefill
    # never consumes snapshots (it is the recompute reference path).
    state_resume: bool = True
    # ---- telemetry (repro_torch.telemetry) ----
    # None = the shared no-op facade (no registry, no scheduler events
    # hook, no trace buffer); a TelemetryConfig or a built Telemetry turns
    # on the registry, the request tracker and the Perfetto timeline, all
    # host-side bookkeeping on the horizon readback the engine already pays
    telemetry: Any = None
    # ---- fault injection (repro_torch.runtime.faults) ----
    # None = the shared no-op injector; a FaultConfig (or a live injector
    # shared across engines) arms the seeded plan
    faults: Any = None
    # ---- request lifecycle ----
    # bounded admission queue: submit() sheds (terminal, reason "shed")
    # once this many requests wait; 0 = unbounded
    max_queue: int = 0
    # deadline (seconds on the engine clock) for requests that bring none;
    # 0 = none. Expired requests are torn down at the next safe point
    default_deadline_s: float = 0.0
    # time source (zero-arg callable -> seconds) for deadlines, submit and
    # first-token stamps, the SLO policies and the request tracker; None =
    # time.perf_counter. EngineTiming and the trace stay on the wall clock
    clock: Any = None
    # ---- graceful degradation ----
    # fault observations (injected pressure, swap-tier failures, NaN
    # quarantines) before a tier is dropped: spec decoding -> plain
    # horizon, horizon -> 1, host tier -> device only; 0 disables
    degrade_after: int = 3
    # ---- crash-consistent serving snapshots ----
    # snapshot_every > 0: every N ticks run() writes a serving checkpoint
    # under snapshot_dir (runtime/checkpoint.py layout), keeping the
    # newest snapshot_keep steps
    snapshot_dir: str | None = None
    snapshot_every: int = 0
    snapshot_keep: int = 3
    # real-logits quarantine (step(): non-finite rows; the horizon:
    # out-of-range ids). None = armed together with fault injection
    nan_guard: bool | None = None
    # ---- disaggregated serving (serving/cluster.py) ----
    # the engine's role in a cluster: "prefill" engines run requests to
    # their first token and hand them off, "decode" engines adopt and
    # finish them, "both" is the colocated behaviour. The engine only
    # records it: the cluster's router enforces it (a standalone engine
    # ignores it)
    role: str = "both"


@dataclass
class EngineTiming:
    """Wall-clock split of the serving loop (host bookkeeping vs device)."""
    steps: int = 0
    host_s: float = 0.0               # schedule + config-buffer assembly
    prefill_s: float = 0.0
    decode_s: float = 0.0             # decode dispatch + horizon readback
    fold_s: float = 0.0               # a readback's tokens into the requests
    # host time a dispatching tick spends with no decode work queued: from
    # the end of its collect (or, having collected nothing, of its overlap
    # window) to the end of its dispatch, prefill and captures left out
    serial_s: float = 0.0
    launch_s: float = 0.0             # HorizonRunner.run: allow + replay
    capture_s: float = 0.0            # one-time graph captures (not decode)
    graph_captures: int = 0           # (width, horizon, spec) graphs
    device_syncs: int = 0             # host<->device decode rendezvous
    # per-step logits readbacks for a legacy ``sample=`` callable (the
    # eager horizon's, apart from device_syncs)
    sample_readbacks: int = 0
    decode_tokens: int = 0            # tokens emitted by decode dispatches
    decode_steps: int = 0             # decode steps dispatched (sum of K)
    prefill_calls: int = 0            # model prefill / prefill_chunk calls
    draft_catchups: int = 0           # the draft's catch-up prefill calls
    encoder_calls: int = 0            # enc-dec encoder passes (cross rows)
    # speculative rounds dispatched, by K (K - 1 draft steps, one verify
    # pass over K query positions)
    spec_dispatches: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        n = max(1, self.steps)
        return {"steps": self.steps, "host_us_per_step": 1e6 * self.host_s / n,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "capture_s": self.capture_s, "fold_s": self.fold_s,
                "serial_s": self.serial_s, "launch_s": self.launch_s,
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
                 sample=None, policy=None, device=None, draft_params=None):
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
            if sample is not None:
                raise ValueError(
                    "speculative decode needs the sampler kinds "
                    "(greedy/temperature/top_k) so the draft's proposal "
                    "distribution is known to the verifier; legacy per-row "
                    "sample= callables cannot be verified against")
            self.draft_cfg = dcfg
        if sample is not None and ecfg.decode_graphs:
            raise ValueError("a sample= callable runs on the host every "
                             "decode step, which a CUDA graph cannot; use "
                             "decode_graphs=None or False with it")
        # ``sample``: a legacy per-row host callable ``logits [V] ->
        # token`` (repro's seed API), or None for the sampler kinds
        self.sample = sample
        self.device = resolve_device(device)
        if rt is None:
            rt = MDL.Runtime(kernels=KernelConfig(
                use_kernels=ecfg.use_kernels, n_splits=ecfg.kernel_splits))
        if self.draft_cfg is not None and rt.ring_width:
            raise ValueError(
                "speculative decode rides the fused batchable path; "
                "ring-buffer runtimes are per-slot")
        self.rt = rt
        if params is None:
            params = MDL.init_params(cfg, 0, torch.float32, self.device)
        elif params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        maxp = -(-ecfg.max_context // ecfg.page_size) + 1
        n_attn = cfg.n_layers if cfg.family == "encdec" else \
            sum(k in ("attn", "local") for k in cfg.block_kinds())
        self.pool_spec = PoolSpec(
            max(n_attn, 1), ecfg.n_pages, ecfg.page_size, cfg.n_kv_heads,
            cfg.d_head, maxp, dtype="float32")
        static_pages = maxp if ecfg.static_alloc else None
        # a ring pool holds a request to ``ring_width`` pages, so no table
        # slot past the ring is ever live (ROADMAP C.10: repro's engine
        # leaves them in the table, where they alias ring slots)
        self.alloc = PageAllocator(
            ecfg.n_pages, ecfg.n_shards, ecfg.page_size, policy=ecfg.policy,
            n_rows=ecfg.n_rows, static_max_pages=static_pages,
            ring_pages=rt.ring_width or None)
        # behavioral time source (deadlines, SLO budgets, request stamps)
        self.clock = ecfg.clock if ecfg.clock is not None \
            else time.perf_counter
        self.batcher = ContinuousBatcher(
            self.alloc, ecfg.n_slots, max_context=ecfg.max_context,
            n_rows=ecfg.n_rows, policy=make_policy(policy or ecfg.sched_policy),
            bt_width=maxp)
        self.batcher.clock = self.clock
        self.state = MDL.init_decode_state(cfg, self.pool_spec, ecfg.n_slots,
                                           device=self.device)
        # batched / chunked prefill thread the group's rows through each
        # call; a ring pool's prefill ignores ``valid_len`` (pad-write
        # masking), so it stays on the slot path
        self.batchable = self.chunkable = not rt.ring_width
        # recurrent / cross per-slot rows ([L, n_slots, ...] leaves of
        # self.state)
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
        # hybrid's prefix_cache=True serves without a cache, as in repro;
        # nor can ring pools, whose slots recycle)
        self.cacheable = self.chunkable and "layers" in self.params \
            and cfg.family != "encdec"
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
        self._scan_sample = (
            make_scan_sampler(ecfg.sampler, **sk) if sample is None
            else make_callback_sampler(sample, count=self._count_readback))
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
            graphs = self.device.type == "cuda" and sample is None
        elif graphs and self.device.type != "cuda":
            raise ValueError("EngineConfig.decode_graphs=True needs a CUDA "
                             f"engine; this one runs on {self.device}")
        self.horizons = HorizonRunner(self, graphs=bool(graphs))
        # in-flight horizon: (packed device readback, K, [(slot, req)],
        # proposals or None), collected at the next tick's sync point
        self._inflight: tuple | None = None
        # the end of the last phase, and where the tick's serial path began
        self._t_phase = self._serial_t0 = 0.0
        # finished mask of a horizon collected outside the tick loop
        self._pending_fin: np.ndarray | None = None
        # ---- fault injection + request lifecycle: one injector threaded
        # through scheduler and cache, so every decision shares the plan
        self.faults = make_faults(ecfg.faults)
        self.nan_guard = (self.faults.enabled if ecfg.nan_guard is None
                          else ecfg.nan_guard)
        self.batcher.faults = self.faults
        if self.cache is not None:
            self.cache.faults = self.faults
        # terminal-but-not-finished requests: req_id -> reason
        self.aborted: dict[int, str] = {}
        self.abort_counts: dict[str, int] = {
            "client": 0, "deadline": 0, "nan": 0, "shed": 0, "chaos": 0,
            "handoff": 0}
        # aborts requested mid-tick, torn down at the next safe point (a
        # teardown while a horizon is in flight would free pages its KV
        # writes still target)
        self._abort_req: dict[int, str] = {}
        # req_id -> absolute deadline on the engine clock
        self.deadline_t: dict[int, float] = {}
        # sticky degradation bitmask: 1 = horizon 1, 2 = spec off, 4 = host
        # tier dropped
        self.degraded_mode = 0
        self.snapshot_saves = 0
        self.snapshot_restores = 0
        self.snapshot_rejects = 0       # torn / corrupt steps skipped
        self._tick_no = 0
        # ---- telemetry (last: its bindings read everything above)
        self.tel = make_telemetry(ecfg.telemetry)
        self.tel.attach_engine(self)
        # (dispatch wall clock, dispatch-time ctx, horizon seq) of the
        # in-flight horizon: the inferred device span and the modeled
        # bytes at collect; None while telemetry is off
        self._horizon_meta: tuple | None = None
        self._horizon_seq = 0

    def _tensor(self, a) -> torch.Tensor:
        """Host numpy -> a tensor on the engine's device. The copy does not
        wait for the device (``non_blocking``): pageable host memory is
        staged by the driver before the call returns."""
        return torch.as_tensor(np.asarray(a)).to(self.device,
                                                  non_blocking=True)

    @contextmanager
    def _phase(self, acc: str, track: str | None = None,
               name: str | None = None):
        """Accumulate one timed segment into ``EngineTiming.<acc>`` (the
        one bookkeeping path of ``step()``, the fused tick and the
        horizon's launch); when tracing, emit it as a Perfetto slice on
        ``track``; while a profiler records, as an ``engine.<name>`` span."""
        name = name or acc
        span = _Span("engine." + name) if _profiling() else None
        if span is not None:
            span.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = self._t_phase = time.perf_counter()
            setattr(self.timing, acc, getattr(self.timing, acc) + t1 - t0)
            tr = self.tel.trace
            if tr is not None and track is not None:
                tr.slice(track, name, t0, t1 - t0)
            if span is not None:
                span.__exit__(None, None, None)

    # ------------------------------------------------------------------
    def submit(self, spec: RequestSpec) -> bool:
        """Enqueue a request described by a ``serving.Request`` spec.
        Returns False when the bounded queue is full and the request was
        shed instead (terminal at once, reason ``shed``, empty output).
        ``spec.deadline_s`` (or the engine default) arms a deadline on the
        engine clock; an expired request is torn down at the next tick's
        safe point wherever it is."""
        req_id = spec.req_id
        prompt = np.asarray(spec.prompt, np.int32)
        self.prompts[req_id] = prompt
        self.outputs[req_id] = []
        now = self.submit_t[req_id] = self.clock()
        self.tel.on_submit(req_id, len(prompt), spec.max_new_tokens, now,
                           spec=spec)
        sreq = Request(req_id, len(prompt), spec.max_new_tokens,
                       priority=spec.priority, submit_t=now, spec=spec)
        E = self.ecfg
        if E.max_queue and len(self.batcher.queue) >= E.max_queue:
            self.aborted[req_id] = "shed"
            self.abort_counts["shed"] += 1
            self.tel.on_abort(sreq, -1, "shed")
            return False
        dl = E.default_deadline_s if spec.deadline_s is None \
            else spec.deadline_s
        if dl and dl > 0:
            self.deadline_t[req_id] = now + dl
        if self.prefiller.name == "chunked":
            sreq.chunked_prefill = True
            sreq.prefill_done = False
        self.batcher.submit(sreq)
        return True

    def abort(self, req_id: int, reason: str = "client") -> bool:
        """Client-side cancel, torn down at the next tick's safe point
        (freeing a slot's pages while a horizon is in flight would let its
        KV writes land in pages a re-admission owns). True if the request
        was live (queued or running)."""
        live = any(r is not None and r.req_id == req_id
                   for r in self.batcher.slots) \
            or any(r.req_id == req_id for r in self.batcher.queue)
        if live:
            self._abort_req.setdefault(req_id, reason)
        return live

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
            if self.tel.enabled:
                self.tel.on_tokens(req.req_id, 1,
                                   self.first_tok_t[req.req_id])
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

    def _init_cross_rows(self, slots: list[int]) -> None:
        """Encoder pass and cross K/V projection for fresh enc-dec slots of
        chunked prefill (stub zero frames, as the slot path), written into
        the slots' rows in place."""
        self.timing.encoder_calls += 1
        enc = MDL.encode(self.cfg, self.params,
                         MDL.stub_frames(self.cfg, len(slots), self.device),
                         self.rt)
        ck, cv = MDL.make_cross_kv(self.cfg, self.params, enc)
        MDL.scatter_rstate(self.state, slots, {"cross_k": ck, "cross_v": cv})

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

    def _count_readback(self) -> None:
        self.timing.sample_readbacks += 1

    def _sample_rows(self, logits) -> np.ndarray:
        """[B, V] -> [B] int32: the sampler kind in ONE batched call, or a
        ``sample=`` callable row by row over one host copy."""
        if self.sample is None:
            return self.sampler(logits)
        rows = (logits.float().cpu().numpy() if torch.is_tensor(logits)
                else np.asarray(logits))
        return np.fromiter((int(self.sample(r)) for r in rows), np.int32,
                           len(rows))

    def _first_tokens(self, logits, emits) -> np.ndarray:
        """Sample the first token for a prefill group (only rows that emit
        are sampled)."""
        toks = np.zeros((len(emits),), np.int32)
        idx = [i for i, e in enumerate(emits) if e]
        if idx:
            toks[idx] = self._sample_rows(logits[idx])
        return toks

    # ---- fault processing + terminal teardown (the tick safe point) ----
    def _find_request(self, req_id: int):
        """``(slot, req)`` for a running request, ``(None, req)`` for a
        queued one, ``(None, None)`` when the id is not live."""
        for s, r in enumerate(self.batcher.slots):
            if r is not None and r.req_id == req_id:
                return s, r
        for r in self.batcher.queue:
            if r.req_id == req_id:
                return None, r
        return None, None

    def _teardown(self, req_id: int, reason: str) -> bool:
        """Terminal teardown of a live request: scheduler state (pages,
        pins, queued swap ops) through abort_slot / abort_queued, then every
        engine-side reference (carry snapshot, draft coverage, deadline).
        Freed pages are safe to reuse at once: every gather that reads them
        (swap-out, preemption snapshot) copies them on the compute stream
        into a fresh tensor first, and only that tensor crosses to the
        copy stream; a dropped snapshot's pinned buffer is not reused by
        the caching host allocator before its copy's event passes."""
        s, req = self._find_request(req_id)
        if req is None:
            return False
        if s is not None:
            self.batcher.abort_slot(s, reason)
        else:
            self.batcher.abort_queued(req, reason)
        self.rsnaps.pop(req_id, None)
        if self.spec:
            self._dlen.pop(req_id, None)
        self.deadline_t.pop(req_id, None)
        self.aborted[req_id] = reason
        self.abort_counts[reason] = self.abort_counts.get(reason, 0) + 1
        return True

    def _process_row_death(self, finished) -> None:
        """Injected serving-row death: every request not finishing this
        tick whose pages live on a dead row (the physical row under
        ``row_affine``, the slot's row group under striped) is drained —
        freed without a cache insert and requeued for a re-prefill of its
        reconstructable context (``elastic.plan_request_migration``)."""
        E = self.ecfg
        dead = {row for row in range(max(1, E.n_rows))
                if self.faults.fire("row_death", key=row)}
        if not dead:
            return
        row_of: dict[int, int] = {}
        slot_of: dict[int, int] = {}
        for s, r in enumerate(self.batcher.slots):
            if r is None or (finished is not None and finished[s]):
                continue
            row = self.alloc.row_of_request(r.req_id)
            if row is None:
                row = self.batcher._row_of_slot(s)
            row_of[r.req_id] = row
            slot_of[r.req_id] = s
        for rid in plan_request_migration(row_of, dead):
            s = slot_of[rid]
            req = self.batcher.slots[s]
            out = self.outputs[rid]
            if req.prefill_done and out:
                # the really-emitted frame before the requeue arithmetic (a
                # zero-emission horizon can leave ``generated`` ahead)
                P = len(self.prompts[rid])
                req.generated = min(
                    req.generated,
                    max(0, len(out) - 1 - (req.prompt_len - P)))
            else:
                req.generated = 0
            self.batcher.drain_slot(s)
            self.rsnaps.pop(rid, None)
            if self.spec:
                self._dlen.pop(rid, None)

    def _update_degradation(self) -> None:
        """Sticky ladder driven only by injected pressure and observed
        faults (never by ordinary preemption): at ``degrade_after`` drop
        speculative decoding (a draft-less engine: the horizon); at twice
        that, the horizon too; repeated swap-in failures drop the host
        tier (its copies are drained before the tier goes)."""
        E = self.ecfg
        if not E.degrade_after:
            return
        inj = self.faults.counts
        pressure = (inj.get("alloc_exhaust", 0) + inj.get("row_death", 0)
                    + self.abort_counts.get("nan", 0))
        if pressure >= E.degrade_after:
            self.degraded_mode |= 2 if self.spec else 1
        if pressure >= 2 * E.degrade_after:
            self.degraded_mode |= 1
        if (self.cache is not None and self.cache.host is not None
                and self.cache.stats.swap_in_fails >= E.degrade_after):
            self.cache.drop_host_tier()
            self.degraded_mode |= 4

    def _process_faults(self, finished) -> None:
        """The tick's SAFE POINT, after the collect (no horizon in flight)
        and before the scheduler reuses anything: advance the fault clock,
        fire this tick's plan (straggler sleep, seeded client aborts, row
        deaths), expire deadlines, tear down every requested abort, move
        the degradation ladder. A natural finish beats a same-tick abort,
        except a NaN quarantine, whose tokens are invalid."""
        self._tick_no += 1
        F = self.faults
        F.on_tick()
        if F.enabled:
            if F.fire("slow_tick"):
                time.sleep(F.cfg.slow_tick_s)
            live = [r for r in self.batcher.slots if r is not None] \
                + list(self.batcher.queue)
            for r in live:
                if F.fire("client_abort", key=r.req_id):
                    self._abort_req.setdefault(r.req_id, "chaos")
            self._process_row_death(finished)
        if self.deadline_t:
            now = self.clock()
            for rid, t in list(self.deadline_t.items()):
                s, req = self._find_request(rid)
                if req is None or (s is not None and finished is not None
                                   and finished[s]):
                    self.deadline_t.pop(rid)
                elif now >= t:
                    self._abort_req.setdefault(rid, "deadline")
        if self._abort_req:
            for rid, reason in list(self._abort_req.items()):
                s, req = self._find_request(rid)
                if req is None:
                    continue
                if s is not None and finished is not None and finished[s] \
                        and reason != "nan":
                    continue
                self._teardown(rid, reason)
            self._abort_req.clear()
        self._update_degradation()

    def _maintain_cache(self) -> None:
        """The cache's once-a-tick drain of last tick's swap-outs and its
        watermark offload, unless an injected swap-tier stall skips it."""
        if not (self.faults.enabled and self.faults.fire("swap_stall")):
            self.cache.maintain()

    # ---- the per-token tick --------------------------------------------
    def step(self, finished_mask=None):
        """One per-token tick: schedule -> prefill -> ONE decode step ->
        sample on the host logits (``repro``'s reference path, and for
        callers driving the engine token by token). Interleaves with
        ``run()``: a pending fused finish mask is consumed, active slots
        are marked dirty (this step advanced tokens and ctx on the host
        only, so the device mirror re-syncs before the next horizon), and
        the returned mask is also stashed for a later ``run()``."""
        E = self.ecfg
        with self._phase("host_s", "host", "schedule"):
            self._drain_snapshots()
            if self._pending_fin is not None:
                finished_mask = self._pending_fin if finished_mask is None \
                    else (np.asarray(finished_mask, bool) | self._pending_fin)
                self._pending_fin = None
            self._process_faults(finished_mask)
            admitted, active = self.batcher.step(finished_mask)
            if self.cache is not None:
                self._maintain_cache()
                if self.cache.has_pending:
                    self.cache.apply_pending(self.state["pool"])
        if admitted or self.prefiller.busy:
            with self._phase("prefill_s", "prefill", "prefill"):
                active = self.prefiller.run(admitted, active)
        self.timing.steps += 1
        if not active:
            return np.zeros((E.n_slots,), bool)

        with self._phase("host_s", "host", "config"):
            ctx = self.batcher.context_lens()
            W = self.pool_spec.max_pages_per_req
            bt = self.batcher.block_tables(W)
            active_mask = np.zeros((E.n_slots,), bool)
            active_mask[active] = True
            # host twin of the horizon's device-side write targets; idle
            # slots write to the trash page (n_pages)
            t = np.clip(ctx - 1, 0, None)
            vp = t // E.page_size
            if self.rt.ring_width:
                vp = vp % self.rt.ring_width
            vp = np.minimum(vp, W - 1)
            npage = np.where(active_mask, bt[np.arange(E.n_slots), vp],
                             E.n_pages).astype(np.int32)
            noff = np.where(active_mask, t % E.page_size, 0).astype(np.int32)
            if E.decode_bucket and W > 16:
                bt = bt[:, :decode_table_bucket(self.batcher.max_live_pages(),
                                                W)]
        # ``run`` keeps the recurrent rows of idle and mid-chunk-prefill
        # slots (their KV writes go to the trash page)
        with self._phase("decode_s", "sync", "decode+sample"):
            logits, _ = MDL.decode_step(
                self.cfg, self.params, self.state, self._tensor(self.tokens),
                self._tensor(np.ascontiguousarray(bt)),
                self._tensor(ctx.astype(np.int32)), self._tensor(npage),
                self._tensor(noff), run=self._tensor(active_mask),
                rt=self.rt)
            logits = logits.float().cpu().numpy()
            self.timing.device_syncs += 1
            self.timing.decode_steps += 1
            if self.sample is None:
                nxt = self.sampler(logits)
            else:            # a legacy callable sees the active rows only
                nxt = np.zeros((E.n_slots,), np.int32)
                nxt[active] = self._sample_rows(logits[active])

        with self._phase("host_s", "host", "bookkeep"):
            # quarantine: a non-finite row (when guarded) or an injected
            # NaN plan; the token is not emitted and the request goes
            # terminal at the next safe point
            quar = np.zeros((E.n_slots,), bool)
            finite = (np.isfinite(logits[active]).all(axis=1)
                      if self.nan_guard
                      else np.ones((len(active),), bool))
            for i, s in enumerate(active):
                rid = self.batcher.slots[s].req_id
                if (self.faults.enabled
                        and self.faults.fire("nan_logits", key=rid)) \
                        or not finite[i]:
                    quar[s] = True
                    self._abort_req.setdefault(rid, "nan")
            gen = np.asarray([0 if r is None else r.generated
                              for r in self.batcher.slots], np.int32)
            budget = np.asarray([1 if r is None else r.max_new_tokens
                                 for r in self.batcher.slots], np.int32)
            self.tokens = np.where(active_mask & ~quar, nxt,
                                   self.tokens).astype(np.int32)
            finished = active_mask & ~quar \
                & ((nxt == E.eos_token) | (gen >= budget))
            emitted = [s for s in active if not quar[s]]
            for s in emitted:
                self.outputs[self.batcher.slots[s].req_id].append(int(nxt[s]))
            self.timing.decode_tokens += len(emitted)
            if self.tel.enabled:
                tnow = self.clock()
                for s in emitted:
                    self.tel.on_tokens(self.batcher.slots[s].req_id, 1, tnow)
                self.tel.on_horizon(float(ctx[emitted].sum()))
            self.batcher.dirty.update(active)
            self._pending_fin = finished
        return finished

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
        coverage and the accept counters). A slot whose ids fall outside
        the vocabulary (when guarded) or that draws an injected
        ``nan_logits`` is quarantined: its tokens are not folded and it
        goes terminal at this tick's safe point."""
        if self._inflight is None:
            return None
        packed, K, pairs, nprop = self._inflight
        self._inflight = None
        meta, self._horizon_meta = self._horizon_meta, None
        with self._phase("decode_s", "sync", "collect"):
            host = packed.cpu().numpy()
        self._serial_t0 = self._t_phase
        self.timing.device_syncs += 1
        with self._phase("fold_s", "sync", "fold"):
            return self._fold(host, K, pairs, nprop, meta)

    def _fold(self, host, K, pairs, nprop, meta):
        """Fold a collected horizon's emissions into the outputs and the
        requests; returns the finished mask."""
        n = self.ecfg.n_slots
        tel = self.tel.enabled
        if tel and meta is not None and self.tel.trace is not None:
            # the horizon's device-busy window, inferred dispatch -> readback
            self.tel.trace.span("device", "horizon", meta[2], meta[0],
                                time.perf_counter(),
                                args={"slots": len(pairs)})
        toks = host[:K * n].reshape(K, n)
        emit = host[K * n:2 * K * n].reshape(K, n).astype(bool)
        fin = host[2 * K * n:2 * K * n + n].astype(bool)
        acc = host[2 * K * n + n:]
        # one readback stamp for the whole horizon (the tracker's TTFT
        # equals first_tok_t - submit_t exactly)
        tnow = self.clock()
        tok_ctx = 0.0
        finished = np.zeros((n,), bool)
        for slot, req in pairs:
            ts = toks[emit[:, slot], slot]
            if not len(ts):            # pool-starved to zero steps
                continue
            if (self.faults.enabled
                    and self.faults.fire("nan_logits", key=req.req_id)) \
                    or (self.nan_guard
                        and (int(ts.min()) < 0
                             or int(ts.max()) >= self.cfg.padded_vocab)):
                self._abort_req.setdefault(req.req_id, "nan")
                continue
            self.outputs[req.req_id].extend(int(t) for t in ts)
            self.first_tok_t.setdefault(req.req_id, tnow)
            if tel:
                self.tel.on_tokens(req.req_id, int(len(ts)), tnow)
                if meta is not None:
                    tok_ctx += len(ts) * float(meta[1][slot])
            if nprop is not None:
                # the draft absorbed its proposals' KV up to the emitted
                # frontier (req.total_len is still the dispatch-time
                # context: ``generated`` advances below)
                self._dlen[req.req_id] = req.total_len - 1 \
                    + min(len(ts), int(nprop[slot]))
                self.spec_rounds += 1
                self.spec_proposed += int(nprop[slot])
                self.spec_accepted += int(acc[slot])
                if tel:
                    self.tel.on_spec(req.req_id, int(nprop[slot]),
                                     int(acc[slot]))
            # the tick's scheduler step already reserved one token; the rest
            # of the horizon's emissions land here
            req.generated += len(ts) - 1
            self.tokens[slot] = int(ts[-1])
            finished[slot] = bool(fin[slot])
            if fin[slot] and self.spec:
                self._dlen.pop(req.req_id, None)
            self.timing.decode_tokens += int(len(ts))
        if tel:
            self.tel.on_horizon(tok_ctx)
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
        """One pipelined tick: collect the previous horizon, the safe
        point, schedule and prefill, then dispatch the next horizon
        WITHOUT blocking on it."""
        E = self.ecfg
        # ---- overlap window: host work that does not need the horizon's
        # results, done while it runs. Watermark offload gathers pages here
        # with the horizon still queued: stream order puts the gathers
        # after it, and they take only tree pages no running slot writes
        # (a node pinned by a request, or with a queued write, is never a
        # victim: the policy's ``_eligible``; tree pages are whole prompt
        # pages, written once)
        with self._phase("host_s", "host", "overlap"):
            if self.cache is not None:
                self._maintain_cache()
            self._drain_snapshots()
            if self._inflight is not None and self.batcher.queue:
                self.batcher.prefetch_peeks(limit=2 * E.n_slots)

        # the serial path starts here, or at the end of the collect
        self._serial_t0 = self._t_phase
        T = self.timing
        aside = T.prefill_s + T.capture_s
        finished = self._collect_horizon()
        if finished is None:
            finished, self._pending_fin = self._pending_fin, None

        with self._phase("host_s", "host", "faults"):
            self._process_faults(finished)

        with self._phase("host_s", "host", "schedule"):
            admitted, active = self.batcher.step(finished)
            if self.cache is not None and self.cache.has_pending:
                # swap-ins and CoW copies queued by this tick's admissions
                # land, in place, before prefill or decode read the pages
                self.cache.apply_pending(self.state["pool"])
        if admitted or self.prefiller.busy:
            with self._phase("prefill_s", "prefill", "prefill"):
                active = self.prefiller.run(admitted, active)
        self.timing.steps += 1
        if not active:
            return

        with self._phase("host_s", "host", "config"):
            # degradation bit 2 turns speculative decoding into the plain
            # horizon (the draft's coverage goes stale, read only with spec)
            spec = self.spec and not (self.degraded_mode & 2)
            if spec:
                # the draft re-absorbs every (re)admitted context
                for _s, req in admitted:
                    self._dlen[req.req_id] = 0
                K = max(1, E.spec_horizon + 1)
            else:
                K = max(1, E.decode_horizon)
            cap = self.prefiller.max_horizon
            if cap is not None:
                K = min(K, cap)
            if (self.degraded_mode & 1) and not spec:
                K = 1                  # bit 1: the per-token trajectory
            allow = self.batcher.reserve_horizon(active, K,
                                                 gentle=E.reserve_gentle)
            self._sync_device_slots()
            W = self.pool_spec.max_pages_per_req
            width = W
            if E.decode_bucket and W > 16:
                width = decode_table_bucket(self.batcher.max_live_pages(), W)

        key = (int(width), int(K), spec)
        if self.horizons.needs_capture(key):
            with self._phase("capture_s", "dispatch", "capture"):
                self.horizons.capture(key)
            self.timing.graph_captures += 1
        nprop = None
        with self._phase("decode_s", "dispatch",
                         "spec_dispatch" if spec else "dispatch"):
            if self.tel.enabled:
                self._horizon_seq += 1
                self._horizon_meta = (time.perf_counter(),
                                      self.batcher._ctx.copy(),
                                      self._horizon_seq)
            if spec:
                self._draft_catchup(active)
                nprop = np.clip(np.asarray(allow) - 1, 0, K - 1)
                sd = self.timing.spec_dispatches
                sd[int(K)] = sd.get(int(K), 0) + 1
            packed = self.horizons.run(key, allow)
            self.timing.decode_steps += int(K)
            self._inflight = (packed, int(K),
                              [(s, self.batcher.slots[s]) for s in active],
                              nprop)
        T.serial_s += self._t_phase - self._serial_t0 \
            - (T.prefill_s + T.capture_s - aside)

    def tick(self) -> None:
        """One pipelined fused tick plus the serving-snapshot cadence
        (public driver API: chaos drivers tick and may abandon the engine
        between ticks)."""
        self._step_fused()
        E = self.ecfg
        if E.snapshot_every and E.snapshot_dir \
                and self._tick_no % E.snapshot_every == 0:
            self.save_snapshot()

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        for _ in range(max_steps):
            if self._inflight is None and self.batcher.done():
                break
            self.tick()
        if self._inflight is not None:   # max_steps hit mid-horizon
            self._pending_fin = self._collect_horizon()
        return self.outputs

    def quiesce(self) -> None:
        """Bring the engine to the post-collect frame: fold an in-flight
        horizon into host bookkeeping (its finish mask joins the pending
        one for the next scheduler step) and drain the snapshot copies.
        Snapshots and teardowns need this frame; one extra device sync
        when a horizon was in flight."""
        if self._inflight is not None:
            fin = self._collect_horizon()
            if fin is not None:
                self._pending_fin = fin if self._pending_fin is None \
                    else (self._pending_fin | fin)
        self._drain_snapshots()

    def extract_request(self, req_id: int):
        """Pull a live request out of this engine for a cross-engine
        handoff: quiesce, take its snapshot-entry frame (the written KV
        pages and recurrent carry, copied to host numpy, when warm), then
        tear it down here (reason ``handoff``: its private pages free;
        prefixes it already published to the radix cache stay under the
        tree's own references). Returns ``(entry, arrays)``, or None when
        the request is not live or finished during the quiesce (its output
        is complete: nothing to move)."""
        self.quiesce()
        s, req = self._find_request(req_id)
        if req is None:
            return None
        if s is not None and self._pending_fin is not None \
                and self._pending_fin[s]:
            return None
        ent, arrs = self._snapshot_entry(req, s)
        self._teardown(req_id, "handoff")
        return ent, arrs

    def release(self) -> None:
        """Drop this engine's device state (a dead cluster member): its
        captured graphs and their memory pool, the horizon's static
        buffers, the slot state, the pools and recurrent rows, the draft's
        pool, and the snapshot copies (drained first). The graphs are freed
        here, at a tick boundary and outside any capture, not by a later
        collection that could land inside another engine's capture (the
        collector is held off only during ``graphs.capture``). The engine
        cannot tick after; its host bookkeeping (outputs, aborts) stays
        readable."""
        if self.device.type == "cuda":
            # an uncollected horizon may still be writing the pool
            torch.cuda.synchronize(self.device)
        self._snap_copy.drain()
        self._inflight = None
        self.rsnaps.clear()
        self.horizons.captured.clear()
        self.horizons.outs.clear()
        self.horizons.spec_bufs.clear()
        self.horizons.pool = None
        self.state = {}
        self._dstate = None
        self.dev = None

    def adopt_request(self, req_id: int, ent: dict, prompt, out, *,
                      kv=None, rows=None):
        """Register a request arriving from outside ``submit()`` (a
        snapshot restore or a cross-engine handoff): ``ent`` is its
        ``_snapshot_entry`` frame, ``out`` the tokens already streamed. A
        warm entry seeds the preemption snapshot machinery (``kv``: host
        ``{"k", "v"}`` pages in the pool's dtype, ``rows``: the host carry)
        so the prefiller writes them into the pool and rows in place at
        admission instead of recomputing (a running engine's captured
        graphs keep their addresses); slot-mode prefill and cold entries
        re-prefill — token-identical either way. SLO targets do not survive
        the move: the request's stamps restart on this engine's clock.
        Returns the queued Request."""
        self.prompts[req_id] = np.asarray(prompt, np.int32)
        self.outputs[req_id] = [int(t) for t in out]
        now = self.submit_t[req_id] = self.clock()
        spec = RequestSpec(req_id, self.prompts[req_id], int(ent["max_new"]),
                           priority=int(ent.get("priority", 0)))
        self.tel.on_submit(req_id, len(self.prompts[req_id]),
                           int(ent["max_new"]), now, spec=spec)
        req = Request(req_id, int(ent["prompt_len"]), int(ent["max_new"]),
                      priority=spec.priority, submit_t=now, spec=spec)
        if self.prefiller.name == "chunked":
            req.chunked_prefill = True
            req.prefill_done = False
        warm_ok = self.ecfg.state_resume and self.prefiller.name != "slot"
        if ent.get("state") == "warm" and warm_ok:
            snap: dict[str, Any] = {"len": int(ent["depth"])}
            if kv is not None:
                snap["kv"] = kv
            if rows is not None:
                snap["rows"] = rows
            self.rsnaps[req_id] = snap
        self.batcher.submit(req)
        return req

    # ---- crash-consistent serving snapshots ---------------------------
    def _named_generators(self) -> dict:
        """Every generator the engine draws from, by name: their states are
        the snapshot's counterpart of repro's ``dev_key``."""
        gens = {"gen": self.gen, "dgen": self.dgen,
                "sampler": self.sampler.gen}
        return {k: g for k, g in gens.items() if g is not None}

    def _snapshot_entry(self, req, s: int | None):
        """(scalar manifest entry, arrays) for one live request. A running
        warm slot saves its written KV pages (and recurrent carry) at the
        quiescent depth; the requeue arithmetic mirrors ``drain_slot``, so
        the saved ``prompt_len`` is the restore depth and a warm restore
        takes the prefiller's full-restore path. A queued request with a
        preemption snapshot saves that; everything else is cold (a
        deterministic re-prefill)."""
        E = self.ecfg
        rid = req.req_id
        out = self.outputs[rid]
        arrs: dict[str, Any] = {"prompt": self.prompts[rid],
                                "out": np.asarray(out, np.int32)}
        ent = {"prompt_len": int(req.prompt_len),
               "max_new": int(req.max_new_tokens), "state": "cold"}
        if s is not None and req.prefill_done and out and req.kv_written:
            P = len(self.prompts[rid])
            g = min(int(req.generated),
                    max(0, len(out) - 1 - (req.prompt_len - P)))
            depth = req.prompt_len + g
            ent = {"prompt_len": int(depth),
                   "max_new": max(1, int(req.max_new_tokens) - g),
                   "state": "warm", "depth": int(depth)}
            if "pool" in self.state:
                n = -(-depth // E.page_size)
                pages = np.asarray(self.batcher.block_table_row(s)[:n])
                k, v = gather_pages(self.state["pool"]["k"],
                                    self.state["pool"]["v"], pages)
                arrs["kv_k"] = CKPT.to_numpy(k)
                arrs["kv_v"] = CKPT.to_numpy(v)
            if self.has_rstate:
                arrs["rows"] = MDL.tree_map(
                    CKPT.to_numpy, MDL.gather_rstate(self.state, [s]))
        elif s is None and rid in self.rsnaps:
            # queued with a preemption snapshot (host memory after the
            # drain): persist it so the restore resumes
            snap = self.rsnaps[rid]
            ent = {"prompt_len": int(req.prompt_len),
                   "max_new": int(req.max_new_tokens),
                   "state": "warm", "depth": int(snap["len"])}
            if "kv" in snap:
                arrs["kv_k"] = CKPT.to_numpy(snap["kv"]["k"])
                arrs["kv_v"] = CKPT.to_numpy(snap["kv"]["v"])
            if "rows" in snap:
                arrs["rows"] = MDL.tree_map(CKPT.to_numpy, snap["rows"])
        if req.priority:
            ent["priority"] = int(req.priority)
        return ent, arrs

    def save_snapshot(self, ckpt_dir=None):
        """Write a crash-consistent serving checkpoint: every live
        request's prompt and output tokens plus, for warm slots, the
        written KV pages and recurrent carry at the quiescent depth —
        enough for a fresh engine to finish every in-flight request
        token-identically (greedy). Quiesces first (one extra sync on a
        snapshot tick); the manifest is written last, so a crash mid-save
        never damages the latest restorable step."""
        E = self.ecfg
        d = ckpt_dir or E.snapshot_dir
        if d is None:
            return None
        self.quiesce()
        order: list[int] = []
        ents: dict[str, dict] = {}
        arrs: dict[str, dict] = {}
        for s, req in enumerate(self.batcher.slots):
            if req is None:
                continue
            if self._pending_fin is not None and self._pending_fin[s]:
                ent = {"state": "done", "max_new": int(req.max_new_tokens),
                       "prompt_len": int(req.prompt_len)}
                a = {"prompt": self.prompts[req.req_id],
                     "out": np.asarray(self.outputs[req.req_id], np.int32)}
            else:
                ent, a = self._snapshot_entry(req, s)
            order.append(req.req_id)
            ents[str(req.req_id)] = ent
            arrs[str(req.req_id)] = a
        for req in self.batcher.queue:
            ent, a = self._snapshot_entry(req, None)
            order.append(req.req_id)
            ents[str(req.req_id)] = ent
            arrs[str(req.req_id)] = a
        tree = {"reqs": arrs,
                "gen_state": {k: g.get_state().numpy() for k, g
                              in self._named_generators().items()}}
        path = CKPT.save(d, self._tick_no, tree,
                         extra={"order": order, "reqs": ents,
                                "tick": self._tick_no},
                         keep=E.snapshot_keep)
        self.snapshot_saves += 1
        return path

    def _rows_from_nested(self, nd):
        """A one-slot recurrent carry as host tensors from its "/"-keyed
        nested form (sequence indices became string keys): rebuilt against
        the structure and dtypes of a live one-slot gather."""
        like = MDL.gather_rstate(self.state, [0])

        def build(node, d):
            if isinstance(node, dict):
                return {k: build(v, d[k]) for k, v in node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(build(v, d[str(i)])
                                  for i, v in enumerate(node))
            return torch.from_numpy(np.ascontiguousarray(d)).to(node.dtype)
        return build(like, nd)

    def restore_snapshot(self, ckpt_dir=None, step: int | None = None):
        """Rebuild the serving state of the newest (or the given) snapshot
        into THIS engine — a fresh one with the same model and engine
        config, before its first tick: warm requests write their KV pages
        (and carry) into the existing pool in place and continue, cold
        ones re-prefill, done ones republish their outputs.

        Every candidate step is fully validated (manifest, shard, per-array
        crc32) before anything is applied: a torn or damaged step is
        counted in ``snapshot_rejects`` and skipped for the next older one.
        Returns the restored step, or None (the caller's cold start)."""
        d = ckpt_dir or self.ecfg.snapshot_dir
        if d is None:
            return None
        if self.horizons.captured or self._tick_no:
            # the captured graphs hold the pool's and the slot state's
            # addresses and the generators' offsets: restore before them
            raise RuntimeError("restore_snapshot needs a fresh engine (no "
                               "tick run, no graph captured)")
        cands = ([step] if step is not None
                 else sorted(CKPT.valid_steps(d), reverse=True))
        for cand in cands:
            if not CKPT.verify_step(d, cand):
                self.snapshot_rejects += 1
                continue
            return self._restore_step(d, cand)
        return None

    def _restore_step(self, ckpt_dir, step: int):
        """Apply one verified snapshot step (see ``restore_snapshot``)."""
        manifest, nested = CKPT.load(ckpt_dir, step)
        extra = manifest["extra"]
        gens = self._named_generators()
        for k, st in nested.get("gen_state", {}).items():
            if k in gens:
                gens[k].set_state(torch.from_numpy(np.array(st)))
        pool_dtype = self.state["pool"]["k"].dtype \
            if "pool" in self.state else torch.float32
        reqs = nested.get("reqs", {})
        for rid_s in map(str, extra["order"]):
            ent = extra["reqs"][rid_s]
            rid = int(rid_s)
            a = reqs.get(rid_s, {})
            prompt = np.asarray(a["prompt"], np.int32)
            out = [int(t) for t in np.asarray(a.get("out", ()), np.int32)]
            if ent["state"] == "done":         # finished during quiesce:
                self.prompts[rid] = prompt     # republish, don't re-run
                self.outputs[rid] = out
                self.submit_t[rid] = self.clock()
                continue
            kv = ({name: torch.from_numpy(np.ascontiguousarray(
                a[f"kv_{name}"])).to(pool_dtype) for name in ("k", "v")}
                if "kv_k" in a else None)
            rows = (self._rows_from_nested(a["rows"])
                    if "rows" in a else None)
            self.adopt_request(rid, ent, prompt, out, kv=kv, rows=rows)
        self.snapshot_restores += 1
        return step
