"""Multi-pod dry-run: every (arch x shape x mesh) cell on tensors without
storage.

The port's counterpart of ``repro/launch/dryrun.py``, which lowers and
compiles each cell with XLA against ``ShapeDtypeStruct`` stand-ins. Here
there is no compiler: a cell runs ONE shard's step on ``device="meta"``
tensors (the bodies are SPMD, so one is enough), on the abstract
production mesh ((16, 16) over (data, model), or (2, 16, 16) with a pod
axis) given a shape-only backend (``distributed/mesh.ShapeMesh``: each
collective returns a result of the right shape and counts its bytes).
Nothing is allocated and no thread is started. Each cell records, per
shard:

* ``hlo.flops`` — ``torch.utils.flop_counter.FlopCounterMode``'s count
  (matmuls and attention products, the MFU convention), taken by its
  per-op rule (``flop_registry``) in the byte tally's own dispatch mode,
  which gives the same total at a third less time: forward and backward
  for train, remat's recompute included;
* ``hlo.hbm_bytes`` — the bytes of every op's inputs and outputs, unfused
  (views and the ops that emulate a collective excluded): an upper bound
  on the traffic a fused program would make;
* ``hlo.collectives`` — bytes by kind, by ``hlo_analysis``'s rule
  (all-gather its output, all-reduce twice its input, reduce-scatter /
  all-to-all / permute their input);
* ``memory`` — ``argument_bytes`` exactly from the plan's specs
  (``counted_specs``: a leaf's bytes over the shards its spec cuts it
  into; in a pipeline cell the pod's own stage's layers). A
  ``ProcessMesh`` rank holds that and a little more: its pool block's own
  trash page a layer (the count splits the global trash page over the
  page shards); ``output_bytes`` the bytes of the outputs the step wrote or made
  (a resident tensor passed through untouched is not one);
  ``temp_bytes`` the peak of the live bytes of the step's own tensors (a
  fresh op output adds its bytes, its collection takes them off), and
  ``peak_bytes`` = argument + temp, as repro reports it.

What one shard runs (``layout``):

A cell's step takes its params and state resident, as a ``ProcessMesh``
rank does: ``build_cell``'s step cuts the global meta arguments to the
shard's own (``Plan.shard``, uncounted) and returns the shard's outputs
in the plan's layout, as repro's ``out_shardings`` leave them.

* ``train`` — ``training/train.make_train_step`` on the plan's runtime:
  the sharded step's body (``fsdp`` or ``sp``). In ``sp`` (here and in prefill) a recurrent layer
  (Mamba2, mLSTM, sLSTM) runs on the gathered sequence, so each shard
  computes the whole sequence's recurrence: ``notes.sp_recurrent_flops``
  is that extra work. Whisper's encoder runs whole on every model shard
  of its row (its 1500 frames are not cut over 16 shards).
* ``prefill`` — ``distributed/sharding.make_prefill_step``'s shard body
  (repro's prefill cell, in the ``sp`` layout: FSDP weights, rows over
  the dp axes, the sequence over ``model``; attention over the rows'
  gathered K/V, each shard writing the pages it owns; a recurrent layer
  on the gathered sequence).
* ``decode`` — ``distributed/sharding.make_decode_step``'s shard body
  (repro's decode cell: ``decode_step`` on the serve slices, Megatron TP
  over ``model``, the shard's rows of its data row, ITPP over its pages,
  a MoE on ``moe_ep_rows``). A
  batch the dp axes do not divide (long_500k's one request) is
  replicated over them, so each data row computes the dense layers'
  1/tp share of the whole request: ``notes.replicated_rows`` is the dp
  size such a cell's dense work repeats over (1 when the rows divide).
* ``--pod-mode pp`` — ``distributed/pipeline.make_pp_decode_step``'s
  shard body (stage 0: its layers for every microbatch, TP inside the
  stage).

Meta tensors launch no kernel: the plans' runtimes take the plain paths,
which do the kernels' products. xLSTM's sLSTM is a Python loop of cell
steps: one step runs and the others are counted as that step's flops and
bytes (forward, and backward where there is one) times their number
(``notes.extrapolated_slstm_steps``); their temp bytes are not tallied.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from dataclasses import replace
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ASSIGNED, SHAPES, ParallelConfig,
                                 applicable_shapes, get_config)
from repro_torch.core.paged_kv import pool_spec_for
from repro_torch.distributed import mesh as M
from repro_torch.distributed.mesh import P
from repro_torch.distributed.sharding import (_leaves, make_decode_step,
                                              make_plan, make_prefill_step)
from repro_torch.launch import roofline as RF
from repro_torch.models import model as MDL
from repro_torch.models import ssm as SSM
from repro_torch.training import optimizer as OPT
from repro_torch.training.train import make_train_step

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
META = torch.device("meta")
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def shape_mesh(*, multi_pod: bool) -> M.ShapeMesh:
    """The production mesh (``mesh.make_production_mesh``) with the
    shape-only backend."""
    m = M.make_production_mesh(multi_pod=multi_pod)
    return M.ShapeMesh(m.sizes, m.axis_names)


def _resident(step, plan, specs):
    """``step`` on global arguments: the leading ones (one for each of
    ``specs``) cut to the shard's resident part at the edge
    (``Plan.shard``, uncounted), the rest (the batch, which the step
    cuts) passed as they are."""
    def f(*args):
        n = len(specs)
        return step(*(plan.shard(a, s) for a, s in zip(args, specs)),
                    *args[n:])
    return f


def input_specs(cfg, shape, parallel, *, mode: str, n_shards: int) -> dict:
    """Meta stand-ins for every model input of a step (repro's
    ``ShapeDtypeStruct``s)."""
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, _DT[cfg.dtype]
    e = lambda *s, dtype=i32: torch.empty(s, dtype=dtype, device=META)
    if mode in ("train", "prefill"):
        d = {"tokens": e(B, S)}
        if mode == "train":
            d["targets"] = e(B, S)
            d["mask"] = e(B, S, dtype=torch.float32)
        if cfg.rope_kind == "mrope":
            d["positions"] = e(3, B, S)
            d["extra_embeds"] = e(B, S, cfg.d_model, dtype=dt)
        if cfg.family == "encdec":
            d["frames"] = e(B, cfg.enc_seq, cfg.d_model, dtype=dt)
        return d
    maxp = pool_spec_for(cfg, shape, parallel,
                         n_shards=n_shards).max_pages_per_req
    d = {"tokens": e(B), "bt": e(B, maxp), "ctx": e(B), "npage": e(B),
         "noff": e(B)}
    if cfg.rope_kind == "mrope":
        d["positions"] = e(3, B, 1)
    return d


def batch_shardings(cfg, shape, plan, *, mode: str) -> dict:
    """The inputs' specs (repro's ``batch_shardings``): a train or
    prefill batch's ``Plan.batch_specs``, a decode batch's rows over the
    dp axes."""
    if mode in ("train", "prefill"):
        return plan.batch_specs(input_specs(cfg, shape, None, mode=mode,
                                            n_shards=plan.mesh.size))
    b = plan.batch_spec
    d = {"tokens": P(b), "bt": P(b, None), "ctx": P(b), "npage": P(b),
         "noff": P(b)}
    if cfg.rope_kind == "mrope":
        d["positions"] = P(None, b, None)
    return d


def build_cell(arch: str, shape_name: str, *, multi_pod: bool,
               pod_mode: str = "dp", parallel: ParallelConfig | None = None):
    """Returns (step_fn, args, in_specs, out_specs, plan): the shard's step,
    its meta arguments and the specs that cut them (and its outputs)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mode = shape.kind
    mesh = shape_mesh(multi_pod=multi_pod)
    parallel = replace(parallel or ParallelConfig(), use_kernels=False)
    plan = make_plan(mesh, parallel, shape, pod_mode=pod_mode)
    moe_virtual = plan.tp if cfg.is_moe else 0
    params = MDL.init_params(cfg, dtype=_DT[cfg.dtype], device=META,
                             moe_virtual=moe_virtual)
    if parallel.serve_quant == "int8" and mode == "decode":
        params = plan.serve_params(params, parallel, mode="decode")
    p_train = plan.param_specs(params, mode="train")
    p_serve = plan.param_specs(params, mode="serve")
    binp = input_specs(cfg, shape, parallel, mode=mode, n_shards=mesh.size)
    bshard = batch_shardings(cfg, shape, plan, mode=mode)

    if mode == "train":
        rt = plan.make_runtime(cfg, parallel, mode="train")
        step = make_train_step(cfg, rt, OPT.AdamWConfig(),
                               microbatches=parallel.microbatches,
                               specs=p_train)
        opt = {"m": MDL.tree_map(lambda p: torch.empty(
            p.shape, dtype=torch.float32, device=META), params),
            "v": MDL.tree_map(lambda p: torch.empty(
                p.shape, dtype=torch.float32, device=META), params),
            "step": torch.empty((), dtype=torch.int32, device=META)}
        opt_spec = {"m": p_train, "v": p_train, "step": P()}
        args = (params, opt, binp)
        return (_resident(step, plan, (p_train, opt_spec)), args,
                (p_train, opt_spec, bshard), (p_train, opt_spec, None), plan)

    pool = pool_spec_for(cfg, shape, parallel, n_shards=mesh.size)
    state = MDL.init_decode_state(cfg, pool, shape.global_batch, device=META)
    s_res = plan.state_specs(state)

    if mode == "prefill":
        step = _resident(make_prefill_step(cfg, plan, parallel, pool,
                                           specs=p_train),
                         plan, (p_train, s_res))
        binp = {**binp, "bt": torch.empty(
            (shape.global_batch, pool.max_pages_per_req), dtype=torch.int32,
            device=META)}
        bshard = plan.batch_specs(binp)
        p_train, s_spec = counted_specs(plan, p_train, state, pp=False)
        return (step, (params, state, binp), (p_train, s_spec, bshard),
                (None, s_spec), plan)

    if pod_mode == "pp" and multi_pod:
        from repro_torch.distributed.pipeline import (make_pp_decode_step,
                                                      stage_specs)
        mb = max(2, min(8, shape.global_batch // max(plan.dp_total, 1)))
        mb = min(mb, shape.global_batch)
        p_serve = stage_specs(plan, p_serve)
        step = _resident(make_pp_decode_step(
            cfg, plan, parallel, pool, n_stages=2, microbatches=mb,
            specs=p_serve), plan, (p_serve, s_res))
        p_serve, s_spec = counted_specs(plan, p_serve, state, pp=True)
        return (step, (params, state, binp), (p_serve, s_spec, bshard),
                (None, s_spec), plan)

    step = _resident(make_decode_step(cfg, plan, parallel, pool,
                                      specs=p_serve), plan, (p_serve, s_res))
    p_serve, s_spec = counted_specs(plan, p_serve, state, pp=False)
    return (step, (params, state, binp), (p_serve, s_spec, bshard),
            (None, s_spec), plan)


def counted_specs(plan, p_spec, state, *, pp: bool):
    """The specs a prefill or decode cell's params and state are counted by
    (``argument_bytes``, repro's shardings): ``p_spec``, the specs the
    step holds its params in (a pipeline's ``pipeline.stage_specs``: a pod
    holds only its stage's layers), and the state's
    ``Plan.decode_state_specs`` (the pool, trash page included, cut over
    the page axes; in a pipeline cell its layers over ``pod`` too). A
    rank's resident state holds a little more: its pool block's own trash
    page a layer (``Plan.state_specs``)."""
    s_spec = plan.decode_state_specs(state)
    if not pp:
        return p_spec, s_spec
    pool = P("pod", plan.page_axes, None, None, None)
    return p_spec, {**s_spec, "pool": {"k": pool, "v": pool}}


# ---------------------------------------------------------------------------
# the counting modes
# ---------------------------------------------------------------------------

class Tally(TorchDispatchMode):
    """Per op: its flops (``FlopCounterMode``'s ``flop_registry``) and the
    bytes of its inputs and outputs (views and the ops that emulate a
    collective on a ``ShapeMesh`` excluded), in total and by op name as
    [bytes, calls, flops]; and the live bytes of the fresh tensors the ops
    make (an in-place op's output is its input), with their peak."""

    def __init__(self, mesh: M.ShapeMesh | None = None):
        super().__init__()
        self.mesh = mesh
        self.bytes = 0.0
        self.flops = 0.0
        self.by_op: dict[str, list[float]] = {}
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (self.mesh is not None and self.mesh.quiet_depth) or func.is_view:
            return out
        packet = func.overloadpacket
        rec = self.by_op.setdefault(str(packet), [0.0, 0, 0.0])
        if packet in flop_registry:
            fl = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += fl
            rec[2] += fl
        ins = [t for t in tree_leaves((args, kwargs)) if torch.is_tensor(t)]
        outs = [t for t in tree_leaves(out) if torch.is_tensor(t)]
        b = float(sum(_nbytes(t) for t in ins + outs))
        self.bytes += b
        rec[0] += b
        rec[1] += 1
        for t in outs:
            if any(t is i for i in ins):
                continue
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


@contextlib.contextmanager
def counting(mesh: M.ShapeMesh | None = None):
    """A ``Tally`` around a step; yields (tally, extra) where ``extra``
    gathers the counts added for the sLSTM steps that do not run."""
    extra = {"flops": 0.0, "bytes": 0.0, "steps": 0}
    with Tally(mesh) as tally, _slstm_extrapolated(extra):
        yield tally, extra


_STEP_COUNTS: dict = {}


def _step_counts(orig, cell, cfg, x_t, state, grad: bool) -> tuple:
    """One sLSTM cell step's (forward, backward) flops and bytes at these
    shapes, measured apart from the cell's tallies."""
    key = (tuple(x_t.shape), x_t.dtype, tuple(cell["r"].shape), grad)
    if key not in _STEP_COUNTS:
        # apart from the modes and from a remat's saved-tensor hooks (its
        # forward and its recompute must save the same tensors)
        with _disable_current_modes(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t):
            rg = lambda t: torch.empty(t.shape, dtype=t.dtype, device=META,
                                       requires_grad=grad)
            c = {"r": rg(cell["r"])}
            x = rg(x_t)
            st = tuple(rg(s) for s in state)
            with Tally() as t1:
                new, h = orig(c, cfg, x, st)
            fwd = (t1.flops, t1.bytes)
            bwd = (0.0, 0.0)
            if grad:
                outs = [*new, h]
                with Tally() as t2:
                    torch.autograd.grad(
                        outs, [c["r"], x, *st],
                        [torch.empty_like(o) for o in outs],
                        allow_unused=True)
                bwd = (t2.flops, t2.bytes)
        _STEP_COUNTS[key] = (fwd, bwd)
    return _STEP_COUNTS[key]


class _AddBackward(torch.autograd.Function):
    """Identity; its backward adds the skipped steps' backward counts."""

    @staticmethod
    def forward(ctx, h, extra, counts):
        ctx.extra, ctx.counts = extra, counts
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        steps, (fl, by) = ctx.counts
        ctx.extra["flops"] += steps[0] * fl
        ctx.extra["bytes"] += steps[0] * by
        return g, None, None


@contextlib.contextmanager
def _slstm_extrapolated(extra: dict):
    """The sLSTM loop's first step runs; each later step of the loop
    passes the carry through and adds the first step's counts."""
    orig = SSM._slstm_cell
    loop = {"cell": None, "counts": None, "steps": None}

    def cell(c, cfg, x_t, state):
        if loop["cell"] is not c:               # a new loop: its first step
            grad = torch.is_grad_enabled() and any(
                t.requires_grad for t in (x_t, c["r"], *state))
            fwd, bwd = _step_counts(orig, c, cfg, x_t, state, grad)
            loop.update(cell=c, counts=(fwd, bwd), steps=[0])
            new, h = orig(c, cfg, x_t, state)
            if grad:
                h = _AddBackward.apply(h, extra, (loop["steps"], bwd))
                new = (*new[:3], h)
            return new, h
        (fl, by), _ = loop["counts"]
        loop["steps"][0] += 1
        extra["flops"] += fl
        extra["bytes"] += by
        extra["steps"] += 1
        return state, state[3].detach()

    SSM._slstm_cell = cell
    try:
        yield
    finally:
        SSM._slstm_cell = orig


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _sp_recurrent_flops(cfg, plan, shape) -> float:
    """In ``sp`` a recurrent layer runs on the gathered sequence: its
    parameters' 6ND (train) or 2ND (prefill) over the tokens a shard
    computes beyond its own (the scan's own products come on top)."""
    if shape.kind == "decode" or plan.train_layout != "sp" \
            or not plan.seq_divisible:
        return 0.0
    rec = {"mamba", "mlstm", "slstm"}
    n = sum(t.numel() for keys, t, _ in _leaves(MDL.init_params(
        cfg, device=META, moe_virtual=plan.tp if cfg.is_moe else 0))
        if keys[0] in rec)
    rows = shape.global_batch // plan.dp_total
    per = 6.0 if shape.kind == "train" else 2.0
    return per * n * rows * shape.seq_len * (1 - 1 / plan.tp)


def _passed(t, ins: dict) -> bool:
    """``t`` is a global argument, or a view of one the step left as it
    was (its version unchanged)."""
    b = t._base if t._is_view() else None
    return id(t) in ins or (b is not None and id(b) in ins
                            and t._version == ins[id(b)])


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             pod_mode: str = "dp", save: bool = True, verbose: bool = True,
             parallel: ParallelConfig | None = None, tag: str = "") -> dict:
    t0 = time.time()
    cell = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    if pod_mode != "dp":
        cell += f"__{pod_mode}"
    if tag:
        cell += f"__{tag}"
    try:
        step, args, in_sh, _, plan = build_cell(
            arch, shape_name, multi_pod=multi_pod, pod_mode=pod_mode,
            parallel=parallel)
        mesh = plan.mesh
        # the global arguments' versions: a resident block (a view of one)
        # the step passes through unwritten is not an output it made
        ins = {id(t): t._version for t in tree_leaves(args)}
        with counting(mesh) as (tally, extra):
            outs = step(*args)
        arg_bytes = sum(M.block_nbytes(a, s, mesh)
                        for a, s in zip(args, in_sh))
        out_bytes = sum(_nbytes(t) for t in tree_leaves(
            outs[:2] if SHAPES[shape_name].kind == "train" else outs)
            if not _passed(t, ins))
        flops = tally.flops + extra["flops"]
        coll = dict(mesh.collectives)
        hlo = {"flops": float(flops),
               "hbm_bytes": tally.bytes + extra["bytes"],
               "collectives": coll,
               "collective_bytes": float(sum(coll.values()))}
        cfg = get_config(arch)
        out = {
            "cell": cell, "arch": arch, "shape": shape_name,
            "multi_pod": multi_pod, "pod_mode": pod_mode, "ok": True,
            "devices": mesh.size,
            "layout": (plan.train_layout
                       if SHAPES[shape_name].kind != "decode" else "serve"),
            "memory": {"argument_bytes": int(arg_bytes),
                       "output_bytes": int(out_bytes),
                       "temp_bytes": int(tally.peak),
                       "peak_bytes": int(arg_bytes + tally.peak)},
            "hlo": hlo,
            "roofline": RF.roofline_terms(hlo),
            "notes": {"extrapolated_slstm_steps": extra["steps"],
                      "sp_recurrent_flops": _sp_recurrent_flops(
                          cfg, plan, SHAPES[shape_name]),
                      "replicated_rows": (
                          plan.dp_total if SHAPES[shape_name].kind
                          == "decode" and not plan.batch_divisible else 1),
                      "dtype": cfg.dtype},
            "t_build_s": round(time.time() - t0, 1),
        }
    except Exception as e:  # noqa: BLE001
        out = {"cell": cell, "arch": arch, "shape": shape_name,
               "multi_pod": multi_pod, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc(limit=20)}
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        (RESULTS / f"{cell}.json").write_text(json.dumps(out, indent=1))
    if verbose:
        if out["ok"]:
            m = out["memory"]["peak_bytes"] / 2**30
            r = out["roofline"]
            print(f"[dryrun] {cell}: OK peak={m:.2f}GiB/dev "
                  f"bottleneck={r['bottleneck']} "
                  f"t=(c{r['t_compute']:.3f} m{r['t_memory']:.3f} "
                  f"x{r['t_collective']:.3f})s build={out['t_build_s']}s",
                  flush=True)
        else:
            print(f"[dryrun] {cell}: FAIL {out['error']}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ASSIGNED)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--pod-mode", default="dp", choices=["dp", "pp"])
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 on the serve path (decode cells)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if not (args.all or args.arch):
        ap.error("name --arch (and --shape) or --all")
    parallel = ParallelConfig(serve_quant="int8") if args.int8 else None
    tag = "int8" if args.int8 else ""
    archs = [args.arch] if args.arch else list(ASSIGNED)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_ok = n_fail = 0
    t0 = time.time()
    for arch in archs:
        shapes = [args.shape] if args.shape else applicable_shapes(arch)
        for shape in shapes:
            for mp in meshes:
                cell = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                if args.pod_mode != "dp":
                    cell += f"__{args.pod_mode}"
                if tag:
                    cell += f"__{tag}"
                path = RESULTS / f"{cell}.json"
                if args.skip_existing and path.exists() \
                        and json.loads(path.read_text()).get("ok"):
                    print(f"[dryrun] {cell}: cached OK", flush=True)
                    n_ok += 1
                    continue
                res = run_cell(arch, shape, multi_pod=mp,
                               pod_mode=args.pod_mode, parallel=parallel,
                               tag=tag)
                n_ok += res["ok"]
                n_fail += not res["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed in "
          f"{time.time() - t0:.1f} s", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
