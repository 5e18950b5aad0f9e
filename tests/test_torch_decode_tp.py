"""The sharded decode step (``distributed/sharding.make_decode_step``:
``decode_step`` as a Megatron-TP shard body on the serve plan's slices)
against repro's decode cell, on the CPU.

ONE module-scoped subprocess forces 8 host devices and runs repro's
``decode_step`` jitted under the serve plan's shardings ``(p_serve,
s_spec, batch)`` on a (data 2, model 4) mesh, as its dry-run cell does,
with ``REPLICATE_SMALL`` at 0 so that every divisible leaf is cut at
these reduced widths (fp32 llama3.2-1b, gemma3-27b with its mixed
local:global stack on ``cond_window`` and its tied head, phi3.5-moe on
``moe_ep``, the zamba2-1.2b hybrid): an unsharded prefill of 4 rows, then
4 greedy steps. Its weights, prefilled state, logits, tokens and final
pool land in an ``.npz``.

The port converts the weights (``models/convert.py``), takes the same
prefilled state and runs ``make_decode_step`` on a ``LocalMesh`` fed
repro's tokens, on the plain path and with the kernel wrappers (their
plain versions here): the greedy tokens equal repro's, the logits are
within 1e-5 of their scale, the written pool pages and carry within 1e-5
of theirs, and every shard's weight leaves have their serve-slice shapes.
The other families (xLSTM, whisper, qwen2-vl's M-RoPE, mixtral's
windowed MoE, int8 serve weights, a request replicated over the data
axis) are held to the port's unsharded ``decode_step``.
"""
import contextlib
import math
import os
import subprocess
import sys
import threading
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ParallelConfig, ShapeConfig, get_config, reduced
from repro_torch.core import paged_kv as PK
from repro_torch.core.allocator import PageAllocator
from repro_torch.distributed import mesh as M
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.pipeline import (make_pp_decode_step,
                                              stage_specs)
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_numpy, state_from_numpy

SRC = Path(__file__).resolve().parent.parent / "src"
JAX_ARCHS = ("llama3.2-1b", "gemma3-27b", "phi3.5-moe-42b-a6.6b",
             "zamba2-1.2b")
B, PAGE, STEPS, N_PAGES = 4, 4, 4, 64

JAX_PROG = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platform_name", "cpu")
from dataclasses import replace
from jax.sharding import PartitionSpec as P
from repro.core.jax_compat import make_mesh
from repro.core.allocator import PageAllocator
from repro.core.paged_kv import PoolSpec
from repro.configs import get_config, reduced, ParallelConfig, ShapeConfig
from repro.distributed import sharding as SH
from repro.models import model as MDL
SH.REPLICATE_SMALL = 0          # every divisible leaf cut at these widths
B, page, steps, n_pages = %d, %d, %d, %d
mesh = make_mesh((2, 4), ("data", "model"))
out = {}

def flat(prefix, tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in leaves:
        keys = [str(getattr(q, "key", getattr(q, "idx", q))) for q in path]
        out[prefix + "/".join(keys)] = np.asarray(leaf)

for arch in sys.argv[2:]:
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = MDL.init_params(cfg, jax.random.PRNGKey(0), jnp.float32,
                             moe_virtual=4 if cfg.is_moe else 0)
    rng = np.random.default_rng(7)
    lens = rng.integers(8, 25, B).astype(np.int32)
    S = int(lens.max())
    maxp = (S + steps) // page + 1
    n_attn = sum(k in ("attn", "local") for k in cfg.block_kinds())
    pool = PoolSpec(n_attn, n_pages, page, cfg.n_kv_heads, cfg.d_head, maxp,
                    dtype="float32")
    alloc = PageAllocator(n_pages, 8, page, policy="row_affine", n_rows=2)
    for b in range(B):
        alloc.admit(b, int(lens[b]) + steps, row=b // 2)
    bt = np.stack([alloc.block_table(b, maxp) for b in range(B)])
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    state = MDL.init_decode_state(cfg, pool, B, dtype="float32")
    lg0, state = jax.jit(lambda p, s, t, b: MDL.prefill(
        cfg, p, s, t, b, last_idx=jnp.asarray(lens - 1),
        valid_len=jnp.asarray(lens)))(params, state, jnp.asarray(toks),
                                      jnp.asarray(bt))
    flat(arch + "/params/", params)
    flat(arch + "/state/", state)
    parallel = ParallelConfig(dp=2, tp=4, page_size=page, use_pallas=False)
    plan = SH.make_plan(mesh, parallel, ShapeConfig("d", "decode",
                                                    S + steps, B))
    rt = plan.make_runtime(cfg, parallel, pool_spec=pool, mode="decode")
    b_ = plan.batch_spec
    bshard = {"tokens": P(b_), "bt": P(b_, None), "ctx": P(b_),
              "npage": P(b_), "noff": P(b_)}
    s_spec = plan.decode_state_specs(state)
    step = jax.jit(
        lambda p, s, bb: MDL.decode_step(cfg, p, s, bb["tokens"], bb["bt"],
                                         bb["ctx"], bb["npage"], bb["noff"],
                                         rt=rt),
        in_shardings=(plan.named(plan.param_specs(params, mode="serve")),
                      plan.named(s_spec), plan.named(bshard)),
        out_shardings=(None, plan.named(s_spec)))
    V = cfg.vocab_size
    tok = np.asarray(lg0)[:, :V].argmax(-1).astype(np.int32)
    toks_d, lgs = [tok], []
    for j in range(steps):
        pos = lens + j
        batch = {"tokens": jnp.asarray(tok), "bt": jnp.asarray(bt),
                 "ctx": jnp.asarray(pos + 1),
                 "npage": jnp.asarray(bt[np.arange(B), pos // page]),
                 "noff": jnp.asarray(pos %% page)}
        lg, state = step(params, state, batch)
        lgs.append(np.asarray(lg))
        tok = lgs[-1][:, :V].argmax(-1).astype(np.int32)
        toks_d.append(tok)
    flat(arch + "/out/", state)
    out.update({arch + "/lens": lens, arch + "/bt": bt,
                arch + "/logits": np.stack(lgs),
                arch + "/tokens": np.stack(toks_d)})
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
""" % (B, PAGE, STEPS, N_PAGES)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Serial torch in this file: the LocalMesh runs 8 shard threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_decode_tp") / "ref.npz"
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", JAX_PROG, str(path),
                        *JAX_ARCHS], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0 and "JAX_REF_OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _sub(ref, tag) -> dict:
    n = len(tag) + 1
    return {k[n:]: v for k, v in ref.items() if k.startswith(tag + "/")}


def _tree(flat: dict):
    """A '/'-keyed flat dict back into dicts; a node whose keys are
    0..n-1 becomes a tuple (repro's carries)."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if set(node) == {str(i) for i in range(len(node))}:
            return tuple(node[str(i)] for i in range(len(node)))
        return node
    return fix(tree)


def _port_state(cfg, jstate: dict, maxp: int):
    """repro's decode state as the port keeps it: the pool with its trash
    page, the carries as tensors."""
    st = {}
    for k, v in jstate.items():
        if k == "pool":
            st[k] = {n: torch.cat([torch.from_numpy(np.array(a)),
                                   torch.zeros_like(torch.from_numpy(
                                       np.array(a[:, :1])))], dim=1)
                     for n, a in v.items()}
        else:
            st[k] = state_from_numpy(v, device="cpu")
    return st


def _walk(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _walk(v)
    elif isinstance(t, (tuple, list)):
        for v in t:
            yield from _walk(v)
    else:
        yield t


def _close(a, b, what, tol=1e-5):
    scale = max(float(b.abs().max()), 1e-30)
    gap = float((a - b).abs().max())
    assert gap <= tol * scale, (what, gap, scale)


def _recording_shards(monkeypatch) -> list:
    """Record, per shard call of ``decode_step``, its weight leaves'
    shapes."""
    seen, lock = [], threading.Lock()
    orig = SH.MDL.decode_step

    def rec(cfg, params, *a, **kw):
        with lock:
            seen.append([tuple(t.shape) for _, t, _ in SH._leaves(params)])
        return orig(cfg, params, *a, **kw)
    monkeypatch.setattr(SH.MDL, "decode_step", rec)
    return seen


def _slice_shapes(plan, params) -> list:
    sizes = plan.axis_sizes
    out = []
    for (_, t, _), spec in zip(SH._leaves(params),
                               plan.spec_list(params, mode="serve")):
        shape = list(t.shape)
        for d, e in enumerate(spec):
            if e is not None:
                shape[d] //= int(np.prod([sizes[a] for a in M._names(e)]))
        out.append(tuple(shape))
    return out


@pytest.mark.parametrize("path", ["plain", "kernels"])
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_decode_step_matches_repros_decode_cell(ref, arch, path,
                                                monkeypatch):
    """``make_decode_step`` on a (data 2, model 4) LocalMesh against
    repro's decode cell (its ``decode_step`` jitted under the serve
    plan's shardings on 8 host devices), from the same prefilled state
    and fed repro's greedy tokens: 4 steps, tokens identical, logits
    within 1e-5 of their scale, the pool pages and the carry within 1e-5
    of repro's; every shard holds its serve slices."""
    monkeypatch.setattr(SH, "REPLICATE_SMALL", 0)
    c = _sub(ref, arch)
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = params_from_numpy(cfg, _tree(_sub(c, "params")), device="cpu")
    bt, lens = torch.from_numpy(c["bt"]).to(torch.int32), c["lens"]
    maxp = bt.shape[1]
    S = int(lens.max())
    n_attn = sum(k in ("attn", "local") for k in cfg.block_kinds())
    spec = PK.PoolSpec(n_attn, N_PAGES, PAGE, cfg.n_kv_heads, cfg.d_head,
                       maxp, dtype="float32")
    mesh = M.LocalMesh((2, 4), ("data", "model"))
    parallel = ParallelConfig(page_size=PAGE,
                              use_kernels=None if path == "kernels"
                              else False)
    plan = SH.make_plan(mesh, parallel, ShapeConfig("d", "decode",
                                                    S + STEPS, B))
    step = SH.make_decode_step(cfg, plan, parallel, spec,
                               specs=plan.param_specs(params, mode="serve"))
    assert step.rt.tp_axis == "model"
    assert step.rt.cond_window == (cfg.sliding_window
                                   if arch == "gemma3-27b" else 0)
    seen = _recording_shards(monkeypatch)
    state = _port_state(cfg, _tree(_sub(c, "state")), maxp)
    toks = torch.from_numpy(c["tokens"]).to(torch.int32)
    V = cfg.vocab_size
    rows = torch.arange(B)
    for j in range(STEPS):
        pos = torch.from_numpy(lens + j).to(torch.int32)
        batch = {"tokens": toks[j], "bt": bt, "ctx": pos + 1,
                 "npage": bt[rows, (pos // PAGE).long()].contiguous(),
                 "noff": (pos % PAGE).to(torch.int32)}
        lg, state = step(params, state, batch)
        want = torch.from_numpy(c["logits"][j])
        _close(lg, want, (arch, path, j))
        assert torch.equal(lg[:, :V].argmax(-1).to(torch.int32),
                           toks[j + 1]), (arch, path, j)
    out = _tree(_sub(c, "out"))
    for k, v in out.items():
        got = state[k]
        if k == "pool":
            for n in ("k", "v"):
                _close(got[n][:, :N_PAGES], torch.from_numpy(v[n]), (k, n))
        else:
            for a, b in zip(_walk(got), _walk(state_from_numpy(v, "cpu"))):
                _close(a, b, k)
    want = _slice_shapes(plan, params)
    assert len(seen) == STEPS * mesh.size
    assert all(s == want for s in seen)
    assert any(s != tuple(t.shape) for s, (_, t, _) in
               zip(want, SH._leaves(params)))     # something was cut


# ---------------------------------------------------------------------------
# the other families, against the port's unsharded decode_step
# ---------------------------------------------------------------------------

def _unsharded_case(cfg, params, *, rows: int, mesh_shape=(2, 4),
                    path="plain", parallel_kw=None, seed=7):
    """Prefill ``rows`` requests unsharded, then 4 greedy steps of
    ``make_decode_step`` on a LocalMesh and of the unsharded
    ``decode_step`` fed the same tokens; returns the per-step gaps
    checked inside and the final states."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(8, 25, (rows,), generator=g)
    S = int(lens.max())
    maxp = (S + STEPS) // PAGE + 1
    n_attn = cfg.n_layers if cfg.family == "encdec" else max(
        1, sum(k in ("attn", "local") for k in cfg.block_kinds()))
    parallel = ParallelConfig(page_size=PAGE, **(parallel_kw or {}),
                              use_kernels=None if path == "kernels"
                              else False)
    spec = PK.PoolSpec(n_attn, N_PAGES, PAGE, cfg.n_kv_heads, cfg.d_head,
                       maxp, dtype="float32")
    mesh = M.LocalMesh(mesh_shape, ("data", "model"))
    plan = SH.make_plan(mesh, parallel, ShapeConfig("d", "decode",
                                                    S + STEPS, rows))
    divisible = plan.batch_divisible
    alloc = (PageAllocator(N_PAGES, mesh.size, PAGE, policy="row_affine",
                           n_rows=mesh_shape[0]) if divisible else
             PageAllocator(N_PAGES, mesh.size, PAGE, policy="striped"))
    per_row = rows // mesh_shape[0]
    for b in range(rows):
        if divisible:
            alloc.admit(b, int(lens[b]) + STEPS, row=b // per_row)
        else:
            alloc.admit(b, int(lens[b]) + STEPS)
    bt = torch.from_numpy(np.stack([alloc.block_table(b, maxp)
                                    for b in range(rows)])).to(torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (rows, S), generator=g)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = 0.1 * torch.randn(rows, cfg.enc_seq, cfg.d_model,
                                         generator=g)
    sparams = plan.serve_params(params, parallel, mode="decode")
    state = MDL.init_decode_state(cfg, spec, rows, device="cpu")
    lg, state = MDL.prefill(cfg, sparams, state, toks, bt,
                            last_idx=lens - 1, valid_len=lens, **kw)
    state_u = MDL.tree_map(torch.clone, state)
    step = SH.make_decode_step(cfg, plan, parallel, spec,
                               specs=plan.param_specs(sparams, mode="serve"))
    rt_u = MDL.Runtime(kernels=None if path == "plain" else KernelConfig())
    V = cfg.vocab_size
    tok = lg[:, :V].argmax(-1).to(torch.int32)
    r = torch.arange(rows)
    for j in range(STEPS):
        pos = (lens + j).to(torch.int32)
        batch = {"tokens": tok, "bt": bt, "ctx": pos + 1,
                 "npage": bt[r, (pos // PAGE).long()].contiguous(),
                 "noff": (pos % PAGE).to(torch.int32)}
        if cfg.rope_kind == "mrope":
            batch["positions"] = pos.long()[None, :, None].expand(
                3, rows, 1).contiguous()
        lg_s, state = step(sparams, state, batch)
        lg_u, state_u = MDL.decode_step(
            cfg, sparams, state_u, tok, bt, batch["ctx"], batch["npage"],
            batch["noff"], positions=batch.get("positions"), rt=rt_u)
        _close(lg_s, lg_u, (cfg.name, j))
        assert torch.equal(lg_s[:, :V].argmax(-1), lg_u[:, :V].argmax(-1))
        tok = lg_s[:, :V].argmax(-1).to(torch.int32)
    assert set(state) == set(state_u)
    for k in state:
        for a, b in zip(_walk(state[k]), _walk(state_u[k])):
            if k == "pool":
                a, b = a[:, :N_PAGES], b[:, :N_PAGES]
            _close(a, b, (cfg.name, k))
    return plan


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-small",
                                  "qwen2-vl-7b", "mixtral-8x22b"])
def test_decode_step_families_match_unsharded(arch, monkeypatch):
    """xLSTM (mLSTM TP, the sLSTM whole), whisper's cross-attention
    decode, qwen2-vl's M-RoPE positions and mixtral's MoE on an
    all-windowed stack: ``make_decode_step`` on (data 2, model 4) equals
    the unsharded ``decode_step`` (tokens, logits within 1e-5 of scale,
    pool pages, carry and cross rows)."""
    monkeypatch.setattr(SH, "REPLICATE_SMALL", 0)
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    if cfg.is_moe:
        cfg = replace(cfg, capacity_factor=8.0)
    params = MDL.init_params(cfg, seed=3, device="cpu",
                             moe_virtual=4 if cfg.is_moe else 0)
    _unsharded_case(cfg, params, rows=4)


@pytest.mark.parametrize("path", ["plain", "kernels"])
@pytest.mark.parametrize("arch", ["gemma3-27b", "zamba2-1.2b"])
def test_decode_step_replicated_request(arch, path, monkeypatch):
    """long_500k's layout: one request, which the data axis does not
    divide, replicated over it and striped over all 8 shards (ITPP merged
    over both axes), the dense layers TP over ``model`` on every data
    row (the Mamba2 carry advanced by each shard on its own copy)."""
    monkeypatch.setattr(SH, "REPLICATE_SMALL", 0)
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = MDL.init_params(cfg, seed=4, device="cpu")
    plan = _unsharded_case(cfg, params, rows=1, path=path)
    assert not plan.batch_divisible
    assert plan.itpp_spec(PAGE).merge_axes == ("data", "model")


def test_decode_step_int8_serve_weights(monkeypatch):
    """int8 weight-only serve weights (``serve_quant="int8"``): a column
    slice cuts a QTensor's ``q`` and the shard computes with its columns'
    scale (the plan leaves the scale whole under its size floor, 1024
    here), a row slice keeps the scale whole."""
    from repro_torch.core.quant import is_qtensor
    monkeypatch.setattr(SH, "REPLICATE_SMALL", 1024)
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32",
                  d_model=256, d_head=64, d_ff=512)
    params = MDL.init_params(cfg, seed=6, device="cpu")
    plan = _unsharded_case(cfg, params, rows=4,
                           parallel_kw={"serve_quant": "int8"})
    q = plan.serve_params(params, ParallelConfig(serve_quant="int8"),
                          mode="decode")
    wq = q["layers"][0]["attn"]["wq"]
    assert is_qtensor(wq)
    specs = dict(zip((k for k, _, _ in SH._leaves(q)),
                     plan.spec_list(q, mode="serve")))
    assert specs[("layers", "0", "attn", "wq", "q")] == (None, "model")
    assert specs[("layers", "0", "attn", "wq", "s")] == ()
    assert specs[("layers", "0", "attn", "wo", "q")] == ("model", None)


# ---------------------------------------------------------------------------
# the gloo ProcessMesh cases (tests/test_torch_distributed.py runs them on
# 8 ranks and holds them to the LocalMesh bit for bit): the sharded steps
# on resident params and state, gathered only at the end
# ---------------------------------------------------------------------------

GLOO_ARCHS = ("gemma3-27b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b")


@contextlib.contextmanager
def assembly_counter(mesh):
    """The bytes this rank sends through collectives while ``shard_map``
    assembles a step's outputs on a ``ProcessMesh`` (a ``LocalMesh``
    assembles from views and sends none)."""
    moved, depth = {"bytes": 0}, [0]
    asm = M._assemble_process

    def counted(*a, **kw):
        depth[0] += 1
        try:
            return asm(*a, **kw)
        finally:
            depth[0] -= 1

    def wrap(fn):
        def f(rank, axes, x):
            if depth[0]:
                moved["bytes"] += x.numel() * x.element_size()
            return fn(rank, axes, x)
        return f
    M._assemble_process = counted
    mesh._gather, mesh._all_to_all = wrap(mesh._gather), wrap(
        mesh._all_to_all)
    try:
        yield moved
    finally:
        M._assemble_process = asm
        del mesh._gather, mesh._all_to_all


def nbytes(tree) -> int:
    """The bytes of a tree's tensors, each storage once."""
    seen, n = set(), 0
    for t, _ in M.leaf_specs(tree, None):
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            n += t.numel() * t.element_size()
    return n


def beyond_count(plan, state, *, pp: bool) -> int:
    """The bytes a rank holds beyond the dry-run's ``argument_bytes`` for
    the same params and decode state (``dryrun.counted_specs``), from the
    shapes: each pool block's own trash page (the rank's N/n pages and a
    trash page a layer of its stage, against the global N+1 pages over the
    n page shards)."""
    n = math.prod(plan.axis_sizes[a] for a in plan.page_axes)
    st = plan.axis_sizes["pod"] if pp else 1
    gap = 0
    for t in state["pool"].values():
        L, pages = t.shape[:2]
        pb = t[0, 0].numel() * t.element_size()
        gap += (L // st * ((pages - 1) // n + 1) * pb
                - L * pages * pb // (st * n))
    return gap


def resident_facts(plan, trees, resident, specs, ptrs, moved, *,
                   counted=None, beyond: int = 0) -> dict:
    """What a rank holds and moves: its resident bytes against the plan's
    count of its slices (``Plan.local_bytes``) and against the dry-run's
    ``argument_bytes`` rule (``block_nbytes`` on the specs ``build_cell``
    counts these trees by, ``counted``; ``specs`` by default) with what
    the rank holds beyond that count (``beyond``); the pool block's
    storage before and after the steps; the assembly's bytes."""
    return {"held": np.int64(sum(nbytes(r) for r in resident)),
            "want": np.int64(sum(plan.local_bytes(t, s)
                                 for t, s in zip(trees, specs))),
            "want_dryrun": np.int64(sum(M.block_nbytes(t, s, plan.mesh)
                                        for t, s in zip(trees,
                                                        counted or specs))),
            "beyond_dryrun": np.int64(beyond),
            "same_storage": np.bool_(ptrs[0] == ptrs[1]),
            "moved": np.int64(moved)}


def serve_facts(plan, params, state, resident, p_spec, s_spec, ptrs,
                moved, *, pp: bool = False) -> dict:
    """``resident_facts`` of a prefill or decode rank: its params and
    decode state, counted as the dry-run's cell counts them."""
    from repro_torch.launch.dryrun import counted_specs
    return resident_facts(
        plan, (params, state), resident, (p_spec, s_spec), ptrs, moved,
        counted=counted_specs(plan, p_spec, state, pp=pp),
        beyond=beyond_count(plan, state, pp=pp))


def decode_tp_run(mesh, arch: str, facts: dict | None = None) -> dict:
    """``STEPS`` steps of ``make_decode_step`` on ``mesh`` ((data 2, model
    4)) from an unsharded prefill of 4 rows, the caller having set
    ``REPLICATE_SMALL`` to 0: the params and state cut to the rank's own
    at the start (``Plan.shard``) and gathered at the end
    (``Plan.gather``), its logits and pool pages (and carry) as numpy.
    ``facts`` gets ``resident_facts`` and the logits' share of the
    assembly's bytes (``logits``)."""
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = MDL.init_params(cfg, seed=2, device="cpu",
                             moe_virtual=4 if cfg.is_moe else 0)
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(8, 25, (B,), generator=g)
    S, steps = int(lens.max()), STEPS
    maxp = (S + steps) // PAGE + 1
    spec = PK.PoolSpec(cfg.n_layers, N_PAGES, PAGE, cfg.n_kv_heads,
                       cfg.d_head, maxp, dtype="float32")
    alloc = PageAllocator(N_PAGES, 8, PAGE, policy="row_affine", n_rows=2)
    for b in range(B):
        alloc.admit(b, int(lens[b]) + steps, row=b // 2)
    bt = torch.from_numpy(np.stack([alloc.block_table(b, maxp)
                                    for b in range(B)])).to(torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    state = MDL.init_decode_state(cfg, spec, B, device="cpu")
    lg, state = MDL.prefill(cfg, params, state, toks, bt,
                            last_idx=lens - 1, valid_len=lens)
    parallel = ParallelConfig(page_size=PAGE)
    plan = SH.make_plan(mesh, parallel, ShapeConfig("d", "decode",
                                                    S + steps, B))
    p_spec = plan.param_specs(params, mode="serve")
    s_spec = plan.state_specs(state)
    step = SH.make_decode_step(cfg, plan, parallel, spec, specs=p_spec)
    p_loc, st = plan.shard(params, p_spec), plan.shard(state, s_spec)
    ptr = st["pool"]["k"].data_ptr()
    tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    rows, out = torch.arange(B), {}
    with assembly_counter(mesh) as moved:
        for j in range(steps):
            pos = (lens + j).to(torch.int32)
            lg, st = step(p_loc, st, {
                "tokens": tok, "bt": bt, "ctx": pos + 1,
                "npage": bt[rows, (pos // PAGE).long()].contiguous(),
                "noff": (pos % PAGE).to(torch.int32)})
            out[f"logits{j}"] = lg.numpy()
            tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    if facts is not None:
        facts.update(serve_facts(
            plan, params, state, (p_loc, st), p_spec, s_spec,
            (ptr, st["pool"]["k"].data_ptr()), moved["bytes"]))
        # a rank sends its [B/2, V/4] block over data, then [B, V/4] over
        # model (a tied head's logits: [B/2, V] over data), each step: the
        # logits, nothing else
        cut = SH.serve_args(plan, params, p_spec)[3]
        facts["logits"] = np.int64(steps * lg.numel() * 4
                                   * (3 if cut else 4) // 8)
    full = plan.gather(st, s_spec)
    out["pool_k"] = full["pool"]["k"][:, :N_PAGES].numpy()
    out["pool_v"] = full["pool"]["v"][:, :N_PAGES].numpy()
    for k in ("mamba",):
        if k in full:
            out.update({f"{k}{i}": x.numpy() for i, (x, _) in enumerate(
                M.leaf_specs(full[k], None))})
    return out


PREFILL_ARCHS = ("llama3.2-1b", "zamba2-1.2b")


def prefill_tp_run(mesh, arch: str, facts: dict | None = None) -> dict:
    """``make_prefill_step`` (the ``sp`` layout) on ``mesh`` ((data 2,
    model 4)), ``REPLICATE_SMALL`` at 0: 2 rows of 32 tokens (one valid to
    27), the params and a fresh state cut to the rank's own, the pages a
    rank owns written into its block, gathered at the end: logits, pool
    pages and carry as numpy."""
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = MDL.init_params(cfg, seed=0, device="cpu")
    Bp, S = 2, 32
    parallel = ParallelConfig(page_size=PAGE)
    shape = ShapeConfig("p", "prefill", S, Bp)
    plan = SH.make_plan(mesh, parallel, shape)
    spec = PK.pool_spec_for(cfg, shape, parallel, n_shards=8,
                            slack_pages=16)
    alloc = PageAllocator(spec.n_pages, 8, PAGE, policy="row_affine",
                          n_rows=2)
    for b in range(Bp):
        alloc.admit(b, S, row=b)
    bt = torch.from_numpy(np.stack([alloc.block_table(
        b, spec.max_pages_per_req) for b in range(Bp)])).to(torch.int32)
    g = torch.Generator().manual_seed(1)
    lens = torch.tensor([S, S - 5])
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (Bp, S),
                                     generator=g), "bt": bt,
             "valid_len": lens, "last_idx": lens - 1}
    state = MDL.init_decode_state(cfg, spec, Bp, device="cpu")
    p_spec = plan.param_specs(params, mode="train")
    s_spec = plan.state_specs(state)
    step = SH.make_prefill_step(cfg, plan, parallel, spec, specs=p_spec)
    p_loc, st = plan.shard(params, p_spec), plan.shard(state, s_spec)
    ptr = st["pool"]["k"].data_ptr()
    with assembly_counter(mesh) as moved:
        lg, st = step(p_loc, st, batch)
    if facts is not None:
        facts.update(serve_facts(
            plan, params, state, (p_loc, st), p_spec, s_spec,
            (ptr, st["pool"]["k"].data_ptr()), moved["bytes"]))
        facts["logits"] = np.int64(lg.numel() * 4 // 2)  # [1, V] over data
    full = plan.gather(st, s_spec)
    out = {"logits": lg.numpy()}
    for k, v in full.items():       # the pool's pages, not its trash page
        out.update({f"{k}{i}": (x[:, :-1] if k == "pool" else x).numpy()
                    for i, (x, _) in enumerate(M.leaf_specs(v, None))})
    return out


def pp_tp_run(mesh, facts: dict | None = None) -> dict:
    """GPipe decode (``make_pp_decode_step``, 2 stages, 2 microbatches) of
    reduced llama3.2-1b (4 layers) on ``mesh`` ((pod 2, data 2, model
    2)), ``REPLICATE_SMALL`` at 0: 4 rows prefilled to 8 tokens
    unsharded, then 4 steps on the rank's serve slices of its stage's
    layers (``stage_specs``) and its stage's pool block, gathered at the
    end: logits and pool pages as numpy. ``facts`` also gets the rank's
    layer count and whether the params gathered from the stages are the
    global ones."""
    cfg = replace(reduced(get_config("llama3.2-1b"), layers=4),
                  dtype="float32")
    params = MDL.init_params(cfg, seed=4, device="cpu")
    S_pre, S, n_pages = 8, 12, 32
    maxp = S // PAGE + 1
    parallel = ParallelConfig(page_size=PAGE)
    plan = SH.make_plan(mesh, parallel, ShapeConfig("d", "decode", S, B),
                        pod_mode="pp")
    spec = PK.PoolSpec(cfg.n_layers, n_pages, PAGE, cfg.n_kv_heads,
                       cfg.d_head, maxp, dtype="float32")
    alloc = PageAllocator(n_pages, 4, PAGE, policy="row_affine", n_rows=2)
    for b in range(B):
        alloc.admit(b, S, row=b // 2)
    bt = torch.from_numpy(np.stack([alloc.block_table(b, maxp)
                                    for b in range(B)])).to(torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(5))
    state = MDL.init_decode_state(cfg, spec, B, device="cpu")
    MDL.prefill(cfg, params, state, toks[:, :S_pre], bt)
    p_spec = stage_specs(plan, plan.param_specs(params, mode="serve"))
    s_spec = plan.state_specs(state)
    step = make_pp_decode_step(cfg, plan, parallel, spec, n_stages=2,
                               microbatches=2, specs=p_spec)
    p_loc, st = plan.shard(params, p_spec), plan.shard(state, s_spec)
    ptr, out = st["pool"]["k"].data_ptr(), {}
    with assembly_counter(mesh) as moved:
        for j, t in enumerate(range(S_pre, S)):
            lg, st = step(p_loc, st, {
                "tokens": toks[:, t], "bt": bt,
                "ctx": torch.full((B,), t + 1, dtype=torch.int32),
                "npage": bt[:, t // PAGE].clone(),
                "noff": torch.full((B,), t % PAGE, dtype=torch.int32)})
            out[f"logits{j}"] = lg.numpy()
    if facts is not None:
        facts.update(serve_facts(
            plan, params, state, (p_loc, st), p_spec, s_spec,
            (ptr, st["pool"]["k"].data_ptr()), moved["bytes"], pp=True))
        facts["layers"] = np.int64(len(p_loc["layers"]))
        facts["n_layers"] = np.int64(cfg.n_layers)
        whole = plan.gather(p_loc, p_spec)
        facts["gathered_params"] = np.bool_(
            len(whole["layers"]) == cfg.n_layers and all(
                torch.equal(a, b) for (a, _), (b, _) in zip(
                    M.leaf_specs(whole, None), M.leaf_specs(params, None))))
        # the stage's logits come back summed over pod and gathered over
        # data inside the body; the assembly gathers [B, V/2] over model
        cut = SH.serve_args(plan, {k: v for k, v in params.items()
                                   if k != "layers"}, p_spec)[3]
        facts["logits"] = np.int64((S - S_pre) * lg.numel() * 4 // 2
                                   if cut else 0)
    full = plan.gather(st, s_spec)
    out["pool_k"] = full["pool"]["k"][:, :n_pages].numpy()
    out["pool_v"] = full["pool"]["v"][:, :n_pages].numpy()
    return out
