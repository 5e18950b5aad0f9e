"""repro_torch's multi-shard serving paths against repro's, on the CPU.

The inputs are those of ``tests/test_distributed.py``: ONE module-scoped
subprocess forces 8 host devices (``--xla_force_host_platform_device_count``,
which must precede jax's first use, so it cannot run in this process),
makes the inputs as that file does, runs repro's sharded paths and writes
inputs and outputs to an ``.npz``: the striped 8-shard ITPP, the 2 x 4
long-context request (one request over every shard), the sequence-sharded
prefill writer, ``moe_ep`` over 8 shards, and GPipe decode over (pod 2,
data 2, model 2). repro's single-device oracles (``write_token`` +
``paged_decode_attention_ref``, ``write_prefill``, ``moe_local``,
``forward``) run in this process. The sharded decode step's own
reference (repro's decode cell under the serve shardings) is
``tests/test_torch_decode_tp.py``'s.

The port runs each case on a single-process ``LocalMesh`` (8 shards as
threads), with the plain path and with the kernel wrappers (their plain
versions here). The 8-shard ITPP merge, ``moe_ep``'s ``all_to_all`` and
the sharded steps — the Megatron-TP decode step
(``sharding.make_decode_step`` on (data 2, model 4)), the sharded prefill
and the pipeline — also run on an 8-rank ``gloo`` ``ProcessMesh`` (8
local processes) on each rank's resident state (``Plan.shard``, gathered
at the end) and must equal the ``LocalMesh`` bit for bit; rank 0's
resident bytes, pool storage and output assembly are held too. ``make_plan``,
``Plan.itpp_spec`` and ``param_specs`` equal repro's on repro's
``abstract_mesh`` with ``PartitionSpec``s read as tuples.
"""
import os
import socket
import subprocess
import sys
from dataclasses import asdict, fields, replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import ParallelConfig as JParallel
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import paged_kv as JPK
from repro.distributed.sharding import abstract_mesh as jax_abstract_mesh
from repro.distributed.sharding import make_plan as jax_make_plan
from repro.models import model as JMDL
from repro.models import moe as JMOE
from repro_torch.configs import SHAPES, ParallelConfig, ShapeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core import itpp as IT
from repro_torch.core import paged_kv as PK
from repro_torch.core.allocator import PageAllocator
from repro_torch.distributed import mesh as M
from repro_torch.distributed.pipeline import (make_pp_decode_step,
                                              stage_specs)
from repro_torch.distributed.sharding import abstract_mesh, make_plan
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models import model as MDL
from repro_torch.models import moe as MOE
from repro_torch.models.convert import params_from_numpy

SRC = Path(__file__).resolve().parent.parent / "src"
KERNELS = {"plain": None, "kernels": KernelConfig()}
ASSIGNED = ("llama3.2-1b", "internlm2-1.8b", "yi-34b", "gemma3-27b",
            "xlstm-350m", "whisper-small", "mixtral-8x22b",
            "phi3.5-moe-42b-a6.6b", "qwen2-vl-7b", "zamba2-1.2b")

# repro's sharded paths on 8 forced host devices, on the inputs of
# tests/test_distributed.py; every array lands in one .npz
JAX_PROG = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platform_name", "cpu")
from dataclasses import replace
from jax.sharding import PartitionSpec as P
from repro.core.jax_compat import make_mesh, shard_map
from repro.core import paged_kv as PK, itpp as IT
from repro.core.allocator import PageAllocator
from repro.configs import get_config, reduced, ParallelConfig, ShapeConfig
out = {}

def itpp_case(tag, B, H, KVH, D, page, maxp, n_pages, ctx_prev, mesh_shape,
              axes, merge):
    alloc = PageAllocator(n_pages, 8, page, policy="striped")
    bts = []
    for b in range(B):
        alloc.admit(b, int(ctx_prev[b]) + 1)
        bts.append(alloc.block_table(b, maxp))
    bt = jnp.asarray(np.stack(bts))
    pool_k = jax.random.normal(jax.random.PRNGKey(0), (n_pages, page, KVH, D))
    pool_v = jax.random.normal(jax.random.PRNGKey(1), (n_pages, page, KVH, D))
    q = jax.random.normal(jax.random.PRNGKey(2), (B, H, D))
    k_new = jax.random.normal(jax.random.PRNGKey(3), (B, KVH, D))
    v_new = jax.random.normal(jax.random.PRNGKey(4), (B, KVH, D))
    ctx = jnp.asarray(ctx_prev + 1)
    npage = jnp.asarray([bts[b][int(ctx_prev[b]) // page] for b in range(B)])
    noff = jnp.asarray(ctx_prev % page)
    mesh = make_mesh(mesh_shape, axes)
    spec = IT.ItppSpec(axes, merge, None, 8, 8, page)
    f = IT.make_itpp_attention(mesh, spec, max_pages_per_req=maxp)
    o, pk, pv = jax.jit(f)(q, k_new, v_new, pool_k, pool_v, bt, ctx, npage,
                           noff, 0)
    for k, v in dict(q=q, k_new=k_new, v_new=v_new, pool_k=pool_k,
                     pool_v=pool_v, bt=bt, ctx=ctx, npage=npage, noff=noff,
                     out=o, out_pk=pk, out_pv=pv).items():
        out[f"{tag}/{k}"] = np.asarray(v)

itpp_case("itpp8", 4, 8, 2, 16, 4, 8, 64, np.array([13, 7, 22, 1], np.int32),
          (8,), ("model",), ("model",))
itpp_case("long", 1, 4, 1, 16, 4, 16, 64, np.array([57], np.int32),
          (2, 4), ("data", "model"), ("data", "model"))

# the sequence-sharded prefill writer
B, S, page, KVH, D = 2, 32, 4, 2, 8
maxp = S // page
alloc = PageAllocator(32, 8, page, policy="row_affine", n_rows=2,
                      blocked_chunk=maxp // 4)
bts = []
for b in range(B):
    alloc.admit(b, S, row=b)
    bts.append(alloc.block_table(b, maxp))
bt = jnp.asarray(np.stack(bts))
k = jax.random.normal(jax.random.PRNGKey(0), (B, S, KVH, D))
v = jax.random.normal(jax.random.PRNGKey(1), (B, S, KVH, D))
zeros = jnp.zeros((32, page, KVH, D))
mesh = make_mesh((2, 4), ("data", "model"))
spec = IT.ItppSpec(("data", "model"), ("model",), "data", 8, 4, page)
writer = IT.make_prefill_writer(mesh, spec, seq_axis="model")
wk, wv = jax.jit(writer)(zeros, zeros, k, v, bt)
out.update({"writer/k": np.asarray(k), "writer/v": np.asarray(v),
            "writer/bt": np.asarray(bt), "writer/out_k": np.asarray(wk),
            "writer/out_v": np.asarray(wv)})

# moe_ep on 8 shards (4 experts x 2 ff slices), dropless
from repro.models import moe as MO
cfg = replace(reduced(get_config("mixtral-8x22b")), dtype="float32",
              capacity_factor=8.0)
p = MO.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32, n_virtual=8)
x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, cfg.d_model))
mesh = make_mesh((8,), ("model",))
def body(pw, x_loc):
    Bl, Sl, Dl = x_loc.shape
    y, aux = MO.moe_ep(pw, cfg, x_loc.reshape(-1, Dl), "model", 8)
    return y.reshape(Bl, Sl, Dl), jax.lax.pmean(aux, "model")
pspec = {"router": P(None, None), "w1": P("model", None, None),
         "w2": P("model", None, None), "w3": P("model", None, None)}
f = shard_map(body, mesh=mesh, in_specs=(pspec, P(None, "model", None)),
              out_specs=(P(None, "model", None), P()), check_vma=False)
y_ep, aux = jax.jit(f)({k: p[k] for k in pspec}, x)
out.update({f"moe/p/{k}": np.asarray(v) for k, v in p.items()})
out.update({"moe/x": np.asarray(x), "moe/y": np.asarray(y_ep),
            "moe/aux": np.asarray(aux)})

# GPipe decode over (pod 2, data 2, model 2)
from repro.core.paged_kv import PoolSpec
from repro.distributed.sharding import make_plan
from repro.distributed.pipeline import make_pp_decode_step
from repro.models import model as MDL
cfg = replace(reduced(get_config("llama3.2-1b"), layers=4), dtype="float32")
params = MDL.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
B, S, page, mbs = 4, 12, 4, 2
toks = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size)
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
parallel = ParallelConfig(dp=2, tp=2, pods=2, page_size=page)
plan = make_plan(mesh, parallel, ShapeConfig("d", "decode", S, B),
                 pod_mode="pp")
maxp = S // page + 1
pool = PoolSpec(cfg.n_layers, 16, page, cfg.n_kv_heads, cfg.d_head, maxp,
                dtype="float32")
state = MDL.init_decode_state(cfg, pool, B, dtype="float32")
alloc = PageAllocator(16, 4, page, policy="row_affine", n_rows=2)
bts = []
for b in range(B):
    alloc.admit(b, S, row=b % 2)
    bts.append(alloc.block_table(b, maxp))
bt = np.stack(bts)
S_pre = 8
_, state = MDL.prefill(cfg, params, state, toks[:, :S_pre], jnp.asarray(bt))
step = jax.jit(make_pp_decode_step(cfg, plan, parallel, pool, n_stages=2,
                                   microbatches=mbs))
lgs = []
for t in range(S_pre, S):
    batch = {"tokens": toks[:, t], "bt": jnp.asarray(bt),
             "ctx": jnp.full((B,), t + 1, jnp.int32),
             "npage": jnp.asarray([bts[b][t // page] for b in range(B)]),
             "noff": jnp.full((B,), t % page, jnp.int32)}
    lg, state = step(params, state, batch)
    lgs.append(np.asarray(lg))
flat, _ = jax.tree_util.tree_flatten_with_path(params)
for path, leaf in flat:
    out["pp/params/" + "/".join(str(q.key) for q in path)] = np.asarray(leaf)
out.update({"pp/toks": np.asarray(toks), "pp/bt": bt,
            "pp/logits": np.stack(lgs),
            "pp/pool_k": np.asarray(state["pool"]["k"])})
np.savez(sys.argv[1], **out)
print("JAX_REF_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Serial torch in this file: the LocalMesh runs 8 shard threads, and
    the ProcessMesh ranks run on one thread each (bit-equal reductions)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", JAX_PROG, str(path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "JAX_REF_OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _sub(ref, tag) -> dict:
    n = len(tag) + 1
    return {k[n:]: v for k, v in ref.items() if k.startswith(tag + "/")}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _with_trash(pool) -> torch.Tensor:
    """repro's [P, ...] pool with the port's trash page appended."""
    p = _t(pool, torch.float32)
    return torch.cat([p, torch.zeros_like(p[:1])])


def _itpp_inputs(c):
    return (_t(c["q"]), _t(c["k_new"]), _t(c["v_new"]),
            _with_trash(c["pool_k"]), _with_trash(c["pool_v"]),
            _t(c["bt"]), _t(c["ctx"]), _t(c["npage"]), _t(c["noff"]))


def _run_itpp(c, mesh, spec, kernels, maxp):
    q, kn, vn, pk, pv, bt, ctx, npage, noff = _itpp_inputs(c)
    f = IT.make_itpp_attention(mesh, spec, max_pages_per_req=maxp,
                               kernels=kernels)
    out, pk, pv = f(q, kn, vn, pk, pv, bt, ctx, npage, noff, 0)
    return out, pk, pv


def _oracle(c):
    """repro's single-device oracle: write_token, then gather-and-dense."""
    import jax.numpy as jnp
    pk, pv = JPK.write_token(jnp.asarray(c["pool_k"]),
                             jnp.asarray(c["pool_v"]),
                             jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]),
                             jnp.asarray(c["npage"]), jnp.asarray(c["noff"]))
    return np.asarray(JPK.paged_decode_attention_ref(
        jnp.asarray(c["q"]), pk, pv, jnp.asarray(c["bt"]),
        jnp.asarray(c["ctx"])))


@pytest.mark.parametrize("path", list(KERNELS))
@pytest.mark.parametrize("case", ["itpp8", "long"])
def test_itpp_sharded_matches_repro(ref, case, path):
    """The striped 8-shard ITPP (mesh (8,) over model, merge over model)
    and the long-context request (one request over a 2 x 4 mesh, merged
    over both axes): outputs within 1e-5 of repro's sharded op and of the
    single-device oracle; the pool (the new token written by its owner
    alone) equals repro's exactly."""
    c = _sub(ref, case)
    axes = ("model",) if case == "itpp8" else ("data", "model")
    mesh = M.LocalMesh((8,) if case == "itpp8" else (2, 4), axes)
    spec = IT.ItppSpec(axes, axes, None, 8, 8, c["pool_k"].shape[1])
    out, pk, pv = _run_itpp(c, mesh, spec, KERNELS[path], c["bt"].shape[1])
    n_pages = c["pool_k"].shape[0]
    assert np.abs(out.numpy() - c["out"]).max() < 1e-5
    assert np.abs(out.numpy() - _oracle(c)).max() < 1e-5
    np.testing.assert_array_equal(pk[:n_pages].numpy(), c["out_pk"])
    np.testing.assert_array_equal(pv[:n_pages].numpy(), c["out_pv"])


def test_prefill_writer_matches_repro(ref):
    """Blocked page allocation + the shard-local prefill scatter (a shard
    of the sharded prefill writes the pages it owns from its rows' whole
    K/V): the pool pages equal repro's sharded writer's (each shard its
    own block of the sequence) and the port's global ``write_prefill``'s
    exactly."""
    c = _sub(ref, "writer")
    page, KVH, D = 4, c["k"].shape[2], c["k"].shape[3]
    mesh = M.LocalMesh((2, 4), ("data", "model"))
    spec = IT.ItppSpec(("data", "model"), ("model",), "data", 8, 4, page)
    pool, rows = M.P(M.Paged(spec.page_axes)), M.P("data")
    writer = M.shard_map(
        IT.make_prefill_writer(spec, pool_layout=mesh.pool_layout), mesh,
        in_specs=(pool, pool, rows, rows, rows), out_specs=(pool, pool))
    pk = torch.zeros((33, page, KVH, D))
    pv = torch.zeros((33, page, KVH, D))
    k, v, bt = _t(c["k"]), _t(c["v"]), _t(c["bt"])
    writer(pk, pv, k, v, bt)
    np.testing.assert_array_equal(pk[:32].numpy(), c["out_k"])
    np.testing.assert_array_equal(pv[:32].numpy(), c["out_v"])
    gk, gv = torch.zeros_like(pk), torch.zeros_like(pv)
    PK.write_prefill(gk, gv, k, v, bt)
    # page 32 is the trash page: a shard drops there the tokens it does
    # not own
    assert torch.equal(gk[:32], pk[:32]) and torch.equal(gv[:32], pv[:32])


def _moe_cfg():
    return replace(reduced(get_config("mixtral-8x22b")), dtype="float32",
                   capacity_factor=8.0)


def _moe_ep_fn(mesh, cfg, rt=None):
    def body(pw, x_loc):
        if rt is not None:          # a shard runtime's MoE
            y, aux = rt.moe_apply(pw, cfg, x_loc, with_aux=True)
            return y, M.pmean(aux, "model")
        B, S, D = x_loc.shape
        y, aux = MOE.moe_ep(pw, cfg, x_loc.reshape(-1, D), "model", 8)
        return y.reshape(B, S, D), M.pmean(aux, "model")
    pspec = {"router": None, "w1": M.P("model"), "w2": M.P("model"),
             "w3": M.P("model")}
    return M.shard_map(body, mesh, in_specs=(pspec, M.P(None, "model")),
                       out_specs=(M.P(None, "model"), None))


def test_moe_ep_matches_local(ref):
    """``moe_ep`` over 8 shards (4 experts x 2 ff slices, dropless):
    within 2e-5 of scale of the port's ``moe_local`` and of repro's
    ``moe_ep``; its aux (the shards' mean) equals repro's within 1e-6;
    the plan's prefill shard runtime gives the same output."""
    c = _sub(ref, "moe")
    cfg = _moe_cfg()
    p = {k[2:]: _t(v) for k, v in c.items() if k.startswith("p/")}
    x = _t(c["x"])
    y_local = MOE.moe_local(p, cfg, x)
    y, aux = _moe_ep_fn(M.LocalMesh((8,), ("model",)), cfg)(p, x)
    scale = float(y_local.abs().max())
    assert float((y - y_local).abs().max()) < 2e-5 * scale
    assert np.abs(y.numpy() - c["y"]).max() < 2e-5 * scale
    assert abs(float(aux) - float(c["aux"])) < 1e-6
    jy, _ = JMOE.moe_local({k: np.asarray(v) for k, v in
                            _sub(c, "p").items()},
                           replace(jax_reduced(jax_get_config(
                               "mixtral-8x22b")), dtype="float32",
                               capacity_factor=8.0), c["x"])
    assert np.abs(y_local.numpy() - np.asarray(jy)).max() < 2e-5 * scale
    plan = make_plan(M.LocalMesh((1, 8), ("data", "model")),
                     ParallelConfig(),
                     ShapeConfig("p", "prefill", 8, 2))
    rt = plan.make_runtime(cfg, ParallelConfig(remat=False),
                           mode="prefill")
    y_rt, aux_rt = _moe_ep_fn(plan.mesh, cfg, rt)(p, x)
    assert torch.equal(y_rt, y) and float(aux_rt) == float(aux)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.mark.parametrize("path", list(KERNELS))
def test_pp_decode_matches_forward(ref, path, monkeypatch):
    """GPipe decode over (pod 2, data 2, model 2) with 2 microbatches, each
    stage's layers as Megatron TP over ``model`` on its serve slices
    (``REPLICATE_SMALL`` at 0: every divisible leaf cut) and a
    microbatch's rows over ``data``: logits within 5e-3 of the port's
    full-sequence forward (the bound of ``tests/test_distributed.py``) and
    within 1e-4 of repro's pipeline; the pool within 1e-5 of repro's."""
    from repro_torch.distributed import sharding as SH
    monkeypatch.setattr(SH, "REPLICATE_SMALL", 0)
    c = _sub(ref, "pp")
    cfg = replace(reduced(get_config("llama3.2-1b"), layers=4),
                  dtype="float32")
    params = params_from_numpy(cfg, _unflatten(_sub(c, "params")),
                               device="cpu")
    toks = _t(c["toks"]).long()
    B, S, page, S_pre = 4, 12, 4, 8
    logits_ref, _ = MDL.forward(cfg, params, toks)
    mesh = M.LocalMesh((2, 2, 2), ("pod", "data", "model"))
    parallel = ParallelConfig(page_size=page, use_kernels=path == "kernels")
    plan = make_plan(mesh, parallel, ShapeConfig("d", "decode", S, B),
                     pod_mode="pp")
    maxp = S // page + 1
    pool = PK.PoolSpec(cfg.n_layers, 16, page, cfg.n_kv_heads, cfg.d_head,
                       maxp, dtype="float32")
    state = MDL.init_decode_state(cfg, pool, B, device="cpu")
    bt = _t(c["bt"])
    MDL.prefill(cfg, params, state, toks[:, :S_pre], bt)
    step = make_pp_decode_step(cfg, plan, parallel, pool, n_stages=2,
                               microbatches=2,
                               specs=stage_specs(plan, plan.param_specs(
                                   params, mode="serve")))
    for j, t in enumerate(range(S_pre, S)):
        batch = {"tokens": toks[:, t], "bt": bt,
                 "ctx": torch.full((B,), t + 1, dtype=torch.int32),
                 "npage": bt[:, t // page].clone(),
                 "noff": torch.full((B,), t % page, dtype=torch.int32)}
        lg, state = step(params, state, batch)
        assert float((lg - logits_ref[:, t]).abs().max()) < 5e-3, t
        assert np.abs(lg.numpy() - c["logits"][j]).max() < 1e-4, t
    assert np.abs(state["pool"]["k"][:, :16].numpy()
                  - c["pool_k"]).max() < 1e-5


def test_merge_partials_axis_form_matches_stacked():
    """The axis form (pmax, then psum of the rescaled partials, inside a
    shard body) equals the stacked form on the same partials."""
    g = torch.Generator().manual_seed(0)
    o = torch.randn((8, 3, 4, 16), generator=g)
    l = torch.rand((8, 3, 4), generator=g) + 0.5
    m = torch.randn((8, 3, 4), generator=g) * 5
    stacked = PK.merge_partials(o, l, m)
    mesh = M.make_test_mesh((2, 4), ("data", "model"))
    outs = mesh.run(lambda r: PK.merge_partials(o[r], l[r], m[r],
                                                axis=("data", "model")))
    for out in outs:
        assert torch.allclose(out, stacked, atol=1e-6, rtol=1e-6)
    assert all(torch.equal(outs[0], x) for x in outs[1:])


# ---------------------------------------------------------------------------
# the gloo ProcessMesh against the LocalMesh
# ---------------------------------------------------------------------------

RANK_PROG = """
import os, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from dataclasses import replace
from repro_torch.configs import get_config, reduced
from repro_torch.core import itpp as IT
from repro_torch.distributed import mesh as M
from repro_torch.models import moe as MOE
rank, port, inp, outp = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                         sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=8, rank=rank)
mesh = M.ProcessMesh((8,), ("model",))
z = dict(np.load(inp))
t = lambda k: torch.from_numpy(z[k])
res = {}
for path in ("plain", "kernels"):
    spec = IT.ItppSpec(("model",), ("model",), None, 8, 8, 4)
    kern = None if path == "plain" else IT.KernelConfig()
    f = IT.make_itpp_attention(mesh, spec, max_pages_per_req=8, kernels=kern)
    pool = M.P(M.Paged(("model",)))
    pk, pv = (M.shard(t(k), pool, mesh) for k in ("pool_k", "pool_v"))
    ptr = pk.data_ptr()
    out, pk, pv = f(t("q"), t("k_new"), t("v_new"), pk, pv, t("bt"),
                    t("ctx"), t("npage"), t("noff"), 0)
    res[f"facts/itpp_{path}/same_storage"] = np.bool_(pk.data_ptr() == ptr)
    res[f"facts/itpp_{path}/block_pages"] = np.int64(pk.shape[0])
    res[f"itpp_{path}"] = out.numpy()
    res[f"itpp_{path}_pk"] = M.gather(pk, pool, mesh).numpy()
cfg = replace(reduced(get_config("mixtral-8x22b")), dtype="float32",
              capacity_factor=8.0)
def body(pw, x_loc):
    B, S, D = x_loc.shape
    y, aux = MOE.moe_ep(pw, cfg, x_loc.reshape(-1, D), "model", 8)
    return y.reshape(B, S, D), M.pmean(aux, "model")
pspec = {"router": None, "w1": M.P("model"), "w2": M.P("model"),
         "w3": M.P("model")}
f = M.shard_map(body, mesh, in_specs=(pspec, M.P(None, "model")),
                out_specs=(M.P(None, "model"), None))
p = {k: t("moe_" + k) for k in ("router", "w1", "w2", "w3")}
y, aux = f(p, t("moe_x"))
res["moe_y"], res["moe_aux"] = y.numpy(), aux.numpy()
# the sharded steps on resident state: decode (TP) and prefill on a
# (data 2, model 4) world, the pipeline on (pod 2, data 2, model 2)
sys.path.insert(0, sys.argv[5])
from repro_torch.distributed import sharding as SH
from test_torch_decode_tp import (GLOO_ARCHS, PREFILL_ARCHS, decode_tp_run,
                                  pp_tp_run, prefill_tp_run)
SH.REPLICATE_SMALL = 0
def keep(tag, out, facts):
    res.update({f"{tag}/{k}": v for k, v in out.items()})
    res.update({f"facts/{tag}/{k}": v for k, v in facts.items()})
mesh = M.ProcessMesh((2, 4), ("data", "model"))
for arch in GLOO_ARCHS:
    facts = {}
    keep(f"decode_tp/{arch}", decode_tp_run(mesh, arch, facts), facts)
for arch in PREFILL_ARCHS:
    facts = {}
    keep(f"prefill/{arch}", prefill_tp_run(mesh, arch, facts), facts)
mesh = M.ProcessMesh((2, 2, 2), ("pod", "data", "model"))
facts = {}
keep("pp", pp_tp_run(mesh, facts), facts)
if rank == 0:
    np.savez(outp, **res)
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo(ref, tmp_path_factory):
    """Both cases on an 8-rank gloo ``ProcessMesh`` (8 local processes)."""
    d = tmp_path_factory.mktemp("gloo")
    c, mo = _sub(ref, "itpp8"), _sub(ref, "moe")
    inp = {k: np.asarray(v) for k, v in c.items()
           if k in ("q", "k_new", "v_new", "bt", "ctx", "npage", "noff")}
    inp["pool_k"] = _with_trash(c["pool_k"]).numpy()
    inp["pool_v"] = _with_trash(c["pool_v"]).numpy()
    inp.update({"moe_" + k[2:]: v for k, v in mo.items()
                if k.startswith("p/")})
    inp["moe_x"] = mo["x"]
    np.savez(d / "in.npz", **inp)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_PROG, str(r), port, str(d / "in.npz"),
         str(d / "out.npz"), str(Path(__file__).resolve().parent)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(8)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode:
            errs.append(err[-2000:])
    assert not errs, errs[0]
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}


def _gloo_local(case: str) -> dict:
    """The LocalMesh's run of a sharded-step case of ``RANK_PROG``."""
    from test_torch_decode_tp import (GLOO_ARCHS, PREFILL_ARCHS,
                                      decode_tp_run, pp_tp_run,
                                      prefill_tp_run)
    if case == "pp":
        return {"pp": pp_tp_run(M.LocalMesh((2, 2, 2),
                                            ("pod", "data", "model")))}
    mesh = M.LocalMesh((2, 4), ("data", "model"))
    if case == "decode_tp":
        return {f"decode_tp/{a}": decode_tp_run(mesh, a) for a in GLOO_ARCHS}
    return {f"prefill/{a}": prefill_tp_run(mesh, a) for a in PREFILL_ARCHS}


@pytest.mark.parametrize("case", ["itpp_plain", "itpp_kernels", "moe",
                                  "decode_tp", "prefill", "pp"])
def test_process_mesh_equals_local_mesh(ref, gloo, case, monkeypatch):
    """The same bodies over ``torch.distributed`` (gloo, one shard a
    process) give the LocalMesh's bits: the ITPP merge's pmax / psum,
    ``moe_ep``'s two ``all_to_all``s, and the sharded steps on resident
    params and state, gathered at the end (``Plan.gather``):
    ``make_decode_step``'s TP shard body on (data 2, model 4) (gemma3's
    tied head and windows, phi3.5-moe on ``moe_ep_rows``, zamba2's carry:
    logits over 4 steps, the pool pages and carry), ``make_prefill_step``
    (llama3.2-1b, zamba2: logits, the pages each rank wrote into its
    block, the carry) and the pipeline on (pod 2, data 2, model 2)
    (logits over 4 steps, the stages' pool pages)."""
    if case in ("decode_tp", "prefill", "pp"):
        from repro_torch.distributed import sharding as SH
        monkeypatch.setattr(SH, "REPLICATE_SMALL", 0)
        for tag, local in _gloo_local(case).items():
            assert {k for k in gloo if k.startswith(tag + "/")} == {
                f"{tag}/{k}" for k in local}, tag
            for k, v in local.items():
                np.testing.assert_array_equal(gloo[f"{tag}/{k}"], v,
                                              err_msg=f"{tag} {k}")
        return
    if case == "moe":
        c = _sub(ref, "moe")
        p = {k[2:]: _t(v) for k, v in c.items() if k.startswith("p/")}
        y, aux = _moe_ep_fn(M.LocalMesh((8,), ("model",)), _moe_cfg())(
            p, _t(c["x"]))
        np.testing.assert_array_equal(gloo["moe_y"], y.numpy())
        np.testing.assert_array_equal(gloo["moe_aux"], aux.numpy())
        return
    c = _sub(ref, "itpp8")
    spec = IT.ItppSpec(("model",), ("model",), None, 8, 8, 4)
    out, pk, _ = _run_itpp(c, M.LocalMesh((8,), ("model",)), spec,
                           KERNELS[case.split("_")[1]], 8)
    np.testing.assert_array_equal(gloo[case], out.numpy())
    np.testing.assert_array_equal(gloo[case + "_pk"][:64], pk[:64].numpy())


@pytest.mark.parametrize("case", ["itpp_plain", "itpp_kernels"]
                         + [f"decode_tp/{a}" for a in (
                             "gemma3-27b", "phi3.5-moe-42b-a6.6b",
                             "zamba2-1.2b")]
                         + ["prefill/llama3.2-1b", "prefill/zamba2-1.2b",
                            "pp"])
def test_process_mesh_state_stays_resident(gloo, case):
    """What rank 0 of the gloo world held and moved: its resident params
    and state are exactly its slices under the plan (``Plan.local_bytes``,
    a ``Paged`` block with its own trash page); the dry-run's
    ``argument_bytes`` rule on its cell's specs counts less by exactly the
    blocks' own trash pages (less the global trash page's share it counts)
    (``beyond_count``); its pool block kept its storage through the steps
    (no copy of a pool inside a step), and the steps' output assembly sent
    only the logits' bytes (no param, page or carry byte). A pipeline rank
    holds its own stage's layers only (``stage_specs``), and gathering
    them rebuilds the global params. The ITPP op's pool block is its 8
    pages and a trash page."""
    f = {k[len(f"facts/{case}/"):]: v for k, v in gloo.items()
         if k.startswith(f"facts/{case}/")}
    assert bool(f["same_storage"])
    if case.startswith("itpp"):
        assert int(f["block_pages"]) == 64 // 8 + 1
        return
    assert int(f["held"]) == int(f["want"]) > 0
    assert int(f["held"]) == int(f["want_dryrun"]) + int(f["beyond_dryrun"])
    assert int(f["beyond_dryrun"]) > 0
    assert int(f["moved"]) == int(f["logits"])
    if case == "pp":
        assert 2 * int(f["layers"]) == int(f["n_layers"]) == 4
        assert bool(f["gathered_params"])


# ---------------------------------------------------------------------------
# the plan against repro's, on repro's abstract mesh
# ---------------------------------------------------------------------------

def _spec_tuple(s):
    return tuple(s)


def _repro_specs(tree) -> dict:
    """repro's spec tree as {path without layer index: spec tuple}, the
    stacked leading None of ``layers`` / ``enc`` / ``dec`` dropped."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    out = {}
    for path, spec in flat:
        keys = tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
        s = _spec_tuple(spec)
        if keys[0] in ("layers", "enc", "dec"):
            s = s[1:]
        out[keys] = s
    return out


def _port_specs(tree) -> dict:
    out: dict = {}

    def walk(node, keys):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + (k,))
        elif isinstance(node, list):
            for v in node:                 # per-layer lists: layer dropped
                walk(v, keys)
        else:
            prev = out.setdefault(keys, tuple(node))
            assert prev == tuple(node), (keys, prev, node)
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", ASSIGNED)
def test_plan_param_specs_match_repro(arch):
    """``param_specs`` (train and serve) of the port's full-size params
    (meta device) equal repro's on its ``abstract_mesh``, single- and
    multi-pod, with the serve layout's virtual experts at ``tp``."""
    import jax.random as jr
    for multi_pod in (False, True):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        jparallel = JParallel(pods=2 if multi_pod else 1)
        jplan = jax_make_plan(jax_abstract_mesh(shape, axes), jparallel,
                              JSHAPES["train_4k"])
        parallel = ParallelConfig()
        plan = make_plan(M.make_production_mesh(multi_pod=multi_pod),
                         parallel, SHAPES["train_4k"])
        jcfg = jax_get_config(arch)
        mv = jparallel.tp if jcfg.is_moe else 0
        jparams = jax.eval_shape(lambda: JMDL.init_params(
            jcfg, jr.PRNGKey(0), moe_virtual=mv))
        params = MDL.init_params(get_config(arch), device="meta",
                                 moe_virtual=mv)
        for mode in ("train", "serve"):
            want = _repro_specs(jplan.param_specs(jparams, mode=mode))
            got = _port_specs(plan.param_specs(params, mode=mode))
            assert got == want, (arch, multi_pod, mode)


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_make_plan_and_itpp_spec_match_repro(shape_name):
    """``make_plan``'s layout choice, the activation table and
    ``itpp_spec`` equal repro's for each cell shape, single- and multi-pod
    and with the pod axis as pipeline stages; the shapes, skips and
    parallel fields the port keeps have repro's defaults."""
    from repro.configs import applicable_shapes as japplicable
    from repro_torch.configs import applicable_shapes, list_configs
    assert asdict(SHAPES[shape_name]) == asdict(JSHAPES[shape_name])
    for name in list_configs():
        assert applicable_shapes(name) == japplicable(name)
    jdef, pdef = asdict(JParallel()), asdict(ParallelConfig())
    assert {k: pdef[k] for k in pdef if k != "use_kernels"} == \
        {k: jdef[k] for k in pdef if k != "use_kernels"}
    for shape, axes, pod_mode in (
            ((16, 16), ("data", "model"), "dp"),
            ((2, 16, 16), ("pod", "data", "model"), "dp"),
            ((2, 16, 16), ("pod", "data", "model"), "pp")):
        jplan = jax_make_plan(jax_abstract_mesh(shape, axes), JParallel(),
                              JSHAPES[shape_name], pod_mode=pod_mode)
        plan = make_plan(abstract_mesh(shape, axes), ParallelConfig(),
                         SHAPES[shape_name], pod_mode=pod_mode)
        for f in ("dp_axes", "tp_axis", "shape_kind", "batch_divisible",
                  "seq_divisible", "pod_mode", "train_layout"):
            assert getattr(plan, f) == getattr(jplan, f), f
        assert plan.batch_spec == jplan.batch_spec
        assert plan.page_axes == jplan.page_axes
        assert tuple(plan.pool_spec()) == tuple(jplan.pool_spec())
        assert {k: tuple(v) for k, v in plan._act_table().items()} == \
            {k: tuple(v) for k, v in jplan._act_table().items()}
        js, ps = jplan.itpp_spec(256), plan.itpp_spec(256)
        assert asdict(ps) == asdict(js)


def test_local_mesh_collectives_errors_and_mismatch():
    """The single-process mesh's collectives by axis name (psum, pmax,
    all_gather, all_to_all, ppermute) against their definitions; a shard's
    error reaches the caller; a collective the other shards never call is
    reported, not waited on forever."""
    mesh = M.LocalMesh((2, 4), ("data", "model"))

    def body(r):
        x = torch.tensor([float(r)])
        return (M.psum(x, "model"), M.pmax(x, ("data", "model")),
                M.all_gather(x, "data", tiled=True),
                M.all_to_all(torch.arange(4.) + 10 * r, "model"),
                M.ppermute(x, "model", [(0, 1), (1, 2), (2, 3)]),
                M.axis_index(("data", "model")))
    for r, (s, mx, ag, a2a, pp, idx) in enumerate(mesh.run(body)):
        d, m = divmod(r, 4)
        assert idx == r and float(mx) == 7.0
        assert float(s) == sum(4 * d + j for j in range(4))
        assert ag.tolist() == [float(m), float(4 + m)]
        assert a2a.tolist() == [10.0 * (4 * d + j) + m for j in range(4)]
        assert float(pp) == (0.0 if m == 0 else float(r - 1))

    def bad(r):
        if r == 3:
            raise ValueError("shard 3")
        return M.psum(torch.ones(1), ("data", "model"))
    for _ in range(5):      # an aborted run leaves the next one clean
        with pytest.raises(ValueError, match="shard 3"):
            mesh.run(bad)
        with pytest.raises(RuntimeError, match="never call"):
            mesh.run(lambda r: M.psum(torch.ones(1), "model") if r == 0
                     else 0)
        assert mesh.run(lambda r: float(M.psum(torch.ones(1), "model"))) \
            == [4.0] * 8
    # the idle shard threads keep nothing of a finished run (on the card
    # a pool of tens of GB)
    import gc
    import weakref
    big = torch.ones(64)
    ref_big = weakref.ref(big)
    f = M.shard_map(lambda x: (M.psum(x.sum(), "model"),), mesh,
                    in_specs=(M.P(("data", "model")),), out_specs=(None,))
    assert float(f(big)[0]) == 32.0
    del big, f
    gc.collect()
    assert ref_big() is None


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b",
                                  "xlstm-350m", "whisper-small"])
def test_decode_state_specs_and_serve_params(arch):
    """``decode_state_specs`` of the port's decode state equal repro's (the
    pool over the page axes, rows and cross rows over the batch axis),
    key by key; ``serve_params`` quantizes a decode plan's weights under
    ``serve_quant="int8"`` and leaves them otherwise."""
    from repro.core.paged_kv import PoolSpec as JPoolSpec
    from repro_torch.core.quant import is_qtensor
    mesh, axes = (16, 16), ("data", "model")
    jplan = jax_make_plan(jax_abstract_mesh(mesh, axes), JParallel(),
                          JSHAPES["decode_32k"])
    plan = make_plan(abstract_mesh(mesh, axes), ParallelConfig(),
                     SHAPES["decode_32k"])
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    n_attn = max(1, sum(k in ("attn", "local") for k in cfg.block_kinds()))
    jstate = JMDL.init_decode_state(jcfg, JPoolSpec(n_attn, 8, 4, 2, 16, 4,
                                                    dtype="float32"), 4)
    state = MDL.init_decode_state(cfg, PK.PoolSpec(n_attn, 8, 4, 2, 16, 4,
                                                   dtype="float32"), 4,
                                  device="cpu")
    jspecs = jplan.decode_state_specs(jstate)
    specs = plan.decode_state_specs(state)
    assert set(specs) == set(jspecs)
    for k in specs:
        want = sorted(tuple(s) for s in jax.tree.leaves(
            jspecs[k], is_leaf=lambda x: isinstance(x, JP)))
        got = sorted(tuple(s) for s in _walk(
            specs[k], lambda x: isinstance(x, M.P)))
        assert got == want, k
    # wide enough that quantize_params' size floor (1 << 16) is passed
    params = MDL.init_params(replace(cfg, d_model=256,
                                     d_ff=512 if cfg.d_ff else 0),
                             device="cpu")
    q = plan.serve_params(params, ParallelConfig(serve_quant="int8"),
                          mode="decode")
    assert any(is_qtensor(v) for v in _walk(q, is_qtensor))
    for parallel, mode in ((ParallelConfig(), "decode"),
                           (ParallelConfig(serve_quant="int8"), "prefill")):
        assert plan.serve_params(params, parallel, mode=mode) is params


def _walk(tree, is_leaf):
    """The leaves of a dict / list / tuple tree (``is_leaf`` stops the
    walk early)."""
    if is_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v, is_leaf)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v, is_leaf)
    else:
        yield tree


def test_stage_cut_of_a_layer_list():
    """``mesh.Stages`` over ``pod`` on a 4-element layer list, (pod 2,
    data 1, model 2): a ``LocalMesh``'s ``shard_map`` hands each shard its
    stage's 2 layers, each cut by its own spec (global or resident);
    ``shard`` / ``gather`` are the identity there. A ``ShapeMesh`` rank's
    ``shard`` holds its stage's 2 layers only, and ``block_nbytes`` counts
    just those (shard 0's on a ``LocalMesh``). A list that does not cut
    into the stages raises, as does counting a stage with no mesh."""
    g = torch.Generator().manual_seed(0)
    layers = [{"w": torch.randn(4, 6, generator=g),
               "b": torch.randn(3, generator=g)} for _ in range(4)]
    spec = M.Stages("pod", tuple({"w": M.P(None, "model"), "b": M.P()}
                                 for _ in layers))
    shape, axes = (2, 1, 2), ("pod", "data", "model")

    def mine(i, m):        # stage i's layers as model shard m holds them
        return [{"w": lp["w"][:, 3 * m:3 * m + 3], "b": lp["b"]}
                for lp in layers[2 * i:2 * i + 2]]

    def same(a, b):
        return len(a) == len(b) and all(
            torch.equal(x["w"], y["w"]) and torch.equal(x["b"], y["b"])
            for x, y in zip(a, b))

    local = M.LocalMesh(shape, axes)

    def body(ls):
        return (torch.tensor([same(ls, mine(M.axis_index("pod"),
                                            M.axis_index("model")))]),)
    for sp in (spec, M.Resident(spec)):
        ok, = M.shard_map(body, local, in_specs=(sp,),
                          out_specs=(M.P(("pod", "data", "model")),))(layers)
        assert ok.tolist() == [True] * 4
    assert M.shard(layers, spec, local) is layers
    assert M.gather(layers, spec, local) is layers
    want = 2 * (4 * 3 + 3) * 4
    assert M.block_nbytes(layers, spec, local) == want
    for rank in range(4):
        sm = M.ShapeMesh(shape, axes, rank=rank)
        c = sm.coords(rank)
        assert same(M.shard(layers, spec, sm), mine(c["pod"], c["model"]))
        assert M.block_nbytes(layers, spec, sm) == want
    with pytest.raises(ValueError):
        M.shard(layers[:3], spec, M.ShapeMesh(shape, axes))
    with pytest.raises(ValueError):
        M.block_nbytes(layers, M.Stages("pod", spec.specs[:3]), local)
    with pytest.raises(ValueError):
        list(M.leaf_specs(layers, spec))


def test_pp_decode_moe_matches_forward(monkeypatch):
    """GPipe decode of a MoE stack (reduced mixtral, 4 experts as 4
    virtual experts on the model axis, dropless) on (pod 2, data 1, model
    4): each stage's experts run as ``moe_ep_rows`` over ``model``, its
    dense layers as TP on the serve slices (``REPLICATE_SMALL`` at 0);
    logits within 5e-3 of the port's full-sequence forward."""
    from repro_torch.distributed import sharding as SH
    monkeypatch.setattr(SH, "REPLICATE_SMALL", 0)
    cfg = replace(reduced(get_config("mixtral-8x22b"), layers=2),
                  dtype="float32", capacity_factor=8.0, sliding_window=0)
    params = MDL.init_params(cfg, seed=3, device="cpu", moe_virtual=4)
    B, S_pre, S, page = 2, 6, 9, 4
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    logits_ref, _ = MDL.forward(cfg, params, toks)
    mesh = M.LocalMesh((2, 1, 4), ("pod", "data", "model"))
    parallel = ParallelConfig(page_size=page)
    plan = make_plan(mesh, parallel, ShapeConfig("d", "decode", S, B),
                     pod_mode="pp")
    maxp = S // page + 1
    pool = PK.PoolSpec(cfg.n_layers, 16, page, cfg.n_kv_heads, cfg.d_head,
                       maxp, dtype="float32")
    alloc = PageAllocator(16, 4, page, policy="striped")
    for b in range(B):
        alloc.admit(b, S)
    bt = torch.from_numpy(np.stack([alloc.block_table(b, maxp)
                                    for b in range(B)]))
    state = MDL.init_decode_state(cfg, pool, B, device="cpu")
    MDL.prefill(cfg, params, state, toks[:, :S_pre], bt)
    step = make_pp_decode_step(cfg, plan, parallel, pool, n_stages=2,
                               microbatches=2,
                               specs=stage_specs(plan, plan.param_specs(
                                   params, mode="serve")))
    for t in range(S_pre, S):
        batch = {"tokens": toks[:, t], "bt": bt,
                 "ctx": torch.full((B,), t + 1, dtype=torch.int32),
                 "npage": bt[:, t // page].clone(),
                 "noff": torch.full((B,), t % page, dtype=torch.int32)}
        lg, state = step(params, state, batch)
        assert float((lg - logits_ref[:, t]).abs().max()) < 5e-3, t


@pytest.mark.parametrize("path", ["plain", "kernels"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-27b"])
def test_model_decode_sharded_matches_unsharded(arch, path, monkeypatch):
    """The model-level sharded decode: ``sharding.make_decode_step`` (the
    serve slices as Megatron TP over ``model``, every divisible leaf cut
    with ``REPLICATE_SMALL`` at 0; ITPP over a (data 2, model 4)
    LocalMesh, requests pinned to data rows by ``row_affine``; gemma3's
    mixed local:global stack on ``cond_window``) against the unsharded
    ``decode_step``, both from the same prefilled pool: 4 greedy steps,
    tokens identical, logits within 1e-5 of their scale (the unsharded
    runtime is fed the sharded one's tokens)."""
    from repro_torch.distributed import sharding as SH
    monkeypatch.setattr(SH, "REPLICATE_SMALL", 0)
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    params = MDL.init_params(cfg, seed=5, device="cpu")
    B, page, steps, n_pages = 4, 4, 4, 64
    g = torch.Generator().manual_seed(7)
    lens = torch.randint(8, 25, (B,), generator=g)
    S = int(lens.max())
    maxp = (S + steps) // page + 1
    mesh = M.LocalMesh((2, 4), ("data", "model"))
    parallel = ParallelConfig(page_size=page, remat=False,
                              use_kernels=None if path == "kernels"
                              else False)
    plan = make_plan(mesh, parallel, ShapeConfig("d", "decode", S + steps,
                                                 B))
    spec = PK.PoolSpec(cfg.n_layers, n_pages, page, cfg.n_kv_heads,
                       cfg.d_head, maxp, dtype="float32")
    step = SH.make_decode_step(cfg, plan, parallel, spec,
                               specs=plan.param_specs(params, mode="serve"))
    rt = step.rt
    assert plan.itpp_spec(page).merge_axes == ("model",)
    assert rt.cond_window == (cfg.sliding_window
                              if arch == "gemma3-27b" else 0)
    assert rt.tp_axis == "model" and rt.fetch is None
    rt_u = MDL.Runtime(kernels=KERNELS[path])
    alloc = PageAllocator(n_pages, 8, page, policy="row_affine", n_rows=2)
    for b in range(B):
        alloc.admit(b, int(lens[b]) + steps, row=b // 2)
    bt = torch.from_numpy(np.stack([alloc.block_table(b, maxp)
                                    for b in range(B)])).to(torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    state = MDL.init_decode_state(cfg, spec, B, device="cpu")
    lg, _ = MDL.prefill(cfg, params, state, toks, bt, last_idx=lens - 1,
                        valid_len=lens)
    state_u = {"pool": {k: v.clone() for k, v in state["pool"].items()}}
    V = cfg.vocab_size
    tok = lg[:, :V].argmax(-1).to(torch.int32)
    rows = torch.arange(B)
    for j in range(steps):
        pos = (lens + j).to(torch.int32)
        args = (pos + 1, bt[rows, (pos // page).long()].contiguous(),
                (pos % page).to(torch.int32))
        lg_s, state = step(params, state, dict(zip(
            ("tokens", "bt", "ctx", "npage", "noff"), (tok, bt, *args))))
        lg_u, _ = MDL.decode_step(cfg, params, state_u, tok, bt, *args,
                                  rt=rt_u)
        scale = float(lg_u.abs().max())
        assert float((lg_s - lg_u).abs().max()) <= 1e-5 * scale, (arch, j)
        assert torch.equal(lg_s[:, :V].argmax(-1), lg_u[:, :V].argmax(-1))
        tok = lg_s[:, :V].argmax(-1).to(torch.int32)
    # the pages the steps wrote, from hidden states 1e-5 apart
    for k in ("k", "v"):
        want = state_u["pool"][k][:, :n_pages]
        gap = float((state["pool"][k][:, :n_pages] - want).abs().max())
        assert gap <= 1e-5 * float(want.abs().max()), (arch, k, gap)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-27b",
                                  "zamba2-1.2b", "xlstm-350m",
                                  "whisper-small", "qwen2-vl-7b",
                                  "mixtral-8x22b"])
def test_sharded_prefill_matches_unsharded(arch, monkeypatch):
    """``sharding.make_prefill_step`` (repro's prefill cell: the ``sp``
    layout on a (data 2, model 4) LocalMesh, every divisible leaf cut so
    the shards gather their weights; ``REPLICATE_SMALL`` at 0) against the
    unsharded ``prefill``: 2 rows of 32 tokens (one padded to 27), logits,
    the pool's pages, the carry and the cross rows within 1e-5 of their
    scale. mixtral's all-windowed stack writes a ring pool (its window 16
    under 32 tokens)."""
    from repro_torch.distributed import sharding as SH
    monkeypatch.setattr(SH, "REPLICATE_SMALL", 0)
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    if cfg.is_moe:
        cfg = replace(cfg, capacity_factor=8.0)
    params = MDL.init_params(cfg, seed=0, device="cpu",
                             moe_virtual=4 if cfg.is_moe else 0)
    B, S, page = 2, 32, 4
    parallel = ParallelConfig(page_size=page)
    shape = ShapeConfig("p", "prefill", S, B)
    plan = make_plan(M.LocalMesh((2, 4), ("data", "model")), parallel, shape)
    assert plan.train_layout == "sp"
    spec = PK.pool_spec_for(cfg, shape, parallel, n_shards=8,
                            slack_pages=16)
    ring = spec.max_pages_per_req if spec.ring else 0
    assert bool(ring) == (arch == "mixtral-8x22b")
    alloc = PageAllocator(spec.n_pages, 8, page, policy="row_affine",
                          n_rows=2, **({"ring_pages": ring} if ring else {}))
    for b in range(B):
        alloc.admit(b, S, row=b)
    bt = torch.from_numpy(np.stack([alloc.block_table(
        b, spec.max_pages_per_req) for b in range(B)])).to(torch.int32)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=g), "bt": bt}
    if cfg.family == "encdec":
        batch["frames"] = 0.1 * torch.randn(B, cfg.enc_seq, cfg.d_model,
                                            generator=g)
    if cfg.rope_kind == "mrope":
        batch["positions"] = torch.arange(S)[None, None].expand(
            3, B, S).contiguous()
        batch["extra_embeds"] = 0.02 * torch.randn(B, S, cfg.d_model,
                                                   generator=g)
    if not ring:        # a ring pool's write ignores valid_len, as unsharded
        lens = torch.tensor([S, S - 5])
        batch.update(valid_len=lens, last_idx=lens - 1)
    kw = {k: v for k, v in batch.items() if k not in ("tokens", "bt")}
    st0 = MDL.init_decode_state(cfg, spec, B, device="cpu")
    lg0, st0 = MDL.prefill(cfg, params, st0, batch["tokens"], bt,
                           rt=MDL.Runtime(ring_width=ring), **kw)
    step = SH.make_prefill_step(cfg, plan, parallel, spec,
                                specs=plan.param_specs(params, mode="train"))
    lg1, st1 = step(params, MDL.init_decode_state(cfg, spec, B,
                                                  device="cpu"), batch)

    def close(a, b, what):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-5 * scale, (arch, what)
    close(lg1, lg0, "logits")
    assert set(st1) == set(st0)
    for k in st0:
        for a, b in zip(_walk(st1[k], torch.is_tensor),
                        _walk(st0[k], torch.is_tensor)):
            if k == "pool":
                a, b = a[:, :spec.n_pages], b[:, :spec.n_pages]
            close(a, b, k)
    with pytest.raises(ValueError, match="sp layout"):
        SH.make_prefill_step(cfg, make_plan(
            M.LocalMesh((2, 4), ("data", "model")), parallel,
            ShapeConfig("p", "prefill", S, 8)), parallel, spec,
            specs=plan.param_specs(params, mode="train"))
