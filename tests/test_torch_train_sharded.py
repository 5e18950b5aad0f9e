"""repro_torch's sharded train step (``training/train.py::make_train_step``
with a train plan's runtime) against single-device steps, on the CPU.

``make_train_step(cfg, plan.make_runtime(cfg, parallel, mode="train"),
...)`` runs on a ``LocalMesh((2, 4), ("data", "model"))`` (8 shards as
threads) in the plan's ``train_layout``: ``fsdp`` (rows over every axis)
when the batch divides the 8 shards, else ``sp`` (rows over ``data``, the
sequence over ``model``). At reduced widths every leaf is under the plan's
``REPLICATE_SMALL``, so each case also runs with that threshold at 0: every
divisible leaf is then cut as the production plan cuts the large ones, and
the shards gather their weights in each layer's forward and reduce-scatter
the grads in backward.

(a), (c), (d): reduced llama3.2-1b, fp32, one AdamW step at lr 1e-3,
against repro's jitted single-device ``make_train_step`` on the same numpy
weights: the loss, the grad norm and every parameter within 1e-4. (b)
three steps on an 8-rank gloo ``ProcessMesh``, each rank holding its own
FSDP slices of the params and moments (``Plan.shard``, gathered at the
end), equal the ``LocalMesh``'s bit for bit, and a rank holds exactly its
slices. (e) the other assigned families, in ``fsdp`` and in ``sp``,
against the port's own single-device step (which
``tests/test_torch_train.py`` holds to repro).
"""
import os
import socket
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JMDL
from repro.training import optimizer as JOPT
from repro.training.train import make_train_step as jax_make_train_step
from repro_torch.configs import ParallelConfig, ShapeConfig, get_config
from repro_torch.configs import reduced
from repro_torch.distributed import mesh as M
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models import model as MDL
from repro_torch.models import moe as MOE
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import optimizer as OPT
from repro_torch.training.train import make_train_step
from test_models import build, make_inputs

SRC = Path(__file__).resolve().parent.parent / "src"
S = 16
MESH = ((2, 4), ("data", "model"))
# the plan's own threshold, and 0: every divisible leaf cut
CUTS = {"plan": SH.REPLICATE_SMALL, "all": 0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Serial torch: the LocalMesh runs 8 shard threads, the gloo ranks one
    thread each (bit-equal reductions between the backends)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jbatch(jcfg, B: int, seed: int = 1) -> dict:
    toks = jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0,
                              jcfg.vocab_size)
    return {"tokens": toks, "targets": jnp.roll(toks, -1, 1),
            "mask": jnp.ones((B, S)).at[1, -2:].set(0),
            **make_inputs(jcfg, B, S, S)}


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _mesh_step(cfg, params, B, ocfg, *, microbatches=1, mesh=None):
    """The train step on ``mesh`` (the LocalMesh (2, 4) by default) for
    params cut by its plan's train specs (the plan, the step)."""
    mesh = mesh or M.LocalMesh(*MESH)
    plan = SH.make_plan(mesh, ParallelConfig(), ShapeConfig("t", "train", S,
                                                            B))
    rt = plan.make_runtime(cfg, ParallelConfig(), mode="train")
    return plan, make_train_step(cfg, rt, ocfg, microbatches=microbatches,
                                 specs=plan.param_specs(params, mode="train"))


def _gap(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in
               zip(OPT.tree_leaves(a), OPT.tree_leaves(b)))


def _repro_step(arch, B, jocfg, *, microbatches=1):
    """repro's jitted single-device step: (port cfg, port params, batch,
    loss, grad norm, new params in the port's layout)."""
    jcfg = build(arch)
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jb = _jbatch(jcfg, B)
    step = jax.jit(jax_make_train_step(jcfg, JMDL.Runtime(), jocfg,
                                       microbatches=microbatches))
    jnew, _, jm = step(jparams, JOPT.init(jparams), jb)
    to_port = lambda t: params_from_numpy(cfg, jax.tree.map(np.asarray, t),
                                          "cpu")
    return (cfg, to_port(jparams), _t(jb), float(jm["loss"]),
            float(jm["grad_norm"]), to_port(jnew))


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("case", ["fsdp", "sp", "microbatches", "clip"])
def test_mesh_step_matches_repro(case, cut, monkeypatch):
    """(a) fsdp at B 8, (c) sp at B 2, (d) 2 microbatches at B 16 (a
    microbatch is 8 rows: one a shard) and a clip that binds (clip_norm
    at half the grad norm): loss, grad norm and every parameter within
    1e-4 of repro's single-device step."""
    monkeypatch.setattr(SH, "REPLICATE_SMALL", CUTS[cut])
    B = {"fsdp": 8, "sp": 2, "microbatches": 16, "clip": 8}[case]
    mb = 2 if case == "microbatches" else 1
    clip = 1.0
    if case == "clip":      # half of the step's unclipped grad norm
        clip = _repro_step("llama3.2-1b", B, JOPT.AdamWConfig(
            lr=1e-3, warmup_steps=1))[4] / 2
    jocfg = JOPT.AdamWConfig(lr=1e-3, warmup_steps=1, clip_norm=clip)
    cfg, params, batch, jloss, jnorm, jnew = _repro_step(
        "llama3.2-1b", B, jocfg, microbatches=mb)
    plan, step = _mesh_step(cfg, params, B, OPT.AdamWConfig(
        lr=1e-3, warmup_steps=1, clip_norm=clip), microbatches=mb)
    assert plan.train_layout == ("sp" if case == "sp" else "fsdp")
    if cut == "all":        # the gathers run: a matrix is cut over both
        spec = plan.param_specs(params, mode="train")["layers"][0]
        assert spec["attn"]["wq"] == M.P("data", "model")
    new, opt, m = step(params, OPT.init(params), batch)
    assert abs(float(m["loss"]) - jloss) <= 1e-4
    assert abs(float(m["grad_norm"]) - jnorm) <= 1e-4
    if case == "clip":
        assert float(m["grad_norm"]) > 1.9 * clip
    assert _gap(new, jnew) <= 1e-4
    assert int(opt["step"]) == 1
    assert float(m["tokens"]) == (0 if mb > 1 else B * S - 2)
    # the step is functional: its inputs are left as they were
    assert _gap(params, _repro_step("llama3.2-1b", B, jocfg)[1]) == 0


def test_mesh_step_checks():
    """The train runtime keeps the plain paths and carries its plan; the
    FSDP layout gathers what the specs cut, keeps a MoE's experts on
    their shard and names the axes whose shards hold copies."""
    cfg = replace(reduced(get_config("mixtral-8x22b")), dtype="float32")
    mesh = M.abstract_mesh((16, 16), ("data", "model"))
    plan = SH.make_plan(mesh, ParallelConfig(),
                        ShapeConfig("t", "train", 4096, 256))
    rt = plan.make_runtime(cfg, ParallelConfig(), mode="train")
    assert rt.plan is plan and rt.kernels is None and rt.remat
    full = MDL.init_params(get_config("mixtral-8x22b"), device="meta",
                           moe_virtual=16)
    lay = plan.fsdp_layout(full)
    keys = [k for k, _, _ in SH._leaves(full)]
    by = dict(zip(keys, lay))
    spec, cut, rest, pick = by[("layers", "0", "moe", "w1")]
    assert spec == M.P("model", "data", None) and cut == [(1, "data")]
    assert rest == () and pick is None
    spec, cut, rest, pick = by[("layers", "0", "attn", "wq")]
    assert cut == [(0, "data"), (1, "model")] and rest == ()
    spec, cut, rest, pick = by[("layers", "0", "ln1")]
    assert spec == M.P() and cut == [] and rest == ("data", "model")
    # a small (replicated) expert weight: the shard keeps its expert
    small = MDL.init_params(cfg, device="meta", moe_virtual=16)
    lay = dict(zip([k for k, _, _ in SH._leaves(small)],
                   plan.fsdp_layout(small)))
    assert lay[("layers", "0", "moe", "w2")] == (M.P(), [], ("data", "model"),
                                                 (0, "model"))
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, replace(rt, kernels=KernelConfig()),
                        OPT.AdamWConfig())


# ---------------------------------------------------------------------------
# (e) the other assigned families, against the port's single-device step
# ---------------------------------------------------------------------------

FAMILIES = ("zamba2-1.2b", "xlstm-350m", "whisper-small", "qwen2-vl-7b",
            "gemma3-27b")
# eps 1e-6: at the default 1e-8 AdamW's first step is lr * sign(g) for
# every |g| above 1e-8, so the rounding noise of a grad that is zero in
# exact arithmetic (ROADMAP C.11: xLSTM's) sets a step of up to lr
E_OPT = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, eps=1e-6)


def _port_case(arch, B, *, virtual=0):
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    if cfg.is_moe:
        cfg = replace(cfg, capacity_factor=8.0)      # drops nothing
    params = MDL.init_params(cfg, seed=0, device="cpu", moe_virtual=virtual)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    batch = {"tokens": toks, "targets": toks.roll(-1, 1),
             "mask": torch.ones(B, S)}
    batch["mask"][1, -2:] = 0
    if cfg.rope_kind == "mrope":
        batch["positions"] = torch.arange(S)[None, None].expand(
            3, B, S).contiguous()
        batch["extra_embeds"] = 0.02 * torch.randn(B, S, cfg.d_model,
                                                   generator=g)
    if cfg.family == "encdec":
        batch["frames"] = 0.1 * torch.randn(B, cfg.enc_seq, cfg.d_model,
                                            generator=g)
    return cfg, params, batch


def _family_step(arch, B, layout):
    """One step of ``arch`` at ``B`` rows on the mesh (``layout`` the
    plan's choice) and on one device: loss within 1e-4 and every
    parameter and first moment (the clipped grads) within 1e-4."""
    cfg, params, batch = _port_case(arch, B)
    ref = make_train_step(cfg, MDL.Runtime(remat=True), E_OPT)
    p0, s0, m0 = ref(params, OPT.init(params), batch)
    plan, step = _mesh_step(cfg, params, B, E_OPT)
    assert plan.train_layout == layout
    p1, s1, m1 = step(params, OPT.init(params), batch)
    assert abs(float(m1["loss"]) - float(m0["loss"])) <= 1e-4
    assert _gap(p1, p0) <= 1e-4 and _gap(s1["m"], s0["m"]) <= 1e-4


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_step_families(arch, cut, monkeypatch):
    """fsdp at B 8, against the port's single-device step."""
    monkeypatch.setattr(SH, "REPLICATE_SMALL", CUTS[cut])
    _family_step(arch, 8, "fsdp")


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_step_families_sp(arch, cut, monkeypatch):
    """sp at B 2 (a row over each ``data`` shard, 4 tokens over each
    ``model`` shard), against the port's single-device step: Mamba2,
    mLSTM and sLSTM on the gathered sequence (their grads cut back to
    the shard's slice), whisper's decoder positions offset by the shard's
    block, M-RoPE positions cut along the sequence, gemma3's windowed
    attention at the shard's ``q_offset``."""
    monkeypatch.setattr(SH, "REPLICATE_SMALL", CUTS[cut])
    _family_step(arch, 2, "sp")


@pytest.mark.parametrize("cut", list(CUTS))
def test_mesh_step_moe_ep(cut, monkeypatch):
    """reduced mixtral-8x22b on ``moe_ep`` (4 experts, one a model shard,
    dropless): the aux is the shards' mean of their own balance terms (C.5;
    ``moe_local``'s over every token differs), so the step equals a
    single-device step whose MoE returns that mean: loss and every
    parameter within 1e-4; the cross-entropy within 1e-4 of the plain
    single-device step's, and every leaf the aux term does not reach
    within 1e-4 of it."""
    monkeypatch.setattr(SH, "REPLICATE_SMALL", CUTS[cut])
    cfg, params, batch = _port_case("mixtral-8x22b", 8, virtual=4)

    def shard_mean_moe(p, cfg_, x):      # fsdp: shard s holds row s
        y = MOE.moe_local(p, cfg, x)
        aux = torch.stack([MOE.aux_loss(p["router"], cfg, x[r])
                           for r in range(x.shape[0])]).mean()
        return y, aux

    ref = make_train_step(cfg, MDL.Runtime(remat=True, moe=shard_mean_moe),
                          E_OPT)
    p0, _, m0 = ref(params, OPT.init(params), batch)
    _, step = _mesh_step(cfg, params, 8, E_OPT)
    p1, _, m1 = step(params, OPT.init(params), batch)
    assert abs(float(m1["loss"]) - float(m0["loss"])) <= 1e-4
    assert _gap(p1, p0) <= 1e-4
    with torch.no_grad():
        _, aux_mean = MDL.forward_hidden(
            cfg, params, batch["tokens"],
            rt=MDL.Runtime(moe=shard_mean_moe))
        _, aux_all = MDL.forward_hidden(cfg, params, batch["tokens"])
    np.testing.assert_allclose(float(m1["aux"]), float(aux_mean), rtol=1e-5)
    assert abs(float(aux_all) - float(aux_mean)) > 1e-4
    plain = make_train_step(cfg, MDL.Runtime(remat=True), E_OPT)
    p2, _, m2 = plain(params, OPT.init(params), batch)
    w = 0.01 / cfg.n_layers
    ce_mesh = float(m1["loss"]) - w * float(m1["aux"])
    assert abs(ce_mesh - (float(m2["loss"]) - w * float(aux_all))) <= 1e-4
    # the aux term reaches every leaf upstream of a router (through the
    # router's input); the last layer's experts and the final norm it
    # does not reach
    last = str(cfg.n_layers - 1)
    held = 0
    for (keys, a, _), b in zip(SH._leaves(p1), OPT.tree_leaves(p2)):
        if keys in (("final_norm",), ("head",)) or \
                keys[:3] == ("layers", last, "moe") and keys[-1] != "router":
            assert float((a - b).abs().max()) <= 1e-4, keys
            held += 1
    assert held >= 3


# ---------------------------------------------------------------------------
# (b) the same steps on an 8-rank gloo ProcessMesh
# ---------------------------------------------------------------------------

RANK_PROG = r"""
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[5])
from test_torch_train_sharded import CASES, run_case
from repro_torch.distributed import mesh as M
rank, port, outp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=8, rank=rank)
mesh = M.ProcessMesh((2, 4), ("data", "model"))
res = {}
for name in CASES:
    facts = {}
    res.update({f"{name}/{k}": v
                for k, v in run_case(name, mesh, facts).items()})
    res.update({f"facts/{name}/{k}": v for k, v in facts.items()})
if rank == 0:
    np.savez(outp, **res)
dist.barrier()
dist.destroy_process_group()
"""

# (arch, B, threshold, microbatches)
CASES = {"fsdp": ("llama3.2-1b", 8, 0, 1),
         "sp": ("llama3.2-1b", 2, 0, 1),
         "microbatches": ("llama3.2-1b", 16, 0, 2),
         "moe": ("mixtral-8x22b", 8, 0, 1)}
TRAIN_STEPS = 3


def run_case(name: str, mesh, facts: dict | None = None) -> dict:
    """``TRAIN_STEPS`` steps of ``CASES[name]`` on ``mesh``, the params and
    AdamW's moments cut to the rank's own FSDP slices at the start
    (``Plan.shard``) and gathered at the end (``Plan.gather``): the new
    params, moments and each step's metrics as numpy arrays. ``facts``
    gets what the rank held and moved (``test_torch_decode_tp.
    resident_facts``: no bytes but the metrics' in the assembly, which
    has none to gather)."""
    from test_torch_decode_tp import assembly_counter, resident_facts
    arch, B, small, mb = CASES[name]
    old, SH.REPLICATE_SMALL = SH.REPLICATE_SMALL, small
    try:
        cfg, params, batch = _port_case(
            arch, B, virtual=4 if arch == "mixtral-8x22b" else 0)
        plan, step = _mesh_step(cfg, params, B, E_OPT, microbatches=mb,
                                mesh=mesh)
        spec = plan.param_specs(params, mode="train")
        o_spec = {"m": spec, "v": spec, "step": None}
        p = plan.shard(params, spec)
        s = OPT.init(p)
        held = (p, s)
        out = {}
        with assembly_counter(mesh) as moved:
            for i in range(TRAIN_STEPS):
                p, s, m = step(p, s, batch)
                out.update({f"{k}{i}": v.numpy() for k, v in m.items()})
        if facts is not None:
            facts.update(resident_facts(
                plan, (params, OPT.init(params)), held, (spec, o_spec),
                (0, 0), moved["bytes"]))
            facts["logits"] = np.int64(0)
        p, s = plan.gather(p, spec), plan.gather(s, o_spec)
    finally:
        SH.REPLICATE_SMALL = old
    out.update({f"p{i}": x.numpy() for i, x in enumerate(OPT.tree_leaves(p))})
    out.update({f"m{i}": x.numpy()
                for i, x in enumerate(OPT.tree_leaves(s["m"]))})
    out["step"] = s["step"].numpy()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo_train") / "out.npz"
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    port = str(_free_port())
    here = str(Path(__file__).resolve().parent)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_PROG, str(r), port, str(out), "",
         here], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(8)]
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
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(CASES))
def test_process_mesh_step_equals_local_mesh(gloo, name):
    """(b): ``TRAIN_STEPS`` steps on each rank's resident params and
    moments, gathered at the end: params, first moments, the step count
    and every step's loss and grad norm of the gloo ranks equal the
    LocalMesh's bit for bit."""
    local = run_case(name, M.LocalMesh(*MESH))
    got = {k[len(name) + 1:]: v for k, v in gloo.items()
           if k.startswith(name + "/")}
    assert set(got) == set(local)
    for k, v in local.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(local["step"]) == TRAIN_STEPS


@pytest.mark.parametrize("name", list(CASES))
def test_process_mesh_step_state_stays_resident(gloo, name):
    """What rank 0 held and moved: its params and both moments (and the
    step counter) are exactly its FSDP slices under the plan
    (``Plan.local_bytes`` and the dry-run's ``argument_bytes`` rule, the
    counter whole: nothing beyond the dry-run's count), and the steps' output assembly sent no byte (the metrics are
    replicated; params and moments stay resident)."""
    f = {k[len(f"facts/{name}/"):]: v for k, v in gloo.items()
         if k.startswith(f"facts/{name}/")}
    assert int(f["held"]) == int(f["want"]) == int(f["want_dryrun"]) > 0
    assert int(f["beyond_dryrun"]) == 0
    assert int(f["moved"]) == 0
