"""The port's dry-run tooling (``repro_torch.launch.dryrun``, ``roofline``,
``profile_cell``) on the CPU.

A cell runs one shard's step on meta tensors over the production mesh with
the shape-only backend (``distributed/mesh.ShapeMesh``). A subset of the 68
cells builds and writes its JSON here: reduced in count, never in size (the
cells are the production shapes; nothing is allocated).
"""
import ast
import json
import math
from pathlib import Path

import pytest
import torch

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro_torch.configs import ASSIGNED, SHAPES, ParallelConfig, get_config
from repro_torch.distributed import mesh as M
from repro_torch.distributed.sharding import make_plan
from repro_torch.launch import dryrun as DR
from repro_torch.launch import profile_cell as PC
from repro_torch.launch import roofline as RF
from repro_torch.models import ssm as SSM

ROOT = Path(__file__).resolve().parent.parent
# (arch, shape, multi_pod, pod_mode)
CELLS = [("llama3.2-1b", s, mp, "dp")
         for s in ("train_4k", "prefill_32k", "decode_32k")
         for mp in (False, True)] + [
    ("llama3.2-1b", "decode_32k", True, "pp"),
    ("gemma3-27b", "long_500k", False, "dp"),
    ("mixtral-8x22b", "decode_32k", False, "dp"),
    ("whisper-small", "prefill_32k", False, "dp"),
    ("zamba2-1.2b", "train_4k", True, "dp"),
]
RECURRENT = ("zamba2-1.2b", "xlstm-350m")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Every cell of ``CELLS`` run once, its JSON written under a temporary
    results directory."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    old, DR.RESULTS = DR.RESULTS, out
    try:
        res = {c: DR.run_cell(c[0], c[1], multi_pod=c[2], pod_mode=c[3],
                              verbose=False) for c in CELLS}
    finally:
        DR.RESULTS = old
    return out, res


def _repro_keys() -> tuple[set, set, set]:
    """The top-level, ``memory`` and ``hlo`` keys of repro's ``run_cell``
    JSON, read from its source (its ``out = {...}`` and the keys its
    ``HLO.analyze`` returns)."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    top = mem = None
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "memory"
                for k in node.keys):
            top = {k.value for k in node.keys}
            mem = {k.value for k in node.values[
                [k.value for k in node.keys].index("memory")].keys}
    hsrc = (ROOT / "src/repro/launch/hlo_analysis.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(hsrc))
              if isinstance(n, ast.FunctionDef) and n.name == "analyze")
    ret = [n.value for n in ast.walk(fn) if isinstance(n, ast.Return)
           and isinstance(n.value, ast.Dict)][-1]
    return top, mem, {k.value for k in ret.keys}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(map(str, c)))
def test_cell_builds_and_writes_json(cells, cell):
    out, res = cells
    r = res[cell]
    assert r["ok"], r.get("traceback")
    name = f"{cell[0]}__{cell[1]}__{'pod2' if cell[2] else 'pod1'}" + (
        "__pp" if cell[3] == "pp" else "")
    on_disk = json.loads((out / f"{name}.json").read_text())
    assert on_disk["cell"] == name and on_disk["ok"]
    assert r["devices"] == (512 if cell[2] else 256)
    h = r["hlo"]
    assert h["flops"] > 0 and h["hbm_bytes"] > 0
    assert h["collective_bytes"] == sum(h["collectives"].values())
    m = r["memory"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    if cell[:3] == ("llama3.2-1b", "train_4k", True):
        assert r["layout"] == "sp"      # 256 rows over 512 shards
    if SHAPES[cell[1]].kind == "train":
        # FSDP: weights gathered in forward (and remat), grads scattered
        assert h["collectives"]["all-gather"] > 0
        assert h["collectives"]["reduce-scatter"] > 0
    if SHAPES[cell[1]].kind == "decode":
        # Megatron TP: the row-parallel products summed over ``model``
        assert h["collectives"]["all-reduce"] > 0


def test_json_keys_are_repros(cells):
    """repro's keys minus the quantities XLA alone has (the TPU-adjusted
    peak, XLA's cost analysis, the lower and compile times, and the HLO
    parse's CPU upcast bytes and computation count), with one build time
    in place of lower + compile; plus the port's ``layout`` and
    ``notes``."""
    top, mem, hlo = _repro_keys()
    r = cells[1][CELLS[0]]
    assert set(r) == (top - {"xla_cost", "t_lower_s", "t_compile_s"}) | {
        "t_build_s", "layout", "notes"}
    assert set(r["memory"]) == mem - {"peak_bytes_tpu_adjusted"}
    assert set(r["hlo"]) == hlo - {"cpu_upcast_bytes", "n_computations"}
    assert set(r["roofline"]) == {"t_compute", "t_memory", "t_collective",
                                  "bottleneck", "t_bound"}


def test_argument_bytes_follow_the_specs(cells):
    """The train cell's per-shard argument bytes: params in the train
    (FSDP) specs, fp32 moments in the same, the step counter, the batch
    rows and sequence of one shard."""
    step, args, in_sh, _, plan = DR.build_cell("llama3.2-1b", "train_4k",
                                               multi_pod=False)
    sizes = plan.axis_sizes
    from repro_torch.distributed.sharding import _leaves
    params = args[0]
    want = 0
    for (_, t, _), spec in zip(_leaves(params),
                               plan.spec_list(params, mode="train")):
        cut = math.prod(math.prod(sizes[a] for a in M._names(e))
                        for e in spec if e is not None)
        want += t.numel() * (2 + 4 + 4) // cut     # bf16 param, fp32 m, v
    want += 4                                      # the step
    B, S = 256, 4096
    want += (B // 256) * S * (4 + 4 + 4)           # tokens, targets, mask
    assert cells[1][CELLS[0]]["memory"]["argument_bytes"] == want


# the pipeline cell's argument_bytes before a pipeline rank held only its
# own stage's layers: counted then as every layer's share over the pods
PP_ARGUMENT_BYTES = 370565280


def test_pipeline_argument_bytes_are_the_stage_specs(cells):
    """The pipeline cell (``llama3.2-1b decode_32k pod2 pp``) counts a
    rank's stage: its serve slices of the first L / 2 layers (the stage of
    the shard the cell runs as, pod 0) and of the replicated weights, its
    pool block (the stage's layers over ``pod``, pages over the page
    axes) and its batch rows, from the shapes; the same bytes the count
    gave before the stage cut (``PP_ARGUMENT_BYTES``)."""
    _, args, in_sh, _, plan = DR.build_cell(
        "llama3.2-1b", "decode_32k", multi_pod=True, pod_mode="pp")
    sizes = plan.axis_sizes
    from repro_torch.distributed.sharding import _leaves

    def cut(spec):
        return math.prod(math.prod(sizes[a] for a in M._names(e))
                         for e in spec or () if e is not None)
    params, L = args[0], len(args[0]["layers"])
    want = sum(t.numel() * t.element_size() // cut(spec)
               for (keys, t, _), spec in zip(
                   _leaves(params), plan.spec_list(params, mode="serve"))
               if keys[0] != "layers" or int(keys[1]) < L // 2)
    for tree, specs in zip(args[1:], in_sh[1:]):
        want += sum(t.numel() * t.element_size() // cut(s)
                    for t, s in M.leaf_specs(tree, specs))
    got = cells[1][CELLS[6]]["memory"]["argument_bytes"]
    assert CELLS[6] == ("llama3.2-1b", "decode_32k", True, "pp")
    assert got == want == PP_ARGUMENT_BYTES


def _plain_attention_flops(cfg, shape, n_dev: int) -> float:
    """A prefill's self-attention products as the plain path computes
    them (every (q, k) pair: the causal mask saves no product), per
    device: 4 B S^2 H d over the attention layers. ``model_flops`` (2ND)
    leaves them out, and at 32k tokens they are most of a prefill."""
    n_attn = sum(k in ("attn", "local") for k in cfg.block_kinds())
    if cfg.family == "encdec":
        n_attn = cfg.n_layers
    return (4.0 * shape.global_batch * shape.seq_len ** 2 * cfg.n_heads
            * cfg.d_head * n_attn / n_dev)


def _decode_attention_flops(cfg, shape, n_dev: int) -> float:
    """A decode step's attention products per device: 4 B H d against
    every context token of a global layer, its window's of a local one.
    ``model_flops``'s decode term counts the K/V bytes a step reads,
    which a GQA stack's H / KVH query heads per K/V head multiply."""
    span = sum(shape.seq_len if k == "attn" else
               min(shape.seq_len, cfg.sliding_window or shape.seq_len)
               for k in cfg.block_kinds() if k in ("attn", "local"))
    return 4.0 * shape.global_batch * cfg.n_heads * cfg.d_head * span / n_dev


def test_flops_against_model_flops(cells):
    """The counted flops against ``model_flops`` (6ND train, 2ND prefill
    and decode, over the devices), within 0.5-4x:

    * train: as they are (the count adds attention and remat's
      recompute);
    * prefill (the ``sp`` shard body): with the plain attention's (q, k)
      products added to ``model_flops``;
    * recurrent ``sp`` cells (zamba2 on pod2), the exception: each shard
      runs a recurrent layer over the whole gathered sequence, so the
      ratio is low (0.06); ``notes.sp_recurrent_flops`` is that layer's
      parameter products on the other shards' tokens (its scan's own
      work, which 6ND leaves out, comes on top);
    * decode and long (``make_decode_step``'s and the pipeline stage's
      Megatron-TP shard body, pp included): with the attention products
      added to ``model_flops`` (``_decode_attention_flops``), as prefill
      adds its own. A batch the dp axes do not divide (long_500k's one
      request) is replicated over them by repro's serve layout: each data
      row computes the dense layers' 1/tp share of the whole request, so
      its 2ND counts ``notes.replicated_rows`` (the dp size) times over;
      a divided batch has ``replicated_rows`` 1.

    Every ratio is printed."""
    for cell, r in cells[1].items():
        arch, shape = cell[:2]
        cfg, sh = get_config(arch), SHAPES[shape]
        mf = RF.model_flops(arch, shape, r["devices"])
        if sh.kind == "prefill":
            mf += _plain_attention_flops(cfg, sh, r["devices"])
        rep = r["notes"]["replicated_rows"]
        if sh.kind == "decode":
            plan = make_plan(M.make_production_mesh(multi_pod=cell[2]),
                             ParallelConfig(), sh, pod_mode=cell[3])
            assert rep == (1 if plan.batch_divisible else plan.dp_total)
            mf += _decode_attention_flops(cfg, sh, r["devices"]) + (
                rep - 1) * 2 * cfg.active_param_count() * sh.global_batch \
                / r["devices"]
        else:
            assert rep == 1
        counted = r["hlo"]["flops"]
        rec = r["notes"]["sp_recurrent_flops"]
        print(f"{cell}: model/counted flops {mf / counted:.4f}"
              + (f", sp recurrent share {rec / counted:.3f}" if rec else "")
              + (f", rows replicated {rep}x" if rep > 1 else ""))
        if rec:     # the exception: printed, and its cause counted
            assert arch in RECURRENT and r["layout"] == "sp", cell
            assert mf / counted < 0.5 and 0 < rec < counted, cell
            continue
        assert 0.5 <= mf / counted <= 4, (cell, mf / counted)


def test_tally_flops_equal_flop_counter_mode():
    """The tally's flops (``FlopCounterMode``'s per-op rule in the tally's
    own mode) equal ``FlopCounterMode``'s total on a whole cell step."""
    from torch.utils.flop_counter import FlopCounterMode
    step, args, _, _, plan = DR.build_cell("mixtral-8x22b", "decode_32k",
                                           multi_pod=False)
    with FlopCounterMode(display=False) as fc, DR.Tally(plan.mesh) as t:
        step(*args)
    assert t.flops == fc.get_total_flops() > 0


def test_shape_mesh_collective_bytes():
    """The shape-only backend's byte rule: ``tests/test_hlo_analysis.py::
    test_collective_byte_accounting``'s numbers — an all-gather of bf16
    [4, 8] over 4 shards (256, its output), an all-reduce of the [16, 8]
    result (512, twice its input) and a permute of it (256)."""
    mesh = M.ShapeMesh((4,), ("model",))

    def body(r):
        x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
        ag = M.all_gather(x, "model", tiled=True)
        ar = M.psum(ag, "model")
        pp = M.ppermute(ar, "model", [(0, 1)])
        return ag, ar, pp
    ag, ar, pp = mesh.run(body)
    assert ag.shape == ar.shape == pp.shape == (16, 8)
    assert mesh.collectives == {"all-gather": 256, "all-reduce": 512,
                                "collective-permute": 256}
    # the transpose pair and all_to_all; a one-shard group moves nothing
    mesh = M.ShapeMesh((2, 4), ("data", "model"))

    def body2(r):
        x = torch.empty((8, 4), dtype=torch.float32, device="meta")
        rs = M.psum_scatter(x, "model", dim=0, tiled=True)
        a2a = M.all_to_all(torch.empty((4, 3), device="meta"), "model")
        one = M.psum(x, ())
        return rs, a2a, one
    rs, a2a, one = mesh.run(body2)
    assert rs.shape == (2, 4) and a2a.shape == (4, 3)
    assert mesh.collectives == {"reduce-scatter": 128, "all-to-all": 48}


def test_roofline_terms_with_the_cards_figures():
    """After ``test_roofline_terms_and_bottleneck``, at the H100's
    datasheet figures: 989 TF/s, 3.35 TB/s, 450 GB/s."""
    t = RF.roofline_terms({"flops": 989e12, "hbm_bytes": 3.35e12 * 2,
                           "collective_bytes": 450e9 * 0.5})
    assert abs(t["t_compute"] - 1.0) < 1e-9
    assert abs(t["t_memory"] - 2.0) < 1e-9
    assert abs(t["t_collective"] - 0.5) < 1e-9
    assert t["bottleneck"] == "memory" and t["t_bound"] == t["t_memory"]
    t = RF.roofline_terms({"flops": 989e12 * 3, "hbm_bytes": 0,
                           "collective_bytes": 450e9})
    assert t["bottleneck"] == "compute"


def test_assigned_equals_repros():
    assert ASSIGNED == JAX_ASSIGNED


def test_roofline_and_profile_cell_read_the_cells(cells, capsys):
    """``roofline`` reads the written JSONs into its table; ``profile_cell``
    attributes a cell's flops, bytes and collectives to ops, summing to
    the cell's totals."""
    out, res = cells
    rows = RF.load("all", out)
    assert len(rows) == len(CELLS) and all(r["ok"] for r in rows)
    md = RF.emit_markdown(rows)
    assert md.count("\n| llama3.2-1b |") == 7 and "Levers" in md
    assert RF.main(["--mesh", "all", "--results", str(out)]) == 0
    rows, s = PC.profile("llama3.2-1b", "decode_32k")
    want = res[("llama3.2-1b", "decode_32k", False, "dp")]["hlo"]
    assert s == want
    assert sum(r[0] for r in rows) == want["flops"]
    assert PC.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                    "--kind", "coll"]) == 0
    assert "collective:all-gather" in capsys.readouterr().out


@pytest.mark.parametrize("grad", [False, True])
def test_slstm_extrapolation_counts_the_whole_loop(grad):
    """The sLSTM loop counted as its first step times S equals the loop
    run in full (forward, and forward + backward to the input and every
    weight, as a train step takes it), on a short sequence."""
    cfg = get_config("xlstm-350m")
    p = {k: torch.empty(v, device="meta", dtype=torch.bfloat16,
                        requires_grad=grad) for k, v in {
        "ln": (cfg.d_model,), "w": (cfg.d_model, 4 * cfg.d_model),
        "b": (4 * cfg.d_model,),
        "r": (4, cfg.n_heads, cfg.d_model // cfg.n_heads,
              cfg.d_model // cfg.n_heads),
        "norm": (cfg.d_model,), "proj": (cfg.d_model, cfg.d_model)}.items()}
    for k in ("b",):
        p[k] = p[k].float().detach().requires_grad_(grad)
    x = torch.empty((2, 6, cfg.d_model), device="meta", dtype=torch.bfloat16,
                    requires_grad=grad)

    def run(extrapolate):
        from torch.utils.flop_counter import FlopCounterMode
        if extrapolate:
            with DR.counting() as (tally, extra):
                y, _ = SSM.slstm_forward(p, cfg, x)
                if grad:
                    torch.autograd.grad(y.sum(), [x, *p.values()])
            return tally.flops + extra["flops"], extra["steps"]
        with FlopCounterMode(display=False) as fc:
            y, _ = SSM.slstm_forward(p, cfg, x)
            if grad:
                torch.autograd.grad(y.sum(), [x, *p.values()])
        return fc.get_total_flops(), 0
    full, _ = run(False)
    counted, steps = run(True)
    assert steps == 5 and counted == full
