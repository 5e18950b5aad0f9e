"""Pipeline parallelism over the ``pod`` axis for decode (paper §4.2).

Port of ``repro/distributed/pipeline.py``. TP-only multi-module PIM
collapses (aspect distortion), so layers are grouped into pipeline stages
with moderate TP inside each stage and microbatches keep the pipe full:

* stage s = pod s: the layer list cut into ``n_stages`` runs
  (``stage_specs``: ``mesh.Stages`` over ``pod``, the list form of
  repro's ``P("pod")`` on the stacked layers), so each pod holds only its
  stage's layers, and the pool's layer dim cut over ``pod`` too, so it
  holds only its stage's K/V;
* one decode step is a GPipe loop of ``M + stages - 1`` ticks; at tick t
  stage s runs microbatch t - s through its layers, and activations hop
  to the next stage by ``ppermute`` over ``pod``; the last stage's logits
  are shared by a psum over ``pod`` (the other stages add zeros);
* inside each stage the serve layout of ``(data, model)`` runs as in a
  ``sharding.make_decode_step`` shard: a microbatch's rows are cut over
  the batch axis (``data``; every shard takes them all when they do not
  divide), the stage's layers run as Megatron TP over ``model`` on the
  shard's serve slices (the decode runtime's ``tp_axis``), each shard
  attends over its pages and merges over ``model`` (ITPP), a MoE stack
  runs ``moe_ep_rows`` over ``model``; the last stage's logits are
  gathered back over ``data``.

repro runs the body manual over ``pod`` only, with data / model left to
XLA inside each stage under the serve shardings. The port's body is
manual over every axis (one ``shard_map``): each shard holds its serve
slices of its own stage's layers and of the replicated ``embed``,
``final_norm`` and ``head`` (a ``ProcessMesh`` rank's resident layer list
is its stage's L / n_stages layers; on a ``LocalMesh`` the resident list
is the global one and each shard is handed its stage's run), and the
collectives of TP, the ITPP and the MoE stay inside the pod. A stage
skips the fill and drain ticks outright (Python control flow), where
repro computes them and masks their pool writes; the pipeline bubbles
are the same.

Applies to uniform attention stacks (dense / MoE / VLM, gemma3's windows
included); hybrid and enc-dec stacks use pod = dp.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import mesh as M
from repro_torch.distributed.sharding import serve_args
from repro_torch.models import model as MDL


def stage_specs(plan, p_spec):
    """The pipeline's parameter specs: the serve specs ``p_spec``
    (``Plan.param_specs(params, mode="serve")``) with the layer list cut
    into the plan's pod stages (``mesh.Stages``, as repro's pipeline cell
    gives the stacked layers ``P("pod")``, ``launch/dryrun.py``), each
    layer under its serve spec; ``embed``, ``final_norm`` and an untied
    ``head`` stay replicated over ``pod``."""
    if plan.pod_mode != "pp":
        raise ValueError(f"stage specs need a pipeline plan, not pod_mode "
                         f"{plan.pod_mode!r}")
    return {**p_spec, "layers": M.Stages("pod", tuple(p_spec["layers"]))}


def make_pp_decode_step(cfg, plan, parallel, pool_spec, *, n_stages: int,
                        microbatches: int, specs):
    """``step(params, state, batch) -> (logits [B, V] fp32, state)`` with
    ``batch`` = {tokens [B], bt [B, maxp], ctx [B] incl. the new token,
    npage [B], noff [B]} global; params as ``models.model.init_params``
    makes them, resident in the stage specs they were cut by (``specs``,
    ``stage_specs``: a rank's layer list its stage's layers); the state
    resident in ``Plan.state_specs`` (a pipeline plan's pool block: the
    stage's layers over ``pod``, the page shard's pages), written in place
    and returned so."""
    if "pod" not in plan.mesh.axis_names \
            or plan.axis_sizes["pod"] != n_stages:
        raise ValueError(f"{n_stages} stages need a pod axis of that size; "
                         f"mesh {plan.mesh.shape}")
    if not all(k in ("attn", "local") for k in cfg.block_kinds()) \
            or cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name}: pipeline decode takes "
                                  "uniform attention stacks")
    mesh = plan.mesh
    b, tp = plan.itpp_spec(parallel.page_size).batch_axis, plan.tp_axis
    rt = plan.make_runtime(cfg, parallel, pool_spec=pool_spec,
                           mode="decode")
    windows = MDL._window_array(cfg)
    Ls = cfg.n_layers // n_stages
    n_ticks = microbatches + n_stages - 1

    pool = M.Resident(M.P("pod", M.Paged(plan.page_axes)))

    def step(params, state, batch):
        rest = {k: v for k, v in params.items() if k != "layers"}
        flat, p_spec, tree, vocab_cut = serve_args(plan, rest, specs)

        def body(pool_k, pool_v, p_loc, layers, tokens, bt, ctx, npage,
                 noff):
            """One shard; pool_{k,v} the stage's [L/stages, N+1, ...]
            layers, ``layers`` its serve slices of its stage's layers,
            ``p_loc`` of the other weights."""
            if len(layers) != Ls:       # params not cut by stage_specs
                raise ValueError(f"a stage holds {len(layers)} layers, "
                                 f"not {Ls}")
            p = tree(p_loc)
            s = M.axis_index("pod")
            wins = windows[s * Ls:(s + 1) * Ls]
            mb = tokens.shape[0] // microbatches
            n, off = mb, 0                # this shard's rows of a microbatch
            if b is not None:
                n = mb // M.axis_size(b)
                off = M.axis_index(b) * n
            outs = []
            x = torch.zeros((n, cfg.d_model), dtype=p["final_norm"].dtype,
                            device=tokens.device)
            for t in range(n_ticks):
                i = t - s                 # the microbatch this stage runs
                if 0 <= i < microbatches:
                    r = slice(i * mb + off, i * mb + off + n)
                    if s == 0:
                        x = MDL._embed(cfg, p["embed"], tokens[r], rt)
                    cs = MDL._cos_sin(cfg, (ctx[r].long() - 1)[:, None])
                    for li, (lp, w) in enumerate(zip(layers, wins)):
                        x = MDL._attn_block_decode(
                            lp, cfg, x, cs, w, pool_k[li], pool_v[li],
                            bt[r], ctx[r], npage[r], noff[r], rt)
                    if s == n_stages - 1:
                        outs.append(MDL._logits(cfg, p, x, rt))
                x = M.ppermute(x, "pod", [(k, k + 1)
                                          for k in range(n_stages - 1)])
            out = torch.stack(outs) if outs else torch.zeros(
                (microbatches, n, _vocab_cols(cfg, p)), dtype=torch.float32,
                device=tokens.device)
            out = M.psum(out, "pod")      # the last stage's; the others' 0
            if b is not None:
                out = M.all_gather(out, b, dim=1, tiled=True)
            return (out.reshape(-1, out.shape[-1]),)

        fn = M.shard_map(body, mesh,
                         in_specs=(pool, pool, M.Resident(p_spec),
                                   M.Resident(specs["layers"]), None, None,
                                   None, None, None),
                         out_specs=(M.P(None, tp if vocab_cut else None),))
        logits, = fn(state["pool"]["k"], state["pool"]["v"], flat,
                     params["layers"], batch["tokens"], batch["bt"],
                     batch["ctx"], batch["npage"], batch["noff"])
        return logits, state

    return step


def _vocab_cols(cfg, params) -> int:
    """The logits' columns on a shard: its block of an untied head's
    vocabulary, the whole padded vocabulary of a tied one."""
    if cfg.tie_embeddings:
        return cfg.padded_vocab
    w = params["head"]
    return (w["q"] if isinstance(w, dict) else w).shape[-1]
