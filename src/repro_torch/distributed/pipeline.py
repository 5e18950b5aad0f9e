"""Pipeline parallelism over the ``pod`` axis for decode (paper §4.2).

Port of ``repro/distributed/pipeline.py``. TP-only multi-module PIM
collapses (aspect distortion), so layers are grouped into pipeline stages
with moderate TP inside each stage and microbatches keep the pipe full:

* stage s = pod s: the layer list cut into ``n_stages`` runs
  (``stack_stages``), the pool's layer dim cut over ``pod`` too, so each
  pod holds only its stage's K/V;
* one decode step is a GPipe loop of ``M + stages - 1`` ticks; at tick t
  stage s runs microbatch t - s through its layers, and activations hop
  to the next stage by ``ppermute`` over ``pod``; the last stage's logits
  are shared by a psum over ``pod`` (the other stages add zeros);
* inside each stage the ITPP of ``(data, model)`` runs as in
  ``core/itpp.py``: the microbatch's rows are cut over the batch axis
  (``data``), each shard attends over its pages and merges over
  ``model``, and the rows are gathered back over ``data``; a MoE stack
  runs ``moe_ep`` over ``model`` the same way.

repro runs the body manual over ``pod`` only, with data / model left to
XLA inside each stage. The port's body is manual over every axis (one
``shard_map``): each shard of a pod computes the stage's dense layers on
the whole microbatch (replicated, as XLA's auto axes would leave the
values) and the collectives of the ITPP and the MoE stay inside the pod.
A stage skips the fill and drain ticks outright (Python control flow),
where repro computes them and masks their pool writes; the pipeline
bubbles are the same.

Applies to uniform attention stacks (dense / MoE / VLM, gemma3's windows
included); hybrid and enc-dec stacks use pod = dp.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.core.itpp import itpp_decode_attention_shard
from repro_torch.distributed import mesh as M
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.models import moe as MOE


def stack_stages(layers: list, n_stages: int) -> list[list]:
    """[L] per-layer list -> ``n_stages`` lists of L / n_stages layers."""
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not cut into "
                         f"{n_stages} stages")
    n = len(layers) // n_stages
    return [layers[s * n:(s + 1) * n] for s in range(n_stages)]


def _by_rows(fn, batch_axis, *rows):
    """``fn`` on this shard's rows of each ``rows`` tensor (cut over
    ``batch_axis``), its first output gathered back over the axis."""
    if batch_axis is None:
        return fn(*rows)
    nb, i = M.axis_size(batch_axis), M.axis_index(batch_axis)
    n = rows[0].shape[0] // nb
    out = fn(*(r.narrow(0, i * n, n) for r in rows))
    first = M.all_gather(out[0], batch_axis, tiled=True)
    return (first, *out[1:])


def make_pp_decode_step(cfg, plan, parallel, pool_spec, *, n_stages: int,
                        microbatches: int):
    """``step(params, state, batch) -> (logits [B, V] fp32, state)`` with
    ``batch`` = {tokens [B], bt [B, maxp], ctx [B] incl. the new token,
    npage [B], noff [B]}; params as ``models.model.init_params`` makes
    them (the step cuts the layers into stages). The pool is written in
    place on a ``LocalMesh``."""
    if "pod" not in plan.mesh.axis_names \
            or plan.axis_sizes["pod"] != n_stages:
        raise ValueError(f"{n_stages} stages need a pod axis of that size; "
                         f"mesh {plan.mesh.shape}")
    if not all(k in ("attn", "local") for k in cfg.block_kinds()) \
            or cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name}: pipeline decode takes "
                                  "uniform attention stacks")
    mesh = plan.mesh
    ispec = plan.itpp_spec(parallel.page_size)
    b = ispec.batch_axis
    ring = pool_spec.max_pages_per_req if pool_spec.ring else 0
    kernels = KernelConfig(use_kernels=parallel.use_kernels,
                           n_splits=parallel.kernel_splits)
    itpp = partial(itpp_decode_attention_shard, spec=ispec,
                   max_pages_per_req=pool_spec.max_pages_per_req,
                   ring_width=ring, kernels=kernels,
                   pool_layout=mesh.pool_layout)

    def itpp_rows(q, k, v, pk, pv, bt, ctx, npage, noff, window):
        return _by_rows(lambda q_, k_, v_, bt_, c_, np_, no_: itpp(
            q_, k_, v_, pk, pv, bt_, c_, np_, no_, window),
            b, q, k, v, bt, ctx, npage, noff)

    def moe_rows(p, cfg_, x):
        def ep(x_loc):
            B, S, D = x_loc.shape
            y, aux = MOE.moe_ep({k: _expert_slice(k, w, plan.tp_axis)
                                 for k, w in p.items()}, cfg,
                                x_loc.reshape(-1, D), plan.tp_axis, plan.tp)
            return y.reshape(B, S, D), aux
        return _by_rows(ep, b, x)

    rt = MDL.Runtime(itpp=itpp_rows, moe=moe_rows if cfg.is_moe else None,
                     ring_width=ring, kernels=kernels)
    windows = MDL._window_array(cfg)
    Ls = cfg.n_layers // n_stages
    n_ticks = microbatches + n_stages - 1

    def body(pool_k, pool_v, params, tokens, bt, ctx, npage, noff):
        """One shard; pool_{k,v} the stage's [L/stages, N+1, ...] layers."""
        s = M.axis_index("pod")
        layers = stack_stages(params["layers"], n_stages)[s]
        wins = windows[s * Ls:(s + 1) * Ls]
        B = tokens.shape[0]
        mb = B // microbatches
        out = torch.zeros((B, cfg.padded_vocab), dtype=torch.float32,
                          device=tokens.device)
        x = torch.zeros((mb, cfg.d_model), dtype=params["embed"].dtype,
                        device=tokens.device)
        for t in range(n_ticks):
            i = t - s                     # the microbatch this stage runs
            if 0 <= i < microbatches:
                r = slice(i * mb, (i + 1) * mb)
                if s == 0:
                    x = L.embed(params["embed"], tokens[r])
                cs = MDL._cos_sin(cfg, (ctx[r].long() - 1)[:, None])
                for li, (lp, w) in enumerate(zip(layers, wins)):
                    x = MDL._attn_block_decode(
                        lp, cfg, x, cs, w, pool_k[li], pool_v[li], bt[r],
                        ctx[r], npage[r], noff[r], rt)
                if s == n_stages - 1:
                    out[r] = MDL._logits(cfg, params, x)
            x = M.ppermute(x, "pod", [(k, k + 1)
                                      for k in range(n_stages - 1)])
        out = M.psum(out if s == n_stages - 1 else torch.zeros_like(out),
                     "pod")
        return out, pool_k, pool_v

    pool_in = M.P("pod", M.Paged(plan.page_axes))
    # on a LocalMesh the stage views are written in place: nothing to
    # assemble; a ProcessMesh gathers its stages' pages back
    pool_out = None if mesh.pool_layout == "global" else pool_in
    fn = M.shard_map(body, mesh,
                     in_specs=(pool_in, pool_in, None, None, None, None,
                               None, None),
                     out_specs=(None, pool_out, pool_out))

    def step(params, state, batch):
        pool = state["pool"]
        logits, pk, pv = fn(pool["k"], pool["v"], params, batch["tokens"],
                            batch["bt"], batch["ctx"], batch["npage"],
                            batch["noff"])
        if pool_out is not None:
            state = {**state, "pool": {"k": pk, "v": pv}}
        return logits, state

    return step


def _expert_slice(name: str, w, axis: str):
    """This shard's virtual expert of a ``[V, ...]`` MoE leaf (the router
    stays whole)."""
    if name == "router":
        return w
    i = M.axis_index(axis)
    if isinstance(w, dict):
        return {k: v.narrow(0, i, 1) for k, v in w.items()}
    return w.narrow(0, i, 1)
