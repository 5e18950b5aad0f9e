"""Training step: loss and grads (with microbatch accumulation), then AdamW.

Port of ``repro/training/train.py``. ``make_train_step(cfg, rt, opt_cfg)``
returns ``train_step(params, opt_state, batch) -> (params, opt_state,
metrics)``, functional as JAX's: the inputs are left as they were. The
gradient is autograd's through ``models.model.nll_sum`` (the terms of
``train_loss``) on the plain paths (``check_trainable``: the port's
kernels have no backward, and repro's training path reaches none of its
Pallas kernels). Microbatches split the batch into ``microbatches``
sequential chunks along the batch axis (M-RoPE ``positions`` [3, B, S]
along axis 1), accumulate fp32 grads and divide them, and the loss, by
their count.

With a runtime from ``Plan.make_runtime(mode="train")`` the same step
runs as a shard body on the plan's mesh (FSDP weights, the ``fsdp`` or
``sp`` batch layout), equal to the single-device step up to summation
order, on params and moments each rank keeps resident in the train specs
(``Plan.shard`` / ``Plan.gather`` at the edges).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import mesh as M
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import P
from repro_torch.models import model as MDL
from repro_torch.training import optimizer as OPT


def make_loss_fn(cfg, rt):
    def loss_fn(params, batch):
        return MDL.train_loss(cfg, params, batch, rt=rt)
    return loss_fn


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device)
            for k, v in batch.items()}


def _split_microbatches(batch: dict, n: int) -> dict:
    """[n, B / n, ...] per key: microbatch i is rows [i B / n, (i + 1) B
    / n) of the global batch, as repro splits it (M-RoPE positions [n, 3,
    B / n, S])."""
    out = {}
    for k, x in batch.items():
        if k == "positions" and x.dim() == 3:
            out[k] = x.reshape(3, n, -1, x.shape[-1]).transpose(0, 1)
        else:
            out[k] = x.reshape(n, -1, *x.shape[1:])
    return out


def make_train_step(cfg, rt, opt_cfg: OPT.AdamWConfig, *,
                    microbatches: int = 1, specs=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: one device's step, or, when ``rt`` comes from
    ``Plan.make_runtime(mode="train")``, the counterpart of repro's step
    jitted under the train plan's shardings, on ``rt.plan``'s mesh
    (``LocalMesh`` or ``ProcessMesh``): params and AdamW's moments
    resident in, cut by ``specs`` (``Plan.param_specs(params,
    mode="train")``; required with a plan), and resident out, as repro's ``out_shardings``
    leave them; the step counter and the metrics replicated on every
    rank; the batch global.

    One body runs both. On a mesh each shard holds its FSDP slices of the
    params and of AdamW's moments (``Plan.param_specs(mode="train")``) and
    its part of the batch (``Plan.batch_specs``: ``fsdp`` rows over every
    axis; ``sp`` rows over the dp axes and the sequence over the model
    axis). A layer's whole weights are gathered in its forward
    (``rt.fetch``) and, under remat, again in backward; their grads come
    back summed over every shard and cut to the slice. The loss is the
    shard's summed cross-entropy over the mesh's token count (a ``psum``),
    plus, for a MoE, ``0.01 * aux / n_layers`` over the shard count: the
    shards' losses sum to the step's loss, whose aux is the shards' mean,
    as repro's ``pmean``. AdamW clips by the global grad norm: a ``psum``
    of the slices' squares, a replicated leaf counted on one shard.
    Microbatches are the global batch's, each shard taking its part of
    each, as repro's scan over them; their fp32 grads and losses are
    averaged. Without a plan the collectives are identities.

    Backward runs on the shard's thread
    (``set_multithreading_enabled(False)``): the gathers' transposes and
    the ``sp`` K/V gathers' and ``moe_ep``'s collectives run inside it."""
    MDL.check_trainable(rt, "make_train_step")
    plan = rt.plan
    if plan is not None and specs is None:
        raise TypeError("a sharded train step takes the specs its params "
                        "were cut by: specs=plan.param_specs(params, "
                        "mode='train')")
    axes = tuple(plan.mesh.axis_names) if plan is not None else ()
    n_shards = plan.mesh.size if plan is not None else 1

    def total(x):                         # the sum over the mesh's shards
        return M.psum(x, axes) if axes else x

    def body(p_loc, m_loc, v_loc, step, mb, layout, tree):
        """A shard's step (the whole step without a plan) on its leaves of
        the params and moments (shaped as ``tree``) and its microbatches
        ``mb``."""
        leaves = [p.detach().requires_grad_(True) for p in p_loc]
        ptree = OPT.tree_unflatten(tree, leaves)
        view = SH.fsdp_view(ptree, layout) if layout else ptree
        acc, losses = None, []
        with torch.autograd.set_multithreading_enabled(False):
            for i in range(microbatches):
                b = {k: v[i] for k, v in mb.items()}
                with torch.enable_grad():
                    nll, aux, count = MDL.nll_sum(cfg, view, b, rt=rt)
                    tokens = total(count.detach())
                    loss = nll / tokens.clamp_min(1.0)
                    if cfg.is_moe:
                        loss = loss + 0.01 * aux / (max(1, cfg.n_layers)
                                                    * n_shards)
                    grads = torch.autograd.grad(loss, leaves,
                                                allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g.float()
                         for p, g in zip(leaves, grads)]
                acc = grads if acc is None else [
                    a + g for a, g in zip(acc, grads)]
                losses.append(total(loss.detach()))
        if microbatches > 1:
            acc = [a / microbatches for a in acc]
        gnorm = None
        if layout:
            sq = torch.zeros((), dtype=torch.float32, device=acc[0].device)
            for g, lay in zip(acc, layout):
                if all(M.axis_index(a) == 0 for a in lay[2]):
                    sq = sq + torch.sum(torch.square(g))
            gnorm = torch.sqrt(total(sq))
        unf = OPT.tree_unflatten
        new_p, new_s, om = OPT.apply(
            opt_cfg, unf(tree, [p.detach() for p in leaves]),
            unf(tree, acc), {"m": unf(tree, m_loc), "v": unf(tree, v_loc),
                             "step": step}, gnorm=gnorm)
        loss = sum(losses) / microbatches
        metrics = {"nll": loss, **om, "loss": loss,
                   "tokens": tokens if microbatches == 1
                   else torch.zeros((), device=loss.device)}
        if cfg.is_moe:
            metrics["aux"] = total(aux.detach()) / n_shards
        return (OPT.tree_leaves(new_p), OPT.tree_leaves(new_s["m"]),
                OPT.tree_leaves(new_s["v"]), new_s["step"], metrics)

    def train_step(params, opt_state, batch):
        mb = _split_microbatches(batch, microbatches)
        args = [OPT.tree_leaves(t) for t in (params, opt_state["m"],
                                              opt_state["v"])]
        if plan is None:
            p, m, v, step, metrics = body(*args, opt_state["step"], mb,
                                          None, params)
        else:
            layout = plan.fsdp_layout(params, SH.step_specs(params, specs))
            keys = range(len(layout))
            res = M.Resident({i: lay[0] for i, lay in zip(keys, layout)})
            bspec = {k: P(None, *s) for k, s in
                     plan.batch_specs(batch).items()}

            def shard(p_loc, m_loc, v_loc, step, b_loc):
                out = body(*([d[i] for i in keys]
                             for d in (p_loc, m_loc, v_loc)),
                           step, b_loc, layout, params)
                return (*(dict(zip(keys, x)) for x in out[:3]), *out[3:])

            f = M.shard_map(shard, plan.mesh,
                            in_specs=(res, res, res, None, bspec),
                            out_specs=(res, res, res, None, None))
            p, m, v, step, metrics = f(
                *(dict(zip(keys, x)) for x in args), opt_state["step"], mb)
            p, m, v = ([d[i] for i in keys] for d in (p, m, v))
        unf = OPT.tree_unflatten
        return (unf(params, p), {"m": unf(params, m), "v": unf(params, v),
                                 "step": step}, metrics)

    return train_step
