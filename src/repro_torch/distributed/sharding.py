"""Sharding plans: parameter specs, activation layouts and the Runtime
wiring (ITPP decode attention, the shard-local prefill writer,
expert-parallel MoE) of a cell.

Port of ``repro/distributed/sharding.py``. Two weight layouts:

* ``train`` — FSDP/ZeRO-3: every large leaf sharded over (dp..., model)
  on its last two divisible dims; compute data/sequence-parallel.
* ``serve`` — Megatron TP resident weights: column-parallel up/QKV,
  row-parallel down/out over the model axis; the batch rides the data
  axes as independent serving rows; attention is ITPP (pages sharded over
  dp + model, stable merge); MoE weights in virtual-expert layout with the
  expert dim on the model axis (EP).

Specs are trees of ``distributed.mesh.P`` (a tuple of per-dim entries,
the port's ``PartitionSpec``) shaped like the port's params: the port
keeps ``layers`` / ``enc`` / ``dec`` as lists of per-layer dicts, so a
leaf of those has repro's spec without the stacked leading ``None``;
``mamba`` / ``mlstm`` / ``slstm`` leaves stay stacked, as in repro.

The cells' steps run as shard bodies on the plan's mesh: the train step
(``training/train.make_train_step``) and ``make_prefill_step`` on the
shard's FSDP slices, ``make_decode_step`` on its serve slices (Megatron
TP, ``Runtime.tp_axis``) with ITPP attention and, for a MoE,
``moe_ep_rows``. Each takes and returns its state RESIDENT, as repro's
``in_shardings`` / ``out_shardings`` keep it: the params (and AdamW's
moments) in the specs the caller cut them by (``Plan.param_specs``,
given to the step as ``specs``), the decode state in ``state_specs``
(the pool's ``Paged`` block, written in place; rows over the batch
axes). Only the batch comes in global and only the logits or metrics
come out assembled. ``Plan.shard`` and ``Plan.gather`` cut and gather at
the edges (a comparison, a checkpoint). On a ``LocalMesh`` (one card)
both are the identity: resident tensors are the global ones, the weights
stay whole and a shard body gets views of them (``mesh.shard_map``).
``_act_table`` gives repro's activation layouts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any

import torch

from repro_torch.core.itpp import (ItppSpec, itpp_decode_attention_shard,
                                   make_prefill_writer)
from repro_torch.distributed import mesh as M
from repro_torch.distributed.mesh import P, abstract_mesh  # noqa: F401
from repro_torch.models import moe as MOE
from repro_torch.models import model as MDL
from repro_torch.models.model import Runtime, tree_map

STACKED_KEYS = {"layers", "enc", "dec", "mamba", "mlstm", "slstm"}
# serve-mode column-parallel (shard last dim) / row-parallel (shard first
# non-stack dim) weight names
COL_NAMES = {"wq", "wk", "wv", "w1", "w3", "wz", "wx", "wu", "wg"}
ROW_NAMES = {"wo", "w2", "out_proj", "down"}
REPLICATE_SMALL = 1 << 16


def _leaves(tree, keys=(), in_list=False):
    """(keys, leaf, under a per-layer list) for every tensor of ``tree``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + (str(k),), in_list)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + (str(i),), True)
    else:
        yield keys, tree, in_list


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


@dataclass
class Plan:
    mesh: Any
    dp_axes: tuple[str, ...]          # ('data',) or ('pod','data')
    tp_axis: str                      # 'model'
    shape_kind: str                   # train | prefill | decode
    batch_divisible: bool             # global_batch % prod(dp_axes) == 0
    seq_divisible: bool = True
    pod_mode: str = "dp"
    # train/prefill activation layout: 'fsdp' (batch over every axis) when
    # the global batch divides the device count, else 'sp' (batch over dp,
    # sequence over the model axis)
    train_layout: str = "fsdp"

    # -------------------- sizes --------------------
    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(self.mesh.shape)

    @property
    def dp_total(self) -> int:
        s = self.axis_sizes
        return math.prod(s[a] for a in self.dp_axes)

    @property
    def tp(self) -> int:
        return self.axis_sizes[self.tp_axis]

    @property
    def dp_spec(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def batch_spec(self):
        return self.dp_spec if self.batch_divisible else None

    # -------------------- activation layouts --------------------
    @property
    def full_batch_spec(self):
        return (*self.dp_axes, self.tp_axis)

    def _act_table(self) -> dict[str, P]:
        dp, tp, b = self.dp_spec, self.tp_axis, self.batch_spec
        if self.train_layout == "fsdp":
            fb = self.full_batch_spec
            return {"act": P(fb, None, None),
                    "kv_full": P(fb, None, None, None),
                    "logits": P(fb, None, None),
                    "act_decode": P(b, None),
                    "logits_decode": P(b, tp)}
        seq = tp if self.seq_divisible else None
        return {"act": P(dp, seq, None),
                "kv_full": P(dp, None, None, None),
                "logits": P(dp, seq, None),
                "act_decode": P(b, None),
                "logits_decode": P(b, tp)}

    # -------------------- parameter specs --------------------
    def param_specs(self, params, *, mode: str):
        """mode: 'train' (FSDP) or 'serve' (Megatron TP, rows replicated).
        A tree of ``P`` shaped like ``params``."""
        return _unflatten(params, iter(self.spec_list(params, mode=mode)))

    def spec_list(self, params, *, mode: str) -> list:
        """``param_specs`` as a list, one ``P`` a leaf in tree order."""
        dp_n, tp_n = self.dp_total, self.tp
        specs = []
        for keys, leaf, in_list in _leaves(params):
            stacked = keys[0] in STACKED_KEYS and not in_list
            name = keys[-1]
            if name in ("q", "s") and len(keys) >= 2:   # int8 QTensor leaves
                name = keys[-2]
            shape = tuple(leaf.shape)
            spec = [None] * len(shape)
            start = 1 if stacked else 0
            body = shape[start:]
            is_moe = "moe" in keys
            if math.prod(body) < REPLICATE_SMALL:
                specs.append(P())
                continue
            if mode == "serve":
                if is_moe and name in ("w1", "w2", "w3"):
                    spec[start] = self.tp_axis      # virtual experts (EP)
                elif name == "embed":
                    spec[1] = self.tp_axis          # [V, D] shard D
                elif name == "head":
                    spec[1] = self.tp_axis          # [D, V] vocab col-TP
                elif name in COL_NAMES and len(shape) - start == 2:
                    if shape[-1] % tp_n == 0:
                        spec[-1] = self.tp_axis
                elif name in ROW_NAMES and len(shape) - start == 2:
                    if shape[start] % tp_n == 0:
                        spec[start] = self.tp_axis
                specs.append(P(*spec))
                continue
            # ---- train: FSDP over (dp, model) on last two divisible dims
            if is_moe and name in ("w1", "w2", "w3"):
                spec[start] = self.tp_axis
                if shape[start + 1] % dp_n == 0:
                    spec[start + 1] = self.dp_spec
                specs.append(P(*spec))
                continue
            if name == "embed":
                spec[1] = self.tp_axis
                if shape[0] % dp_n == 0:
                    spec[0] = self.dp_spec
                specs.append(P(*spec))
                continue
            if shape[-1] % tp_n == 0 and len(shape) - start >= 1:
                spec[-1] = self.tp_axis
            if len(shape) - start >= 2 and shape[-2] % dp_n == 0:
                spec[-2] = self.dp_spec
            specs.append(P(*spec))
        return specs

    # -------------------- the edges of a resident step --------------------
    def shard(self, tree, specs):
        """This rank's resident part of the global ``tree`` under ``specs``
        (``mesh.shard``: the identity on a ``LocalMesh``)."""
        return M.shard(tree, specs, self.mesh)

    def gather(self, tree, specs):
        """The global tree from this rank's resident part (``mesh.gather``:
        on a ``ProcessMesh`` an all-gather over the cut axes, on every
        rank; the identity on a ``LocalMesh``)."""
        return M.gather(tree, specs, self.mesh)

    def local_bytes(self, tree, specs) -> int:
        """The bytes a rank holds of the global ``tree`` under ``specs``
        (``mesh.block_nbytes``: a ``Paged`` pool's block with its own trash
        page, a ``Stages`` list its rank's stage)."""
        return M.block_nbytes(tree, specs, self.mesh)

    def fsdp_layout(self, params, specs: list | None = None) -> list:
        """Per leaf of ``params`` in tree order, how a shard of the train
        step rebuilds it from its slice (``training/train.py``): (its
        train ``P``, the ``(dim, axes)`` it all-gathers, the mesh axes no
        dim of it is cut over, whose shards hold copies, and a ``(dim,
        axis)`` whose block the shard then keeps, or None). An expert
        weight keeps its expert dim cut over the model axis (``moe_ep``
        runs the shard's own experts): a replicated one (under
        ``REPLICATE_SMALL``) is cut there after the gather. ``specs``: the
        train specs as a list (by default ``spec_list(params)``'s)."""
        out = []
        if specs is None:
            specs = self.spec_list(params, mode="train")
        for (keys, _, in_list), spec in zip(_leaves(params), specs):
            cut = [(d, e) for d, e in enumerate(spec) if e is not None]
            named = {a for _, e in cut for a in M._names(e)}
            pick = None
            if "moe" in keys and keys[-1] in ("w1", "w2", "w3"):
                cut = [(d, e) for d, e in cut if e != self.tp_axis]
                if self.tp_axis not in named:
                    start = 1 if keys[0] in STACKED_KEYS and not in_list \
                        else 0
                    pick = (start, self.tp_axis)
            rest = tuple(a for a in self.mesh.axis_names if a not in named)
            out.append((spec, cut, rest, pick))
        return out

    def batch_specs(self, batch) -> dict:
        """A train or prefill batch's layout (repro's
        ``dryrun.batch_shardings``): rows over every axis (``fsdp``), or
        rows over the dp axes and the sequence over the model axis
        (``sp``). Per-row entries (``bt``, ``valid_len``, ``last_idx``)
        follow the rows."""
        rows, seq = self.dp_spec, (self.tp_axis if self.seq_divisible
                                   else None)
        if self.train_layout == "fsdp":
            rows, seq = self.full_batch_spec, None
        out = {}
        for k, v in batch.items():
            if k == "positions" and v.dim() == 3:      # M-RoPE [3, B, S]
                out[k] = P(None, rows, seq)
            elif k in ("frames", "bt", "valid_len", "last_idx"):
                out[k] = P(rows)
            else:                                      # [B, S, ...]
                out[k] = P(rows, seq)
        return out

    def serve_params(self, params, parallel, *, mode: str):
        """The weights a ``mode`` runtime serves: int8 weight-only
        (``core/quant.py``) for a decode plan with ``serve_quant="int8"``,
        else ``params`` themselves."""
        if parallel.serve_quant == "int8" and mode == "decode":
            from repro_torch.core.quant import quantize_params
            return quantize_params(params)
        if parallel.serve_quant not in ("", "int8"):
            raise ValueError(f"serve_quant {parallel.serve_quant!r}")
        return params

    # -------------------- decode state specs --------------------
    @property
    def page_axes(self) -> tuple[str, ...]:
        return (*self.dp_axes, self.tp_axis)

    def pool_spec(self) -> P:
        return P(None, self.page_axes, None, None, None)

    def state_specs(self, state):
        """The decode state's specs as the sharded steps hold it resident:
        each pool's page dim ``Paged`` over the page axes (its layer dim
        over ``pod`` too for a pipeline plan), recurrent and cross rows
        over the batch axes."""
        pool = P(None, M.Paged(self.page_axes))
        if self.pod_mode == "pp":
            pool = P("pod", M.Paged(self.page_axes))
        return {k: {"k": pool, "v": pool} if k == "pool"
                else P(None, self.batch_spec) for k in state}

    def decode_state_specs(self, state):
        b = self.batch_spec
        out = {}
        for k, v in state.items():
            if k == "pool":
                out[k] = {"k": self.pool_spec(), "v": self.pool_spec()}
            elif torch.is_tensor(v):      # cross_k / cross_v: [L, B, ...]
                out[k] = P(None, b, *([None] * (v.dim() - 2)))
            else:                         # recurrent rows: [n, B, ...]
                out[k] = _unflatten(v, iter(
                    P(None, b, *([None] * (a.dim() - 2)))
                    for _, a, _ in _leaves(v)))
        return out

    # -------------------- runtime wiring --------------------
    def itpp_spec(self, page_size: int) -> ItppSpec:
        sizes = self.axis_sizes
        n_page_shards = math.prod(sizes[a] for a in self.page_axes)
        if self.batch_divisible:
            # requests pinned to data rows; stripe over the row's model shards
            return ItppSpec(self.page_axes, (self.tp_axis,), self.batch_spec,
                            n_page_shards, self.tp, page_size)
        # batch replicated: stripe each request over the whole mesh
        return ItppSpec(self.page_axes, self.page_axes, None,
                        n_page_shards, n_page_shards, page_size)

    def make_runtime(self, cfg, parallel, *, pool_spec=None,
                     mode: str = "train") -> Runtime:
        """The shard runtime of a ``mode`` cell, for a body on the plan's
        mesh. ``train`` and ``prefill`` (``training/train.make_train_step``,
        ``make_prefill_step``): a layer's whole weights fetched from the
        shard's FSDP slices (``fsdp_fetch``), the ``sp`` sequence cut over
        the model axis (``seq_axis``), a MoE on ``moe_ep`` over the
        shard's own tokens; prefill writes the pool pages the shard owns.
        ``decode`` (``make_decode_step``, the pipeline's stages): Megatron
        TP over the model axis on the shard's serve slices (``tp_axis``),
        ITPP over the shard's pages (``itpp_decode_attention_shard``,
        merged over ``itpp_spec``'s axes), a MoE on ``moe_ep_rows``."""
        from repro_torch.kernels.backend import KernelConfig
        kernels = KernelConfig(use_kernels=parallel.use_kernels,
                               n_splits=parallel.kernel_splits)
        seq = self.tp_axis if (self.train_layout == "sp"
                               and self.seq_divisible) else None
        moe = shard_moe(cfg, self.tp_axis, self.tp) if cfg.is_moe else None
        if mode == "train":     # make_train_step's shard body, plain paths
            return Runtime(remat=parallel.remat, plan=self, fetch=fsdp_fetch,
                           seq_axis=seq, moe=moe)
        ring = pool_spec.max_pages_per_req if pool_spec is not None \
            and pool_spec.ring else 0
        if mode == "prefill":
            if seq is None:
                raise ValueError("the sharded prefill takes the sp layout "
                                 "with the sequence cut over "
                                 f"{self.tp_axis!r}")
            return Runtime(
                kernels=kernels, ring_width=ring, fetch=fsdp_fetch,
                seq_axis=seq, moe=moe,
                write_pool=None if pool_spec is None else make_prefill_writer(
                    self.itpp_spec(parallel.page_size),
                    pool_layout=self.mesh.pool_layout, ring_width=ring))
        if mode != "decode":
            raise ValueError(f"mode {mode!r}")
        kinds = set(cfg.block_kinds())
        cond = cfg.sliding_window if {"local", "attn"} <= kinds else 0
        itpp = None if pool_spec is None else partial(
            itpp_decode_attention_shard,
            spec=self.itpp_spec(parallel.page_size),
            max_pages_per_req=pool_spec.max_pages_per_req,
            ring_width=ring, cond_window=cond, kernels=kernels,
            pool_layout=self.mesh.pool_layout)
        return Runtime(kernels=kernels, ring_width=ring, itpp=itpp,
                       cond_window=cond, tp_axis=self.tp_axis,
                       moe=decode_moe(cfg, self.tp_axis, self.tp)
                       if cfg.is_moe else None)


# ---------------------------------------------------------------------------
# FSDP inside a shard body: a layer's whole weights from the shard's slices
# ---------------------------------------------------------------------------

class _Slices:
    """A subtree of a shard's FSDP slices and, per leaf, what to gather;
    the shard runtime's ``fetch`` turns it into whole weights."""
    __slots__ = ("tree", "cuts")

    def __init__(self, tree, cuts):
        self.tree, self.cuts = tree, cuts


class _FsdpGather(torch.autograd.Function):
    """A leaf's whole weight from this shard's slice, all-gathered over
    its cut dims. Backward: the whole grad's sum over every shard, cut
    back to the slice (``psum_scatter`` over the cut axes, ``psum`` over
    the axes whose shards hold copies), in the shard's own backward."""

    @staticmethod
    def forward(ctx, x, cut, rest):
        ctx.cut, ctx.rest = cut, rest
        for d, axes in cut:
            x = M._all_gather(x, axes, d, True)
        return x if cut else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for d, axes in reversed(ctx.cut):
            g = M.psum_scatter(g, axes, dim=d, tiled=True)
        if ctx.rest:
            g = M.psum(g, ctx.rest)
        return g, None, None


def _whole(x, cut, rest, pick):
    x = _FsdpGather.apply(x, cut, rest)
    if pick is not None:                # a replicated expert weight
        d, axis = pick
        blk = x.shape[d] // M.axis_size(axis)
        x = x.narrow(d, M.axis_index(axis) * blk, blk)
    return x


def fsdp_fetch(node):
    """``Runtime.fetch`` of a shard: a ``_Slices`` node's whole weights."""
    if not isinstance(node, _Slices):
        return node
    it = iter(node.cuts)
    return tree_map(lambda x: _whole(x, *next(it)), node.tree)


def fsdp_view(params, layout):
    """The shard's params as the model takes them: every top-level weight
    and every layer a ``_Slices`` (stacked ``[L, ...]`` groups split into
    per-layer lists, their specs less the stacked dim)."""
    it = iter(layout)
    out = {}
    for key, node in params.items():
        if isinstance(node, list):              # layers / enc / dec
            out[key] = [_Slices(lp, [next(it)[1:] for _ in _leaves(lp)])
                        for lp in node]
        elif isinstance(node, dict) and key in STACKED_KEYS:
            cuts = [next(it)[1:] for _ in _leaves(node)]
            cuts = [([(d - 1, a) for d, a in cut], rest,
                     pick and (pick[0] - 1, pick[1]))
                    for cut, rest, pick in cuts]
            n = next(_leaves(node))[1].shape[0]
            out[key] = [_Slices(tree_map(lambda a: a[i], node), cuts)
                        for i in range(n)]
        else:
            out[key] = _Slices(node, [next(it)[1:] for _ in _leaves(node)])
    return out


def shard_moe(cfg, tp_axis: str, tp_n: int):
    """A shard body's MoE: ``moe_ep`` over the shard's own tokens (its
    experts local, the buffers over ``tp_axis``), its balance term
    unreduced."""
    def moe(p, cfg_, x):
        B, S, D = x.shape
        y, aux = MOE.moe_ep(p, cfg, x.reshape(-1, D), tp_axis, tp_n)
        return y.reshape(B, S, D), aux
    return moe


def own_experts(p, axis: str):
    """A MoE layer's weights as ``moe_ep`` takes them on a shard: its
    virtual expert of each ``[V, ...]`` leaf (one the plan left whole,
    under ``REPLICATE_SMALL``, is cut here), the router whole."""
    i = M.axis_index(axis)

    def own(w):
        return w if w.shape[0] == 1 else w.narrow(0, i, 1)
    return {k: w if k == "router" else tree_map(own, w)
            for k, w in p.items()}


def decode_moe(cfg, tp_axis: str, tp_n: int):
    """A decode shard's MoE: ``moe_ep_rows`` over its rows, the same on
    every shard of ``tp_axis``, the experts over ``tp_axis``."""
    def moe(p, cfg_, x):
        B, S, D = x.shape
        y, aux = MOE.moe_ep_rows(own_experts(p, tp_axis), cfg,
                                 x.reshape(-1, D), tp_axis, tp_n)
        return y.reshape(B, S, D), aux
    return moe


# the decode state's rows a step writes (the cross rows it only reads; the
# pool it writes in place on every mesh)
_ROWS_WRITTEN = ("mamba", "mlstm", "slstm")


def step_specs(params, specs) -> list:
    """A sharded step's parameter specs, one a leaf of ``params`` in tree
    order, from ``specs``: the spec tree the caller cut the resident
    params by (``Plan.param_specs``)."""
    return [s for _, s in M.leaf_specs(params, specs)]


def serve_args(plan: Plan, params, specs):
    """``params`` (resident, cut by ``specs``: ``step_specs``) as a decode
    shard map takes them: the leaves and their serve specs, keyed by
    position; a function that rebuilds the tree from a shard's slices;
    whether the head's vocabulary is cut over the model axis (the logits
    come back cut there)."""
    leaves = list(_leaves(params))
    specs = step_specs(params, specs)
    keys = range(len(specs))
    vocab_cut = any(k[0] == "head" and plan.tp_axis in s
                    for (k, _, _), s in zip(leaves, specs))
    return (dict(zip(keys, (t for _, t, _ in leaves))),
            dict(zip(keys, specs)),
            lambda loc: _unflatten(params, (loc[i] for i in keys)),
            vocab_cut)


def make_decode_step(cfg, plan: Plan, parallel, pool_spec, *, specs):
    """repro's decode cell: ``models.model.decode_step`` under the serve
    plan's shardings, as a shard body on ``plan.mesh``. ``step(params,
    state, batch) -> (logits [B, V] fp32, state)``: ``params`` resident in
    the serve specs they were cut by (``specs``, ``Plan.param_specs(
    params, mode="serve")``; on a ``LocalMesh`` resident params are the
    global ones), ``state`` resident in
    ``Plan.state_specs`` and returned so, ``batch`` global (``tokens``
    [B], ``bt`` [B, maxp], ``ctx`` [B] incl. the new token, ``npage`` /
    ``noff`` [B], the optional ``positions`` and ``run``).

    A shard holds its slices of the weights under ``spec_list(mode=
    "serve")`` (a leaf under ``REPLICATE_SMALL``, or whose dim does not
    divide, whole) and computes with them as Megatron TP over the model
    axis (``Runtime.tp_axis``; a site tells a cut weight by its shape);
    its rows are those of its data row (over the dp axes), or every row
    when the batch does not divide them (long_500k's one request, which
    ITPP stripes over the whole mesh); its pool block is the page shard's
    pages (written in place: no copy, no gather) and its recurrent /
    cross rows follow the batch. The logits come back assembled, cut on
    the vocabulary over the model axis (repro's ``logits_decode``) where
    the head is."""
    rt = plan.make_runtime(cfg, parallel, pool_spec=pool_spec,
                           mode="decode")
    rows, tp = plan.batch_spec, plan.tp_axis
    local = isinstance(plan.mesh, M.LocalMesh)

    def step(params, state, batch):
        flat, p_spec, tree, vocab_cut = serve_args(plan, params, specs)
        s_spec = plan.state_specs(state)
        b_spec = {k: P(None, rows) if k == "positions" and v.dim() == 3
                  else P(rows) for k, v in batch.items()}
        out_spec = {k: s_spec[k] for k in state if k in _ROWS_WRITTEN}

        def body(p_loc, st, b):
            # a shard's own recurrent rows: on a LocalMesh the model shards
            # of a row would otherwise read each other's new carry
            if local:
                st = {k: tree_map(torch.clone, v) if k in out_spec else v
                      for k, v in st.items()}
            lg, st = MDL.decode_step(
                cfg, tree(p_loc), st, b["tokens"], b["bt"], b["ctx"], b["npage"],
                b["noff"], positions=b.get("positions"), run=b.get("run"),
                rt=rt)
            return lg, {k: st[k] for k in out_spec}

        f = M.shard_map(body, plan.mesh,
                        in_specs=(M.Resident(p_spec), M.Resident(s_spec),
                                  b_spec),
                        out_specs=(P(rows, tp if vocab_cut else None),
                                   M.Resident(out_spec)))
        lg, new = f(flat, state, batch)
        return lg, {**state, **new}

    step.rt = rt
    return step


def make_prefill_step(cfg, plan: Plan, parallel, pool_spec, *, specs):
    """repro's prefill cell: ``models.model.prefill`` under the train
    plan's shardings, as a shard body on ``plan.mesh`` in the ``sp``
    layout. ``step(params, state, batch) -> (logits [B, V], state)``:
    ``params`` resident in the train specs they were cut by (``specs``,
    ``Plan.param_specs(params, mode="train")``), ``state`` resident in ``Plan.state_specs`` and
    returned so, ``batch`` global (``tokens`` [B, S], ``bt`` [B, maxp],
    the optional ``valid_len`` / ``last_idx`` [B], ``positions``,
    ``extra_embeds``, ``frames``).

    A shard holds its FSDP slices of the weights (a layer gathered in its
    forward, ``fsdp_fetch``), rows over the dp axes and its block of the
    sequence over the model axis (``Plan.make_runtime(mode="prefill")``).
    Attention takes the rows' whole K/V (gathered over the model axis) at
    the shard's ``q_offset``, and the shard writes, from them, the pool
    pages it owns into its block (``make_prefill_writer``; any allocator
    policy); a recurrent layer runs on the gathered sequence, its carry
    the whole rows'; the logits come from the shard holding each row's
    last position; a MoE runs ``moe_ep``."""
    rt = plan.make_runtime(cfg, parallel, pool_spec=pool_spec,
                           mode="prefill")
    rows = plan.dp_spec
    local = isinstance(plan.mesh, M.LocalMesh)

    def step(params, state, batch):
        layout = plan.fsdp_layout(params, step_specs(params, specs))
        keys = range(len(layout))
        flat = dict(zip(keys, (t for _, t, _ in _leaves(params))))
        p_spec = {i: lay[0] for i, lay in zip(keys, layout)}
        s_spec = M.Resident(plan.state_specs(state))
        b_spec = plan.batch_specs(batch)

        def body(p_loc, st, b):
            ptree = _unflatten(params, (p_loc[i] for i in keys))
            # a shard's own carry rows: on a LocalMesh the model shards of
            # a row would otherwise read each other's new carry
            if local:
                st = {k: v if k == "pool" else tree_map(torch.clone, v)
                      for k, v in st.items()}
            return MDL.prefill(
                cfg, fsdp_view(ptree, layout), st, b["tokens"], b["bt"],
                positions=b.get("positions"),
                extra_embeds=b.get("extra_embeds"), frames=b.get("frames"),
                last_idx=b.get("last_idx"), valid_len=b.get("valid_len"),
                rt=rt)

        f = M.shard_map(body, plan.mesh,
                        in_specs=(M.Resident(p_spec), s_spec, b_spec),
                        out_specs=(P(rows, None), s_spec))
        return f(flat, state, batch)

    return step


def make_plan(mesh, parallel, shape, *, pod_mode: str = "dp",
              train_layout: str | None = None) -> Plan:
    axes = mesh.axis_names
    dp_axes = tuple(a for a in axes if a in ("pod", "data")) \
        if pod_mode == "dp" else ("data",)
    sizes = dict(mesh.shape)
    dp_total = math.prod(sizes[a] for a in dp_axes)
    tp = sizes["model"]
    n_dev = math.prod(sizes.values())
    if train_layout is None:
        train_layout = "fsdp" if shape.global_batch % n_dev == 0 else "sp"
    return Plan(
        mesh=mesh,
        dp_axes=dp_axes,
        tp_axis="model",
        shape_kind=shape.kind,
        batch_divisible=shape.global_batch % dp_total == 0,
        seq_divisible=(shape.seq_len % tp == 0) and shape.kind != "decode",
        pod_mode=pod_mode,
        train_layout=train_layout,
    )
