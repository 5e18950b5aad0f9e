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

On a ``LocalMesh`` (one card) tensors are global: the weights stay whole
and a shard body gets views of them (``mesh.shard_map``). The specs say
what each shard holds; ``_act_table`` gives the activation layouts, of
which the MoE's shard map reads ``act``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.itpp import (ItppSpec, make_itpp_attention,
                                   make_prefill_writer)
from repro_torch.distributed import mesh as M
from repro_torch.distributed.mesh import P, abstract_mesh  # noqa: F401
from repro_torch.models import moe as MOE
from repro_torch.models.model import Runtime

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
        return _unflatten(params, iter(specs))

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
        from repro_torch.kernels.backend import KernelConfig
        kernels = KernelConfig(use_kernels=parallel.use_kernels,
                               n_splits=parallel.kernel_splits)
        rt = Runtime(remat=parallel.remat, kernels=kernels)
        if pool_spec is not None:
            rt.ring_width = pool_spec.max_pages_per_req if pool_spec.ring \
                else 0
            if mode == "decode":
                spec = self.itpp_spec(parallel.page_size)
                kinds = set(cfg.block_kinds())
                mixed = "local" in kinds and "attn" in kinds
                rt.cond_window = cfg.sliding_window if mixed else 0
                rt.itpp = make_itpp_attention(
                    self.mesh, spec,
                    max_pages_per_req=pool_spec.max_pages_per_req,
                    ring_width=rt.ring_width, cond_window=rt.cond_window,
                    kernels=kernels)
            if mode == "prefill" and not pool_spec.ring \
                    and self.train_layout == "sp" and self.seq_divisible:
                rt.write_pool = make_prefill_writer(
                    self.mesh, self.itpp_spec(parallel.page_size),
                    seq_axis=self.tp_axis)
        if cfg.is_moe:
            rt.moe = self._make_moe_ep(cfg)
        return rt

    def _make_moe_ep(self, cfg):
        tp_axis, tp_n = self.tp_axis, self.tp
        b = self.batch_spec
        all_axes = (*self.dp_axes, tp_axis)

        def body(pw, x_loc):
            B, S, D = x_loc.shape
            y, aux = MOE.moe_ep(pw, cfg, x_loc.reshape(-1, D), tp_axis,
                                tp_n)
            return y.reshape(B, S, D), M.pmean(aux, all_axes)

        def apply(p, cfg_, x):
            is_decode = x.shape[1] == 1
            act = self._act_table()["act"]
            xspec = P(b, None, None) if is_decode else P(*act[:2], None)
            pspec = {"router": None, "w1": P(tp_axis), "w2": P(tp_axis)}
            if "w3" in p:
                pspec["w3"] = P(tp_axis)
            fn = M.shard_map(body, self.mesh, in_specs=(pspec, xspec),
                             out_specs=(xspec, None))
            return fn({k: p[k] for k in pspec}, x)

        return apply


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
