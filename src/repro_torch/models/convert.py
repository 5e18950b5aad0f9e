"""Convert ``repro`` parameter and state trees (as numpy arrays) into the
port's.

``repro`` keeps the attention stack as stacked leaves ``layers/*`` of shape
``[L, ...]`` (scanned over layers); the port keeps a list of per-layer
dicts, so a MoE layer's ``moe`` leaves come out as router ``[D, E]``,
``w1`` / ``w3`` ``[V, D, ff/v]`` and ``w2`` ``[V, ff/v, D]``. The zamba2
hybrid's Mamba2 weights stay stacked (``mamba/*`` ``[L_mamba, ...]``) and
its shared attention block ``attn_shared`` is one unstacked dict, in both
packages; so do xLSTM's ``mlstm/*`` and ``slstm/*`` (``[n_cyc, ...]``,
``slstm/r`` ``[n_cyc, 4, H, dh, dh]``). Dense weights keep the JAX layout
``[d_in, d_out]`` — no transpose: both packages compute ``x @ w``. The
enc-dec family's stacked ``enc/*`` and ``dec/*`` (with each decoder
layer's ``lnx`` and ``xattn``) become per-layer lists as ``layers`` does;
``enc_norm`` stays a leaf. The
tied embedding stays ``[V, D]`` and is transposed by ``layers.lm_head``,
as in JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

# leaves JAX keeps in fp32 whatever the model dtype: Mamba2's decay, skip
# and step bias, the mLSTM gate biases and the sLSTM gate bias
_FP32_LEAVES = ("A_log", "D", "dt_bias", "bi", "bf", "b")


def _tensor(a, device, dtype):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                        device=device)


def params_from_numpy(cfg, tree: dict, device=None,
                      dtype=torch.float32) -> dict[str, Any]:
    """``tree``: ``repro.models.model.init_params(cfg, ...)`` with every
    leaf converted to numpy. Returns the port's params on ``device``
    (``cuda`` by default) in ``dtype``."""
    dev = resolve_device(device)

    def conv(node, layer=None, name=""):
        if isinstance(node, dict):
            return {k: conv(v, layer, k) for k, v in node.items()}
        dt = torch.float32 if name in _FP32_LEAVES else dtype
        return _tensor(node if layer is None else node[layer], dev, dt)

    # stacked attention stacks become lists of per-layer dicts
    depth = {"layers": cfg.n_layers, "dec": cfg.n_layers,
             "enc": cfg.enc_layers}
    out = {k: conv(v) for k, v in tree.items() if k not in depth}
    for k, n in depth.items():
        if k in tree:
            out[k] = [conv(tree[k], i) for i in range(n)]
    return out


def state_from_numpy(tree, device=None):
    """A ``repro`` recurrent state tree (dicts / tuples of arrays, e.g.
    ``{"conv", "ssm": (C, n, m)}`` Mamba2 rows, the mLSTM ``(C, n, m)`` and
    sLSTM ``(c, n, m, h)`` carries) as fp32 tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(state_from_numpy(v, dev) for v in tree)
    return _tensor(tree, dev, torch.float32)


def oracle_draft_pair(cfg, params):
    """The zeroed-layer oracle pair of ``benchmarks/serving_bench.py``'s
    speculative rows: ``(target_params, draft_cfg, draft_params)``.

    The target's attention ``wo`` and MLP ``w2`` are zeroed in layers
    2..L, so every layer past the first adds exactly +0.0 to the residual
    stream at an unchanged cost; the draft is the target's 1-layer slice,
    sharing its embedding, final norm and head. The draft's logits are then
    the target's, and greedy verification accepts every proposal (exactly
    on the CPU; on a card up to the products' shape-dependent rounding).

    ``params``: the port's params (``params_from_numpy``'s list of
    per-layer dicts); the inputs are not modified."""
    from dataclasses import replace
    if "layers" not in params:
        raise ValueError(f"{cfg.name}: the oracle pair needs an "
                         "attention-only stack")
    t_layers = [lp if i == 0 else dict(
        lp, attn=dict(lp["attn"], wo=torch.zeros_like(lp["attn"]["wo"])),
        mlp=dict(lp["mlp"], w2=torch.zeros_like(lp["mlp"]["w2"])))
        for i, lp in enumerate(params["layers"])]
    return (dict(params, layers=t_layers),
            replace(cfg, name=cfg.name + "-draft", n_layers=1),
            dict(params, layers=t_layers[:1]))
