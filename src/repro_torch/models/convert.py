"""Convert ``repro`` parameter and state trees (as numpy arrays) into the
port's.

``repro`` keeps the attention stack as stacked leaves ``layers/*`` of shape
``[L, ...]`` (scanned over layers); the port keeps a list of per-layer
dicts. The zamba2 hybrid's Mamba2 weights stay stacked (``mamba/*``
``[L_mamba, ...]``) and its shared attention block ``attn_shared`` is one
unstacked dict, in both packages. Dense weights keep the JAX layout
``[d_in, d_out]`` — no transpose: both packages compute ``x @ w``. The
tied embedding stays ``[V, D]`` and is transposed by ``layers.lm_head``, as
in JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

# Mamba2 leaves JAX keeps in fp32 whatever the model dtype
_FP32_LEAVES = ("A_log", "D", "dt_bias")


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

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    if "layers" in tree:
        out["layers"] = [conv(tree["layers"], i)
                         for i in range(cfg.n_layers)]
    return out


def state_from_numpy(tree, device=None):
    """A ``repro`` recurrent state tree (dicts / tuples of arrays, e.g.
    ``{"conv", "ssm": (C, n, m)}`` rows) as fp32 tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(state_from_numpy(v, dev) for v in tree)
    return _tensor(tree, dev, torch.float32)
