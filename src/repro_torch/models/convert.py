"""Convert a ``repro`` parameter tree (as numpy arrays) into the port's.

``repro`` keeps the attention stack as stacked leaves ``layers/*`` of shape
``[L, ...]`` (scanned over layers); the port keeps a list of per-layer
dicts. Dense weights keep the JAX layout ``[d_in, d_out]`` — no transpose:
both packages compute ``x @ w``. The tied embedding stays ``[V, D]`` and
is transposed by ``layers.lm_head``, as in JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


def _tensor(a, device, dtype):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                        device=device)


def params_from_numpy(cfg, tree: dict, device=None,
                      dtype=torch.float32) -> dict[str, Any]:
    """``tree``: ``repro.models.model.init_params(cfg, ...)`` with every
    leaf converted to numpy. Returns the port's params on ``device``
    (``cuda`` by default) in ``dtype``."""
    dev = resolve_device(device)

    def conv(node, layer=None):
        if isinstance(node, dict):
            return {k: conv(v, layer) for k, v in node.items()}
        return _tensor(node if layer is None else node[layer], dev, dtype)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [conv(tree["layers"], i) for i in range(cfg.n_layers)]
    return out
