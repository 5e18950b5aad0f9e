"""Training step: loss and grads (with microbatch accumulation), then AdamW.

Port of ``repro/training/train.py``. ``make_train_step(cfg, rt, opt_cfg)``
returns ``train_step(params, opt_state, batch) -> (params, opt_state,
metrics)``, functional as JAX's: the inputs are left as they were. The
gradient is autograd's through ``models.model.train_loss`` on the plain
paths (``check_trainable``: the port's kernels have no backward, and
repro's training path reaches none of its Pallas kernels). Microbatches
split the batch into ``microbatches`` sequential chunks along the batch
axis (M-RoPE ``positions`` [3, B, S] along axis 1), accumulate fp32
grads and divide them, and the loss, by their count.
"""
from __future__ import annotations

import numpy as np
import torch

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


def _split(key: str, x: torch.Tensor, n: int) -> list:
    if key == "positions" and x.dim() == 3:           # mrope [3, B, S]
        return list(x.chunk(n, dim=1))
    return list(x.chunk(n, dim=0))


def make_train_step(cfg, rt, opt_cfg: OPT.AdamWConfig, *,
                    microbatches: int = 1):
    MDL.check_trainable(rt, "make_train_step")
    loss_fn = make_loss_fn(cfg, rt)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in OPT.tree_leaves(params)]
        loss, metrics = loss_fn(OPT.tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), metrics, grads

    def train_step(params, opt_state, batch):
        if microbatches <= 1:
            loss, metrics, grads = grad_fn(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            parts = {k: _split(k, v, microbatches) for k, v in batch.items()}
            acc, loss = None, 0.0
            for i in range(microbatches):
                l, _, g = grad_fn(params, {k: v[i] for k, v in parts.items()})
                g = [x.float() for x in g]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                loss = loss + l
            grads = [a / microbatches for a in acc]
            loss = loss / microbatches
            metrics = {"nll": loss, "tokens": torch.zeros(())}
        params, opt_state, om = OPT.apply(
            opt_cfg, params, OPT.tree_unflatten(params, grads), opt_state)
        return params, opt_state, {**metrics, **om, "loss": loss}

    return train_step
