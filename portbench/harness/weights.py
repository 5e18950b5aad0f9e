"""The cell's inputs that live on the device: the model's weights in the
port's parameter layout and the KV pages a prefill pool hands over.

Both come from ``--seed`` through a ``torch.Generator`` on the run's
device, in a few large calls: every normal weight is a view into one flat
fp32 buffer drawn by one ``normal_``, then scaled in place leaf by leaf.
The same seed on the same device gives the same tensors, so the reference
makes them again after the program's state is freed instead of reading
the program's.

The layout is the port's (``repro_torch.models.model.init_params``), and
each architecture's file under ``references/`` lists its leaves. Dense
weights are ``[d_in, d_out]``; norms scale by ``1 + w``. The
distributions follow the port's (normal, 1/sqrt(fan-in); output
projections also over 2 x layers), with the norms drawn at 0.1 instead of
zero, so that every weight the math reads is exercised.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for ``(seed, *tags)``: the draws of one run that must
    not share a stream get seeds of their own."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for t in tags:
        words += ([int(t) & 0xFFFFFFFF] if isinstance(t, int)
                  else list(str(t).encode()))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31 | int(state[1]) >> 1) & (2 ** 63 - 1)


def generator(seed: int, device, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def derived(c: dict) -> dict:
    """Widths the config implies (``ModelConfig``'s derived properties)."""
    mult = c.get("vocab_multiple", 256)
    d = dict(c)
    d["padded_vocab"] = -(-c["vocab_size"] // mult) * mult
    d["q_dim"] = c["n_heads"] * c["d_head"]
    d["kv_dim"] = c["n_kv_heads"] * c["d_head"]
    pattern = c.get("pattern", ["attn"])
    kinds = [pattern[i % len(pattern)] for i in range(c["n_layers"])]
    d["n_attn"] = sum(k == "attn" for k in kinds)
    return d


def attn_leaves(c: dict, prefix: tuple) -> list:
    """An attention block's leaves: norms, q/k/v/o, the MLP."""
    D, q, kv, F = c["d_model"], c["q_dim"], c["kv_dim"], c["d_ff"]
    out_scale = 1 / math.sqrt(q * 2 * c["n_layers"])
    leaves = [(prefix + ("ln1",), (D,), 0.1),
              (prefix + ("attn", "wq"), (D, q), 1 / math.sqrt(D)),
              (prefix + ("attn", "wk"), (D, kv), 1 / math.sqrt(D)),
              (prefix + ("attn", "wv"), (D, kv), 1 / math.sqrt(D)),
              (prefix + ("attn", "wo"), (q, D), out_scale),
              (prefix + ("ln2",), (D,), 0.1),
              (prefix + ("mlp", "w1"), (D, F), 1 / math.sqrt(D)),
              (prefix + ("mlp", "w2"), (F, D), 1 / math.sqrt(F))]
    if c.get("act", "swiglu") in ("swiglu", "geglu"):
        leaves.append((prefix + ("mlp", "w3"), (D, F), 1 / math.sqrt(D)))
    return leaves


def io_leaves(c: dict) -> list:
    """The embedding, the final norm and an untied head."""
    D, V = c["d_model"], c["padded_vocab"]
    leaves = [(("embed",), (V, D), 0.02), (("final_norm",), (D,), 0.1)]
    if not c.get("tie_embeddings", False):
        leaves.append((("head",), (D, V), 0.02))
    return leaves


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
            continue
        if k not in node:
            node[k] = [] if isinstance(nxt, int) else {}
        node = node[k]
    node[path[-1]] = value


ALIGN = 64          # elements: every leaf starts on a 256-byte boundary


def make_params(config: dict, seed: int, device) -> dict:
    """The weights of ``config`` from ``seed`` on ``device`` (fp32), in the
    layout its reference file gives (``normal_leaves(c)``: [(path, shape,
    scale)] in draw order; ``init_extra(params, c, seed, device)`` for what
    is not a scaled normal draw)."""
    from harness.reference import module_for
    c = derived(config)
    arch = module_for(c)
    leaves = arch.normal_leaves(c)
    sizes = [math.prod(s) for _, s, _ in leaves]
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // ALIGN) * ALIGN
    flat = torch.empty((total,), dtype=torch.float32, device=device)
    flat.normal_(generator=generator(seed, device, "weights"))
    params: dict = {}
    for (path, shape, scale), off, n in zip(leaves, offs, sizes):
        leaf = flat[off:off + n].view(shape)
        leaf.mul_(scale)
        _put(params, path, leaf)
    if hasattr(arch, "init_extra"):
        arch.init_extra(params, c, seed, device)
    return params


K_SCALE = 2.0       # the handed-over K's scale against V's


def context_kv(config: dict, seed: int, req: int, n_tokens: int,
               page_size: int, device) -> dict:
    """The KV pages of adopted request ``req``: ``{"k", "v"}`` each
    ``[L_attn, pages, page, KVH, D]`` fp32, K already rotated, as a
    prefill pool hands them over. K is drawn at ``K_SCALE`` so that
    attention over a long context is peaked, as a trained model's is, and
    the answer depends on which tokens the kernel reads. Slots past
    ``n_tokens`` in the last page are drawn too; nothing reads them."""
    c = derived(config)
    pages = -(-n_tokens // page_size)
    shape = (2, c["n_attn"], pages, page_size, c["n_kv_heads"], c["d_head"])
    kv = torch.empty(shape, dtype=torch.float32, device=device)
    kv.normal_(generator=generator(seed, device, "kv", req))
    kv[0].mul_(K_SCALE)
    return {"k": kv[0], "v": kv[1]}
