"""The plain reference of a dense attention stack (Yi-34B, the llama
architecture): embedding, pre-norm attention blocks with a SwiGLU MLP
(``harness.reference.attn_block``), final RMS norm and an untied head. An
adopted row's context K/V (already rotated) sit in front of the new
tokens' own, which the reference computes itself. Weights: the port's
``{"embed", "final_norm", "head", "layers": [per-layer dict]}``."""
import torch

from harness.reference import attn_block, logits
from harness.weights import attn_leaves, io_leaves


def normal_leaves(c):
    leaves = io_leaves(c)
    for i in range(c["n_layers"]):
        leaves += attn_leaves(c, ("layers", i))
    return leaves


def forward(c, params, tokens, start, ctx_kv=None):
    """Logits [n, V] at positions start .. start + n - 1 of ``tokens`` [n]
    (int64, on the weights' device); ``ctx_kv`` = (k, v), each [L, start,
    KVH, D], the context in front of them."""
    x = params["embed"][tokens]
    pos = start + torch.arange(len(tokens), device=x.device)
    for i, lp in enumerate(params["layers"]):
        ck = cv = None
        if ctx_kv is not None:
            ck, cv = ctx_kv[0][i], ctx_kv[1][i]
        x = attn_block(c, lp, x, pos, ck, cv)
    return logits(c, params, x)
