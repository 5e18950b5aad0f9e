"""Token samplers and the speculative-decode verifier for the serving engine.

Port of ``repro/serving/sampling.py``: greedy argmax, temperature and top-k
sampling over the whole batch on the logits' device, and
``make_verifier``, the acceptance rule of a speculative round.

JAX threads a PRNG key chain through every draw; here every draw takes an
explicit ``torch.Generator`` (on the logits' device) and nothing reads the
global RNG. A categorical draw is Gumbel-max over ``torch.rand(...,
generator=)`` noise: one uniform tensor a draw, whatever the logits hold,
so a stream of tokens is a function of (seed, call sequence) and a draw
can be captured into a CUDA graph (the graph registers the generator and
advances its Philox offset per replay, ``serving/graphs.py``). JAX's
threefry and torch's Philox give different numbers from one seed, so the
two packages agree in distribution, not token for token (ROADMAP C.2).

``top_k`` keeps ``lax.top_k``'s exact winner set: on equal values the
lowest index wins (``_topk_mask``), which ``torch.topk`` does not promise.

``make_callback_sampler`` (legacy per-row host callables) is not ported
(ROADMAP A.5).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models.layers import NEG_INF

KINDS = ("greedy", "temperature", "top_k")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown sampler {kind!r} (one of {KINDS})")


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """logits [..., V] -> int32 token ids [...] (first-max tie-break)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _topk_mask(z: torch.Tensor, k: int) -> torch.Tensor:
    """bool [..., V]: the ``k`` largest entries of each row, ties at the
    k-th value going to the lowest indices (``lax.top_k``'s set)."""
    kth = torch.topk(z, k, dim=-1).values[..., -1:]
    above = z > kth
    tied = z == kth
    room = k - above.sum(-1, keepdim=True)
    return above | (tied & (torch.cumsum(tied.to(torch.int32), -1) <= room))


def _scaled(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(float(temperature), 1e-6)


def _uniform(gen, shape, device) -> torch.Tensor:
    """fp32 uniforms in [0, 1) from ``gen``; never from the global RNG."""
    if not isinstance(gen, torch.Generator):
        raise ValueError("a stochastic draw takes an explicit "
                         f"torch.Generator, got {gen!r}")
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


def _gumbel_argmax(gen, z: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row of ``z`` [..., V] (unnormalized log
    probabilities; ``-inf`` entries are never drawn): argmax of z plus
    Gumbel noise from ``gen``."""
    u = _uniform(gen, z.shape, z.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(z.float() + g, dim=-1).to(torch.int32)


def stochastic_sample(gen, logits, temperature: float = 1.0,
                      top_k: int = 0) -> torch.Tensor:
    """Temperature / top-k sampling. ``top_k=0`` samples the full
    distribution."""
    z = _scaled(logits, temperature)
    if top_k:
        z = z.masked_fill(~_topk_mask(z, top_k), float("-inf"))
    return _gumbel_argmax(gen, z)


_stochastic = stochastic_sample             # repro's name for the core


def stochastic_sample_step(gen, logits, temperature: float = 1.0,
                           top_k: int = 0):
    """``(gen, tokens)``: JAX's key-threading form; the generator advances
    in place."""
    return gen, stochastic_sample(gen, logits, temperature, top_k)


def make_scan_sampler(kind: str = "greedy", *, temperature: float = 1.0,
                      top_k: int = 0):
    """``(gen, logits [B, V]) -> tokens [B]`` for the fused decode
    (``models.model.decode_multi``) and the draft's proposal scan; greedy
    ignores ``gen``, so one signature serves every kind."""
    _check_kind(kind)
    if kind == "greedy":
        return lambda gen, logits: greedy_sample(logits)
    tk = int(top_k) if kind == "top_k" else 0
    temp = float(temperature)
    return lambda gen, logits: stochastic_sample(gen, logits, temp, tk)


def _probs(logits, temperature: float, top_k: int) -> torch.Tensor:
    """The distribution ``stochastic_sample`` draws from, as fp32 probabilities
    [..., V]: the temperature-scaled softmax restricted to the top-k winner
    set."""
    z = _scaled(logits, temperature)
    if top_k:
        z = z.masked_fill(~_topk_mask(z, top_k), NEG_INF)
    return torch.softmax(z.float(), dim=-1)


def make_verifier(kind: str = "greedy", *, temperature: float = 1.0,
                  top_k: int = 0):
    """Acceptance rule of a speculative round
    (``models.model.decode_verify``): ``(gen, logits [B, C, V], qlogits
    [C-1, B, V] | None, proposals [B, C-1], nprop [B], run [B]) ->
    (candidates [B, C], accept [B])``.

    Greedy: candidates are the target's argmax at every position; accept
    is the longest prefix where the draft proposed exactly those tokens,
    so the emitted tokens are those of target-only greedy decoding.

    Stochastic: residual rejection sampling. Position i accepts d_i iff
    ``u_i * q_i(d_i) <= p_i(d_i)`` (p and q from ``_probs``); the first
    rejected position draws from ``max(p - q, 0)``, a fully accepted run
    draws its bonus token from p, so the emitted tokens follow target-only
    sampling whatever the draft. Rows past ``nprop`` never accept and
    their qlogits are never read.
    """
    _check_kind(kind)
    temp = float(temperature)
    tk = int(top_k) if kind == "top_k" else 0

    if kind == "greedy":
        def verifier(gen, logits, qlogits, proposals, nprop, run):
            cand = greedy_sample(logits)                       # [B, C]
            i = torch.arange(cand.shape[1] - 1, device=cand.device)[None]
            match = (proposals == cand[:, :-1]) & (i < nprop[:, None])
            acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
            return cand, acc.to(torch.int32)
        return verifier

    def verifier(gen, logits, qlogits, proposals, nprop, run):
        B, C, V = logits.shape
        dev = logits.device
        p = _probs(logits, temp, tk)                           # [B, C, V]
        q = _probs(qlogits, temp, tk).transpose(0, 1)          # [B, C-1, V]
        u = _uniform(gen, (B, C - 1), dev)
        prop = proposals.long().clamp(0, V - 1)
        p_d = p[:, :-1].gather(2, prop[..., None])[..., 0]
        q_d = q.gather(2, prop[..., None])[..., 0]
        cols = torch.arange(C - 1, device=dev)[None]
        ok = (u * q_d <= p_d) & (cols < nprop[:, None])
        acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        rows = torch.arange(B, device=dev)
        # the one token the draft did not give: from the residual at the
        # first rejection, or from p after a full accept (q at row nprop
        # was never computed by the draft: it is not read)
        p_acc = p[rows, acc]                                   # [B, V]
        q_acc = torch.cat([q, q.new_zeros((B, 1, V))], dim=1)[rows, acc]
        full = (acc == nprop)[:, None]
        resid = torch.where(full, p_acc, (p_acc - q_acc).clamp_min(0.0))
        extra = _gumbel_argmax(gen, torch.log(resid + 1e-30))
        prop_pad = torch.cat(
            [prop.to(torch.int32),
             torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=1)
        idx = torch.arange(C, device=dev)[None]
        cand = torch.where(idx < acc[:, None], prop_pad, extra[:, None])
        return cand.to(torch.int32), acc.to(torch.int32)
    return verifier


def make_generator(seed: int, device) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device``: the port's
    counterpart of ``jax.random.PRNGKey(seed)``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


class Sampler:
    """Stateful batch sampler: ``sampler(logits)`` -> np.int32 tokens.

    Accepts [V] or [B, V] logits (numpy or tensor). Greedy is stateless;
    temperature / top-k draw from one generator on ``device`` seeded with
    ``seed``, so token streams are deterministic in (seed, call order).
    """

    def __init__(self, kind: str = "greedy", *, temperature: float = 1.0,
                 top_k: int = 0, seed: int = 0, device=None):
        _check_kind(kind)
        self._sample = make_scan_sampler(kind, temperature=temperature,
                                         top_k=top_k)
        self.gen = (None if kind == "greedy"
                    else make_generator(seed, resolve_device(device)))

    def __call__(self, logits) -> np.ndarray:
        t = torch.as_tensor(logits)
        if self.gen is not None:
            t = t.to(self.gen.device)
        squeeze = t.ndim == 1
        out = self._sample(self.gen, t[None] if squeeze else t)
        out = out.cpu().numpy()
        return out[0] if squeeze else out


def make_sampler(kind: str = "greedy", *, temperature: float = 1.0,
                 top_k: int = 0, seed: int = 0, device=None) -> Sampler:
    return Sampler(kind, temperature=temperature, top_k=top_k, seed=seed,
                   device=device)
