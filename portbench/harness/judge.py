"""How ``correct`` is decided: the plain reference, run once over each
sampled request's prompt (or handed-over context) with the tokens the
program served, reads the logits at every served position. The number
compared is the widest gap by which a served token's logit lies below the
reference's best there (0 where the program served the reference's
greedy choice). The control puts the reference in the program's place in
TF32: at the same positions it reads the gap of the token that TF32 puts
first.

The sample, drawn from the seed, holds ``sample`` requests and always the
longest: of an adopted pool, rows that served tokens; otherwise requests
that finished in the window. It runs once the program's state is freed,
a request at a time, on weights and context made again from the seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from harness import reference as R
from harness.weights import context_kv, derived, make_params, sub_seed


@dataclass
class Served:
    rid: int
    prompt: np.ndarray
    out: list
    adopted: bool


def pick(tracks, n: int, seed: int) -> list:
    """``n`` tracks drawn from the seed, the longest always among them."""
    cand = [t for t in tracks
            if (t.adopted and t.n_close >= 2) or (not t.adopted and t.done)]
    if not cand:
        return []
    cand.sort(key=lambda t: (t.prompt_len + t.n_close, t.rid))
    longest, rest = cand[-1], cand[:-1]
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    k = min(len(rest), max(0, n - 1))
    others = [rest[i] for i in sorted(rng.choice(len(rest), k,
                                                 replace=False))]
    return [longest] + others


def verdict(chk: dict, limits: dict) -> tuple[dict, bool]:
    """The numbers compared, each beside its limit, and whether the run is
    correct: the widest gap at most ``logit_gap`` over at least
    ``min_positions`` served positions (a gap that is not a number fails)."""
    checks = {"logit_gap": {"value": chk["logit_gap"],
                            "limit": float(limits["logit_gap"])},
              "positions": {"value": chk["positions"],
                            "limit": int(limits["min_positions"])}}
    correct = (chk["logit_gap"] <= checks["logit_gap"]["limit"]
               and chk["positions"] >= checks["positions"]["limit"])
    return checks, bool(correct)


def ref_logits(config, params, s: Served, seed: int, page_size: int,
               device):
    """(logits [n, V] at the served positions, served ids [n])."""
    c = derived(config)
    P = len(s.prompt)
    out = torch.as_tensor(np.asarray(s.out, np.int64), device=device)
    if s.adopted:
        kv = context_kv(config, seed, s.rid, P, page_size, device)
        L = c["n_attn"]
        ck = kv["k"].reshape(L, -1, *kv["k"].shape[3:])[:, :P]
        cv = kv["v"].reshape(L, -1, *kv["v"].shape[3:])[:, :P]
        lg = R.forward_for(c)(c, params, out[:-1], P, (ck, cv))
        return lg, out[1:]
    toks = torch.cat([torch.as_tensor(np.asarray(s.prompt, np.int64),
                                      device=device), out[:-1]])
    lg = R.forward_for(c)(c, params, toks, 0, None)
    return lg[P - 1:], out


def gaps(config, served: list, seed: int, page_size: int, device, *,
         control: bool = False) -> dict:
    """The widest gap over every served position of ``served`` (and, with
    ``control``, the control's); also the positions compared and how many
    served tokens differ from the reference's first choice."""
    params = make_params(config, seed, device)
    worst = ctl = 0.0
    positions = flips = ctl_flips = 0
    with torch.no_grad():
        for s in served:
            with R.precision(False, device):
                lg, ids = ref_logits(config, params, s, seed, page_size,
                                     device)
            best = lg.max(dim=-1).values
            gap = best - lg.gather(1, ids[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            positions += len(ids)
            flips += int((lg.argmax(-1) != ids).sum())
            if control:
                with R.precision(True, device):
                    lt, _ = ref_logits(config, params, s, seed, page_size,
                                       device)
                first = lt.argmax(-1)
                g = best - lg.gather(1, first[:, None])[:, 0]
                ctl = max(ctl, float(g.max()))
                ctl_flips += int((first != lg.argmax(-1)).sum())
                del lt
            del lg
    del params
    out = {"logit_gap": worst, "positions": positions, "flips": flips}
    if control:
        out.update(control_gap=ctl, control_flips=ctl_flips)
    return out
