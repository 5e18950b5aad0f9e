"""The one traffic generator: it reads a mix's data file
(``traffic/<mix>.json``) and makes the requests of a run from ``--seed``.

A mix holds one or more of these parts, which run side by side:

* ``adopted``: a decode pool's rows, handed over warm by a prefill pool
  (``DecodeEngine.adopt_request``): ``requests`` rows whose contexts
  follow ``context``, each with ``max_new``;
* ``closed``: ``clients`` callers, each sending its next request when its
  last one has finished; ``stagger_first`` cuts each client's first
  output to a uniform share of its draw, so that finishes are spread over
  the window as in a loop that has run for a while;
* ``open``: independent users arriving on a schedule (``arrival``:
  ``gamma`` inter-arrival times with a shape and a rate in requests a
  second; shape 1 is Poisson, below 1 bursty);
* ``prefix``: every prompt that is submitted (closed and open) starts with
  one of ``groups`` shared prefixes whose lengths follow ``length``; the
  part's ``prompt`` lengths are then those of the unshared rest.

Lengths (``context``, ``prompt``, ``output``, ``length``) are ``uniform``
over [lo, hi] or ``lognormal`` with a median and a sigma, clipped to [lo,
hi]. Every seed gets the same SET of sizes and inter-arrival gaps, in
another order: the sizes are the distribution's quantiles at evenly spaced
levels (for an open loop, as many as the window's requests; otherwise
``POOL``), the gaps one draw from the mix's own ``set_seed`` rescaled to
the stated rate, and the run's seed permutes them. So two seeds ask for
the same work, and what varies between seeds is the order, the token ids
and the weights. Token ids are drawn inside the vocabulary.

The length and arrival arithmetic follows the port's
``repro_torch/data/workload.py`` (lognormal lengths, clipped; bursty
arrivals), which replays on a virtual clock; here a run replays on the
wall clock.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

from harness.weights import sub_seed

PARTS = ("adopted", "closed", "open")
POOL = 4096                      # sizes drawn for a closed loop or a warm-up
GOLDEN = (5 ** 0.5 - 1) / 2      # irrational steps of stratified orders
SILVER = 2 ** 0.5 - 1


@dataclass
class Req:
    rid: int
    part: str                   # "adopted", "closed", "open" or "warm"
    prompt: np.ndarray          # int32 token ids
    max_new: int
    arrival: float | None = None        # seconds after the window opens
    first_token: int | None = None      # adopted rows: the handed-over token


def quantile_set(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantile levels (i + 0.5) / n of ``dist``."""
    p = (np.arange(n) + 0.5) / n
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if dist["dist"] == "uniform":
        x = lo + p * (hi - lo + 1)
    elif dist["dist"] == "lognormal":
        z = np.asarray([NormalDist().inv_cdf(float(q)) for q in p])
        x = float(dist["median"]) * np.exp(float(dist["sigma"]) * z)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def gap_set(arrival: dict, n: int, set_seed: int) -> np.ndarray:
    """``n`` inter-arrival gaps (s) with mean exactly 1 / rate."""
    if arrival["process"] != "gamma":
        raise ValueError(f"unknown arrival process {arrival['process']!r}")
    k = float(arrival["shape"])
    g = np.random.default_rng(set_seed).gamma(k, 1.0 / k, size=n)
    return g / g.mean() / float(arrival["rate_per_s"])


class Traffic:
    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.parts = [p for p in PARTS if p in mix]
        if not self.parts:
            raise ValueError(f"a mix needs one of {PARTS}")
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.prompts: dict[int, np.ndarray] = {}    # every request's prompt
        self._rng = np.random.default_rng(sub_seed(seed, "order"))
        self._next = 0
        self._drawn: dict[str, int] = {}
        self._pools: dict[str, tuple] = {}

    # ---- the fixed sets, permuted by the seed --------------------------
    def _perm(self, values: np.ndarray, tag: str,
              stratify: float = 0.0) -> np.ndarray:
        """``values`` in an order drawn from the seed. With ``stratify``
        (an irrational step) the order is a low-discrepancy one: request i
        takes the value ranked where ``frac(u + i * step)`` ranks among the
        others, u from the seed, so every stretch of requests holds the
        sizes in their proportions."""
        rng = np.random.default_rng(sub_seed(self.seed, "perm", tag))
        if not stratify:
            return values[rng.permutation(len(values))]
        keys = (rng.uniform() + np.arange(len(values)) * stratify) % 1.0
        return np.sort(values)[np.argsort(np.argsort(keys))]

    def tokens(self, rid: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(sub_seed(self.seed, "prompt", rid))
        return rng.integers(0, self.vocab, size=int(n), dtype=np.int32)

    def _prefixes(self) -> list:
        """The shared prefixes: ``groups`` token runs whose lengths are the
        ``length`` quantiles in an order drawn from the seed."""
        if not hasattr(self, "_pre"):
            p = self.mix["prefix"]
            lens = self._perm(quantile_set(p["length"], int(p["groups"])),
                              "prefix-length")
            self._pre = [np.random.default_rng(
                sub_seed(self.seed, "prefix", g)).integers(
                    0, self.vocab, size=int(n), dtype=np.int32)
                for g, n in enumerate(lens)]
            self._pre_at = int(self._rng.integers(len(lens)))
        return self._pre

    def _make(self, part: str, n_prompt: int, max_new: int, **kw) -> Req:
        """Request ``rid`` of ``part``: its own ``n_prompt`` tokens, after
        a shared prefix (round robin from a seeded start) where the mix has
        one and the request is submitted."""
        rid = self._next
        self._next += 1
        prompt = self.tokens(rid, n_prompt)
        if "prefix" in self.mix and part != "adopted":
            pre = self._prefixes()
            g = (self._pre_at + rid) % len(pre)
            prompt = np.concatenate([pre[g], prompt])
        self.prompts[rid] = prompt
        return Req(rid, part, prompt, int(max_new), **kw)

    def _pool(self, part: str) -> tuple[np.ndarray, np.ndarray]:
        """``POOL`` prompt and output lengths of ``part``, permuted."""
        if part not in self._pools:
            m = self.mix[part]
            self._pools[part] = (
                self._perm(quantile_set(m["prompt"], POOL), part + "-prompt"),
                self._perm(quantile_set(m["output"], POOL), part + "-output"))
        return self._pools[part]

    def request(self, part: str, *, max_new: int | None = None,
                out_share: float = 1.0) -> Req:
        """The next request of ``part``'s permuted sets (a closed loop's,
        or an open part's warm-up with ``max_new``)."""
        prompts, outs = self._pool(part)
        i = self._drawn.get(part, 0)
        self._drawn[part] = i + 1
        new = int(outs[i % POOL]) if max_new is None else int(max_new)
        new = max(1, int(round(new * out_share)))
        return self._make("warm" if max_new is not None else part,
                          int(prompts[i % POOL]), new)

    # ---- the parts ---------------------------------------------------------
    def adopted(self) -> list[Req]:
        m = self.mix["adopted"]
        n = int(m["requests"])
        ctx = self._perm(quantile_set(m["context"], n), "context")
        first = np.random.default_rng(sub_seed(self.seed, "first")).integers(
            0, self.vocab, size=n)
        return [self._make("adopted", int(c), int(m["max_new"]),
                           first_token=int(t)) for c, t in zip(ctx, first)]

    def first_wave(self) -> list[Req]:
        """A closed loop's first request of each client."""
        m = self.mix["closed"]
        n = int(m["clients"])
        shares = (self._rng.uniform(0.0, 1.0, size=n)
                  if m.get("stagger_first", False) else np.ones(n))
        return [self.request("closed", out_share=float(s)) for s in shares]

    def warm_burst(self, n: int, max_new: int) -> list[Req]:
        """``n`` requests of the open part's sizes, ``max_new`` each: the
        set-up's warm-up of the prefill shapes the window will send."""
        return [self.request("open", max_new=max_new) for _ in range(n)]

    def arrivals(self, seconds: float) -> list[Req]:
        """An open loop's requests due within ``seconds``: exactly ``N =
        floor(rate x seconds)`` of them, whose sizes are the prompt and
        output distributions' quantiles at N levels and whose gaps are the
        mix's gap set of N, mean 1 / rate. The seed permutes the gaps and
        puts the sizes in a stratified order. The first is due at 0 and
        the last before ``seconds``."""
        m = self.mix["open"]
        rate = float(m["arrival"]["rate_per_s"])
        n = max(1, int(rate * seconds))
        prompts = self._perm(quantile_set(m["prompt"], n), "w-prompt",
                             GOLDEN)
        outs = self._perm(quantile_set(m["output"], n), "w-output", SILVER)
        gaps = self._perm(gap_set(m["arrival"], n,
                                  int(m.get("set_seed", 0))), "gaps")
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        return [self._make("open", int(p), int(o), arrival=float(t))
                for t, p, o in zip(due, prompts, outs)]
