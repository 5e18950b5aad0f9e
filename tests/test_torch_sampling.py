"""repro_torch's samplers and speculative verifier against repro's.

Greedy paths are held token for token to ``repro.serving.sampling``; the
sampling distribution ``_probs`` within 1e-6 (tied top-k logits
included: the winner set is ``lax.top_k``'s, the lowest index winning a
tie). JAX's threefry and torch's Philox differ (ROADMAP C.2), so random
draws are held by distribution: chi-square tests at N = 20000 over V = 16
categories, passing at p > 1e-3 (a correct sampler fails one in a
thousand runs; the seeds are fixed, so a run is reproducible).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from repro.serving import sampling as JS
from repro_torch.serving import sampling as S

N, V = 20000, 16
P_MIN = 1e-3


def _gen(seed):
    return S.make_generator(seed, "cpu")


def _softmax(z):
    e = np.exp(z - z.max())
    return e / e.sum()


def _expected(z, temperature, top_k):
    """The distribution a draw must follow: softmax(z / T), restricted to
    the k largest entries (lowest index first on ties)."""
    z = np.asarray(z, np.float64) / temperature
    if top_k:
        keep = np.argsort(-z, kind="stable")[:top_k]
        mask = np.full_like(z, -np.inf)
        mask[keep] = z[keep]
        z = mask
    return _softmax(z)


def _chi2(draws, probs):
    """p-value of the draws against ``probs``; no draw may land where the
    probability is 0."""
    counts = np.bincount(draws, minlength=len(probs))
    live = probs > 0
    assert counts[~live].sum() == 0, counts
    exp = probs[live] * len(draws)
    return chisquare(counts[live], exp / exp.sum() * counts[live].sum()).pvalue


def _logits(seed, shape, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def test_greedy_verifier_matches_jax():
    """Candidates and accept lengths equal repro's: proposals that match
    the argmax for a prefix of each length, ``nprop`` cutting some rows
    short and an idle row."""
    B, C = 6, 5
    logits = _logits(0, (B, C, 32))
    arg = logits.argmax(-1).astype(np.int32)
    rng = np.random.default_rng(1)
    proposals = rng.integers(0, 32, (B, C - 1)).astype(np.int32)
    for b in range(B):
        proposals[b, :min(b, C - 1)] = arg[b, :min(b, C - 1)]
    nprop = np.asarray([4, 4, 1, 4, 2, 0], np.int32)
    run = np.asarray([1, 1, 1, 1, 1, 0], bool)
    jv = JS.make_verifier("greedy")
    _, jcand, jacc = jv(jax.random.PRNGKey(0), jnp.asarray(logits), None,
                        jnp.asarray(proposals), jnp.asarray(nprop),
                        jnp.asarray(run))
    cand, acc = S.make_verifier("greedy")(
        None, torch.from_numpy(logits), None, torch.from_numpy(proposals),
        torch.from_numpy(nprop), torch.from_numpy(run))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert acc.tolist() == [0, 1, 1, 3, 2, 0]


@pytest.mark.parametrize("temperature,top_k,tied", [
    (0.8, 0, False), (1.0, 8, False), (0.7, 8, True), (1.3, 3, True)],
    ids=["temperature", "top_k", "top_k-tied", "top_k3-tied"])
def test_probs_match_jax(temperature, top_k, tied):
    """``_probs`` within 1e-6 of repro's; with integer logits most rows
    have ties at the k-th value, where the winner set decides the mass."""
    rng = np.random.default_rng(2)
    logits = (rng.integers(0, 5, (32, 64)).astype(np.float32) if tied
              else _logits(3, (32, 64)))
    want = np.asarray(JS._probs(jnp.asarray(logits), temperature, top_k))
    got = S._probs(torch.from_numpy(logits), temperature, top_k).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if tied:
        assert (got > 0).sum(-1).tolist() == [top_k] * 32


def test_topk_mask_keeps_lowest_index_on_ties():
    z = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 3.0],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    mask = S._topk_mask(z, 3)
    assert mask.tolist() == [[False, True, True, False, True, False],
                             [True, True, True, False, False, False]]


@pytest.mark.parametrize("temperature,top_k", [(0.8, 0), (1.0, 4),
                                               (1.5, 8)])
def test_stochastic_draws_follow_the_distribution(temperature, top_k):
    """N draws of one row: a chi-square test against softmax(z / T) and its
    top-k restriction."""
    z = _logits(4, (V,))
    draws = S._stochastic(_gen(5), torch.from_numpy(z)[None].expand(N, V),
                          temperature, top_k)
    assert draws.dtype == torch.int32 and draws.shape == (N,)
    assert _chi2(draws.numpy(), _expected(z, temperature, top_k)) > P_MIN


@pytest.mark.parametrize("kind,top_k", [("temperature", 0), ("top_k", 6)])
def test_residual_rejection_first_token_follows_p(kind, top_k):
    """A draft with q != p proposes from q; the first token the verifier
    emits (an accepted proposal, or a draw from the residual) follows p."""
    zp, zq = _logits(6, (V,)), _logits(7, (V,))
    T = 0.9
    gen = _gen(8)
    q_rows = torch.from_numpy(zq)[None].expand(N, V)
    props = S._stochastic(gen, q_rows, T, top_k)[:, None]        # [N, 1]
    logits = torch.from_numpy(zp)[None, None].expand(N, 2, V)
    cand, acc = S.make_verifier(kind, temperature=T, top_k=top_k)(
        gen, logits, q_rows[None], props, torch.ones(N, dtype=torch.int32),
        torch.ones(N, dtype=torch.bool))
    assert 0 < acc.float().mean() < 1          # both branches taken
    assert _chi2(cand[:, 0].numpy(), _expected(zp, T, top_k)) > P_MIN


@pytest.mark.parametrize("kind", ["temperature", "top_k"])
def test_p_equal_q_accepts_every_proposal(kind):
    B, G = 512, 3
    z = torch.from_numpy(_logits(9, (B, G + 1, V)))
    gen = _gen(10)
    verify = S.make_verifier(kind, temperature=0.8, top_k=5)
    sample = S.make_scan_sampler(kind, temperature=0.8, top_k=5)
    props = torch.stack([sample(gen, z[:, i]) for i in range(G)], dim=1)
    cand, acc = verify(gen, z, z[:, :G].transpose(0, 1), props,
                       torch.full((B,), G, dtype=torch.int32),
                       torch.ones(B, dtype=torch.bool))
    assert torch.all(acc == G)
    assert torch.equal(cand[:, :G], props)


def test_stochastic_sample_and_step_draw_from_the_generator():
    """The public forms draw what ``_stochastic`` draws from the same
    generator state; the step form hands back the generator, advanced."""
    z = torch.from_numpy(_logits(13, (6, 50)))
    want = S._stochastic(_gen(1), z, 0.7, 5)
    assert torch.equal(S.stochastic_sample(_gen(1), z, 0.7, 5), want)
    g = _gen(1)
    g2, got = S.stochastic_sample_step(g, z, 0.7, 5)
    assert g2 is g and torch.equal(got, want)
    assert not torch.equal(g.get_state(), _gen(1).get_state())


def test_sampler_is_seed_deterministic():
    logits = _logits(11, (4, 64))
    runs = []
    for seed in (3, 3, 4):
        s = S.make_sampler("top_k", temperature=0.9, top_k=10, seed=seed,
                           device="cpu")
        runs.append([s(logits).tolist() for _ in range(5)]
                    + [int(s(logits[0]))])
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    greedy = S.make_sampler("greedy")
    assert greedy(logits).tolist() == logits.argmax(-1).tolist()
    assert greedy.gen is None


def test_scan_sampler_greedy_ignores_the_generator():
    z = torch.from_numpy(_logits(12, (3, 40)))
    f = S.make_scan_sampler("greedy")
    assert torch.equal(f(None, z), f(_gen(0), z))
    assert f(None, z).tolist() == z.argmax(-1).tolist()
    with pytest.raises(ValueError, match="unknown sampler"):
        S.make_scan_sampler("nucleus")
    # a stochastic draw never falls back to the global RNG
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        S.make_scan_sampler("top_k", top_k=4)(None, z)
