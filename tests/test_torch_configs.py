"""The dense configurations of the paper's model zoo in repro_torch against
repro, on the CPU.

qwen1.5-7b / -14b / -72b (no GQA: one query head a kv head),
internlm2-1.8b, yi-34b and gemma3-27b (5:1 local:global windows, qk-norm,
geglu, a tied head; one 6-layer cycle) at their reduced widths, on weights converted from
repro's (``params_from_numpy``):

* prefill and four greedy decode steps give logits within 1e-4 of
  ``repro.models.model`` (the prompts outgrow gemma3's reduced 16-token
  window, so its local layers cut in prefill and in decode); yi-34b also
  with 7 query heads on one kv head, its full-width group;
* the serving engine is token-identical to repro's, with equal
  ``decode_tokens`` and ``device_syncs``: batched prefill at horizons 1
  and 4 for all six, and the whole slot / batched / chunked x 1 / 4
  matrix for qwen1.5-7b and gemma3-27b;
* the registry carries repro's eight new configurations (these six and
  the two MoE stacks of ``tests/test_torch_moe.py``) field for field.
"""
import functools
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.paged_kv import PoolSpec as JaxPoolSpec
from repro.kernels.ops import write_targets
from repro.models import model as JMDL
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.core.paged_kv import PoolSpec
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import DecodeEngine, EngineConfig, Request


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port runs tiny shapes here: one intra-op thread a worker keeps
    the suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DENSE = ("qwen1.5-7b", "qwen1.5-14b", "qwen1.5-72b", "internlm2-1.8b",
         "yi-34b", "gemma3-27b")
NEW = DENSE + ("mixtral-8x22b", "phi3.5-moe-42b-a6.6b")
RT = MDL.Runtime(kernels=KernelConfig(n_splits=2))
# 4 slots, 4-token pages; prompts of 4-24 tokens and 9 new tokens outgrow
# gemma3's reduced 16-token window in prefill and in decode
KW = dict(n_slots=4, page_size=4, n_pages=64, max_context=40, eos_token=-1,
          prefill_chunk=4)


# gemma3-27b reduced to one 5:1 local:global cycle (6 layers, not the 12
# of ``reduced``) for the suite's time: each JAX engine compiles per
# layer, and the eight gemma3 tests below took 269 s of test time at 12
# layers against 152 s at 6 (3 workers, CPU), all passing at both depths
# under the same tolerances
LAYERS = {"gemma3-27b": 6}


def _cfgs(name, **over):
    """(repro cfg, port cfg): ``name`` reduced, fp32, with ``over``."""
    n = LAYERS.get(name)
    return (replace(jax_reduced(jax_get_config(name), layers=n),
                    dtype="float32", **over),
            replace(reduced(get_config(name), layers=n), dtype="float32",
                    **over))


@functools.lru_cache(maxsize=None)
def _models(name, heads=None):
    """Both packages' reduced models on the same weights; ``heads`` =
    (query heads, kv heads) overrides the reduced head layout."""
    over = {} if heads is None else dict(n_heads=heads[0],
                                         n_kv_heads=heads[1])
    jcfg, cfg = _cfgs(name, **over)
    jp = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, jp, cfg, params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("name", NEW)
def test_registry_matches_repro(name):
    assert asdict(get_config(name)) == asdict(jax_get_config(name))
    MDL._check_family(get_config(name))


def test_gemma3_stack_ends_mid_cycle():
    """62 layers of a 6-layer pattern: ten whole cycles, then two local
    layers; each local layer gets the 1024-token window, the global ones
    none, as in repro."""
    cfg = get_config("gemma3-27b")
    w = MDL._window_array(cfg)
    assert len(w) == 62 and w[-2:] == [1024, 1024]
    assert [i for i, x in enumerate(w) if x == 0] == list(range(5, 62, 6))
    np.testing.assert_array_equal(
        w, JMDL._window_array(jax_get_config("gemma3-27b")))


# ---------------------------------------------------------------------------
# the model: prefill and decode logits against repro.models.model
# ---------------------------------------------------------------------------

B, S, PAGE, N_PAGES, MAXP = 2, 20, 4, 20, 8


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("name,heads", [(n, None) for n in DENSE]
                         + [("yi-34b", (7, 1))],
                         ids=list(DENSE) + ["yi-34b-G7"])
def test_prefill_and_decode_logits_match_repro(name, heads):
    """A length-bucketed prefill of 20- and 13-token prompts, then four
    greedy decode steps (the port's kernel path, plain versions here):
    logits within 1e-4 of repro's at every step, the pools within 1e-5 of
    their largest magnitude (the rule of the hybrid's tests: fp32
    reduction-order drift grows with depth, and 1e-5 absolute failed on
    gemma3's pools at 12 reduced layers)."""
    jcfg, jp, cfg, params = _models(name, heads)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    bt = rng.permutation(N_PAGES)[:B * MAXP].reshape(B, MAXP).astype(
        np.int32)
    lens = np.asarray([S, 13], np.int32)
    geo = (cfg.n_layers, N_PAGES, PAGE, cfg.n_kv_heads, cfg.d_head, MAXP)
    jst = JMDL.init_decode_state(jcfg, JaxPoolSpec(*geo, dtype="float32"), B)
    st = MDL.init_decode_state(cfg, PoolSpec(*geo, dtype="float32"), B,
                               device="cpu")
    jl, jst = JMDL.prefill(jcfg, jp, jst, jnp.asarray(tokens),
                           jnp.asarray(bt), last_idx=jnp.asarray(lens - 1),
                           valid_len=jnp.asarray(lens))
    tl, st = MDL.prefill(cfg, params, st, torch.from_numpy(tokens),
                         torch.from_numpy(bt),
                         last_idx=torch.from_numpy(lens - 1),
                         valid_len=torch.from_numpy(lens), rt=RT)
    _close(tl, jl, 1e-4)
    ctx = lens
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, :cfg.vocab_size], -1), np.int32)
        ctx = ctx + 1
        npage, noff = write_targets(jnp.asarray(bt), jnp.asarray(ctx),
                                    jnp.ones((B,), bool), page_size=PAGE,
                                    n_pages=N_PAGES)
        jl, jst = JMDL.decode_step(jcfg, jp, jst, jnp.asarray(nxt),
                                   jnp.asarray(bt), jnp.asarray(ctx), npage,
                                   noff)
        tl, st = MDL.decode_step(cfg, params, st, torch.from_numpy(nxt),
                                 torch.from_numpy(bt), torch.from_numpy(ctx),
                                 torch.from_numpy(np.array(npage)),
                                 torch.from_numpy(np.array(noff)), rt=RT)
        _close(tl, jl, 1e-4)
    for k in ("k", "v"):
        want = np.asarray(jst["pool"][k])
        np.testing.assert_allclose(st["pool"][k][:, :N_PAGES].numpy(), want,
                                   rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the serving engine against repro's
# ---------------------------------------------------------------------------

def _requests():
    rng = np.random.default_rng(3)
    return [(r, rng.integers(0, 256, size=int(rng.integers(4, 25))), 9)
            for r in range(6)]


@functools.lru_cache(maxsize=None)
def _serve_jax(name, mode, horizon):
    jcfg, jp, _, _ = _models(name)
    eng = JaxEngine(jcfg, JaxEngineConfig(prefill_mode=mode,
                                          decode_horizon=horizon,
                                          use_pallas=False, **KW), jp)
    for r, prompt, n in _requests():
        eng.submit(JaxRequest(r, prompt, n))
    out = {k: list(v) for k, v in eng.run(500).items()}
    assert eng.batcher.stats.completed == len(out)
    return out, eng.timing.decode_tokens, eng.timing.device_syncs


def held_to_repro(name, mode, horizon):
    """The port's engine on the trace: tokens, ``decode_tokens`` and
    ``device_syncs`` equal repro's at (mode, horizon); every request
    completes and every page is released."""
    _, _, cfg, params = _models(name)
    eng = DecodeEngine(cfg, EngineConfig(prefill_mode=mode,
                                         decode_horizon=horizon, **KW),
                       params, device="cpu")
    for r, prompt, n in _requests():
        eng.submit(Request(r, prompt, n))
    out = {k: list(v) for k, v in eng.run(500).items()}
    want, dec, syncs = _serve_jax(name, mode, horizon)
    assert out == want
    assert (eng.timing.decode_tokens, eng.timing.device_syncs) == (dec,
                                                                   syncs)
    assert eng.batcher.stats.completed == len(want)
    bal = eng.alloc.shard_balance()
    assert bal.max() == 0 and bal.min() == 0


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("name", [n for n in DENSE
                                  if n not in ("qwen1.5-7b", "gemma3-27b")])
def test_engine_batched_matches_repro(name, horizon):
    held_to_repro(name, "batched", horizon)


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("mode", ["slot", "batched", "chunked"])
@pytest.mark.parametrize("name", ["qwen1.5-7b", "gemma3-27b"])
def test_engine_matrix_matches_repro(name, mode, horizon):
    held_to_repro(name, mode, horizon)


def test_serve_cli_gemma3_on_cpu(capsys):
    """``launch.serve --arch gemma3-27b`` (reduced: two 5:1 cycles)
    completes and releases every page."""
    from repro_torch.launch import serve
    done = serve.main(["--arch", "gemma3-27b", "--requests", "4",
                       "--slots", "2", "--page", "8", "--pages", "48",
                       "--max-context", "96", "--mean-new", "6",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert done == 4 and "completed=4/4" in out
    assert "page balance per shard: max=0 min=0" in out
