"""The MoE family in repro_torch against repro, on the CPU.

``models/moe.py::moe_local`` against ``repro.models.moe.moe_local`` on
the same numpy weights within 1e-5: at the default capacity factor 1.25
with choices dropped, with a zero router (every probability ties, every
token goes to experts 0 and 1, which overflow), with twice as many
virtual experts as experts, and for a single token.

Then the reduced ``mixtral-8x22b`` (sliding-window layers) and
``phi3.5-moe-42b-a6.6b`` engines, on weights converted from repro's, at
the default capacity factor (not the dropless 8.0 of
``tests/test_models.py``): token-identical to repro's engine, with equal
``decode_tokens`` and ``device_syncs``, at every (prefill mode, horizon)
of slot / batched / chunked x 1 / 4. A MoE's drops depend on every row a
call routes (pad positions, idle slots), so its greedy output is not
invariant across horizons or prefill modes, even in repro: each (mode,
horizon) is held to repro's own. The port's runs are checked to drop
choices both in prefill and in decode. Last, speculative decoding with a
MoE target and a 1-layer llama draft, against repro's.
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JMDL
from repro.models import moe as JMOE
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as MOE
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


MOES = ("mixtral-8x22b", "phi3.5-moe-42b-a6.6b")
# 4 slots: a decode step routes 8 choices over 4 experts of capacity 3
KW = dict(n_slots=4, page_size=4, n_pages=64, max_context=40, eos_token=-1,
          prefill_chunk=4)


def _cfgs(name, layers=None):
    return (replace(jax_reduced(jax_get_config(name), layers=layers),
                    dtype="float32"),
            replace(reduced(get_config(name), layers=layers),
                    dtype="float32"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# moe_local against repro's
# ---------------------------------------------------------------------------

def _case(kind):
    """(x [B, S, D], n_virtual, zero router) of a ``moe_local`` case."""
    rng = np.random.default_rng(5)
    shape = {"drops": (4, 16), "zero_router": (2, 8),
             "virtual": (3, 7), "one_token": (1, 1)}[kind]
    x = rng.standard_normal(shape + (64,)).astype(np.float32)
    if kind == "drops":            # a shared direction skews the routing
        x += 3.0 * rng.standard_normal(64).astype(np.float32)
    return x, (8 if kind == "virtual" else None), kind == "zero_router"


@pytest.mark.parametrize("kind", ["drops", "zero_router", "virtual",
                                  "one_token"])
@pytest.mark.parametrize("name", MOES)
def test_moe_local_matches_repro(name, kind):
    jcfg, cfg = _cfgs(name)
    x, n_virtual, zero = _case(kind)
    jp = JMOE.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32,
                       n_virtual=n_virtual)
    if zero:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = {k: torch.tensor(v) for k, v in _np(jp).items()}
    jy, jaux = JMOE.moe_local(jp, jcfg, jnp.asarray(x))
    y = MOE.moe_local(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    # the routing itself is repro's: aux loss, experts, slots and drops
    xt = torch.from_numpy(x.reshape(-1, 64))
    np.testing.assert_allclose(float(MOE.aux_loss(p["router"], cfg, xt)),
                               float(jaux), rtol=1e-6)
    top_p, top_e = MOE.route(p["router"], cfg, xt)
    jtop_p, jtop_e, _ = JMOE.route(jp["router"], jcfg, jnp.asarray(
        x.reshape(-1, 64)))
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p), atol=1e-6)
    C = MOE.capacity(cfg, xt.shape[0])
    assert C == JMOE.capacity(jcfg, xt.shape[0])
    slot, keep = MOE._dispatch_indices(top_e, cfg.n_experts, C)
    jslot, jkeep = JMOE._dispatch_indices(jtop_e, jcfg.n_experts, C)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if kind in ("drops", "zero_router"):
        assert not keep.all()
    if zero:                       # ties go to the lowest expert indices
        assert (top_e == torch.tensor([0, 1])).all()


def test_dispatch_sends_drops_to_the_trash_row():
    """Dropped choices leave the expert buffers untouched; each kept one
    lands once, at its (expert, slot)."""
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2) + 1
    top_e = torch.tensor([[0, 1]] * 6)
    slot, keep = MOE._dispatch_indices(top_e, 3, 2)
    buf = MOE.dispatch(x, top_e, slot, keep, 3, 2)
    assert keep.sum() == 4
    want = torch.zeros(3, 2, 2)
    want[0] = want[1] = x[:2]
    assert torch.equal(buf, want)


# ---------------------------------------------------------------------------
# the serving engine against repro's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(name, layers=None, seed=0):
    jcfg, cfg = _cfgs(name, layers)
    jp = JMDL.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, jp, cfg, params_from_numpy(cfg, _np(jp), "cpu")


def _requests():
    rng = np.random.default_rng(3)
    return [(r, rng.integers(0, 256, size=int(rng.integers(4, 25))), 9)
            for r in range(6)]


def _submit(eng, req):
    for r, prompt, n in _requests():
        eng.submit(req(r, prompt, n))


@functools.lru_cache(maxsize=None)
def _serve_jax(name, mode, horizon, spec=False):
    jcfg, jp, _, _ = _models(name)
    kw = {}
    if spec:
        djcfg, djp, _, _ = _models("llama3.2-1b", 1, 7)
        kw = dict(draft_config=djcfg, spec_horizon=3)
        draft = dict(draft_params=djp)
    eng = JaxEngine(jcfg, JaxEngineConfig(prefill_mode=mode,
                                          decode_horizon=horizon,
                                          use_pallas=False, **KW, **kw), jp,
                    **(draft if spec else {}))
    _submit(eng, JaxRequest)
    out = {k: list(v) for k, v in eng.run(500).items()}
    counters = (eng.timing.decode_tokens, eng.timing.device_syncs)
    if spec:
        counters += (eng.spec_rounds, eng.spec_proposed, eng.spec_accepted)
    return out, counters


def _serve_torch(name, mode, horizon, spec=False, use_kernels=None):
    _, _, cfg, params = _models(name)
    kw, draft = {}, None
    if spec:
        _, _, dcfg, draft = _models("llama3.2-1b", 1, 7)
        kw = dict(draft_config=dcfg, spec_horizon=3)
    eng = DecodeEngine(cfg, EngineConfig(prefill_mode=mode,
                                         decode_horizon=horizon,
                                         use_kernels=use_kernels, **KW, **kw),
                       params, device="cpu", draft_params=draft)
    _submit(eng, Request)
    out = {k: list(v) for k, v in eng.run(500).items()}
    counters = (eng.timing.decode_tokens, eng.timing.device_syncs)
    if spec:
        counters += (eng.spec_rounds, eng.spec_proposed, eng.spec_accepted)
    return out, counters, eng


@pytest.fixture
def drops(monkeypatch):
    """Choices dropped by the port's routing, by rows routed: {T: drops}."""
    seen: dict[int, int] = {}
    inner = MOE._dispatch_indices

    def counting(top_e, E, C):
        slot, keep = inner(top_e, E, C)
        T = top_e.shape[0]
        seen[T] = seen.get(T, 0) + int((~keep).sum())
        return slot, keep
    monkeypatch.setattr(MOE, "_dispatch_indices", counting)
    return seen


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("mode", ["slot", "batched", "chunked"])
@pytest.mark.parametrize("name", MOES)
def test_engine_matches_repro(name, mode, horizon, drops):
    out, counters, eng = _serve_torch(name, mode, horizon)
    want, jcounters = _serve_jax(name, mode, horizon)
    assert out == want
    assert counters == jcounters
    assert eng.batcher.stats.completed == len(want)
    bal = eng.alloc.shard_balance()
    assert bal.max() == 0 and bal.min() == 0
    # the drop path is live in decode (one row a slot) and in prefill
    assert drops.get(KW["n_slots"], 0) > 0
    assert sum(n for T, n in drops.items() if T != KW["n_slots"]) > 0


@pytest.mark.parametrize("mode,use_kernels", [("batched", None),
                                               ("chunked", False)])
def test_spec_with_moe_target_matches_repro(mode, use_kernels):
    """A MoE target (reduced mixtral) verified one pass a round against a
    1-layer llama draft: tokens and the spec counters equal repro's.

    In chunked prefill some verify passes carry idle slots (ctx 0), whose
    rows see no token: repro's reference path gives them the mean of the
    gathered dead pages, the verify kernel (repro's Pallas kernel, the
    port's K1) zeros. Those rows route and take expert capacity, so a
    MoE target's tokens there depend on the attention path (ROADMAP
    C.7); the port's plain path is repro's reference and is held to it.

    On the CPU no CUDA kernel runs: ``use_kernels=None`` takes each
    kernel wrapper's plain version (the kernel's own function, an idle
    row's 0 included) and ``False`` the reference ops. The CUDA kernels
    under a MoE target are held on the card by
    ``tests/test_torch_gpu.py::test_spec_with_moe_target_on_the_card``."""
    out, counters, eng = _serve_torch("mixtral-8x22b", mode, 1, spec=True,
                                      use_kernels=use_kernels)
    want, jcounters = _serve_jax("mixtral-8x22b", mode, 1, spec=True)
    assert out == want
    assert counters == jcounters
    assert eng.spec_rounds > 0
    assert eng.alloc.pages_in_use == 0


def test_serve_cli_moe_on_cpu(capsys):
    """``launch.serve --arch phi3.5-moe-42b-a6.6b`` (reduced) completes and
    releases every page."""
    from repro_torch.launch import serve
    done = serve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--requests", "5",
                       "--slots", "3", "--page", "8", "--pages", "48",
                       "--max-context", "96", "--mean-new", "6",
                       "--prefill-mode", "chunked", "--decode-horizon", "4",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert done == 5 and "completed=5/5" in out
    assert "page balance per shard: max=0 min=0" in out


def test_params_from_numpy_carries_the_moe_leaves():
    """repro's stacked MoE leaves become per-layer router [D, E], w1 / w3
    [V, D, ff/v] and w2 [V, ff/v, D], value for value."""
    jcfg, jp, cfg, params = _models("mixtral-8x22b")
    E, D, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    shapes = {"router": (D, E), "w1": (E, D, ff), "w3": (E, D, ff),
              "w2": (E, ff, D)}
    for i, lp in enumerate(params["layers"]):
        assert set(lp) == {"ln1", "attn", "ln2", "moe"}
        for k, shape in shapes.items():
            assert tuple(lp["moe"][k].shape) == shape
            np.testing.assert_array_equal(
                lp["moe"][k].numpy(), np.asarray(jp["layers"]["moe"][k][i]))


@pytest.mark.parametrize("name", MOES)
def test_init_params_has_repro_layout(name):
    """The port's own seeded weights have the converted tree's leaves and
    shapes, and the experts' scales of repro's ``init_moe``."""
    from repro_torch.models import model as MDL
    _, _, cfg, conv = _models(name)
    own = MDL.init_params(cfg, 0, torch.float32, "cpu")
    flat = lambda t: {k: v for k, v in MDL.tree_map(  # noqa: E731
        lambda x: tuple(x.shape), t)["layers"][0]["moe"].items()}
    assert flat(own) == flat(conv)
    assert [sorted(lp) for lp in own["layers"]] == \
        [sorted(lp) for lp in conv["layers"]]
    w1 = own["layers"][0]["moe"]["w1"]
    assert abs(float(w1.std()) * cfg.d_model ** 0.5 - 1) < 0.05
