"""repro_torch's serving engine against repro's, end to end on the CPU.

Same converted weights and the same requests go through both engines;
greedy outputs must be token-identical for every prefill mode and horizon,
with equal token and device-sync counters. Also: the port imports neither
jax nor repro.
"""
import ast
import os
import pathlib
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JMDL
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import DecodeEngine, EngineConfig, Request

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
KW = dict(n_slots=2, page_size=4, n_pages=48, max_context=40, eos_token=-1,
          prefill_chunk=4)
REF_HORIZON = 4


def _requests():
    rng = np.random.default_rng(3)
    return [(r, rng.integers(0, 256, size=int(rng.integers(4, 14))), 9)
            for r in range(4)]


@pytest.fixture(scope="module")
def models():
    jcfg = replace(jax_reduced(jax_get_config("llama3.2-1b")), dtype="float32")
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    jparams = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _serve_jax(models, mode, horizon):
    jcfg, jparams, _, _ = models
    eng = JaxEngine(jcfg, JaxEngineConfig(prefill_mode=mode,
                                          decode_horizon=horizon,
                                          use_pallas=False, **KW), jparams)
    for r, prompt, n in _requests():
        eng.submit(JaxRequest(r, prompt, n))
    out = {k: list(v) for k, v in eng.run(500).items()}
    assert eng.batcher.stats.completed == len(out)
    return out, eng.timing


def _serve_torch(models, mode, horizon, **kw):
    _, _, cfg, params = models
    eng = DecodeEngine(cfg, EngineConfig(prefill_mode=mode,
                                         decode_horizon=horizon, **KW, **kw),
                       params, device="cpu")
    for r, prompt, n in _requests():
        eng.submit(Request(r, prompt, n))
    out = {k: list(v) for k, v in eng.run(500).items()}
    return out, eng


@pytest.fixture(scope="module")
def jax_ref(models):
    """The JAX engine once per prefill mode (greedy outputs are horizon
    invariant; its counters are those of ``REF_HORIZON``)."""
    return {mode: _serve_jax(models, mode, REF_HORIZON)
            for mode in ("slot", "batched", "chunked")}


@pytest.mark.parametrize("horizon", [1, 4, 8])
@pytest.mark.parametrize("mode", ["slot", "batched", "chunked"])
def test_engine_greedy_identity(models, jax_ref, mode, horizon):
    want, jtiming = jax_ref[mode]
    got, eng = _serve_torch(models, mode, horizon)
    assert got == want
    assert eng.batcher.stats.completed == len(want)
    bal = eng.alloc.shard_balance()
    assert bal.max() == 0 and bal.min() == 0
    if horizon == REF_HORIZON:
        assert eng.timing.decode_tokens == jtiming.decode_tokens
        assert eng.timing.device_syncs == jtiming.device_syncs


@pytest.mark.parametrize("horizon", [1, 8])
def test_engine_sync_counters_match(models, horizon):
    """One readback per horizon: tokens and device syncs equal the JAX
    engine's at the ends of the horizon range."""
    want, jtiming = _serve_jax(models, "batched", horizon)
    got, eng = _serve_torch(models, "batched", horizon)
    assert got == want
    assert eng.timing.decode_tokens == jtiming.decode_tokens
    assert eng.timing.device_syncs == jtiming.device_syncs


def test_engine_plain_path_identity(models, jax_ref):
    """``use_kernels=False`` (gather-then-dense decode, plain prefill) gives
    the same tokens as the kernel path's plain versions."""
    got, _ = _serve_torch(models, "chunked", 4, use_kernels=False,
                          kernel_splits=3)
    assert got == jax_ref["chunked"][0]


def test_engine_rejects_unported_features():
    with pytest.raises(NotImplementedError):
        EngineConfig(prefix_cache=True, **KW)
    with pytest.raises(NotImplementedError):
        EngineConfig(sampler="top_k", **KW)


def test_cuda_request_without_card_raises(models):
    """Entry points default to the card and never fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, cfg, params = models
    with pytest.raises(RuntimeError, match="cuda"):
        DecodeEngine(cfg, EngineConfig(**KW), params)


def test_serve_cli_completes_on_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--requests", "5", "--slots", "2", "--page", "8",
                       "--pages", "48", "--max-context", "96", "--mean-new",
                       "6", "--prefill-mode", "chunked", "--decode-horizon",
                       "4", "--kernel-splits", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert done == 5 and "completed=5/5" in out
    assert "page balance per shard: max=0 min=0" in out


def _port_modules():
    root = SRC / "repro_torch"
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_port_imports_without_jax():
    """Every repro_torch module imports with jax blocked."""
    names = [name for _, name in _port_modules()]
    code = ("import importlib, sys\nsys.modules['jax'] = None\n"
            f"for n in {names!r}:\n    importlib.import_module(n)\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)\nprint('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_port_source_never_imports_jax_or_repro():
    bad = []
    for path, _ in _port_modules():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.name}: {m}")
    assert not bad, bad
