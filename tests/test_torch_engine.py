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
                                         decode_horizon=horizon,
                                         **{**KW, **kw}),
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
    """Every EngineConfig feature is ported: cluster roles, the KV-cache
    hierarchy, the recurrent snapshots, stochastic sampling, speculative
    decoding, telemetry, fault injection, the request lifecycle and
    serving snapshots all construct (the engine records its role; the
    cluster's router enforces it)."""
    for role in ("prefill", "decode", "both"):
        assert EngineConfig(role=role, **KW).role == role
    EngineConfig(prefix_cache=True, host_pages=8, state_resume=True, **KW)
    EngineConfig(sampler="top_k", top_k=8, temperature=0.8, sample_seed=3,
                 draft_config="llama3.2-1b", spec_horizon=3, **KW)
    EngineConfig(telemetry=object(), faults=object(), snapshot_every=1,
                 snapshot_dir="snaps", max_queue=4, default_deadline_s=1.0,
                 degrade_after=2, nan_guard=True, snapshot_keep=2, **KW)


@pytest.mark.parametrize("kw", [dict(static_alloc=True),
                                # tables past 16 pages, where the pow2
                                # bucketing would apply
                                dict(decode_bucket=False, max_context=96),
                                dict(sched_policy="sjf"),
                                dict(sched_policy="memory_aware")],
                         ids=["static_alloc", "no_decode_bucket", "sjf",
                              "memory_aware"])
def test_engine_options_match_repro(models, kw):
    """Static allocation, unbucketed decode tables and the sjf and
    memory-aware admission policies: tokens, decode tokens and device syncs
    equal repro's engine with the same option."""
    jcfg, jparams, _, _ = models
    jeng = JaxEngine(jcfg, JaxEngineConfig(decode_horizon=REF_HORIZON,
                                           use_pallas=False,
                                           **{**KW, **kw}), jparams)
    for r, prompt, n in _requests():
        jeng.submit(JaxRequest(r, prompt, n))
    want = {k: list(v) for k, v in jeng.run(500).items()}
    got, eng = _serve_torch(models, "batched", REF_HORIZON, **kw)
    assert got == want
    assert eng.timing.decode_tokens == jeng.timing.decode_tokens
    assert eng.timing.device_syncs == jeng.timing.device_syncs
    assert eng.batcher.stats.completed == jeng.batcher.stats.completed
    assert eng.batcher.stats.avg_batch == jeng.batcher.stats.avg_batch


class _Picker:
    """A stateful, deterministic legacy ``sample=`` callable: even calls
    take the row's argmax, odd calls the id after it. Logs (call, argmax)
    so two engines' call sequences can be compared."""

    def __init__(self, vocab: int):
        self.vocab = vocab
        self.log: list[tuple[int, int]] = []

    def __call__(self, row) -> int:
        n, a = len(self.log), int(np.argmax(row))
        self.log.append((n, a))
        return a if n % 2 == 0 else (a + 1) % self.vocab


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("mode", ["slot", "batched", "chunked"])
def test_engine_sample_callable_matches_repro(models, mode, horizon):
    """``DecodeEngine(sample=)``: a host callable samples prefill's first
    tokens and every decode step (the eager horizon, one logits readback a
    step); tokens, the callable's call log and device syncs equal repro's
    (whose horizon calls it through an ordered ``io_callback``)."""
    jcfg, jparams, cfg, params = models
    jpick, pick = _Picker(cfg.vocab_size), _Picker(cfg.vocab_size)
    jeng = JaxEngine(jcfg, JaxEngineConfig(prefill_mode=mode,
                                           decode_horizon=horizon,
                                           use_pallas=False, **KW),
                     jparams, sample=jpick)
    eng = DecodeEngine(cfg, EngineConfig(prefill_mode=mode,
                                         decode_horizon=horizon, **KW),
                       params, sample=pick, device="cpu")
    for e, R in ((jeng, JaxRequest), (eng, Request)):
        for r, prompt, n in _requests():
            e.submit(R(r, prompt, n))
    want = {k: list(v) for k, v in jeng.run(500).items()}
    got = {k: list(v) for k, v in eng.run(500).items()}
    assert got == want
    assert pick.log == jpick.log and len(pick.log) > 0
    assert eng.timing.device_syncs == jeng.timing.device_syncs
    assert eng.timing.sample_readbacks == eng.timing.decode_steps
    assert not eng.horizons.graphs


def test_engine_sample_callable_refusals(models):
    """``sample=`` with a draft raises (the verifier needs the sampler's
    distribution), and with ``decode_graphs=True`` (a host call cannot run
    inside a CUDA graph), before any allocation."""
    _, _, cfg, params = models
    with pytest.raises(ValueError, match="sample= callables"):
        DecodeEngine(cfg, EngineConfig(draft_config=cfg, spec_horizon=3,
                                       **KW), params,
                     sample=_Picker(cfg.vocab_size), device="cpu")
    with pytest.raises(ValueError, match="sample= callable"):
        DecodeEngine(cfg, EngineConfig(decode_graphs=True, **KW), params,
                     sample=_Picker(cfg.vocab_size), device="cpu")


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


def test_serve_cli_accepts_reduced_as_repro():
    """``--reduced`` parses as repro's serve parses it: a no-op (True by
    default) that leaves ``--full-width`` its meaning."""
    from repro_torch.launch import serve
    args = serve.parse_args(["--reduced", "--device", "cpu"])
    assert args.reduced is True and args.full_width is False
    assert serve.parse_args([]).reduced is True
    both = serve.parse_args(["--reduced", "--full-width"])
    assert both.reduced is True and both.full_width is True


def test_core_engine_shim_reexports_serving():
    """``repro_torch.core.engine`` is repro's back-compat shim: the
    serving package's engine and its config."""
    from repro_torch.core import engine as shim
    from repro_torch import serving
    assert shim.DecodeEngine is serving.DecodeEngine
    assert shim.EngineConfig is serving.EngineConfig
    assert shim.__all__ == ["DecodeEngine", "EngineConfig"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-small"])
def test_quickstart_example_on_cpu(arch):
    """``examples/quickstart_torch.py --device cpu``: forward, prefill into
    the paged pool and paged decode agree (exit 0), and the engine
    completes its requests (attention stacks)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, str(SRC.parent / "examples" / "quickstart_torch.py"),
         arch, "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "prefill logits match forward: True" in out
    assert out.count("matches forward: True") == 4 and "done." in out
    if arch == "llama3.2-1b":
        assert "serving: completed=3" in out


def test_serve_cli_prefix_cache_on_cpu(capsys):
    """A shared-prefix trace through the prefix cache and a host tier small
    enough to offload: the ``kvcache:`` line reports hits and copies on
    write, and no page is left over once the tree gives back its own."""
    import re
    from repro_torch.launch import serve
    done = serve.main(["--requests", "8", "--slots", "3", "--page", "8",
                       "--pages", "24", "--max-context", "128",
                       "--mean-new", "8", "--shared-frac", "0.9",
                       "--prefix-cache", "--host-pages", "64",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert done == 8 and "completed=8/8" in out
    assert "page balance per shard: max=0 min=0" in out
    m = re.search(r"kvcache: hits=(\d+)/(\d+) reused_tokens=(\d+) "
                  r"cow=(\d+) evicted=(\d+) swap_out=(\d+) swap_in=(\d+)",
                  out)
    assert m, out
    hits, lookups, reused, cow = (int(m.group(i)) for i in range(1, 5))
    assert lookups == 8 and 0 < hits < lookups and reused > 0 and cow > 0


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


@pytest.mark.parametrize("what", ["src/repro_torch", "chip_smoke.py",
                                  "examples/serve_longbench_torch.py",
                                  "examples/train_100m_torch.py",
                                  "examples/quickstart_torch.py",
                                  "examples/multipod_dryrun_torch.py"])
def test_port_source_never_imports_jax_or_repro(what):
    """The port's package, its card script and its example: no import of
    jax or repro anywhere in their source."""
    paths = ([p for p, _ in _port_modules()] if what == "src/repro_torch"
             else [SRC.parent / what])
    bad = []
    for path in paths:
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
