"""The port's crash-consistent serving snapshots against repro's, on the CPU.

``runtime/checkpoint.py`` keeps repro's on-disk layout (``step_N/
shard_00000.npz`` and a ``manifest.json`` written last, a crc32 per array);
the engine's ``save_snapshot`` writes repro's entries, so at the same tick
the manifests' ``extra`` (order, warm / cold / done entries, depths) equal
repro's and the saved tokens and KV pages match. A fresh engine restores
the newest intact step and finishes token-identically to the uninterrupted
run, for llama (KV pages) and zamba2 (the Mamba2 carries), writing pages
and rows into the existing state in place; torn manifests, corrupt
payloads and empty directories fall back as repro's do.
"""
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JMDL
from repro.runtime import checkpoint as JCKPT
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import checkpoint as CKPT
from repro_torch.serving import DecodeEngine, EngineConfig, Request

PAGE = 4


def _pair(arch):
    jcfg = replace(jax_reduced(jax_get_config(arch)), dtype="float32")
    cfg = replace(reduced(get_config(arch)), dtype="float32")
    jp = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, jp, cfg, params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3.2-1b")


def _engine(models, **kw):
    _, _, cfg, params = models
    base = dict(n_slots=3, page_size=PAGE, n_pages=96, max_context=64,
                eos_token=-1)
    base.update(kw)
    return DecodeEngine(cfg, EngineConfig(**base), params, device="cpu")


def _submit(eng, n=6, max_new=8, req=Request):
    rng = np.random.default_rng(0)
    for r in range(n):
        eng.submit(req(r, rng.integers(0, 256, size=int(rng.integers(3, 20))),
                       max_new))


def _outs(eng):
    return {k: list(v) for k, v in eng.outputs.items()}


def _leak_free(eng):
    assert eng.alloc.pages_in_use == 0
    assert not eng.rsnaps and not eng.deadline_t and not eng._abort_req


@pytest.fixture(scope="module")
def ref(llama):
    eng = _engine(llama)
    _submit(eng)
    eng.run(500)
    return _outs(eng)


def _snap_run(models, path, every=2, ticks=7):
    eng = _engine(models, snapshot_dir=str(path), snapshot_every=every)
    _submit(eng)
    for _ in range(ticks):
        eng.tick()
    steps = sorted(int(d.name.split("_")[1]) for d in path.glob("step_*"))
    assert len(steps) >= 2
    return eng, steps


def _flip(path, step):
    shard = path / f"step_{step:08d}" / "shard_00000.npz"
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0x40
    shard.write_bytes(bytes(blob))


# ---------------------------------------------------------------------------
# runtime/checkpoint.py
# ---------------------------------------------------------------------------

def test_checkpoint_layout_matches_repro(tmp_path):
    """The same tree saves under the same keys, crc32s and manifest fields
    in both packages (tuples flatten to indices); bf16 tensors are stored
    as f32, the crc over the stored array."""
    rng = np.random.default_rng(0)
    tree = {"reqs": {"3": {"prompt": rng.integers(0, 9, 5).astype(np.int32),
                           "rows": {"mamba": {"conv": rng.random((2, 1, 3)),
                                              "ssm": (rng.random(4),
                                                      rng.random(2))}}}},
            "gen_state": np.arange(6, dtype=np.uint8)}
    jd, td = tmp_path / "jax", tmp_path / "torch"
    JCKPT.save(jd, 5, tree, extra={"tick": 5})
    CKPT.save(td, 5, tree, extra={"tick": 5})
    jm = json.loads((jd / "step_00000005" / "manifest.json").read_text())
    tm = json.loads((td / "step_00000005" / "manifest.json").read_text())
    assert tm["crc"] == jm["crc"] and tm["n_arrays"] == jm["n_arrays"]
    assert tm["extra"] == jm["extra"]
    assert CKPT.verify_step(td, 5) and JCKPT.verify_step(td, 5)
    _, nested = CKPT.load(td, 5)
    np.testing.assert_array_equal(
        nested["reqs"]["3"]["rows"]["mamba"]["ssm"]["1"], tree["reqs"]["3"][
            "rows"]["mamba"]["ssm"][1])
    bf = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    CKPT.save(td, 6, {"w": bf}, keep=1)
    assert CKPT.valid_steps(td) == [6]            # keep=1 collected step 5
    _, nested = CKPT.load(td, 6)
    assert nested["w"].dtype == np.float32
    np.testing.assert_array_equal(nested["w"], bf.float().numpy())
    assert CKPT.verify_step(td, 6)


# ---------------------------------------------------------------------------
# the engine's snapshots
# ---------------------------------------------------------------------------

def test_snapshot_manifests_match_repro(llama, tmp_path):
    """Snapshots every 3 ticks for 7 ticks in both packages: each step's
    ``extra`` (order, entries, depths) is repro's, the saved prompts and
    outputs equal and the warm KV pages agree to fp32 reduction order."""
    jcfg, jp, cfg, params = llama
    jeng = JaxEngine(jcfg, JaxEngineConfig(
        n_slots=3, page_size=PAGE, n_pages=96, max_context=64, eos_token=-1,
        use_pallas=False, snapshot_dir=str(tmp_path / "jax"),
        snapshot_every=3), jp)
    _submit(jeng, req=JaxRequest)
    eng = _engine(llama, snapshot_dir=str(tmp_path / "torch"),
                  snapshot_every=3)
    _submit(eng)
    for _ in range(7):
        jeng.tick()
        eng.tick()
    assert eng.snapshot_saves == jeng.snapshot_saves == 2
    kinds = set()
    for step in (3, 6):
        tm, tarr = CKPT.load(tmp_path / "torch", step)
        jm, jarr = CKPT.load(tmp_path / "jax", step)
        assert tm["extra"] == jm["extra"]
        for rid, ent in tm["extra"]["reqs"].items():
            kinds.add(ent["state"])
            a, b = tarr["reqs"][rid], jarr["reqs"][rid]
            assert set(a) == set(b)
            for k in ("prompt", "out"):
                np.testing.assert_array_equal(a[k], b[k])
            for k in ("kv_k", "kv_v"):
                if k in b:
                    np.testing.assert_allclose(a[k], b[k], atol=1e-5)
    assert "warm" in kinds


def test_snapshot_restore_token_identical(llama, ref, tmp_path):
    eng, _ = _snap_run(llama, tmp_path, every=3, ticks=7)
    assert eng.snapshot_saves >= 1
    eng2 = _engine(llama, snapshot_dir=str(tmp_path))
    ptrs = {k: t.data_ptr() for k, t in eng2.state["pool"].items()}
    assert eng2.restore_snapshot() is not None
    assert _outs_run(eng2) == ref
    assert eng2.snapshot_restores == 1 and eng2.rstate_restores >= 1
    assert ptrs == {k: t.data_ptr() for k, t in eng2.state["pool"].items()}
    _leak_free(eng2)
    with pytest.raises(RuntimeError):
        eng2.restore_snapshot()                 # not a fresh engine


def _outs_run(eng):
    eng.run(500)
    return _outs(eng)


def test_snapshot_restore_recurrent_carries(tmp_path):
    """zamba2: a warm restore re-seats the saved Mamba2 carries (no
    re-prefill) into the existing rows and matches the uninterrupted
    run."""
    _, _, cfg, params = _pair("zamba2-1.2b")

    def eng_for(**kw):
        return DecodeEngine(cfg, EngineConfig(
            n_slots=3, page_size=PAGE, n_pages=96, max_context=64,
            eos_token=-1, **kw), params, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=int(rng.integers(4, 16)))
               for _ in range(4)]

    def submit(eng):
        for r, p in enumerate(prompts):
            eng.submit(Request(r, p, 8))
    clean = eng_for()
    submit(clean)
    want = _outs_run(clean)
    eng = eng_for(snapshot_dir=str(tmp_path), snapshot_every=4)
    submit(eng)
    for _ in range(5):
        eng.tick()
    eng2 = eng_for(snapshot_dir=str(tmp_path))
    rows = eng2.state["mamba"]["conv"].data_ptr()
    assert eng2.restore_snapshot(step=4) == 4
    assert _outs_run(eng2) == want
    assert eng2.rstate_restores >= 1
    assert eng2.state["mamba"]["conv"].data_ptr() == rows
    _leak_free(eng2)


def test_snapshot_restore_empty_dir(llama, tmp_path):
    eng = _engine(llama, snapshot_dir=str(tmp_path))
    assert eng.restore_snapshot() is None
    _submit(eng, n=2)
    eng.run(500)
    assert eng.batcher.stats.completed == 2


def test_snapshot_restore_rejects_torn_manifest(llama, ref, tmp_path):
    """A half-written newest manifest un-commits that step: restore falls
    back to the previous one and finishes token-identically."""
    _, steps = _snap_run(llama, tmp_path)
    mf = tmp_path / f"step_{steps[-1]:08d}" / "manifest.json"
    text = mf.read_text()
    mf.write_text(text[:len(text) // 2])
    eng2 = _engine(llama, snapshot_dir=str(tmp_path))
    assert eng2.restore_snapshot() == steps[-2]
    assert _outs_run(eng2) == ref
    _leak_free(eng2)


def test_snapshot_restore_rejects_corrupt_payload(llama, ref, tmp_path):
    _, steps = _snap_run(llama, tmp_path)
    _flip(tmp_path, steps[-1])
    eng2 = _engine(llama, snapshot_dir=str(tmp_path))
    assert eng2.restore_snapshot() == steps[-2]
    assert eng2.snapshot_rejects == 1
    assert _outs_run(eng2) == ref
    _leak_free(eng2)


def test_snapshot_restore_all_corrupt_falls_back_cold(llama, ref, tmp_path):
    _, steps = _snap_run(llama, tmp_path)
    for st in steps:
        _flip(tmp_path, st)
    eng2 = _engine(llama, snapshot_dir=str(tmp_path))
    assert eng2.restore_snapshot() is None
    assert eng2.snapshot_rejects == len(steps)
    assert not eng2.prompts                     # nothing half-applied
    _submit(eng2)
    assert _outs_run(eng2) == ref
    _leak_free(eng2)
