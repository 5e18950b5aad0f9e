"""Manifest-gated, crash-safe checkpoints (no external deps).

The port's copy of ``repro/runtime/checkpoint.py``, with the same on-disk
layout: ``<dir>/step_<N>/`` holds one ``shard_00000.npz`` plus a
``manifest.json`` written LAST — a step directory without a manifest is
incomplete and ignored, so a crash mid-save can never corrupt the latest
restorable step. Arrays are keyed by their "/"-joined path in the nested
tree, and the manifest records a crc32 per array (``array_crc``) so a step
whose payload was damaged after the commit point fails ``verify_step``
and callers walking ``valid_steps`` newest first fall back to an older
step (or a cold start).

``latest_step`` / ``restore`` / ``restore_latest`` bring a training run's
params and optimizer tree back onto the device of the tree given as
``like`` (``launch/train.py``'s restart).

There is no ``jax.tree_util`` here: ``_flatten`` walks nested dicts, lists
and tuples itself and takes torch tensors and numpy arrays as leaves.
numpy has no bfloat16, so half-width float tensors are stored as float32,
as repro stores its ml_dtypes leaves; the caller casts back on restore,
and the crc is over the stored array.
"""
from __future__ import annotations

import json
import shutil
import time
import zlib
from pathlib import Path

import numpy as np
import torch


def array_crc(arr: np.ndarray) -> int:
    """crc32 over an array's bytes + dtype + shape (a reshaped or recast
    payload with identical bytes still fails verification)."""
    arr = np.ascontiguousarray(arr)
    h = zlib.crc32(arr.tobytes())
    h = zlib.crc32(str(arr.dtype).encode(), h)
    return zlib.crc32(repr(arr.shape).encode(), h)


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 / fp16 tensors widen to f32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "", out: dict | None = None) -> dict:
    """{"a/b/0": array} over nested dicts / lists / tuples."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix] = to_numpy(tree)
        return out
    for k, v in items:
        _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    return out


def unflatten(flat: dict) -> dict:
    """"/"-joined keys back into nested dicts (list indices stay string
    keys: the caller knows which of its nodes were sequences)."""
    nested: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr
    return nested


def save(ckpt_dir, step: int, tree, *, host_id: int = 0,
         extra: dict | None = None, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    step_dir = ckpt_dir / f"step_{step:08d}"
    step_dir.mkdir(parents=True, exist_ok=True)
    items = _flatten(tree)
    np.savez(step_dir / f"shard_{host_id:05d}.npz", **items)
    if host_id == 0:
        manifest = {"step": step, "time": time.time(),
                    "n_arrays": len(items), "extra": extra or {},
                    "crc": {k: array_crc(v) for k, v in items.items()}}
        # manifest written last = commit point
        (step_dir / "manifest.json").write_text(json.dumps(manifest))
        _gc(ckpt_dir, keep)
    return step_dir


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(d for d in ckpt_dir.glob("step_*")
                   if (d / "manifest.json").exists())
    for d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(d for d in ckpt_dir.glob("step_*")
                   if (d / "manifest.json").exists())
    return int(steps[-1].name.split("_")[1]) if steps else None


def valid_steps(ckpt_dir) -> list[int]:
    """Steps with a *parseable* manifest, oldest first. A truncated or
    garbled manifest.json (crash or corruption mid-write) disqualifies the
    step — it never reached its commit point."""
    out = []
    for d in sorted(Path(ckpt_dir).glob("step_*")):
        mf = d / "manifest.json"
        if not mf.exists():
            continue
        try:
            json.loads(mf.read_text())
        except (OSError, ValueError):
            continue
        out.append(int(d.name.split("_")[1]))
    return out


def verify_step(ckpt_dir, step: int, *, host_id: int = 0) -> bool:
    """Full payload validation for one step: manifest parses, the shard
    loads, and every manifest-listed array is present with a matching
    crc32. Never raises — any failure is False."""
    step_dir = Path(ckpt_dir) / f"step_{step:08d}"
    try:
        manifest = json.loads((step_dir / "manifest.json").read_text())
        with np.load(step_dir / f"shard_{host_id:05d}.npz") as data:
            crcs = manifest.get("crc")
            keys = crcs if crcs is not None else data.files
            if len(data.files) != int(manifest.get("n_arrays",
                                                   len(data.files))):
                return False
            for key in keys:
                arr = data[key]                 # KeyError/zlib error = bad
                if crcs is not None and array_crc(arr) != int(crcs[key]):
                    return False
    except Exception:
        return False
    return True


def load(ckpt_dir, step: int, *, host_id: int = 0) -> tuple[dict, dict]:
    """(manifest, nested arrays) of one step."""
    step_dir = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    with np.load(step_dir / f"shard_{host_id:05d}.npz") as data:
        flat = {k: data[k] for k in data.files}
    return manifest, unflatten(flat)


def restore(ckpt_dir, step: int, like, *, host_id: int = 0):
    """The tree saved at ``step``, in the structure of ``like`` (nested
    dicts / lists / tuples of tensors): each leaf a tensor of the matching
    ``like`` leaf's dtype on its device (a params and optimizer tree comes
    back where training runs)."""
    step_dir = Path(ckpt_dir) / f"step_{step:08d}"
    with np.load(step_dir / f"shard_{host_id:05d}.npz") as data:
        def build(node, prefix):
            if isinstance(node, dict):
                return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(build(v, f"{prefix}/{i}" if prefix
                                        else str(i))
                                  for i, v in enumerate(node))
            arr = torch.from_numpy(np.array(data[prefix]))
            if isinstance(node, torch.Tensor):
                return arr.to(device=node.device, dtype=node.dtype)
            return arr.numpy()
        return build(like, "")


def restore_latest(ckpt_dir, like, *, host_id: int = 0):
    """(step, tree) of the newest complete step, or (None, None)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, like, host_id=host_id)
