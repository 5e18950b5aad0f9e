"""Crash-safe cross-engine KV handoff: the wire format.

The port's copy of ``repro/kvcache/handoff.py``, byte for byte the same
format, so a blob either package encodes decodes in the other.

Disaggregated serving (``serving/cluster.py``) moves a finished-prefill
request from a prefill-role engine to a decode-role engine: its KV pages
(gathered by the engine's snapshot path), its recurrent carry rows, and
the scalar admission frame. The transfer crosses an unreliable boundary
(it can be torn mid-stream or corrupted in flight), so the payload travels
as one self-validating byte blob, after ``runtime/checkpoint.py``'s
manifest-gated layout:

    magic "KVH1" | u64 manifest length | manifest json | npz payload

The manifest is the commit gate: it records the payload's byte length, a
crc32 over the payload bytes, and a per-array crc32
(``checkpoint.array_crc``) for every flattened array. ``decode`` checks
ALL of them before returning anything, so

* a **torn** transfer (truncation anywhere) fails the magic, length or
  manifest-parse check;
* a **corrupt** transfer (any flipped byte) fails the payload or per-array
  crc, or the manifest parse if the flip landed there;

and either way raises ``HandoffError`` with nothing applied. The router
keeps the pristine in-memory ``Handoff`` and re-encodes on retry: a
handoff is re-driven, never half-applied.

Arrays travel as numpy: torch leaves go through ``checkpoint.to_numpy``,
so bf16 / fp16 pools cross the wire as f32 (as the port's snapshots store
them) and the adopting engine casts back to its pool's dtype.

``tear`` / ``flip`` are the deterministic damage models the fault injector
drives (the ``handoff_torn`` / ``handoff_corrupt`` kinds of
``runtime/faults.py``), so tests and the chaos soak share one definition
of "torn" and "corrupt".
"""
from __future__ import annotations

import io
import json
import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.runtime.checkpoint import array_crc, to_numpy

HANDOFF_VERSION = 1
_MAGIC = b"KVH1"
_HDR = len(_MAGIC) + 8


class HandoffError(RuntimeError):
    """A handoff blob failed validation (torn or corrupt): nothing from it
    may be applied; the router must retry or re-drive."""


@dataclass
class Handoff:
    """One request's transferable state: the scalar admission frame
    (``entry``, from the engine's snapshot path) plus the flattened arrays:
    ``prompt``, ``out``, optionally ``kv_k`` / ``kv_v`` and ``rows/<path>``
    recurrent-carry leaves."""
    req_id: int
    entry: dict
    arrays: dict[str, np.ndarray]

    @property
    def kv_pages(self) -> int:
        k = self.arrays.get("kv_k")
        return 0 if k is None else int(k.shape[1])


def pack(req_id: int, entry: dict, arrays: dict) -> Handoff:
    """Build a Handoff from an engine ``extract_request`` result. Nested
    values (the recurrent carry) are flattened to "/"-joined keys, the
    checkpoint module's path convention; sequence items get their index as
    the key, which ``DecodeEngine._rows_from_nested`` inverts."""
    flat: dict[str, np.ndarray] = {}

    def walk(prefix, val):
        if isinstance(val, dict):
            for k, v in val.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(val, (tuple, list)):
            for i, v in enumerate(val):
                walk(f"{prefix}/{i}" if prefix else str(i), v)
        else:
            flat[prefix] = to_numpy(val)

    for name, val in arrays.items():
        walk(name, val)
    return Handoff(int(req_id), dict(entry), flat)


def nested_arrays(h: Handoff) -> dict:
    """Re-nest the "/"-joined array keys into dicts (the inverse of
    ``pack``'s flattening): what the adopting engine consumes."""
    out: dict = {}
    for key, arr in h.arrays.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr
    return out


def encode(h: Handoff) -> bytes:
    """Serialize to the self-validating wire blob (see the module
    docstring)."""
    buf = io.BytesIO()
    np.savez(buf, **h.arrays)
    payload = buf.getvalue()
    manifest = {
        "version": HANDOFF_VERSION,
        "req_id": h.req_id,
        "entry": h.entry,
        "payload_len": len(payload),
        "payload_crc": zlib.crc32(payload),
        "crc": {k: array_crc(v) for k, v in h.arrays.items()},
    }
    mjson = json.dumps(manifest).encode()
    return _MAGIC + len(mjson).to_bytes(8, "little") + mjson + payload


def decode(blob: bytes) -> Handoff:
    """Validate and deserialize a wire blob. Raises ``HandoffError`` on ANY
    defect (truncation, flipped bytes, a version or length mismatch) before
    constructing the result, so a bad transfer yields nothing."""
    if len(blob) < _HDR or blob[:len(_MAGIC)] != _MAGIC:
        raise HandoffError("torn or foreign handoff header")
    mlen = int.from_bytes(blob[len(_MAGIC):_HDR], "little")
    if len(blob) < _HDR + mlen:
        raise HandoffError("torn handoff: manifest truncated")
    try:
        manifest = json.loads(blob[_HDR:_HDR + mlen])
    except ValueError as e:
        raise HandoffError(f"corrupt handoff manifest: {e}") from e
    if not isinstance(manifest, dict) \
            or manifest.get("version") != HANDOFF_VERSION:
        raise HandoffError("handoff version != "
                           f"{HANDOFF_VERSION} or manifest not an object")
    payload = blob[_HDR + mlen:]
    try:
        # a flipped byte INSIDE the manifest can still parse as JSON with a
        # mangled key or value: a missing or mistyped field is the same
        # defect as a failed checksum
        p_len = int(manifest["payload_len"])
        p_crc = int(manifest["payload_crc"])
        crcs = {k: int(v) for k, v in manifest["crc"].items()}
        req_id = int(manifest["req_id"])
        entry = dict(manifest["entry"])
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise HandoffError(f"corrupt handoff manifest: {e!r}") from e
    if len(payload) != p_len:
        raise HandoffError(f"torn handoff payload: {len(payload)} != "
                           f"{p_len} bytes")
    if zlib.crc32(payload) != p_crc:
        raise HandoffError("corrupt handoff payload (crc mismatch)")
    try:
        with np.load(io.BytesIO(payload)) as data:
            arrays = {k: data[k] for k in data.files}
    except Exception as e:      # any npz parse failure is a damaged blob
        raise HandoffError(f"corrupt handoff payload: {e}") from e
    if set(arrays) != set(crcs):
        raise HandoffError("handoff array set != manifest")
    for key, arr in arrays.items():
        if array_crc(arr) != crcs[key]:
            raise HandoffError(f"corrupt handoff array {key!r}")
    return Handoff(req_id, entry, arrays)


def tear(blob: bytes, salt: int) -> bytes:
    """Deterministic truncation damage: cut the blob at a salt-derived
    point (always strictly shorter, never empty)."""
    cut = 1 + (salt * 0x9E3779B9 + 7) % max(1, len(blob) - 1)
    return blob[:cut]


def flip(blob: bytes, salt: int) -> bytes:
    """Deterministic single-byte corruption at a salt-derived offset,
    biased into the payload region when one exists (header damage is
    caught trivially, payload damage needs the crcs)."""
    lo = min(_HDR, len(blob) - 1)
    pos = lo + (salt * 0x9E3779B9 + 13) % max(1, len(blob) - lo)
    out = bytearray(blob)
    out[pos] ^= 0x40
    return bytes(out)
