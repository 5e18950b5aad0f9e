"""Host-memory KV tier: async page swaps between the device pool and DRAM.

Port of ``repro/kvcache/offload.py``. The device page pool caps the
admissible batch long before host DRAM does; this tier holds evicted
radix-node payloads in host memory, keyed by the tree node, and overlaps
the transfers with the decode loop in DCS ping-pong style.

On a card (``HostCopier``, chosen by the tensors' device, as the kernel
wrappers choose):

* **swap-out** gathers the node's pages into a fresh device tensor on the
  compute stream (``HostCopier.pages_to_host``) and releases the device
  pages at once. The gather is a functional snapshot: the freed pages may
  be rewritten by the very next prefill, and stream order makes the
  gather read them first. A dedicated copy stream then waits on an event
  recorded after the gather and copies the snapshot into PINNED host
  memory (``non_blocking``); the device snapshot is kept alive until the
  copy is drained, so the caching allocator cannot hand its memory to
  another tensor while the copy reads it. The gather is page-major, so a
  host payload's pages stay contiguous blocks under radix splits.
* **drain** is the other half of the ping-pong: at the next tick's
  overlap window it waits on the copies' events (a host wait on the copy
  stream, never ``torch.cuda.synchronize()``; not a decode sync) and drops
  the device snapshots.
* **swap-in** and host copy-on-write writes (``DeviceOpQueue.apply``) copy
  the pinned payload host-to-device on the compute stream, after a
  ``wait_stream`` on the copy stream (a payload's own swap-out copy may
  still be in flight), and ``index_copy_`` it into the pool before the
  tick's prefill. Each host buffer is held until an event recorded after
  its copy has passed.

Pinned buffers come from PyTorch's caching host allocator, which keeps
freed pinned blocks for reuse by size, so a steady state allocates no new
page-locked memory. A failed allocation, copy or event raises; nothing
falls back to recompute or to pageable memory.

On a CPU engine the payload is the gather's result itself and there is no
side stream.

``repro`` pads every transfer to a power of two so its jit cache stays
O(log pool); eager PyTorch has no such cache, so the port transfers exactly
the pages asked for. Radix splits (``radix.py::split``) narrow a host
payload as views of the same pinned buffer: nothing is copied.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.core.paged_kv import _page_index, copy_page, scatter_pages
from repro_torch.models.model import tree_map as _tree_map


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _h2d(t: torch.Tensor, device) -> torch.Tensor:
    if t.is_contiguous():
        return t.to(device, non_blocking=True)
    if t.dim() > 1 and t.transpose(0, 1).is_contiguous():
        return t.transpose(0, 1).to(device, non_blocking=True).transpose(0, 1)
    raise ValueError(f"host payload of shape {tuple(t.shape)} and strides "
                     f"{t.stride()} is not one contiguous block")


@dataclass
class CopyStats:
    """Bytes moved each way and their device time (CUDA events around the
    copies; settled at ``drain``), and the host time spent allocating
    pinned buffers (a size the caching host allocator has not seen yet is
    a fresh page-locked allocation). CPU copies are not timed."""
    d2h_bytes: int = 0
    h2d_bytes: int = 0
    d2h_ms: float = 0.0
    h2d_ms: float = 0.0
    pin_alloc_ms: float = 0.0

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


class HostCopier:
    """Device <-> host copies of page payloads and recurrent rows, by tensor
    device: CUDA tensors go to pinned memory on one copy stream (created at
    first use), CPU tensors are the host copy already."""

    def __init__(self):
        self._stream: torch.cuda.Stream | None = None
        # (done event, start event, device tensors, bytes) until drained
        self._out: list = []
        # (done event, start event, host tensors, bytes) until passed
        self._in: list = []
        self.stats = CopyStats()

    def _copy_stream(self, device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def to_host(self, tree):
        """Start copying a tree of FRESH device tensors (nothing else writes
        them) to pinned host memory; returns the host tree. Its values are
        valid once ``drain`` has run, and ``to_device`` orders itself after
        the copy on its own."""
        leaves = list(_leaves(tree))
        if not leaves or not leaves[0].is_cuda:
            return tree
        device = leaves[0].device
        t0 = time.perf_counter()
        host = _tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               pin_memory=True), tree)
        self.stats.pin_alloc_ms += 1e3 * (time.perf_counter() - t0)
        compute = torch.cuda.current_stream(device)
        side = self._copy_stream(device)
        ready = torch.cuda.Event()
        ready.record(compute)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            start.record(side)
            for h, t in zip(_leaves(host), leaves):
                h.copy_(t, non_blocking=True)
            done.record(side)
        self._out.append((done, start, tree,
                          sum(t.nbytes for t in leaves)))
        return host

    def pages_to_host(self, pool: dict, page_ids) -> dict:
        """Swap-out / snapshot of whole pages: gather them from the pool
        into fresh device tensors PAGE-MAJOR (``[n, L, page, KVH, D]``, one
        contiguous run per page) and start their copy to the host. Returns
        ``{"k", "v"}`` as ``[L, n, page, KVH, D]`` views of the host
        buffers (``repro``'s layout), so that narrowing pages (``[:, a:b]``,
        a radix split) is still one contiguous block of host memory."""
        ix = _page_index(page_ids, pool["k"])
        dev = {name: pool[name].transpose(0, 1).index_select(0, ix)
               for name in ("k", "v")}
        host = self.to_host(dev)
        return {name: t.transpose(0, 1) for name, t in host.items()}

    def to_device(self, tree, device):
        """Copy a host tree to ``device`` on the current (compute) stream;
        returns the device tree. A pinned source may still be filling from
        a swap-out: the compute stream first waits on the copy stream.
        Every leaf must be one contiguous block of host memory (itself, or
        its first two axes swapped: the pages of ``pages_to_host``); any
        other layout would be staged by a host read that the copy stream's
        order does not cover, so it raises."""
        device = torch.device(device)
        if device.type != "cuda":
            return _tree_map(lambda t: t.to(device), tree)
        compute = torch.cuda.current_stream(device)
        if self._stream is not None:
            compute.wait_stream(self._stream)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        start.record(compute)
        out = _tree_map(lambda t: _h2d(t, device), tree)
        done.record(compute)
        self._in.append((done, start, tree,
                         sum(t.nbytes for t in _leaves(tree))))
        self._settle_in(wait=False)
        return out

    def _settle_in(self, wait: bool) -> None:
        """Release host buffers whose host-to-device copy has passed."""
        keep = []
        for done, start, tree, nbytes in self._in:
            if wait:
                done.synchronize()
            elif not done.query():
                keep.append((done, start, tree, nbytes))
                continue
            self.stats.h2d_bytes += nbytes
            self.stats.h2d_ms += start.elapsed_time(done)
        self._in = keep

    def drain(self) -> None:
        """Wait for every started device-to-host copy and drop the device
        snapshots it read; settle the host-to-device copies that have
        passed."""
        for done, start, _tree, nbytes in self._out:
            done.synchronize()
            self.stats.d2h_bytes += nbytes
            self.stats.d2h_ms += start.elapsed_time(done)
        self._out.clear()
        self._settle_in(wait=False)

    def settle(self) -> None:
        """``drain`` and wait for the host-to-device copies too (end of a
        run: every buffer released, every copy timed)."""
        self.drain()
        self._settle_in(wait=True)


@dataclass
class TierStats:
    swapped_out_pages: int = 0
    swapped_in_pages: int = 0
    dropped_pages: int = 0          # evicted without a host copy
    peak_host_pages: int = 0
    swap_retries: int = 0           # failed swap-ins absorbed by the
                                    # retry/backoff budget (not the ladder)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


class HostTier:
    """Bounded host-DRAM store for offloaded radix-node payloads."""

    def __init__(self, capacity_pages: int, copier: HostCopier | None = None):
        self.capacity = capacity_pages
        self.used = 0
        self.stats = TierStats()
        self.copier = copier if copier is not None else HostCopier()

    def has_space(self, n_pages: int) -> bool:
        return self.used + n_pages <= self.capacity

    # ------------------------------------------------------------------
    def swap_out(self, node, pool: dict) -> None:
        """Gather ``node``'s device pages and start their copy to the host;
        the node's payload is the (pinned) host copy. The caller releases
        the device pages right after — see the module docstring for why
        that is safe."""
        ids = node.pages
        node.host = self.copier.pages_to_host(pool, ids)
        node.pages = None
        self.used += len(ids)
        self.stats.swapped_out_pages += len(ids)
        self.stats.peak_host_pages = max(self.stats.peak_host_pages,
                                         self.used)

    def drain(self) -> None:
        """Collect last tick's swap-outs (ping-pong: issued last tick,
        waited for this tick)."""
        self.copier.drain()

    def take(self, node) -> dict:
        """Claim a node's host payload for swap-in (device side re-owns it)."""
        data = node.host
        n = int(data["k"].shape[1])
        self.used -= n
        self.stats.swapped_in_pages += n
        node.host = None
        return data

    def discard(self, node) -> None:
        """Drop a host-resident node's payload (tier eviction)."""
        n = node.n_pages
        self.used -= n
        self.stats.dropped_pages += n
        node.host = None


class DeviceOpQueue:
    """Pending device-side page ops (CoW copies, swap-in scatters, host CoW
    writes) queued by host bookkeeping and applied to the pool, in place,
    in one place before the tick's prefill — the cache's half of the
    ping-pong."""

    def __init__(self, copier: HostCopier | None = None):
        self.copier = copier if copier is not None else HostCopier()
        self._scatters: list[tuple[list[int], object, object]] = []
        self._copies: list[tuple[object, int, int]] = []   # (tag, src, dst)
        self._host_writes: list[tuple[object, int, dict]] = []

    @property
    def empty(self) -> bool:
        return not (self._scatters or self._copies or self._host_writes)

    def queue_scatter(self, page_ids: list[int], k, v) -> None:
        self._scatters.append((list(page_ids), k, v))

    def queue_copy(self, tag, src_page: int, dst_page: int) -> None:
        self._copies.append((tag, src_page, dst_page))

    def queue_host_write(self, tag, dst_page: int, data: dict) -> None:
        """Write one host-resident page into ``dst_page`` (host-side CoW)."""
        self._host_writes.append((tag, dst_page, data))

    def cancel(self, tag) -> None:
        """Drop queued request-tagged ops (the request was preempted before
        they applied; its target pages are being released)."""
        self._copies = [c for c in self._copies if c[0] != tag]
        self._host_writes = [w for w in self._host_writes if w[0] != tag]

    def inflight_pages(self) -> set[int]:
        """Pages with a queued write — protected from eviction until applied."""
        out: set[int] = set()
        for ids, _, _ in self._scatters:
            out.update(ids)
        for _, src, dst in self._copies:
            out.update((src, dst))
        for _, dst, _ in self._host_writes:
            out.add(dst)
        return out

    def apply(self, pool: dict) -> dict:
        """Apply every queued op to the pool IN PLACE and return the same
        dict. Order: scatters (swap-ins) first, then host writes, then
        copies — a CoW source may itself be a page that just swapped in."""
        pk, pv = pool["k"], pool["v"]
        for ids, k, v in self._scatters:
            d = self.copier.to_device({"k": k, "v": v}, pk.device)
            scatter_pages(pk, pv, ids, d["k"], d["v"])
        for _, dst, data in self._host_writes:
            d = self.copier.to_device({"k": data["k"], "v": data["v"]},
                                      pk.device)
            scatter_pages(pk, pv, [dst], d["k"], d["v"])
        for _, src, dst in self._copies:
            copy_page(pk, pv, src, dst)
        self._scatters.clear()
        self._copies.clear()
        self._host_writes.clear()
        return pool
