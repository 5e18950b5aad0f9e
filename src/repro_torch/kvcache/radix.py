"""Token-prefix radix tree over allocator pages — cross-request KV sharing.

A copy of ``repro/kvcache/radix.py`` (framework-free), with the module
references pointed at the port. A host-resident node's ``host`` payload
holds torch tensors ``[L, n, page, KVH, D]`` here (pinned CPU memory on a
CUDA engine, ``kvcache/offload.py``); a page-boundary ``split`` narrows
them as views of the same buffer, copying nothing.

Every node covers a run of tokens that is a whole number of pages (its
``pages`` list holds the physical page ids, in order); the root is an empty
sentinel. Requests whose prompts share a token prefix share the *physical*
pages of that prefix (the allocator refcounts owners), so admission borrows
the matched pages and prefill starts at the matched depth — the O(ctx) ->
O(suffix) win of radix prefix caching (SGLang-style), layered on top of the
paper's DPA lazy paging.

Structural sharing is page-granular: nodes split only at page boundaries.
When a request's tokens diverge *inside* a page (or its prompt ends inside
one), the partially-matching page is served **copy-on-write**: the cache
copies that one physical page and the request keeps writing its own tokens
into the copy, reusing the matched head of the page without recomputing it.

Pinning follows the SGLang lock-ref discipline: a running request pins the
whole path of its deepest matched node (ref++ on each ancestor); ``split``
makes the new upper node inherit the lower node's ref so an unpin walk from
any stored node still decrements every ancestor exactly once. Nodes with
ref == 0 are eviction candidates (``repro_torch.kvcache.policy``); a node
whose payload was swapped to the host tier (``repro_torch.kvcache.offload``)
keeps its place in the tree with ``pages=None`` and its data in ``host``.

Host/numpy bookkeeping only — device copies are queued by the cache facade
(``repro_torch.kvcache.cache``) and applied by the engine between steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np


def _match_len(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the common prefix of two int token arrays."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    eq = a[:n] == b[:n]
    return int(np.argmin(eq)) if not eq.all() else n


class RadixNode:
    __slots__ = ("tokens", "pages", "host", "children", "parent", "ref",
                 "tick")

    def __init__(self, tokens: np.ndarray, pages: list[int] | None,
                 parent: "RadixNode | None"):
        self.tokens = np.asarray(tokens, np.int32)
        self.pages = pages                  # device page ids, or None when
        self.host: dict[str, Any] | None = None   # ...payload lives in host
        self.children: dict[int, RadixNode] = {}
        self.parent = parent
        self.ref = 0                        # running requests pinning via path
        self.tick = 0                       # last access (tree clock)

    @property
    def n_pages(self) -> int:
        return len(self.pages) if self.pages is not None else \
            (0 if self.host is None else int(self.host["k"].shape[1]))

    @property
    def on_host(self) -> bool:
        return self.host is not None

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def __repr__(self):  # pragma: no cover - debug aid
        loc = "host" if self.on_host else "dev"
        return (f"RadixNode(tok={len(self.tokens)}, pages={self.n_pages} "
                f"{loc}, ref={self.ref}, kids={len(self.children)})")


@dataclass
class MatchResult:
    """Outcome of a prefix walk: the fully matched node path (root
    excluded, each node a whole-pages unit thanks to boundary splits). The
    caller walks ``path`` itself — materializing host nodes as it goes may
    truncate the usable prefix, so derived values (pages, matched depth)
    belong to the consumer, not here."""
    path: list[RadixNode] = field(default_factory=list)
    # copy-on-write: the next child matches ``cow_tokens`` more tokens inside
    # its first page; the request should copy that page and resume there.
    cow_node: RadixNode | None = None
    cow_tokens: int = 0


class RadixTree:
    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = RadixNode(np.empty(0, np.int32), [], None)
        self.root.ref = 1                   # the root is never evictable
        self._tick = 0

    # ---- pin management ----------------------------------------------
    def touch(self, node: RadixNode) -> None:
        self._tick += 1
        node.tick = self._tick

    def pin(self, node: RadixNode) -> None:
        while node is not None:
            node.ref += 1
            node = node.parent

    def unpin(self, node: RadixNode) -> None:
        while node is not None:
            assert node.ref > 0, "unpin underflow"
            node.ref -= 1
            node = node.parent

    # ---- structural ops ----------------------------------------------
    def split(self, node: RadixNode, n_tokens: int) -> RadixNode:
        """Split ``node`` at a page boundary: the first ``n_tokens`` move to
        a new parent ("upper") inserted between node and its parent; returns
        the upper node. The upper inherits the lower's ref so existing unpin
        walks stay balanced."""
        ps = self.page_size
        assert 0 < n_tokens < len(node.tokens) and n_tokens % ps == 0
        k = n_tokens // ps
        upper = RadixNode(node.tokens[:n_tokens],
                          None if node.on_host else list(node.pages[:k]),
                          node.parent)
        if node.on_host:
            upper.host = {"k": node.host["k"][:, :k],
                          "v": node.host["v"][:, :k]}
            node.host = {"k": node.host["k"][:, k:],
                         "v": node.host["v"][:, k:]}
        else:
            node.pages = list(node.pages[k:])
        upper.ref = node.ref
        upper.tick = node.tick
        upper.children = {int(node.tokens[n_tokens]): node}
        node.parent.children[int(node.tokens[0])] = upper
        node.tokens = node.tokens[n_tokens:]
        node.parent = upper
        return upper

    def remove(self, node: RadixNode) -> None:
        """Unlink an (evicted) leaf from the tree."""
        assert node.is_leaf and node.ref == 0 and node.parent is not None
        del node.parent.children[int(node.tokens[0])]
        node.parent = None

    # ---- walks --------------------------------------------------------
    def match(self, tokens: np.ndarray, *, max_tokens: int | None = None
              ) -> MatchResult:
        """Longest-prefix walk. ``max_tokens`` caps the match (admission caps
        at prompt_len - 1 so at least one token goes through prefill and
        produces first-token logits). Splits nodes at page boundaries when a
        walk ends inside one, so the returned path nodes are fully matched
        units. Touches matched nodes (LRU clock); does NOT pin."""
        tokens = np.asarray(tokens, np.int32)
        budget = len(tokens) if max_tokens is None else min(len(tokens),
                                                            max_tokens)
        res = MatchResult()
        node, pos = self.root, 0
        while pos < budget:
            child = node.children.get(int(tokens[pos]))
            if child is None:
                break
            m = _match_len(child.tokens, tokens[pos:budget])
            full = (m // self.page_size) * self.page_size
            if full == len(child.tokens):           # whole node matched
                self.touch(child)
                res.path.append(child)
                node, pos = child, pos + full
                continue
            if full > 0:                            # ends inside the node:
                upper = self.split(child, full)     # carve the matched pages
                self.touch(upper)
                res.path.append(upper)
                child = upper.children[int(child.tokens[0])]
                pos += full
            rem = m - full
            if rem > 0:                             # mid-page divergence: CoW
                res.cow_node, res.cow_tokens = child, rem
                self.touch(child)
            break
        return res

    def peek(self, tokens: np.ndarray, *, max_tokens: int | None = None
             ) -> tuple[int, int]:
        """(device_pages, host_pages) a match would reuse — admission-policy
        estimate, no splits / touches / side effects."""
        tokens = np.asarray(tokens, np.int32)
        budget = len(tokens) if max_tokens is None else min(len(tokens),
                                                            max_tokens)
        dev = host = 0
        node, pos = self.root, 0
        while pos < budget:
            child = node.children.get(int(tokens[pos]))
            if child is None:
                break
            m = _match_len(child.tokens, tokens[pos:budget])
            # full pages only: a partial (CoW) match still allocates its
            # page fresh, so it must not count as reusable capacity
            full_pages = m // self.page_size
            if child.on_host:
                host += full_pages
            else:
                dev += full_pages
            if m < len(child.tokens):
                break
            node, pos = child, pos + m
        return dev, host

    def insert(self, tokens: np.ndarray, pages: list[int]) -> list[
            tuple[RadixNode, list[int]]]:
        """Record a request's written KV under the tree. Only whole pages are
        inserted (``len(tokens)`` floored to a page multiple). Where the tree
        already covers the tokens, the existing pages win (the request's
        duplicates simply lose an owner when it frees). Returns
        [(node, adopted_pages)] for the newly created nodes — the caller
        (cache facade) increfs those pages to give the tree its ownership."""
        tokens = np.asarray(tokens, np.int32)
        ps = self.page_size
        n_full = (len(tokens) // ps) * ps
        tokens = tokens[:n_full]
        adopted: list[tuple[RadixNode, list[int]]] = []
        node, pos = self.root, 0
        while pos < n_full:
            child = node.children.get(int(tokens[pos]))
            if child is None:
                new = RadixNode(tokens[pos:],
                                list(pages[pos // ps: n_full // ps]), node)
                node.children[int(tokens[pos])] = new
                self.touch(new)
                adopted.append((new, list(new.pages)))
                break
            m = _match_len(child.tokens, tokens[pos:])
            full = (m // ps) * ps
            if full < len(child.tokens):
                if full == 0:
                    break                   # diverges inside the first page
                child = self.split(child, full)
            self.touch(child)
            node, pos = child, pos + full
        return adopted

    # ---- iteration / stats -------------------------------------------
    def nodes(self) -> Iterator[RadixNode]:
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n
            stack.extend(n.children.values())

    def leaves(self) -> Iterator[RadixNode]:
        return (n for n in self.nodes() if n.is_leaf)

    def device_pages(self) -> int:
        return sum(n.n_pages for n in self.nodes() if not n.on_host)

    def host_pages(self) -> int:
        return sum(n.n_pages for n in self.nodes() if n.on_host)

    def total_tokens(self) -> int:
        return sum(len(n.tokens) for n in self.nodes())
