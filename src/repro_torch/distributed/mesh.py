"""Meshes of shards, the collectives a shard body calls, and ``shard_map``.

The port's counterpart of ``repro/core/jax_compat.make_mesh``,
``repro/launch/mesh.py`` and the ``jax.lax`` collectives of repro's
``shard_map`` bodies. A body is written once, SPMD-style: it runs once per
shard, asks ``axis_index(ax)`` where it sits and calls ``psum`` /
``pmax`` / ``pmean`` / ``all_gather`` / ``psum_scatter`` / ``all_to_all``
/ ``ppermute`` by axis name (one name or a tuple), and it runs unchanged
under either backend. ``all_gather`` and ``all_to_all`` are
differentiable: a shard's backward (``torch.autograd.grad`` in its body)
runs their transposes, ``psum_scatter`` and ``all_to_all``, as
collectives of its own. They need the backward on the shard's thread:
the caller sets ``torch.autograd.set_multithreading_enabled(False)``
(a CUDA backward otherwise runs on autograd's device thread, which runs
as no shard).

* ``LocalMesh`` — every shard in this process, on one device, one thread
  a shard, one of them running at a time (a baton passed round robin). A collective's members (the shards that share every coordinate
  but the named axes) deposit their tensors; once all have, each combines
  the group's tensors itself, on their device. This is how the sharded
  paths run on one card (and the CPU tests): 8 shards in one process, as
  repro's tests force 8 host devices.
* ``ProcessMesh`` — one shard per process over ``torch.distributed``
  (``gloo`` on the CPU, and for ranks that share one card: a CUDA
  tensor's collectives staged through host memory), with one process
  group per axis tuple, made when the mesh is. NCCL across cards is the
  design target; it is unverified (the card's machine has one GPU).
* ``ShapeMesh`` — one shard's body on tensors without storage, each
  collective counting the bytes it would move: the dry-run's backend
  (``launch/dryrun.py``).

Both backends reduce a group in the group's own order: all-gather, then a
sum or max over the members stacked in row-major shard order. Every member
of a group so holds the same bits, and the two backends agree bit for bit.
(An all-reduce would move less data; its order would be the library's.)

``shard_map(body, mesh, in_specs, out_specs)`` runs ``body`` once per
shard. A spec is ``None`` (replicated; also for a non-tensor argument), a
dict of specs for a dict argument, a list or tuple of specs for a list or
tuple argument, or ``P(...)`` — JAX's ``PartitionSpec`` as a tuple, one
entry per leading dim: ``None``, an axis name or a tuple of names (the dim
cut into contiguous blocks, row-major over the names), or ``Paged(axes)``
for a paged pool's page dim with its trash page last (``core/itpp.py``
states that layout). One ``P`` also stands for every leaf of a subtree.
``Stages(axis, specs)`` cuts a per-layer list into pipeline stages over
``axis``, each element under its own spec (the list form of repro's
``P("pod")`` on a stacked ``[L, ...]`` dim): a rank's block is its
stage's run of the list.

An argument or output is either global or RESIDENT (``Resident(spec)``):

* global — ``shard_map`` hands each shard its block of the global tensor
  and assembles the global output from the shards' blocks;
* resident — the rank's own block under ``spec``, which it holds across
  steps as ``repro``'s shardings hold a step's state: on a
  ``ProcessMesh`` (and a ``ShapeMesh``) an input is not cut and an output
  is not gathered; a ``Paged`` pool's block is the rank's own pages plus
  its own trash page (``pool_layout = "local"``), written in place by the
  step. On a ``LocalMesh`` a resident tensor IS the global one (the
  shards' blocks are views of it, a ``Paged`` dim the whole pool,
  ``pool_layout = "global"``), so there the two forms are the same.

Global tensors are cut and gathered only at the edges: ``shard(tree,
specs, mesh)`` gives a rank its resident part, ``gather(tree, specs,
mesh)`` the global tree back (both the identity on a ``LocalMesh``;
``distributed/sharding.Plan.shard`` / ``gather`` take the plan's mesh).
On a ``ProcessMesh`` a global output is all-gathered over its cut axes so
every rank returns it; a ``ShapeMesh`` returns the shard's own outputs
(the dry-run counts the step, not its edges).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import math
import threading
from dataclasses import dataclass

import torch

class P(tuple):
    """A partition spec: one entry per leading dim (``None``, an axis name,
    a tuple of names or ``Paged``). A tuple, so it compares equal to the
    plain tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclass(frozen=True)
class Paged:
    """A paged pool's page dim, cut over ``axes``, trash page last."""
    axes: tuple[str, ...]


@dataclass(frozen=True)
class Resident:
    """A ``shard_map`` spec (tree) whose argument or output is already the
    rank's own block under ``spec``: not cut on the way in, not gathered
    on the way out (the global tensor itself on a ``LocalMesh``)."""
    spec: object


@dataclass(frozen=True)
class Stages:
    """A per-layer list cut into pipeline stages over ``axis``: of L
    elements, element ``i`` lives on index ``i // (L / n)`` of the axis's
    n shards, under its own spec tree ``specs[i]``. A rank's block is its
    stage's L / n elements, each its block under its spec."""
    axis: str
    specs: tuple

    def run(self, mesh: "Mesh", rank: int, n_elems: int) -> slice:
        """The elements of a global list of ``n_elems`` that ``rank``'s
        stage holds."""
        n, L = mesh.axis_size(self.axis), len(self.specs)
        if n_elems != L or L % n:
            raise ValueError(f"a list of {n_elems} under {L} stage specs "
                             f"does not cut into {n} stages over "
                             f"{self.axis!r}")
        i = mesh.index(rank, self.axis)
        return slice(i * (L // n), (i + 1) * (L // n))


def _subspecs(spec, a) -> bool:
    """``spec`` a list or tuple of specs, one per element of the list or
    tuple ``a`` (a ``P``, or a plain tuple for a tensor, is one spec)."""
    return (isinstance(spec, (list, tuple)) and not isinstance(spec, P)
            and isinstance(a, (list, tuple)))


def _names(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """Named axes and their sizes; shards are numbered row-major over the
    axes. Plans read it as they read a jax ``Mesh`` (``shape``,
    ``axis_names``); the backends below also run bodies on it."""
    pool_layout = "local"

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not name "
                             f"{axis_names}")
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in shape)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axis_size(self, axis) -> int:
        s = self.shape
        return math.prod(s[a] for a in _names(axis))

    def coords(self, rank: int) -> dict[str, int]:
        out = {}
        for ax, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            out[ax] = rank % n
            rank //= n
        return {ax: out[ax] for ax in self.axis_names}

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for ax, n in zip(self.axis_names, self.sizes):
            r = r * n + coords[ax]
        return r

    def index(self, rank: int, axis) -> int:
        """``rank``'s linear index over ``axis`` (row-major over a tuple):
        ``jax.lax.axis_index``."""
        c, s, i = self.coords(rank), self.shape, 0
        for a in _names(axis):
            i = i * s[a] + c[a]
        return i

    def with_index(self, rank: int, axis, i: int) -> int:
        """The rank that shares ``rank``'s other coordinates and sits at
        linear index ``i`` over ``axis``."""
        c, s = self.coords(rank), self.shape
        for a in reversed(_names(axis)):
            c[a] = i % s[a]
            i //= s[a]
        return self.rank_of(c)

    def group(self, rank: int, axis) -> list[int]:
        """The members of ``rank``'s group over ``axis``, in index order."""
        return [self.with_index(rank, axis, i)
                for i in range(self.axis_size(axis))]

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


def abstract_mesh(shape, axis_names) -> Mesh:
    """A mesh to plan on, with no backend (repro's ``abstract_mesh``)."""
    return Mesh(shape, axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production layout of repro's ``launch/mesh.py``: (16, 16) over
    (data, model), or (2, 16, 16) with a pod axis. Abstract: it plans
    cells and checks their specs (one card holds no 256 shards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> "LocalMesh":
    """A small single-process mesh (tests, the card's sharded phase)."""
    return LocalMesh(shape, axes)


# ---------------------------------------------------------------------------
# the shard a body runs as, and the collectives
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Shard:
    mesh: Mesh
    rank: int


_tls = threading.local()
_process_shard: Shard | None = None


def current() -> Shard:
    """The shard the calling body runs as."""
    s = getattr(_tls, "shard", None) or _process_shard
    if s is None:
        raise RuntimeError("a collective was called outside a shard body "
                           "(run it through shard_map or a mesh's run)")
    return s


def axis_index(axis) -> int:
    s = current()
    return s.mesh.index(s.rank, axis)


def axis_size(axis) -> int:
    return current().mesh.axis_size(axis)


def _gather(x, axis) -> list[torch.Tensor]:
    s = current()
    if s.mesh.axis_size(axis) == 1:
        return [x]
    return s.mesh._gather(s.rank, _names(axis), x)


def _counted(kind: str):
    """A collective of ``kind``: on a ``ShapeMesh`` its bytes are counted
    (hlo_analysis's rule) and the ops that emulate it are not."""
    def wrap(fn):
        @functools.wraps(fn)
        def f(x, axis, *args, **kw):
            mesh = current().mesh
            if not isinstance(mesh, ShapeMesh):
                return fn(x, axis, *args, **kw)
            outer = mesh.coll_depth == 0
            mesh.coll_depth += 1
            try:
                with mesh.quiet():
                    out = fn(x, axis, *args, **kw)
            finally:
                mesh.coll_depth -= 1
            if outer:
                mesh.count(kind, x, out, axis)
            return out
        return f
    return wrap


@_counted("all-gather")
def _all_gather(x, axis, dim: int, tiled: bool):
    vals = _gather(x, axis)
    return torch.cat(vals, dim) if tiled else torch.stack(vals, dim)


@_counted("reduce-scatter")
def psum_scatter(x, axis, *, dim: int = 0, tiled: bool = False):
    """``lax.psum_scatter``: member ``i`` gets the group's sum of block
    ``i`` of ``x`` along ``dim`` (with ``tiled``; else of ``x``'s index
    ``i`` there), summed in the group's order: all_gather's transpose."""
    n = axis_size(axis)
    blocks = x.chunk(n, dim) if tiled else x.unbind(dim)
    return all_to_all(torch.stack(blocks), axis).sum(0)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, tiled):
        ctx.args = (axis, dim, tiled)
        return _all_gather(x, axis, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        axis, dim, tiled = ctx.args
        return psum_scatter(g, axis, dim=dim, tiled=tiled), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis), None


def _tracked(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_gather(x, axis, *, dim: int = 0, tiled: bool = False):
    """The group's ``x`` in index order, stacked on a new ``dim`` or, with
    ``tiled``, concatenated along ``dim``. Differentiable: the gradient
    goes back by ``psum_scatter`` in the shard's own backward."""
    if _tracked(x):
        return _AllGather.apply(x, axis, dim, tiled)
    return _all_gather(x, axis, dim, tiled)


@_counted("all-reduce")
def psum(x, axis):
    x = torch.as_tensor(x)
    return torch.stack(_gather(x, axis)).sum(0)


@_counted("all-reduce")
def pmax(x, axis):
    x = torch.as_tensor(x)
    return torch.stack(_gather(x, axis)).amax(0)


def pmean(x, axis):
    return psum(x, axis) / axis_size(axis)


def all_to_all(x, axis):
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)``: x ``[n, ...]`` (n the
    group's size); block ``j`` goes to member ``j`` and the result's block
    ``i`` is what member ``i`` sent here. Differentiable (its own
    transpose)."""
    if _tracked(x):
        return _AllToAll.apply(x, axis)
    return _all_to_all(x, axis)


@_counted("all-to-all")
def _all_to_all(x, axis):
    s = current()
    n = s.mesh.axis_size(axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} ({n} shards) needs a "
                         f"leading dim of {n}, got {tuple(x.shape)}")
    if n == 1:
        return x
    return s.mesh._all_to_all(s.rank, _names(axis), x)


@_counted("collective-permute")
def ppermute(x, axis, perm):
    """``lax.ppermute``: ``perm`` lists ``(source, destination)`` indices
    over ``axis``; a shard no pair sends to gets zeros."""
    vals = _gather(x, axis)
    me = axis_index(axis)
    src = [a for a, b in perm if b == me]
    return vals[src[0]].clone() if src else torch.zeros_like(x)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class _Aborted(Exception):
    """Raised in a shard whose run was aborted by another shard's error."""


class _Run:
    """One ``LocalMesh.run``: the shards' progress, the collective groups
    and the results."""

    def __init__(self, n: int, fn, grad: bool, infer: bool, stream):
        self.n, self.fn = n, fn
        self.grad, self.infer, self.stream = grad, infer, stream
        self.done = [False] * n
        self.results: list = [None] * n
        self.errors: list = [None] * n
        self.abort = False
        self.idle = 0                   # baton passes since any progress
        self.groups: dict[tuple[int, ...], _Group] = {}
        self.finished = threading.Event()

    def group(self, members) -> "_Group":
        key = tuple(sorted(members))
        g = self.groups.get(key)
        if g is None:
            g = self.groups[key] = _Group(key)
        return g


class _Group:
    """A collective group of a ``LocalMesh`` run: two slot rows used in
    turn (a member refills a row only after every member deposited the
    next call, that is, read this one) and each member's call count."""

    def __init__(self, members: tuple[int, ...]):
        self.members = members
        self.slots: list = [[None] * len(members), [None] * len(members)]
        self.seq = [0] * len(members)


class LocalMesh(Mesh):
    """Every shard in this process, passing one baton: exactly one shard
    runs at a time, until a collective finds its group incomplete; then it
    hands the baton to the next live shard (round robin). Shard 0 runs on
    the caller's thread, the others on threads the mesh keeps, each
    waiting on its own semaphore, so no two shards contend for the
    interpreter (every torch op gives it up and takes it back; with the
    shards side by side each op became a thread switch). Tensors stay on
    their device (a shard's slices are views of the caller's tensors), and
    the shards' launches reach the device in a fixed order."""
    pool_layout = "global"

    def __init__(self, shape, axis_names):
        super().__init__(shape, axis_names)
        self._turn = [threading.Semaphore(0) for _ in range(self.size)]
        self._threads: list[threading.Thread] = []
        self._run: _Run | None = None

    # ---- the baton ----
    def _pass(self, st: _Run, rank: int) -> bool:
        """Hand the baton to the next live shard after ``rank``; False when
        no other shard is live. One baton is ever in flight, an aborted
        run's too: each shard it reaches unwinds and hands it on."""
        live = [r for r in range(self.size) if not st.done[r] and r != rank]
        if not live:
            return False
        self._turn[min(live, key=lambda r: (r - rank) % self.size)].release()
        return True

    def _wait_turn(self, st: _Run, rank: int) -> None:
        self._turn[rank].acquire()
        if st.abort:
            raise _Aborted()

    def _exchange(self, rank, members, x):
        st = self._run
        g = st.group(members)
        me = g.members.index(rank)
        k = g.seq[me]
        row = g.slots[k & 1]
        row[me] = x
        g.seq[me] = k + 1
        while min(g.seq) <= k:          # wait for the group's call k
            st.idle += 1
            if st.idle > 2 * st.n or not self._pass(st, rank):
                raise RuntimeError(
                    f"LocalMesh {self.shape}: shard {rank} waits on a "
                    f"collective over ranks {g.members} that the other "
                    "shards never call")
            self._wait_turn(st, rank)
        st.idle = 0
        return [row[g.members.index(r)] for r in members]

    def _gather(self, rank, axes, x):
        return self._exchange(rank, self.group(rank, axes), x)

    def _all_to_all(self, rank, axes, x):
        vals = self._exchange(rank, self.group(rank, axes), x)
        me = self.index(rank, axes)
        return torch.stack([v[me] for v in vals])

    # ---- running a body ----
    def _shard(self, st: _Run, rank: int, worker: bool) -> None:
        """Shard ``rank`` of the run from its first turn to its end."""
        _tls.shard = Shard(self, rank)
        try:
            if worker:
                with torch.inference_mode(st.infer), \
                        torch.set_grad_enabled(st.grad), \
                        (torch.cuda.stream(st.stream)
                         if st.stream is not None
                         else contextlib.nullcontext()):
                    st.results[rank] = st.fn(rank)
            else:
                st.results[rank] = st.fn(rank)
        except BaseException as e:      # noqa: BLE001 (re-raised by run)
            st.errors[rank] = e
            st.abort = True
        finally:
            _tls.shard = None
            st.done[rank] = True
            st.idle = 0
            if not self._pass(st, rank) and all(st.done):
                st.finished.set()

    def _worker(self, rank: int) -> None:
        while True:
            self._turn[rank].acquire()
            st = self._run
            if st.abort:
                st.done[rank] = True
                if not self._pass(st, rank) and all(st.done):
                    st.finished.set()
            else:
                self._shard(st, rank, worker=True)
            # drop the run (its body holds the caller's tensors) while idle
            del st

    def run(self, fn) -> list:
        """``fn(rank)`` on every shard; returns the results in rank order.
        The caller's grad / inference mode and CUDA stream carry into the
        worker threads. A shard that raises aborts the others, and its
        error is re-raised here."""
        if getattr(_tls, "shard", None) is not None:
            raise RuntimeError("LocalMesh.run inside a shard body")
        if not self._threads:
            self._threads = [threading.Thread(target=self._worker, args=(r,),
                                              name=f"shard-{r}", daemon=True)
                             for r in range(1, self.size)]
            for th in self._threads:
                th.start()
        stream = (torch.cuda.current_stream()
                  if torch.cuda.is_available() and torch.cuda.is_initialized()
                  else None)
        st = self._run = _Run(self.size, fn, torch.is_grad_enabled(),
                              torch.is_inference_mode_enabled(), stream)
        self._shard(st, 0, worker=False)
        st.finished.wait()
        self._run = None
        st.fn = st.groups = None
        errs = [e for e in st.errors if e is not None]
        if errs:
            raise next((e for e in errs if not isinstance(e, _Aborted)),
                       errs[0])
        return st.results


class ProcessMesh(Mesh):
    """One shard per process over an initialised ``torch.distributed`` world
    of ``prod(shape)`` ranks (the caller gives ``init_process_group`` its
    address, world size and rank). Every rank builds the mesh, which makes
    one process group per axis tuple and group, in the same order on every
    rank, and this process's rank becomes the shard collectives run as.

    Over ``gloo`` (the CPU tests, and ranks that share one card, which
    NCCL refuses) a collective's CUDA tensor is staged through host
    memory: copied to the host, exchanged by gloo, copied back to its
    device. That is the wire only; the compute stays on the card.
    ``staged_bytes`` counts the bytes this rank sent that way."""

    def __init__(self, shape, axis_names):
        import torch.distributed as dist
        super().__init__(shape, axis_names)
        if not dist.is_initialized() or dist.get_world_size() != self.size:
            raise RuntimeError(f"ProcessMesh {self.shape} needs an "
                               f"initialised world of {self.size} ranks")
        self.rank = dist.get_rank()
        self.staged = dist.get_backend() == "gloo"
        self.staged_bytes = 0
        self._pgs: dict[tuple[int, ...], object] = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                for r in range(self.size):
                    key = tuple(sorted(self.group(r, axes)))
                    if len(key) > 1 and key not in self._pgs:
                        self._pgs[key] = dist.new_group(list(key))
        global _process_shard
        _process_shard = Shard(self, self.rank)

    def _pg(self, members):
        import torch.distributed as dist
        pg = self._pgs[tuple(sorted(members))]
        return pg, [dist.get_global_rank(pg, i) for i in range(len(members))]

    def _wire(self, x):
        """``x`` as the backend takes it: on the host for gloo."""
        if self.staged and x.is_cuda:
            self.staged_bytes += x.numel() * x.element_size()
            return x.cpu()
        return x

    def _gather(self, rank, axes, x):
        import torch.distributed as dist
        members = self.group(rank, axes)
        pg, order = self._pg(members)
        w = self._wire(x.contiguous())
        out = [torch.empty_like(w) for _ in members]
        dist.all_gather(out, w, group=pg)
        return [out[order.index(r)].to(x.device) for r in members]

    def _all_to_all(self, rank, axes, x):
        import torch.distributed as dist
        members = self.group(rank, axes)
        pg, order = self._pg(members)
        send = self._wire(torch.stack([x[members.index(g)]
                                       for g in order]).contiguous())
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=pg)
        return torch.stack([recv[order.index(r)] for r in members]).to(
            x.device)

    def run(self, fn):
        """``fn(rank)`` as this process's shard."""
        return fn(self.rank)


class ShapeMesh(Mesh):
    """One shard's body on tensors without storage (``device="meta"``):
    the dry-run's backend (``launch/dryrun.py``). The body runs once, as
    ``rank`` (the bodies are SPMD), on the caller's thread; a collective
    returns a tensor of its result's shape and adds the bytes it moves
    to ``collectives`` by ``repro/launch/hlo_analysis.py``'s rule: an
    all-gather its output, an all-reduce (``psum`` / ``pmax``) twice its
    input, a reduce-scatter, an all-to-all or a permute its input. A
    group of one shard moves nothing. While ``quiet`` (a collective's
    emulation, a shard's slicing of its arguments) ops run uncounted by
    the dry-run's tallies. ``shard_map`` cuts the global arguments (a
    resident one is the shard's block already, as on a ``ProcessMesh``)
    and returns the shard's own outputs, uncounted edges aside: what one
    rank of the step computes, holds and moves."""
    pool_layout = "local"

    def __init__(self, shape, axis_names, *, rank: int = 0):
        super().__init__(shape, axis_names)
        self.rank = rank
        self.collectives: dict[str, float] = {}
        self.quiet_depth = 0
        self.coll_depth = 0

    @contextlib.contextmanager
    def quiet(self):
        self.quiet_depth += 1
        try:
            yield
        finally:
            self.quiet_depth -= 1

    def count(self, kind: str, x, out, axis) -> None:
        if self.axis_size(axis) == 1:
            return
        nbytes = lambda t: t.numel() * t.element_size()
        b = {"all-gather": nbytes(out),
             "all-reduce": 2 * nbytes(torch.as_tensor(x))}.get(kind,
                                                              nbytes(x))
        self.collectives[kind] = self.collectives.get(kind, 0.0) + b

    def _gather(self, rank, axes, x):
        return [x] * self.axis_size(axes)

    def _all_to_all(self, rank, axes, x):
        return torch.empty_like(x)

    def split(self, args, specs) -> list:
        with self.quiet():
            return [_split(a, s, self, self.rank)
                    for a, s in zip(args, specs)]

    def run(self, fn):
        """``fn(rank)`` as this mesh's one shard."""
        prev = getattr(_tls, "shard", None)
        _tls.shard = Shard(self, self.rank)
        try:
            return fn(self.rank)
        finally:
            _tls.shard = prev


# ---------------------------------------------------------------------------
# shard_map and the edges
# ---------------------------------------------------------------------------

def _split(a, spec, mesh: Mesh, rank: int):
    """Shard ``rank``'s part of the global argument ``a`` (a resident one
    as it is, but on a ``LocalMesh``)."""
    if isinstance(spec, Resident):
        if not isinstance(mesh, LocalMesh):
            return a
        spec = spec.spec
    if isinstance(spec, dict):
        return {k: _split(a[k], spec.get(k), mesh, rank) for k in a}
    if isinstance(spec, Stages):
        r = spec.run(mesh, rank, len(a))
        return type(a)(_split(v, s, mesh, rank)
                       for v, s in zip(a[r], spec.specs[r]))
    if _subspecs(spec, a):
        return type(a)(_split(v, s, mesh, rank) for v, s in zip(a, spec))
    if not torch.is_tensor(a) and isinstance(a, dict):
        return {k: _split(v, spec, mesh, rank) for k, v in a.items()}
    if isinstance(a, (list, tuple)):        # a carry's tuple: one spec
        return type(a)(_split(v, spec, mesh, rank) for v in a)
    if spec is None or not torch.is_tensor(a):
        return a
    for d, e in enumerate(spec):
        if e is None:
            continue
        if isinstance(e, Paged):
            if mesh.pool_layout == "global":
                continue
            n, i = mesh.axis_size(e.axes), mesh.index(rank, e.axes)
            blk = (a.shape[d] - 1) // n
            trash = torch.zeros_like(a.narrow(d, 0, 1))
            a = torch.cat([a.narrow(d, i * blk, blk), trash], d)
            continue
        n, i = mesh.axis_size(e), mesh.index(rank, e)
        if a.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(a.shape)} does not split "
                             f"over {e!r} ({n} shards)")
        blk = a.shape[d] // n
        a = a.narrow(d, i * blk, blk)
    return a


def _assemble_local(outs: list, spec, mesh: Mesh, rank: int = 0):
    """The global output from every shard's block (a ``LocalMesh``):
    blocks concatenated over the cut dims, a replicated dim read from the
    shard at index 0 of the axes its spec does not name."""
    if isinstance(spec, Resident):
        spec = spec.spec
    if isinstance(spec, dict):
        return {k: _assemble_local([o[k] for o in outs], spec.get(k), mesh,
                                   rank) for k in outs[0]}
    first = outs[rank]
    if _subspecs(spec, first):
        return type(first)(_assemble_local([o[i] for o in outs], s, mesh,
                                           rank) for i, s in enumerate(spec))
    if not torch.is_tensor(first) and isinstance(first, dict):
        return {k: _assemble_local([o[k] for o in outs], spec, mesh, rank)
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_assemble_local([o[i] for o in outs], spec, mesh,
                                           rank) for i in range(len(first)))
    if spec is None or not torch.is_tensor(first):
        return first

    def build(d, r):
        if d == len(spec):
            return outs[r]
        e = spec[d]
        if e is None or isinstance(e, Paged):
            return build(d + 1, r)
        return torch.cat([build(d + 1, mesh.with_index(r, e, i))
                          for i in range(mesh.axis_size(e))], d)
    return build(0, rank)


def _assemble_process(out, spec, mesh: "ProcessMesh"):
    """The global output on every rank (a ``ProcessMesh``): each cut dim
    all-gathered over its axes, a ``Paged`` dim's pages gathered and a
    zero trash page appended; a resident output as it is."""
    if isinstance(spec, Resident):
        return out
    if isinstance(spec, dict):
        return {k: _assemble_process(out[k], spec.get(k), mesh) for k in out}
    if isinstance(spec, Stages):        # the stages' runs over the axis
        n = mesh.axis_size(spec.axis)
        r = spec.run(mesh, mesh.rank, len(out) * n)
        every = [_map(lambda t: all_gather(t, spec.axis),
                      _assemble_process(v, s, mesh))
                 for v, s in zip(out, spec.specs[r])]
        return type(out)(_map(lambda t: t[i], v)
                         for i in range(n) for v in every)
    if _subspecs(spec, out):
        return type(out)(_assemble_process(v, s, mesh)
                         for v, s in zip(out, spec))
    if not torch.is_tensor(out) and isinstance(out, dict):
        return {k: _assemble_process(v, spec, mesh) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_assemble_process(v, spec, mesh) for v in out)
    if spec is None or not torch.is_tensor(out):
        return out
    for d, e in enumerate(spec):
        if e is None:
            continue
        if isinstance(e, Paged):
            blk = out.shape[d] - 1
            pages = all_gather(out.narrow(d, 0, blk), e.axes, dim=d,
                               tiled=True)
            out = torch.cat([pages, torch.zeros_like(out.narrow(d, 0, 1))],
                            d)
        else:
            out = all_gather(out, e, dim=d, tiled=True)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def shard(tree, specs, mesh: Mesh):
    """This rank's resident part of the global ``tree`` under ``specs``
    (the edge a resident step's state comes in by). The identity on a
    ``LocalMesh``; on a ``ProcessMesh`` every cut leaf is a copy of its
    block (the global tree can go) and a ``Paged`` block gets its own
    trash page; on a ``ShapeMesh`` the shard's blocks, uncounted."""
    if isinstance(mesh, LocalMesh):
        return tree
    if isinstance(mesh, ShapeMesh):
        with mesh.quiet():
            return _split(tree, specs, mesh, mesh.rank)
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(f"{mesh!r} has no shards to hold a tree")
    return _map(lambda t: t.clone() if t._is_view() else t,
                _split(tree, specs, mesh, mesh.rank))


def gather(tree, specs, mesh: Mesh):
    """The global tree from every rank's resident part under ``specs``
    (the edge a resident step's state leaves by: a comparison, a
    checkpoint), on every rank. The identity on a ``LocalMesh``."""
    if isinstance(mesh, LocalMesh):
        return tree
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(f"{mesh!r} holds no data to gather")
    return _assemble_process(tree, specs, mesh)


def leaf_specs(tree, specs, mesh: Mesh | None = None):
    """(leaf, its spec) for every tensor of ``tree``: ``specs`` a tree of
    the same shape, or one spec (a ``P`` or None) for a whole subtree. A
    ``Stages`` list, which needs ``mesh``, yields the elements of the
    global list that the mesh's rank holds (shard 0's on a mesh of no
    rank, as a ``LocalMesh``)."""
    if isinstance(specs, dict):
        for k, v in tree.items():
            yield from leaf_specs(v, specs.get(k), mesh)
    elif isinstance(specs, Stages):
        if mesh is None:
            raise ValueError("a Stages spec counts a rank's stage: give "
                             "the mesh")
        r = specs.run(mesh, getattr(mesh, "rank", 0), len(tree))
        for v, s in zip(tree[r], specs.specs[r]):
            yield from leaf_specs(v, s, mesh)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaf_specs(v, specs, mesh)
    elif isinstance(tree, (list, tuple)):
        sub = _subspecs(specs, tree)
        for i, v in enumerate(tree):
            yield from leaf_specs(v, specs[i] if sub else specs, mesh)
    elif torch.is_tensor(tree):
        yield tree, specs


def block_nbytes(t, spec, mesh: Mesh) -> int:
    """The bytes of a rank's block of the global leaf ``t`` under ``spec``:
    ``t``'s bytes over the shards its cut dims split it into; a ``Paged``
    dim the rank's pages and its own trash page. A tree ``t`` sums its
    leaves' (``leaf_specs``: a ``Stages`` list its rank's stage)."""
    if not torch.is_tensor(t):
        return sum(block_nbytes(x, s, mesh)
                   for x, s in leaf_specs(t, spec, mesh))
    n, nbytes = 1, t.numel() * t.element_size()
    for d, e in enumerate(spec or ()):
        if isinstance(e, Paged):
            pages = t.shape[d]
            nbytes = nbytes // pages * ((pages - 1)
                                        // mesh.axis_size(e.axes) + 1)
        elif e is not None:
            n *= mesh.axis_size(e)
    return nbytes // n


def shard_map(body, mesh: Mesh, in_specs, out_specs):
    """``f(*args) -> outputs`` running ``body`` once per shard of ``mesh``
    on its part of each argument (``in_specs``, one per argument) and
    assembling its outputs (``out_specs``, one per element of the tuple
    the body returns); a ``Resident`` spec's argument or output is the
    rank's own (module docstring)."""
    in_specs, out_specs = tuple(in_specs), tuple(out_specs)

    def f(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map: {len(args)} arguments for "
                            f"{len(in_specs)} specs")

        def shard(rank):
            return body(*(_split(a, s, mesh, rank)
                          for a, s in zip(args, in_specs)))

        if isinstance(mesh, LocalMesh):
            outs = mesh.run(shard)
            return tuple(_assemble_local([o[j] for o in outs], s, mesh)
                         for j, s in enumerate(out_specs))
        if isinstance(mesh, ProcessMesh):
            out = mesh.run(shard)
            return tuple(_assemble_process(o, s, mesh)
                         for o, s in zip(out, out_specs))
        if isinstance(mesh, ShapeMesh):
            return tuple(mesh.run(lambda r: body(*mesh.split(args,
                                                             in_specs))))
        raise TypeError(f"{mesh!r} has no backend to run on")
    return f
