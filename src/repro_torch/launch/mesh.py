"""Meshes of ``torch.distributed`` ranks for the sharded flat engine, and the
collectives of the sharded round.

Counterpart of ``repro/launch/mesh.py`` over ranks in place of
``jax.devices()``. A ``Mesh`` lays the world's ranks out row-major over its
axes (``("data", "model")`` flat, ``("data", "fsdp", "model")``
hierarchical): a rank's coordinates are its index in that order, and the
rank order of an axis group is ``lin_index``'s, the reference's
``train/trainer.py::_lin_index``. That is the concatenation order of every
gather. The mesh holds one ``Group`` for every nonempty group of its axes
(this rank's row group, its column group, ...); every rank creates every
group in the same order when the mesh is built.

The transport is fixed when the ranks start (``start``), never on an
error: ``nccl`` when every rank has a card of its own; ``gloo`` otherwise,
that is on the CPU and when several ranks share one card (NCCL refuses
two ranks on one card). On gloo a CUDA tensor goes through host memory
explicitly: copied out before the collective, back after it, through host
buffers kept for reuse (``release_staging`` drops them); ``STAGED``
counts those bytes and the seconds the copies take. The all-gather is one
broadcast from each member straight into its part, so no gathered copy
is made on the host beside the parts. A collective that fails raises.

``ring_gather`` is the reference's ppermute ring for sharded
``staleness_k``: R - 1 neighbour hops of one block each
(``batch_isend_irecv``), the all-gather's result bit for bit.

The column rule (``flat_col_axes``, ``flat_col_entry``,
``flat_view_spec``) is the reference's, as pure functions of the mesh
shape. So is the ``model`` half of its parameter and serving rules
(``_RULES``, ``_MOE_RULES``, ``_leaf_spec``, ``serve_shardings``):
``model_dim`` and ``serve_model_dim`` name the dim the reference splits
over a ``model`` group. The port runs that split explicitly
(tensor-parallel serving): ``tp_split`` / ``state_split`` are the dims
its forward splits, the reference's except where the reference's split
cannot run as an explicit one (``placed_apart``: KV heads that a group
larger than their count would cut inside a head, replicated instead on
the ranks whose query heads read them; the shared expert, whose rule
lands on the layer dim), and ``shard_params`` cuts a rank's shard from a
full tree. ``batch_shardings`` is not here: GSPMD's batch placement has
no counterpart in a sharded step that takes its rank's rows.

``VirtualMesh`` is one rank's view of a mesh of any size with no
processes behind it: the same axes, coordinates and groups, whose
collectives return ``meta`` tensors of the right shapes. Every collective
records its kind, ranks and result bytes with the active
``launch.census.Census`` (real and virtual groups alike), so launch
analysis counts a step's traffic without running it;
``make_production_mesh`` lays H100 nodes out as the dry-run's meshes.

All builders are functions: importing this module starts nothing.
"""
from __future__ import annotations

import math
import os
import time
from datetime import timedelta
from itertools import combinations, product
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshPlan
from repro_torch.launch import census

FLAT_AXES = ("data", "model")
HIER_AXES = ("data", "fsdp", "model")

# bytes copied between card and host around gloo collectives, both ways,
# and the host seconds of those copies
STAGED = {"bytes": 0, "seconds": 0.0}
_POOL = {}          # (numel, dtype) -> free host staging buffers
STAGE_BYTES = 1 << 28  # a blocking gather stages pieces of this size

VIRTUAL = "virtual"     # the backend name of a VirtualMesh's groups
CARDS_PER_NODE = 8      # H100 cards a node, all to all on NVLink

HOW_TO_START = ("start one process per rank, e.g. torchrun "
                "--nproc-per-node N -m repro_torch.launch.train --sharded "
                "... (or --mesh W,F,M with N = W*F*M)")


def reset_staged():
    STAGED["bytes"], STAGED["seconds"] = 0, 0.0


def release_staging():
    """Drop the host staging buffers kept for reuse."""
    _POOL.clear()


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------

def choose_backend(device_type: str, local_world: int, cards: int) -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``
    (the CPU; several ranks on one card)."""
    if device_type == "cuda" and cards >= local_world:
        return "nccl"
    return "gloo"


def start(device: str = "cuda", *, init_method: str = "env://", rank=None,
          world=None, timeout_s: float = 600.0) -> torch.device:
    """Initialise the default process group of this rank and return the
    device it computes on. ``rank`` / ``world`` default to the
    environment's ``RANK`` / ``WORLD_SIZE`` (torchrun sets them). On the
    card each local rank takes card ``LOCAL_RANK`` when there are enough
    cards (nccl), else all share card 0 (gloo). A process group that
    exists already is kept."""
    dev_type = torch.device(device).type
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world = int(os.environ["WORLD_SIZE"]) if world is None else int(world)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu'")
        cards = torch.cuda.device_count()
        backend = choose_backend("cuda", local_world, cards)
        dev = torch.device("cuda", local_rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    else:
        backend, dev = "gloo", torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s))
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def transport(device=None) -> dict:
    """The transport of this process's ranks: backend, ranks per card and
    the bytes staged through host memory so far."""
    backend = dist.get_backend() if dist.is_initialized() else "none"
    world = world_size()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    on_card = device is not None and torch.device(device).type == "cuda"
    per_card = (world if backend == "gloo" else 1) if on_card else 0
    return {"backend": backend, "world": world, "ranks_per_card": per_card,
            "cards": cards, "bytes_staged": STAGED["bytes"]}


# ---------------------------------------------------------------------------
# groups and collectives
# ---------------------------------------------------------------------------

class Group:
    """One axis group of a mesh as this rank sees it: its process group
    (``None`` for a group of one, or of a ``VirtualMesh``), its size, this
    rank's index in it (``lin_index`` over the group's axes) and its
    members' global ranks in that order."""

    def __init__(self, pg, size: int, index: int, backend: str, ranks):
        self.pg, self.size, self.index, self.backend = pg, size, index, backend
        self.ranks = tuple(ranks)

    def __repr__(self):
        return f"Group(size={self.size}, index={self.index}, " \
               f"backend={self.backend!r})"


class Pending:
    """An issued collective: ``wait()`` finishes it (copies the result back
    to the card where it was staged) and returns the result."""

    def __init__(self, work, finish):
        self._work, self._finish, self._out = work, finish, None
        self._done = False

    def wait(self):
        if not self._done:
            if self._work is not None:
                self._work.wait()
            self._out, self._done = self._finish(), True
            self._work = self._finish = None     # the staging buffers
        return self._out


def done(value) -> Pending:
    """A ``Pending`` that is already finished."""
    return Pending(None, lambda: value)


def _host(shape, dtype):
    """A host buffer of ``shape``, from the pool if one is free (a reused
    buffer's pages are resident: no page faults in the copy)."""
    free = _POOL.get((math.prod(shape), dtype))
    buf = free.pop() if free else torch.empty((math.prod(shape),),
                                              dtype=dtype)
    return buf.view(shape)


def _give_back(*bufs):
    for b in bufs:
        _POOL.setdefault((b.numel(), b.dtype), []).append(b.view(-1))


def _staging(group, t):
    return group.backend == "gloo" and t.is_cuda


def _to_host(t):
    """A CUDA tensor copied into a pooled host buffer."""
    t0 = time.perf_counter()
    h = _host(tuple(t.shape), t.dtype)
    h.copy_(t)
    STAGED["bytes"] += t.numel() * t.element_size()
    STAGED["seconds"] += time.perf_counter() - t0
    return h


def _to_card(dst, h):
    t0 = time.perf_counter()
    dst.copy_(h)
    STAGED["bytes"] += h.numel() * h.element_size()
    STAGED["seconds"] += time.perf_counter() - t0


def _gathered(parts, dim, like, staged):
    """The gathered parts in one tensor on ``like``'s device; staged host
    parts are copied straight into their slices of the card's buffer and
    go back to the pool."""
    if not staged:
        return torch.cat(parts, dim=dim)
    shape = list(parts[0].shape)
    step = shape[dim]
    shape[dim] = step * len(parts)
    out = torch.empty(shape, dtype=like.dtype, device=like.device)
    for i, p in enumerate(parts):
        _to_card(out.narrow(dim, i * step, step), p)
    _give_back(*parts)
    return out


def all_gather(x, group: Group, dim: int = 0, *, async_op: bool = False):
    """The group's ``x``s concatenated along ``dim`` in ``lin_index`` order
    (``lax.all_gather(..., tiled=True)``), a new tensor on x's device. A
    group of one returns ``x`` itself. With ``async_op`` a ``Pending``.
    A blocking gather of a 2-D CUDA tensor on gloo is staged in column
    pieces of at most ``STAGE_BYTES``, so the host holds a few pieces, not
    the gathered tensor."""
    if group.size == 1:
        return done(x) if async_op else x
    _record("all-gather", x.numel() * group.size, x, group)
    if group.backend == VIRTUAL:
        out = x.new_empty(_gathered_shape(x, group.size, dim))
        return done(out) if async_op else out
    if not async_op and x.dim() == 2 and _staging(group, x) \
            and x.numel() * x.element_size() > STAGE_BYTES:
        return _gather_in_pieces(x, group, dim)
    return _gather(x, group, dim, async_op)


def _gathered_shape(x, size, dim):
    shape = list(x.shape)
    shape[dim] *= size
    return shape


def _record(kind, numel, like, group, count=1):
    """Record ``count`` collectives whose results together hold ``numel``
    elements of ``like``'s dtype with the active census."""
    c = census.active()
    if c is not None:
        c.collective(kind, numel * like.element_size(), group.ranks, count)


def _gather(x, group, dim, async_op):
    """``all_gather`` in one piece: one broadcast from each member."""
    staged = _staging(group, x)
    h = _to_host(x) if staged else x.contiguous()
    parts = [h if i == group.index else
             _host(tuple(h.shape), h.dtype) if staged else torch.empty_like(h)
             for i in range(group.size)]
    works = [dist.broadcast(p, src, group=group.pg, async_op=True)
             for p, src in zip(parts, group.ranks)]

    def finish():
        for w in works:
            w.wait()
        return _gathered(parts, dim, x, staged)
    pend = Pending(None, finish)
    return pend if async_op else pend.wait()


def _gather_in_pieces(x, group, dim):
    a, b = x.shape
    step = max(1, STAGE_BYTES // (a * x.element_size()))
    shape = [a, b]
    shape[dim] *= group.size
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    for c in range(0, b, step):
        w = min(step, b - c)
        piece = _gather(x[:, c:c + w], group, 0, False)   # (size * a, w)
        for i in range(group.size):
            rows = piece[i * a:(i + 1) * a]
            if dim == 0:
                out[i * a:(i + 1) * a, c:c + w].copy_(rows)
            else:
                out[:, i * b + c:i * b + c + w].copy_(rows)
    return out


def ring_gather(x, group: Group, dim: int = 0, *, axes=("data",),
                async_op: bool = False):
    """The worker-row gather as a ring (the reference's ``ring_gather``):
    ``group.size - 1`` hops, in each of which every member sends the block
    it last received to the next member and receives one from the
    previous (``batch_isend_irecv``), so that after hop h a member holds
    the block of member ``index - h - 1``. The result is bit for bit
    ``all_gather(x, group, dim)``: blocks move verbatim into their places
    of the concatenation order. A group of one returns ``x``; a group
    over several mesh ``axes`` falls back to ``all_gather``, as the
    reference does (a ring needs one linear axis). On gloo a CUDA block
    goes through pooled host buffers. With ``async_op`` a ``Pending``:
    the first hop is issued now, the rest run in ``wait()``."""
    if group.size == 1:
        return done(x) if async_op else x
    if len(tuple(axes)) != 1:
        return all_gather(x, group, dim, async_op=async_op)
    w, idx, ranks = group.size, group.index, group.ranks
    # R - 1 hops, each one block's bytes
    _record("collective-permute", (w - 1) * x.numel(), x, group, w - 1)
    if group.backend == VIRTUAL:
        out = x.new_empty(_gathered_shape(x, w, dim))
        return done(out) if async_op else out
    staged = _staging(group, x)
    step = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = w * step
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, idx * step, step).copy_(x)
    send = _to_host(x) if staged else x.contiguous()
    nxt, prv = ranks[(idx + 1) % w], ranks[(idx - 1) % w]

    def hop(buf):
        recv = _host(tuple(buf.shape), buf.dtype) if staged \
            else torch.empty_like(buf)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, nxt, group=group.pg),
            dist.P2POp(dist.irecv, recv, prv, group=group.pg)])
        return recv, reqs

    pending = [hop(send)]

    def finish():
        nonlocal send
        for h in range(w - 1):
            recv, reqs = pending.pop()
            for r in reqs:
                r.wait()
            if staged:
                _give_back(send)
            send = recv
            if h + 1 < w - 1:
                pending.append(hop(send))
            dst = out.narrow(dim, ((idx - h - 1) % w) * step, step)
            if staged:
                _to_card(dst, recv)
            else:
                dst.copy_(recv)
        if staged:
            _give_back(send)
        return out
    pend = Pending(None, finish)
    return pend if async_op else pend.wait()


def all_reduce(t, group: Group, *, async_op: bool = False):
    """Sum ``t`` over the group, in place (``lax.psum``); returns ``t`` (or
    a ``Pending`` of it). A group of one leaves ``t`` as it is."""
    if group.size == 1:
        return done(t) if async_op else t
    _record("all-reduce", t.numel(), t, group)
    if group.backend == VIRTUAL:
        return done(t) if async_op else t
    staged = _staging(group, t)
    h = _to_host(t) if staged else t.contiguous()

    def finish():
        if staged:
            _to_card(t, h)
            _give_back(h)
        elif h is not t:
            t.copy_(h)
        return t
    work = dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group.pg,
                           async_op=async_op)
    pend = Pending(work, finish)
    return pend if async_op else pend.wait()


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def lin_index(axes, sizes, coords) -> int:
    """Linear index over an ordered axis group, row-major (the reference's
    ``train/trainer.py::_lin_index``): the concatenation order of
    ``all_gather``."""
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


class Mesh:
    """Ranks ``0 .. size-1`` laid out row-major over named axes. ``shape``
    maps each axis to its size, ``coords`` each axis to this rank's index
    on it, ``group(axes)`` gives this rank's ``Group`` over any axes of
    the mesh, and ``device`` is where this rank computes."""

    def __init__(self, names, sizes, *, device=None):
        names, sizes = tuple(names), tuple(int(s) for s in sizes)
        world = world_size()
        size = math.prod(sizes)
        if size != world:
            raise ValueError(f"mesh {'x'.join(map(str, sizes))} has {size} "
                             f"ranks, world has {world}")
        rank = dist.get_rank() if dist.is_initialized() else 0
        backend = dist.get_backend() if dist.is_initialized() else "none"
        self._lay_out(names, sizes, rank, backend, device if device
                      is not None else (
                          torch.device("cuda", torch.cuda.current_device())
                          if torch.cuda.is_available()
                          else torch.device("cpu")))

    def _lay_out(self, names, sizes, rank, backend, device):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.size = math.prod(sizes)
        self.rank, self.backend = rank, backend
        self.device = torch.device(device)
        rest, self.coords = self.rank, {}
        for a in reversed(names):
            rest, self.coords[a] = divmod(rest, self.shape[a])
        self.coords = {a: self.coords[a] for a in names}
        self._groups = {}
        # every rank creates every group in the same order
        for k in range(1, len(names) + 1):
            for axes in combinations(names, k):
                self._groups[axes] = self._make_group(axes)

    def _members(self, axes, fixed):
        """The global ranks of the group over ``axes`` whose other axes sit
        at ``fixed``, in ``lin_index`` order."""
        ranks = []
        for ac in product(*(range(self.shape[a]) for a in axes)):
            c = dict(fixed, **dict(zip(axes, ac)))
            ranks.append(lin_index(self.axis_names, self.shape, c))
        return ranks

    def _make_group(self, axes):
        gsize = self.axis_size(axes)
        index = lin_index(axes, self.shape, self.coords)
        if gsize == 1:
            return Group(None, 1, 0, self.backend, (self.rank,))
        others = [a for a in self.axis_names if a not in axes]
        mine = members = None
        for oc in product(*(range(self.shape[a]) for a in others)):
            fixed = dict(zip(others, oc))
            ranks = self._members(axes, fixed)
            pg = dist.new_group(ranks=ranks)
            if all(fixed[a] == self.coords[a] for a in others):
                mine, members = pg, ranks
        return Group(mine, gsize, index, self.backend, members)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def lin_index(self, axes) -> int:
        return lin_index(axes, self.shape, self.coords)

    def group(self, axes) -> Group:
        axes = tuple(axes)
        if not axes:
            return Group(None, 1, 0, self.backend, (self.rank,))
        order = tuple(a for a in self.axis_names if a in axes)
        if order != axes:
            raise ValueError(f"axes {axes} are not in mesh order "
                             f"{self.axis_names}")
        return self._groups[axes]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, " \
               f"backend={self.backend!r})"


class VirtualMesh(Mesh):
    """Rank ``rank``'s view of a mesh of ``prod(sizes)`` ranks that has no
    processes behind it: ``axis_names``, ``shape``, ``coords``,
    ``lin_index`` and ``group(axes)`` as ``Mesh`` gives them, without a
    world to check or a process group to make. Its groups' collectives
    (``all_gather``, ``ring_gather``, ``all_reduce``) return ``meta``
    tensors of their results' shapes and record with the active census:
    a step traced on it issues the same collectives, with the same
    bytes, as on the real mesh, and moves nothing."""

    def __init__(self, names, sizes, *, rank: int = 0, device="meta"):
        names, sizes = tuple(names), tuple(int(s) for s in sizes)
        if min(sizes) < 1 or not 0 <= rank < math.prod(sizes):
            raise ValueError(f"rank {rank} of a "
                             f"{'x'.join(map(str, sizes))} mesh")
        self._lay_out(names, sizes, int(rank), VIRTUAL, device)

    def _make_group(self, axes):
        others = [a for a in self.axis_names if a not in axes]
        ranks = self._members(axes, {a: self.coords[a] for a in others})
        return Group(None, len(ranks), lin_index(axes, self.shape,
                                                 self.coords), VIRTUAL, ranks)

    def __repr__(self):
        return f"VirtualMesh({self.shape}, rank={self.rank})"


PRODUCTION_PLANS = ("baseline", "hier")


def make_production_mesh(nodes: int, *, plan: str = "baseline",
                         rank: int = 0):
    """``(VirtualMesh, MeshPlan)`` of ``nodes`` H100 nodes of
    ``CARDS_PER_NODE`` cards on NVLink, as rank ``rank`` sees it (the
    counterpart of the reference's ``launch/mesh.py:23-44``, for the
    dry-run). ``baseline``: ``(data = nodes, model = 8)``, one DPPF worker
    a node, the flat engine's (R, n) view in column shards over the
    node's cards. ``hier``: ``(data = 4, fsdp = nodes * 8 / 32, model =
    8)``, four workers each over a quarter of the cards; the node count
    must make fsdp whole. Node counts 32 and 64 are the reference's 256-
    and 512-chip meshes in cards (its ``(16, 16)`` pod and ``(2, 16, 16)``
    pair of pods)."""
    if nodes < 1:
        raise ValueError(f"nodes must be >= 1, got {nodes}")
    cards = nodes * CARDS_PER_NODE
    if plan == "baseline":
        return VirtualMesh(FLAT_AXES, (nodes, CARDS_PER_NODE), rank=rank), \
            MeshPlan(worker_axes=("data",), model_axes=("model",))
    if plan == "hier":
        if cards % (4 * CARDS_PER_NODE):
            raise ValueError(f"the hier plan needs 4 x fsdp x 8 cards: "
                             f"{nodes} nodes ({cards} cards) do not divide "
                             "(use a multiple of 4 nodes)")
        return VirtualMesh(HIER_AXES, (4, cards // (4 * CARDS_PER_NODE),
                                       CARDS_PER_NODE), rank=rank), \
            hierarchical_plan()
    raise ValueError(f"unknown production plan {plan!r}; "
                     f"choose from {PRODUCTION_PLANS}")


def make_hierarchical_mesh(workers: int, fsdp: int, model: int, *,
                           device=None) -> Mesh:
    """The world's ranks as (worker, fsdp, model): DPPF worker rows on
    ``data``, flat-view column shards over ``fsdp x model``. The product
    must be the world size."""
    if min(workers, fsdp, model) < 1:
        raise ValueError(f"hierarchical mesh axes must all be >= 1, got "
                         f"{workers}x{fsdp}x{model}")
    world = world_size()
    if workers * fsdp * model != world:
        raise ValueError(
            f"hierarchical mesh shape {workers}x{fsdp}x{model} = "
            f"{workers * fsdp * model} ranks must use exactly the world "
            f"({world} ranks)")
    return Mesh(HIER_AXES, (workers, fsdp, model), device=device)


def hierarchical_plan() -> MeshPlan:
    """The MeshPlan of ``make_hierarchical_mesh``'s axis names."""
    return MeshPlan(worker_axes=("data",), fsdp_axes=("fsdp",),
                    model_axes=("model",))


def make_hier_engine_mesh(workers: int, fsdp: int, model: int, *,
                          device=None):
    """``(mesh, plan)`` for ``launch/train.py --mesh workers,fsdp,model``,
    validated against the world size."""
    if min(workers, fsdp, model) < 1:
        raise ValueError(f"hierarchical mesh axes must all be >= 1, got "
                         f"{workers}x{fsdp}x{model}")
    need, world = workers * fsdp * model, world_size()
    if need != world:
        raise ValueError(
            f"hierarchical mesh {workers}x{fsdp}x{model} needs {need} "
            f"ranks, world has {world} ({HOW_TO_START})")
    return make_hierarchical_mesh(workers, fsdp, model, device=device), \
        hierarchical_plan()


def make_cpu_mesh(device=None) -> Mesh:
    """The 1x1 mesh of a world of one (same code path, trivial groups)."""
    if world_size() != 1:
        raise ValueError(f"make_cpu_mesh is a world of one, world has "
                         f"{world_size()}")
    return Mesh(FLAT_AXES, (1, 1), device=device or "cpu")


def make_flat_engine_mesh(workers: int, *, device=None):
    """All ranks as a (data, model) mesh: worker rows over ``gcd(workers,
    world)`` ranks, the rest of the world as column shards of the (R, n)
    view. Returns ``(mesh, plan)``."""
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    world = world_size()
    rows = math.gcd(workers, world)
    mesh = Mesh(FLAT_AXES, (rows, world // rows), device=device)
    return mesh, MeshPlan(worker_axes=("data",), model_axes=("model",))


# ---------------------------------------------------------------------------
# the flat view's rule (pure functions of the mesh shape)
# ---------------------------------------------------------------------------

def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _axes_entry(axes):
    return axes if len(axes) > 1 else axes[0]


def flat_col_axes(mesh, n: int, plan: MeshPlan):
    """The column axis group of the flat view: the full ``fsdp + model``
    group when its size divides n, else fsdp alone, else model alone, else
    ``()`` (columns replicated; the Gram's all-reduce is then a no-op)."""
    for axes in (plan.fsdp_axes + plan.model_axes, plan.fsdp_axes,
                 plan.model_axes):
        if axes and n % _axes_size(mesh, axes) == 0:
            return tuple(axes)
    return ()


def flat_col_entry(mesh, n: int, plan: MeshPlan):
    """``flat_col_axes`` as a PartitionSpec entry (None = replicated)."""
    axes = flat_col_axes(mesh, n, plan)
    return _axes_entry(axes) if axes else None


def flat_view_spec(mesh, shape, plan: MeshPlan):
    """The reference's ``flat_view_sharding`` rule as a PartitionSpec
    tuple: rows over the worker axes when they divide R, columns over
    ``flat_col_entry``; a 3-D ``(k, R, n)`` ring keeps its ring dim
    replicated."""
    *ring, R, n = shape
    spec = [None] * len(ring) + [None, flat_col_entry(mesh, n, plan)]
    if plan.worker_axes and R % _axes_size(mesh, plan.worker_axes) == 0:
        spec[-2] = _axes_entry(plan.worker_axes)
    return tuple(spec)


# ---------------------------------------------------------------------------
# the model axis: the reference's rules, and the split the forward runs
# ---------------------------------------------------------------------------

# leaf name -> (model dim from the right, fsdp dim from the right), the
# reference's ``_RULES`` (``launch/mesh.py:111-131``); None = replicated.
# The fsdp half only marks a matrix, whose model split may fall back to
# its sibling feature dim.
_RULES = {
    "wq": (-1, -2), "wk": (-1, -2), "wv": (-1, -2),
    "bq": (-1, None), "bk": (-1, None), "bv": (-1, None),
    "wo": (-2, -1),
    "w_gate": (-1, -2), "w_up": (-1, -2), "w_down": (-2, -1),
    "embed": (-1, -2), "lm_head": (-1, -2),
    "in_proj": (-1, -2), "out_proj": (-2, -1), "conv_w": (-1, None),
    "conv_b": (-1, None), "norm": (-1, None),
    "w_i": (-1, None), "w_f": (-1, None), "w_gates": (-1, -2),
    "r_gates": (None, None),
    "router": (-1, None),
}
# inside a "moe" subtree the expert tables split the expert dim (-3)
_MOE_RULES = {"w_gate": (-3, -1), "w_up": (-3, -1), "w_down": (-3, -1)}

# the dims the port's tensor-parallel forward splits, from the right:
# column-parallel leaves on their outputs (the router's on its experts,
# embed on d_model, lm_head on the vocabulary), row-parallel ones on
# their inputs, a MoE block's expert tables on their expert dim
_COLUMN = ("wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up", "embed",
           "lm_head", "router")
_ROW = ("wo", "w_down")
_EXPERT_TABLES = ("w_gate", "w_up", "w_down")
_KV = ("wk", "wv", "bk", "bv")


def _names(path):
    return [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]


def model_dim(path, shape, size: int):
    """The dim of a parameter leaf at ``path`` (its key names) and
    ``shape`` that the reference's ``_leaf_spec`` puts a ``model`` group of
    ``size`` on in a serving tree (``stacked=False``), as an index into
    ``shape``; None where it replicates the leaf."""
    names = _names(path)
    name = names[-1] if names else ""
    rules = _MOE_RULES if ("moe" in names and name in _MOE_RULES) \
        else _RULES
    dim, fsdp = rules.get(name, (None, None))
    if dim is None:
        return None
    nd = len(shape)
    for d in [dim] + ([-1 if dim == -2 else -2] if fsdp is not None
                      else []):
        if nd + d >= 0 and shape[d] % size == 0 and shape[d] >= size:
            return nd + d
    return None


def serve_model_dim(path, shape, size: int, *, integer=False):
    """The dim of a serving-state leaf that the reference's
    ``serve_shardings`` puts a ``model`` group of ``size`` on (its model
    half; the batch dim's ``data`` placement aside): a KV cache's nkv when
    it divides, else its hd; no dim for ``pos`` tags, 0-d and integer
    leaves; else the last dim that divides."""
    names = _names(path)
    name = names[-1] if names else ""
    nd = len(shape)
    if name == "pos" or nd == 0 or integer:
        return None
    if name in ("k", "v") and nd >= 4:
        for d in (nd - 2, nd - 1):
            if shape[d] % size == 0:
                return d
        return None
    return next((d for d in range(nd - 1, -1, -1)
                 if shape[d] % size == 0 and shape[d] >= size), None)


class Split(NamedTuple):
    """Where a leaf lies over a ``model`` group: ``dim`` cut into ``parts``
    equal pieces. With ``parts`` equal to the group's size each rank holds
    one piece; with fewer (KV heads fewer than the ranks) each piece is
    held by ``size // parts`` ranks in a row."""
    dim: int
    parts: int

    def piece(self, index: int, size: int) -> int:
        return index * self.parts // size


def check_tp(cfg, size: int):
    """Raise ``ValueError`` unless a ``model`` group of ``size`` can split
    ``cfg``'s forward: whole query heads a rank; KV heads a whole number a
    rank, or each shared by ``size // n_kv_heads`` ranks; d_ff, experts,
    d_model and the vocabulary in equal parts."""
    why = []
    if cfg.n_heads % size:
        why.append(f"{cfg.n_heads} query heads")
    if cfg.n_kv_heads % size and size % cfg.n_kv_heads:
        why.append(f"{cfg.n_kv_heads} KV heads (neither divides the other)")
    for what, n in (("d_ff", cfg.d_ff), ("experts", cfg.n_experts),
                    ("d_model", cfg.d_model), ("vocab", cfg.vocab_size)):
        if n % size:
            why.append(f"{what} {n}")
    if why:
        raise ValueError(f"{cfg.name} does not split over a model group of "
                         f"{size}: " + ", ".join(why))


def tp_split(cfg, path, shape, size: int):
    """The ``Split`` of a parameter leaf in the port's tensor-parallel
    forward over a ``model`` group of ``size`` (None: replicated). It is
    the reference's ``model_dim`` with ``size`` parts, except for the
    leaves ``placed_apart`` lists."""
    names = _names(path)
    name = names[-1] if names else ""
    nd = len(shape)
    if "moe" in names and "shared" not in names and name in _EXPERT_TABLES:
        dim = nd - 3
    elif name in _COLUMN:
        dim = nd - 1
    elif name in _ROW:
        dim = nd - 2
    else:
        return None
    parts = size
    if name in _KV and cfg.n_kv_heads % size:
        parts = cfg.n_kv_heads        # whole heads, replicated
    if shape[dim] % parts:
        raise ValueError(f"{'/'.join(names)}: dim {dim} of {tuple(shape)} "
                         f"does not split in {parts}")
    return Split(dim, parts)


def state_split(cfg, path, shape, size: int):
    """The ``Split`` of a serving-state leaf: a KV cache on its heads (in
    ``n_kv_heads`` parts, replicated, where there are fewer heads than
    ranks), ``pos`` tags replicated."""
    names = _names(path)
    name = names[-1] if names else ""
    if name in ("k", "v") and len(shape) >= 4:
        return Split(len(shape) - 2, min(cfg.n_kv_heads, size))
    return None


def shard_leaf(x, split, index: int, size: int):
    """Rank ``index``'s piece of a leaf (a tensor's narrowed view, a numpy
    array's slice) of a group of ``size``; the leaf itself when ``split``
    is None."""
    if split is None:
        return x
    n = x.shape[split.dim] // split.parts
    start = split.piece(index, size) * n
    if isinstance(x, torch.Tensor):
        return x.narrow(split.dim, start, n)
    return x[(slice(None),) * split.dim + (slice(start, start + n),)]


def model_group(mesh, plan: MeshPlan):
    """This rank's ``model`` group of ``mesh`` (``plan.model_axes``)."""
    return mesh.group(tuple(a for a in mesh.axis_names
                            if a in plan.model_axes))


def shard_params(cfg, params, mesh, plan: MeshPlan):
    """This rank's shard of a full parameter tree for tensor-parallel
    serving over ``mesh``'s ``model`` group (``tp_split``): the port's
    tensors, each split leaf copied out of the full one (so that the full
    tree can be freed), or the reference's numpy tree, cut and carried
    across by ``models.registry.params_from_numpy`` onto ``mesh.device``.
    A group of one returns ``params``."""
    from repro_torch.core.engine import tree_from_items, tree_items
    group = model_group(mesh, plan)
    if group.size == 1:
        return params
    items = tree_items(params)
    if not isinstance(items[0][1], torch.Tensor):
        from repro_torch.models.registry import params_from_numpy
        return params_from_numpy(cfg, params, device=mesh.device,
                                 mesh=mesh, plan=plan)
    out = []
    for path, leaf in items:
        split = tp_split(cfg, path, leaf.shape, group.size)
        out.append((path, leaf if split is None else shard_leaf(
            leaf, split, group.index, group.size).clone()))
    return tree_from_items(out)


def placed_apart(cfg, size: int):
    """``{path: (reference dim, port Split)}``: the parameter and KV-cache
    leaves of ``cfg`` where the port's split over a ``model`` group of
    ``size`` is not the reference's (``model_dim`` / ``serve_model_dim``
    in ``size`` parts). Read off meta-device trees."""
    from repro_torch.core.engine import tree_items
    from repro_torch.models import transformer as lm
    out = {}
    params = lm.init_lm(cfg, None, device="meta")
    states = lm.init_states(cfg, 1, 1, torch.float32, device="meta")
    for tree, ref_dim, port in ((params, model_dim, tp_split),
                                (states, serve_model_dim, state_split)):
        for path, leaf in tree_items(tree):
            ref = ref_dim(path, leaf.shape, size)
            got = port(cfg, path, leaf.shape, size)
            if got != (None if ref is None else Split(ref, size)):
                out["/".join(path)] = (ref, got)
    return out
