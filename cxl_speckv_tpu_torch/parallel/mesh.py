"""The device mesh of one process a rank, and the collectives the model
calls.

Counterpart of `cxl_speckv_tpu/parallel/mesh.py` (`make_mesh`,
`single_device_mesh`). The JAX package lays a `jax.sharding.Mesh` over its
devices and lets XLA insert the collectives; here every rank is one process
of a `torch.distributed` world, and the model issues its collectives itself
through `Mesh.all_reduce` / `Mesh.all_gather`.

Axes, as in the JAX package ("dp", "ep", "tp"; tp innermost):

- "dp": data parallel, batch lanes split across it;
- "ep": expert parallel, MoE experts split across it (size 1 for dense
  models);
- "tp": tensor parallel, weight columns / rows, KV heads and the vocabulary
  split across it.

Rank r sits at (dp, ep, tp) = (r // (ep * tp), (r // tp) % ep, r % tp): the
rank-major layout of `np.reshape(devices, (dp, ep, tp))`. Every axis subset
that a collective names gets one group per fixed coordinate of the other
axes, made at construction by every rank in the same order (a
`torch.distributed.new_group` call is collective).

Which backend runs a collective:

- NCCL (one card a rank) runs both collectives on the card.
- gloo (CPU tensors, and ranks that share one card) runs both on CPU
  tensors and takes both on CUDA tensors too, copying through host memory
  inside the backend: with PyTorch 2.11 on the H100, `chip_smoke.py`'s
  `[parallel]` phase issues each of `GLOO_CUDA_OPS` on a CUDA tensor under
  gloo and fails if one is refused. So no collective is routed around its
  backend, and nothing falls back silently: `Mesh.stats` names the backend
  of every collective issued.

World 1 is the degenerate mesh: every axis has size 1 and no collective is
issued.

`LineMesh` is the one-axis mesh of offline scoring ("pp" for
`parallel/pipeline.py`, "sp" for `parallel/ring.py`) over ranks 0 ... S-1
of the world, the counterpart of the JAX package's
`Mesh(devices[:S], ("pp",))`. Its operations, each counted and timed in
`LineMesh.stats()` under its name and route:

- `shift`: one hop along the line, the counterpart of `lax.ppermute`.
  gloo's point-to-point takes CPU tensors only (the `torch.distributed`
  backend table; with PyTorch 2.11 on the H100 a rank that sends a CUDA
  tensor aborts in gloo's TCP transport, "writev ... Bad address", as
  `chip_smoke.py`'s `--mode p2p` probe records), so under gloo a shift of
  CUDA tensors copies through pinned host buffers, the route "gloo-host",
  chosen when the mesh is built from its backend and device; NCCL and gloo
  on the CPU send the tensors themselves;
- `broadcast` from one rank of the line to the whole world;
- `all_gather` along the line.

The broadcast and the gather run on CUDA tensors under gloo itself, as the
(dp, ep, tp) collectives do (`GLOO_CUDA_OPS`).
"""

from __future__ import annotations

import itertools
import time
from collections import defaultdict

import torch
import torch.distributed as dist

from cxl_speckv_tpu_torch.parallel import distributed

AXES = ("dp", "ep", "tp")

# the collectives both meshes issue on CUDA tensors under gloo itself (the
# module docstring); `chip_smoke.py` checks that gloo takes each
GLOO_CUDA_OPS = ("all_reduce", "all_gather", "broadcast")


def coords_of(rank: int, ep: int, tp: int) -> dict[str, int]:
    """(dp, ep, tp) coordinates of `rank`, tp innermost."""
    return {"dp": rank // (ep * tp), "ep": (rank // tp) % ep, "tp": rank % tp}


def rank_of(coords: dict[str, int], ep: int, tp: int) -> int:
    return (coords["dp"] * ep + coords["ep"]) * tp + coords["tp"]


def reduce_in_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over `group` in float32 (a new tensor in x's dtype). The
    partials are widened before the reduce, so the only rounding to a
    narrower activation dtype is the one after it."""
    y = x.float().contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def gather_in_group(x: torch.Tensor, group, size: int,
                    dim: int) -> torch.Tensor:
    """Concatenation along `dim` of every group member's `x` (equal shapes),
    in group-rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _Counted:
    """Per-operation counts, bytes and (while `timing` is on) times: CUDA
    events around an operation on CUDA tensors, the host clock otherwise."""

    backend = "none"

    def _init_stats(self) -> None:
        self.timing = False
        self._stats: dict = defaultdict(lambda: {"calls": 0, "bytes": 0,
                                                 "ms": 0.0})
        self._pending: list = []

    def _timed(self, op: str, x: torch.Tensor, fn, route: str | None = None,
               nbytes: int | None = None):
        st = self._stats[(op, f"{self.backend}-{route or x.device.type}")]
        st["calls"] += 1
        st["bytes"] += (x.numel() * x.element_size() if nbytes is None
                        else nbytes)
        if not self.timing:
            return fn()
        if x.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            self._pending.append((st, a, b))
            return out
        t0 = time.perf_counter()
        out = fn()
        st["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def stats(self) -> dict:
        """{"<op>/<backend>-<route>": {"calls", "bytes", "ms"}} since the
        last reset, the route being the tensors' device or "host" (a copy
        through pinned host buffers); ms only while `timing` was on.
        Reading it synchronizes the pending CUDA events."""
        for st, a, b in self._pending:
            b.synchronize()
            st["ms"] += a.elapsed_time(b)
        self._pending.clear()
        return {f"{op}/{where}": dict(v)
                for (op, where), v in sorted(self._stats.items())}

    def reset_stats(self) -> None:
        self._pending.clear()
        self._stats.clear()


class Mesh(_Counted):
    """This rank's place in a (dp, ep, tp) mesh and its collective groups.

    Build it on every rank of an initialized world of dp * ep * tp ranks
    (`parallel.distributed.initialize`), or with nothing initialized for
    the one-rank mesh. `timing` True brackets every collective with CUDA
    events (host clock for CPU tensors); `stats()` then sums their time."""

    def __init__(self, dp: int = 1, ep: int = 1, tp: int = 1, *,
                 local: bool = False):
        """`local` True: the one-rank mesh of this process alone, whatever
        world it belongs to."""
        world = (dist.get_world_size()
                 if dist.is_initialized() and not local else 1)
        if dp * ep * tp != world:
            raise ValueError(f"dp*ep*tp = {dp}*{ep}*{tp} != world size "
                             f"{world}")
        self.shape = {"dp": dp, "ep": ep, "tp": tp}
        self.rank = dist.get_rank() if world > 1 else 0
        self.world = world
        self.coords = coords_of(self.rank, ep, tp)
        self.backend = dist.get_backend() if world > 1 else "none"
        self._init_stats()
        self._groups: dict[tuple, object] = {}
        if world > 1:
            self._make_groups()

    def _make_groups(self) -> None:
        dp, ep, tp = (self.shape[a] for a in AXES)
        for n in range(1, len(AXES) + 1):
            for axes in itertools.combinations(AXES, n):
                if self.size(axes) == 1 or self.size(axes) == self.world:
                    continue
                rest = [a for a in AXES if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    base = dict(zip(rest, fixed))
                    ranks = [rank_of({**base, **dict(zip(axes, v))}, ep, tp)
                             for v in itertools.product(
                                 *(range(self.shape[a]) for a in axes))]
                    g = distributed.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g
        # a subset spanning every rank is the world group
        for n in range(1, len(AXES) + 1):
            for axes in itertools.combinations(AXES, n):
                if self.size(axes) == self.world:
                    self._groups[axes] = dist.group.WORLD

    # -- shape ------------------------------------------------------------

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's position along `axes` (row-major, as the group's
        rank order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    @property
    def tp(self) -> int:
        return self.shape["tp"]

    @property
    def dp(self) -> int:
        return self.shape["dp"]

    @property
    def ep(self) -> int:
        return self.shape["ep"]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, ep={self.ep}, tp={self.tp}, "
                f"rank={self.rank}, backend={self.backend})")

    # -- collectives --------------------------------------------------------

    def _group(self, axes):
        axes = tuple(a for a in AXES
                     if a in ((axes,) if isinstance(axes, str) else axes))
        return axes, self._groups[axes]

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum of `x` over `axes` (a name or a tuple of names), reduced in
        float32 and returned in x's dtype; `x` itself when the axes have
        size 1."""
        if self.size(axes) == 1:
            return x
        _, g = self._group(axes)
        return self._timed("all_reduce", x, lambda: reduce_in_group(x, g))

    def all_gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Every member's `x` along `axes`, concatenated along `dim` in
        their order; `x` itself when the axes have size 1."""
        n = self.size(axes)
        if n == 1:
            return x
        _, g = self._group(axes)
        return self._timed("all_gather", x,
                           lambda: gather_in_group(x, g, n, dim))

    def agree(self, value):
        """Rank 0's `value` (any picklable object) on every rank: a choice
        that a rank makes from its own measurement (the derived decode
        horizon) must be the same everywhere."""
        if self.world == 1:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]


class LineMesh(_Counted):
    """This rank's place on the one-axis mesh `axis` ("pp" or "sp") over
    ranks 0 ... size - 1 of the initialized world (`size` None: the whole
    world; with nothing initialized, the one-rank line). Line index i is
    world rank i. A rank past the line has `index` None: it runs no part of
    the forward and takes part only in the broadcast that gives every rank
    of the world the result. `device` is where the operations' tensors
    live; under gloo, CUDA tensors shift through pinned host buffers
    (`route` "host", the module docstring).

    Build it on every rank of the world (a line shorter than the world is a
    subgroup, made collectively) and `close()` it on every rank, or use it
    as a context manager. `timing` True times every operation (CUDA events
    on CUDA tensors, the host clock otherwise); `stats()` sums them."""

    def __init__(self, axis: str, size: int | None = None, *,
                 device="cpu"):
        world = dist.get_world_size() if dist.is_initialized() else 1
        size = world if size is None else size
        if not 1 <= size <= world:
            raise ValueError(
                f"{axis}={size} needs {size} ranks, and the world has "
                f"{world} (start one with parallel/distributed.py)")
        self.axis, self.size, self.world = axis, size, world
        self.rank = dist.get_rank() if world > 1 else 0
        self.index = self.rank if self.rank < size else None
        self.backend = dist.get_backend() if world > 1 else "none"
        self.device = torch.device(device)
        self.route = ("host" if self.backend == "gloo"
                      and self.device.type == "cuda" else self.device.type)
        self._init_stats()
        self._pinned: dict = {}
        self._own_group = 1 < size < world
        self.group = (distributed.new_group(list(range(size)))
                      if self._own_group else dist.group.WORLD)

    def __repr__(self) -> str:
        return (f"LineMesh({self.axis}={self.size}, index={self.index}, "
                f"world={self.world}, backend={self.backend}, "
                f"route={self.route})")

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Free the line's subgroup (every rank of the world calls it)."""
        if self._own_group:
            if self.index is not None:
                dist.destroy_process_group(self.group)
            self._own_group = False

    def _host_buffer(self, tag: str, like: torch.Tensor) -> torch.Tensor:
        key = (tag, tuple(like.shape), like.dtype)
        if key not in self._pinned:
            self._pinned[key] = torch.empty(like.shape, dtype=like.dtype,
                                            pin_memory=True)
        return self._pinned[key]

    def _p2p(self, x, recv):
        i = self.index
        nxt, prv = (i + 1) % self.size, (i - 1) % self.size
        if self.route == "host":
            sx = None if x is None else self._host_buffer("send", x).copy_(x)
            rx = None if recv is None else self._host_buffer("recv", recv)
        else:
            sx, rx = (None if x is None else x.contiguous()), recv
        ops = []
        if sx is not None:
            ops.append(dist.P2POp(dist.isend, sx, nxt, self.group))
        if rx is not None:
            ops.append(dist.P2POp(dist.irecv, rx, prv, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if rx is not recv:
            recv.copy_(rx)
        return recv

    def shift(self, x: torch.Tensor | None,
              recv: torch.Tensor | None) -> torch.Tensor | None:
        """One hop along the line, the counterpart of `lax.ppermute`: send
        `x` to index (index + 1) % size and receive into `recv` (contiguous)
        from index (index - 1) % size, both posted at once, so that no ring
        deadlocks; None on either side: nothing that way (the pipeline's
        open line passes None at its ends). Returns `recv`, filled. Counts
        the bytes this rank sent and received. A tensor on another device
        type than the line was built for raises (its route was chosen for
        that type: gloo aborts the process on a CUDA tensor's send)."""
        for t in (x, recv):
            if t is not None and t.device.type != self.device.type:
                raise ValueError(f"a {t.device.type} tensor on a line built "
                                 f"for {self.device.type} tensors")
        if self.size == 1 or (x is None and recv is None):
            return recv
        nbytes = sum(t.numel() * t.element_size()
                     for t in (x, recv) if t is not None)
        return self._timed("shift", x if x is not None else recv,
                           lambda: self._p2p(x, recv), route=self.route,
                           nbytes=nbytes)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Line index `src`'s `x` on every rank of the world, in place:
        every rank passes a contiguous tensor of the same shape and dtype.
        `x` itself in a world of one."""
        if self.world == 1:
            return x

        def call():
            dist.broadcast(x, src=src)
            return x

        return self._timed("broadcast", x, call)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every line member's `x` concatenated along `dim` in line order
        (members only); `x` itself on a line of one."""
        if self.size == 1:
            return x
        return self._timed("all_gather", x, lambda: gather_in_group(
            x, self.group, self.size, dim))


def make_mesh(dp: int = 1, tp: int | None = None, ep: int = 1) -> Mesh:
    """The mesh over the initialized world (`tp` None: whatever dp * ep
    leaves), as the JAX `make_mesh` lays one over its devices."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        tp = world // (dp * ep)
    return Mesh(dp=dp, ep=ep, tp=tp)


def single_device_mesh() -> Mesh:
    """The one-rank mesh: no collective is ever issued."""
    return Mesh(local=True)
