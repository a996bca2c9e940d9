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
  `[parallel]` phase issues each of `COLLECTIVES` on a CUDA tensor under
  gloo and fails if one is refused. So no collective is routed around its
  backend, and nothing falls back silently: `Mesh.stats` names the backend
  of every collective issued.

World 1 is the degenerate mesh: every axis has size 1 and no collective is
issued.
"""

from __future__ import annotations

import itertools
import time
from collections import defaultdict

import torch
import torch.distributed as dist

AXES = ("dp", "ep", "tp")

# the collectives the model issues; gloo must take each on a CUDA tensor
# (the module docstring)
COLLECTIVES = ("all_reduce", "all_gather")


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


class Mesh:
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
        self.timing = False
        self._groups: dict[tuple, object] = {}
        self._stats: dict = defaultdict(lambda: {"calls": 0, "bytes": 0,
                                                 "ms": 0.0})
        self._pending: list = []
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
                    g = dist.new_group(sorted(ranks))
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

    def _timed(self, op: str, x: torch.Tensor, fn):
        st = self._stats[(op, f"{self.backend}-{x.device.type}")]
        st["calls"] += 1
        st["bytes"] += x.numel() * x.element_size()
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

    # -- statistics ---------------------------------------------------------

    def stats(self) -> dict:
        """{"<op>/<backend>-<device>": {"calls", "bytes", "ms"}} since the
        last reset
        (ms only while `timing` was on); reading it synchronizes the
        pending CUDA events."""
        for st, a, b in self._pending:
            b.synchronize()
            st["ms"] += a.elapsed_time(b)
        self._pending.clear()
        return {f"{op}/{where}": dict(v)
                for (op, where), v in sorted(self._stats.items())}

    def reset_stats(self) -> None:
        self._pending.clear()
        self._stats.clear()


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
