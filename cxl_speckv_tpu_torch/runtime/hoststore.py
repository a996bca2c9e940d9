"""The host-DRAM tier and block migration between it and the device pools.

Counterpart of `cxl_speckv_tpu/runtime/hoststore.py`. The host tier is a set
of CPU tensors, pinned when the pools live on the card, in the JAX store's
ROW layout over (slot, layer):

    k, v   [(host_slots + 1) * L, Hkv, bs, D/pack]   row = slot * L + layer
    ks, vs [(host_slots + 1) * L, Hkv, bs] float32

One extra guard slot (its L rows) absorbs padded lanes. The port's device
pools [L, S + 1, Hkv, bs, D/pack] hold K token-major like V, so a block
moves between the tiers as a plain row copy: `migrate_program` gathers the
demoted blocks' rows from the pools and scatters them into the store, then
gathers the promoted blocks' rows from the store and scatters them into
the pools, in place. Copies between the card and the host are synchronous
with the host here (the JAX program chained them by dataflow); overlapping
them with compute is later work.

The host-streamed path reads and writes the store in place of the pools
(the JAX `StoreOps` reads and writes): `fetch_layer` stages one layer's rows
of a wave of blocks, `stage_layers` a group of layers, `fetch_blocks` whole
blocks (all L rows), and `stash_blocks` writes device slabs back. Row =
slot * L + layer, so a block's rows of consecutive layers are one
contiguous run of pinned memory: each slot's run is ONE `copy_` between
the pinned store and the device slab, `non_blocking=True`, all of a call's
runs issued by one `torch._foreach_copy_`, through views of every slot's
run that the store builds once per (first layer, layer count)
(`DeviceHostStore.units`), so a call costs a list lookup a slot on the
host. Nothing indexes the store with a row list (`store[rows]` on a pinned
tensor returns PAGEABLE memory, whose upload is synchronous through a
bounce buffer) and no CPU thread gathers rows first.

Ordering: every copy runs on the caller's current CUDA stream, so a stash
(device -> host) lands before any later read of those rows (host -> device)
by stream order, and the engine copies each streamed dispatch's tokens to
the host after its stash, which waits for the stream, so the host never
touches store rows (`migrate_program`'s host-side indexing) with a stash
still in flight.
"""

from __future__ import annotations

import numpy as np
import torch

# migration lanes per direction in one migrate batch (the descriptor-ring
# depth analog, as in the JAX package)
MIGRATE_BATCH = 16


class DeviceHostStore:
    """The host-DRAM tier (see module docstring)."""

    def __init__(self, host_slots: int, num_layers: int, block_size: int,
                 num_kv_heads: int, head_dim_packed: int,
                 kv_elem_dtype: torch.dtype, pin: bool):
        self.host_slots = host_slots
        self.num_layers = num_layers
        rows = (host_slots + 1) * num_layers
        shape = (rows, num_kv_heads, block_size, head_dim_packed)
        self.k = torch.zeros(shape, dtype=kv_elem_dtype, pin_memory=pin)
        self.v = torch.zeros(shape, dtype=kv_elem_dtype, pin_memory=pin)
        self.ks = torch.ones(shape[:-1], dtype=torch.float32, pin_memory=pin)
        self.vs = torch.ones(shape[:-1], dtype=torch.float32, pin_memory=pin)
        # host -> device bytes staged by the streamed path (`gather_units`)
        self.staged_bytes = 0
        # a list to time the staging copies: each `gather_units` then
        # appends a (start, end) CUDA event pair recorded around its copies
        self.copy_events: list | None = None
        self._units: dict = {}

    @property
    def guard_slot(self) -> int:
        return self.host_slots

    @property
    def arrays(self):
        return (self.k, self.v, self.ks, self.vs)

    def units(self, l0: int, n: int) -> list[tuple]:
        """Per array, a view of every slot's rows l0 .. l0 + n - 1 (one
        contiguous run each), indexed by slot; built at first use."""
        if (l0, n) not in self._units:
            S = self.host_slots + 1
            self._units[l0, n] = [
                a.view(S, self.num_layers, *a.shape[1:])[:, l0:l0 + n]
                .unbind(0) for a in self.arrays]
        return self._units[l0, n]

    @property
    def bytes_per_row(self) -> int:
        """Bytes of one (slot, layer) row over k, v and their scales."""
        return sum(a[0].numel() * a.element_size() for a in self.arrays)

    @property
    def bytes_per_block(self) -> int:
        return self.bytes_per_row * self.num_layers


def block_rows(slots: np.ndarray, num_layers: int) -> torch.Tensor:
    """[M] slot ids -> [M * L] store row ids (slot-major)."""
    rows = (np.asarray(slots, np.int64)[:, None] * num_layers
            + np.arange(num_layers, dtype=np.int64)[None, :])
    return torch.from_numpy(rows.reshape(-1))


def gather_units(store: DeviceHostStore, slots, l0: int, n: int, device):
    """Rows l0 .. l0 + n - 1 of each slot -> device slabs (k, v
    [M, n, Hkv, bs, Dp], ks, vs [M, n, Hkv, bs]) in `slots`' order: one
    non-blocking copy a slot and array."""
    device = torch.device(device)
    slots = np.asarray(slots).reshape(-1).tolist()
    timed = store.copy_events is not None and device.type == "cuda"
    if timed:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    out = []
    for views, src in zip(store.units(l0, n), store.arrays):
        dst = torch.empty((len(slots), n, *src.shape[1:]), dtype=src.dtype,
                          device=device)
        if slots:
            torch._foreach_copy_(list(dst.unbind(0)),
                                 [views[s] for s in slots], non_blocking=True)
        out.append(dst)
    if timed:
        ev[1].record()
        store.copy_events.append(ev)
    store.staged_bytes += len(slots) * n * store.bytes_per_row
    return tuple(out)


def fetch_blocks(store: DeviceHostStore, slots, device):
    """Whole blocks (all L rows of each slot) -> device slabs
    [M, L, Hkv, bs, *]."""
    return gather_units(store, slots, 0, store.num_layers, device)


def stash_blocks(store: DeviceHostStore, slabs, slots) -> None:
    """Device slabs [M, L, Hkv, bs, *] -> the slots' rows (a slot listed
    twice takes its last slab)."""
    slots = np.asarray(slots).reshape(-1).tolist()
    for views, src in zip(store.units(0, store.num_layers), slabs):
        if slots:
            torch._foreach_copy_([views[s] for s in slots],
                                 list(src.unbind(0)), non_blocking=True)


def fetch_layer(store: DeviceHostStore, slots, layer: int, device):
    """Layer `layer` of the given slots -> device slabs [W, Hkv, bs, *]."""
    return tuple(a[:, 0] for a in gather_units(store, slots, layer, 1,
                                                device))


def stage_layers(store: DeviceHostStore, slots, l0: int, g: int, device):
    """Layers l0 .. l0 + g - 1 of the given slots -> device slabs
    [W, g, Hkv, bs, *], slot-major: each slot's g rows are one run."""
    return gather_units(store, slots, l0, g, device)


def migrate_program(pools, store: DeviceHostStore, mig: np.ndarray) -> None:
    """Apply one migration batch in place, both directions.

    pools: (k, v, k_scale, v_scale) [L, S + 1, ...]; mig: [4, M] int32 rows
    (up_host, up_hbm, down_hbm, down_host) in SLOT units, pad lanes at the
    guard slots (`pad_migration`). Pad lanes move nothing. Demotes read the
    PRE-promote pools (a demoted slot may be a promote target of the same
    batch); the planner never routes one block both ways in a batch."""
    L = pools[0].shape[0]
    dev = pools[0].device
    pool_guard = pools[0].shape[1] - 1
    up_host, up_hbm, down_hbm, down_host = (np.asarray(m) for m in mig)

    down = down_hbm != pool_guard
    if down.any():
        src = torch.from_numpy(down_hbm[down].astype(np.int64)).to(dev)
        rows = block_rows(down_host[down], L)
        for pool, st in zip(pools, store.arrays):
            slab = pool[:, src].transpose(0, 1).reshape(-1, *pool.shape[2:])
            st[rows] = slab.cpu()

    up = up_hbm != pool_guard
    if up.any():
        dst = torch.from_numpy(up_hbm[up].astype(np.int64)).to(dev)
        rows = block_rows(up_host[up], L)
        m = len(dst)
        for pool, st in zip(pools, store.arrays):
            slab = st[rows].reshape(m, L, *pool.shape[2:]).transpose(0, 1)
            pool[:, dst] = slab.to(dev)


def pad_migration(ups, downs, pool_guard: int, store_guard: int,
                  batch: int = MIGRATE_BATCH) -> np.ndarray:
    """Build the [4, M] mig array from up/down slot pair lists.

    ups:   [(host_slot, hbm_slot), ...]
    downs: [(hbm_slot, host_slot), ...]
    """
    m = max(batch, len(ups), len(downs))
    mig = np.empty((4, m), np.int32)
    mig[0] = store_guard
    mig[1] = pool_guard
    mig[2] = pool_guard
    mig[3] = store_guard
    for i, (hs, ds) in enumerate(ups):
        mig[0, i], mig[1, i] = hs, ds
    for i, (ds, hs) in enumerate(downs):
        mig[2, i], mig[3, i] = ds, hs
    return mig
