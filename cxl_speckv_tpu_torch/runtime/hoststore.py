"""The host-DRAM tier and block migration between it and the device pools.

Counterpart of `cxl_speckv_tpu/runtime/hoststore.py`. The host tier is a set
of CPU tensors, pinned when the pools live on the card, in the JAX store's
ROW layout over (slot, layer):

    k, v   [(host_slots + 1) * L, Hkv, bs, D/pack]   row = slot * L + layer
    ks, vs [(host_slots + 1) * L, Hkv, bs] float32

One extra guard slot (its L rows) absorbs padded lanes. The port's device
pools [L, S + 1, Hkv, bs, D/pack] hold K token-major like V, so a block
moves between the tiers as a plain row copy, and a block's L rows are one
contiguous run of the store (`DeviceHostStore.units(0, L)`).

A migration batch (`pad_migration`'s [4, M] array) moves in two ways:

- `migrate_program`, the plain synchronous version (the CPU path and the
  tests): gathers the demoted blocks' rows from the pools and scatters
  them into the store, then gathers the promoted blocks' rows from the
  store and scatters them into the pools, in place.
- `copy_batch`, the card's: demotes gather the pool rows into a device slab
  and copy each slot's L-row run straight into the pinned store, promotes
  copy each slot's run into a device slab and scatter it into the pools;
  every copy `non_blocking=True` on the caller's current stream. Nothing
  indexes the store with a row list and nothing passes through pageable
  memory. The served path issues it on the cache's copy stream
  (`CopyStream`), so migrations overlap the rounds; a fused round issues
  it on the round's own stream (`models.llama.decode_round_fused`).

Both read the pools for the demotes before the promotes write them (a
demoted slot may be a promote target of the same batch; the JAX
`migrate_in_graph` rule), and give the same bytes.

The host-streamed path reads and writes the store in place of the pools
(the JAX `StoreOps` reads and writes): `fetch_layer` stages one layer's rows
of a wave of blocks, `stage_layers` a group of layers, `fetch_blocks` whole
blocks (all L rows), and `stash_blocks` writes device slabs back. Each
slot's run is ONE `copy_` between the pinned store and the device slab,
`non_blocking=True`, all of a call's runs issued by one
`torch._foreach_copy_`, through views of every slot's run that the store
builds once per (first layer, layer count) (`DeviceHostStore.units`), so a
call costs a list lookup a slot on the host. Nothing indexes the store with
a row list (`store[rows]` on a pinned tensor returns PAGEABLE memory, whose
upload is synchronous through a bounce buffer) and no CPU thread gathers
rows first.

Ordering crosses two streams on the card. The streamed path copies on the
caller's current stream, migrations on the copy stream:
- a batch's copy stream first waits for everything queued on the current
  stream (`CopyStream.wait_for_compute`), so a demote reads a block after
  the last round that wrote it, a promote writes a slot after every round
  already dispatched that may read its old contents, and a migration
  touches store rows after every streamed stash or read queued before it;
- a round waits (on the device) for the batches that promote into a slot
  it reads (`TieredKVCache.order_round`), and the streamed path for every
  batch in flight (`TieredKVCache.order_after_migrations`), so a streamed
  stash never races a demote's copy into a reused host slot;
- a demoted HBM slot is held out of the free list until its batch's event
  completes (`runtime/transfer.py`), and the batch's tensors live as long.
The host never reads or writes store rows while a copy of them is in
flight: on the card every access to the store is a device copy, and
`migrate_program`'s host-side indexing runs only on the CPU path, where
nothing is in flight; the engine copies each streamed dispatch's tokens to
the host after its stash, which waits for the stream.
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
    """Apply one migration batch in place, both directions, synchronously
    (the plain version of `copy_batch`; the CPU path).

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


def copy_batch(pools, store: DeviceHostStore, mig: np.ndarray,
               mark=None) -> tuple:
    """Issue one migration batch on the current stream (see the module
    docstring): `migrate_program`'s result, copied straight between the
    pools and the store's per-slot runs. Returns the tensors the copies
    use, which must live until they complete. `mark(name, n)`, when given,
    is called before the demotes ("down", their count), before the promotes
    ("up") and after them ("end", 0): the copy stream's timing points."""
    L = pools[0].shape[0]
    dev = pools[0].device
    pool_guard = pools[0].shape[1] - 1
    up_host, up_hbm, down_hbm, down_host = (np.asarray(m) for m in mig)
    runs = store.units(0, L)
    down = down_hbm != pool_guard
    up = up_hbm != pool_guard
    keep = []
    if mark is not None:
        mark("down", int(down.sum()))
    if down.any():
        # slot by slot: no index tensor to upload, so nothing here
        # allocates pinned memory (which can synchronize the device)
        src = down_hbm[down].tolist()
        hs = down_host[down].tolist()
        for pool, views in zip(pools, runs):
            slab = torch.stack([pool[:, s] for s in src])
            torch._foreach_copy_([views[h] for h in hs], list(slab.unbind(0)),
                                 non_blocking=True)
            keep.append(slab)
    if mark is not None:
        mark("up", int(up.sum()))
    if up.any():
        dst = up_hbm[up].tolist()
        hs = up_host[up].tolist()
        for pool, views in zip(pools, runs):
            slab = torch.empty((len(hs), *views[0].shape), dtype=pool.dtype,
                               device=dev)
            torch._foreach_copy_(list(slab.unbind(0)), [views[h] for h in hs],
                                 non_blocking=True)
            torch._foreach_copy_([pool[:, s] for s in dst],
                                 list(slab.unbind(0)))
            keep.append(slab)
    if mark is not None:
        mark("end", 0)
    return tuple(keep)


def apply_batch(pools, store: DeviceHostStore, mig: np.ndarray) -> None:
    """One batch on the current stream, as a fused round applies it:
    `copy_batch` for pools on the card, `migrate_program` on the CPU."""
    if pools[0].is_cuda:
        copy_batch(pools, store, mig)
    else:
        migrate_program(pools, store, mig)


class CopyStream:
    """The cache's migration stream on the card: one `torch.cuda.Stream`
    and a CUDA event a batch (the completion `runtime/transfer.py` polls).
    With `timings` a list, each batch appends [(name, n, event), ...] at
    `copy_batch`'s marks, for the copy stream's own time a direction."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.timings: list | None = None

    def wait_for_compute(self) -> None:
        """The copy stream waits for everything queued on the current
        stream so far (a device-side wait; the host goes on)."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def run(self, fn):
        """`fn(mark)` on the copy stream; returns (the event recorded after
        it, what fn returned)."""
        marks = mark = None
        if self.timings is not None:
            marks = []

            def mark(name, n):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(self.stream)
                marks.append((name, n, ev))
        with torch.cuda.stream(self.stream):
            out = fn(mark)
        done = torch.cuda.Event()
        done.record(self.stream)
        if marks is not None:
            self.timings.append(marks)
        return done, out

    def compute_waits(self, done) -> None:
        """The current stream waits (on the device) for `done`."""
        torch.cuda.current_stream(self.device).wait_event(done)


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
