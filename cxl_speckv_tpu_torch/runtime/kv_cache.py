"""TieredKVCache — the memory system facade.

Counterpart of `cxl_speckv_tpu/runtime/kv_cache.py`: owns the device
pools, the host store, the residency directory, the per-sequence block pool
and the migration queue, and gives the engine

- `extend_seq` / `free_seq`: capacity allocation with OOM backpressure;
- `ensure_resident`: demand fetch for scheduled sequences;
- `prefetch_blocks`: asynchronous promote (the prefetch path);
- `maintain`: eviction to keep the prefetch landing zone free, plus
  migration of what is queued (left for the next fused round under
  `defer_migrations`: `take_migration_plan` / `commit_migration`);
- `order_round` / `order_after_migrations`: the device-side waits that
  order a round, or the streamed path, after the migrations it depends on;
- `retire_out_of_window`: the sliding-window rolling buffer (Mistral);
- the prefix cache (`match_prefix` / `claim_prefix` / `register_prefix`);
- `rebuild_storage`: new pools in another storage width, when idle.

Device pool layout (all layers stacked; one extra guard slot absorbs
padded writes):
    k_pools, v_pools    [L, hbm_slots + 1, Hkv, block_size, D/pack]
    k_scales, v_scales  [L, hbm_slots + 1, Hkv, block_size] float32 (init 1)
K is token-major like V (the JAX package stores it transposed for the TPU
matrix unit), which is the host store's row layout: migration is a row
copy. INT8 and FP8 share the int8 bytes, so blocks of both schemes (and of
a per-layer MIXED8 table) live in one pool.

Two host-tier backends (`CacheConfig.host_store_backend`), as in the JAX
package:

- "device" (the default): the host tier is a pinned store that the card
  reads and writes itself (`runtime/hoststore.py`), migrations are batches
  of `MigrationPlanner`;
- "numpy": a pageable host-process store with background-staged promotes
  and polled demotes (`runtime/transfer.py`'s `HostStore` and
  `TransferEngine`), branching where the JAX cache branches on
  `device_mode`. The engine serves no fused rounds and no host-streamed
  requests on it.

Two residency directories: the Python one (`core/directory.py`,
`core/block_pool.py`) or, with `native=True` or `SPECKV_NATIVE=1`, the C++
runtime of `native/` through ctypes (`cxl_speckv_tpu_torch/native`), of
the same semantics; a native directory that cannot be built raises.

In the device backend on the card every migration batch runs on the
cache's copy stream (`hoststore.CopyStream`, `hoststore.copy_batch`) and
nothing here blocks the host on it, except where an HBM slot is needed now
and the only one to be had is still being read by a demote (`_make_room`,
`extend_seq`: `MigrationPlanner.settle`). On the CPU (`copier` None) a batch is
`migrate_program`, complete when issued, so the CPU engine keeps the JAX
engine's transfer counts and slot choices.

On a tp mesh (`kv_heads` = Hkv / tp) the pools and the host store hold this
rank's kv heads only, and the byte statistics are this rank's. Under `lockstep`
(every mesh engine) a poll or flush waits for what it tests, so that the
directory changes at the same call on every rank and the ranks' schedulers
stay identical; the copies still run on the copy stream.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from cxl_speckv_tpu_torch.config import CacheConfig, KVDtype
from cxl_speckv_tpu_torch.core.block_pool import BlockPool
from cxl_speckv_tpu_torch.core.directory import (
    BlockState,
    DirectoryError,
    ResidencyDirectory,
)
from cxl_speckv_tpu_torch.core.stats import Statistics
from cxl_speckv_tpu_torch.models.configs import LlamaConfig
from cxl_speckv_tpu_torch.ops.quant import (
    compressed_bytes_per_token,
    kv_pack,
    kv_storage_dtype,
)
from cxl_speckv_tpu_torch.runtime.hoststore import (
    MIGRATE_BATCH,
    CopyStream,
    DeviceHostStore,
    copy_batch,
    migrate_program,
    pad_migration,
)
from cxl_speckv_tpu_torch.runtime.transfer import (
    HostStore,
    MigrationPlanner,
    TransferEngine,
)


@dataclass
class CacheRuntimeStatistics(Statistics):
    demand_fetch_events: int = 0     # scheduler had to stall for a block
    demand_fetch_blocks: int = 0
    maintain_demotes: int = 0
    migrate_dispatches: int = 0      # migrate batches applied
    window_retired_blocks: int = 0   # blocks freed by sliding-window retirement
    prefix_hit_blocks: int = 0       # prompt blocks reused via prefix cache
    prefix_tokens_reused: int = 0    # prompt tokens NOT re-prefilled


class TieredKVCache:
    def __init__(self, cache_config: CacheConfig, model_config: LlamaConfig,
                 max_seqs: int, max_blocks_per_seq: int,
                 device: str | torch.device = "cpu", copier=None,
                 native: bool | None = None, kv_heads: int | None = None,
                 lockstep: bool = False):
        """`copier`: what issues the device backend's migration batches
        (`hoststore.CopyStream`'s interface); None means a `CopyStream` on
        the card and the synchronous `migrate_program` on the CPU. `native`:
        the C++ directory and block pool; None follows `SPECKV_NATIVE=1`.
        `kv_heads`: the kv heads this cache holds (a tp rank's share; None
        means all of the model's); `lockstep`: see the module docstring."""
        cache_config.validate()
        self.config = cache_config
        self.model_config = model_config
        self.kv_heads = kv_heads or model_config.num_kv_heads
        self.lockstep = lockstep
        self.device = torch.device(device)
        self._device_mode = cache_config.host_store_backend == "device"
        if copier is None and self.device.type == "cuda" and self._device_mode:
            copier = CopyStream(self.device)
        self.copier = copier
        if native is None:
            native = os.environ.get("SPECKV_NATIVE") == "1"
        if native:
            from cxl_speckv_tpu_torch.native import (
                NativeBlockPool,
                NativeResidencyDirectory,
            )
            self.directory = NativeResidencyDirectory(cache_config)
            self.pool = NativeBlockPool(cache_config, self.directory,
                                        max_seqs, max_blocks_per_seq)
        else:
            self.directory = ResidencyDirectory(cache_config)
            self.pool = BlockPool(cache_config, self.directory, max_seqs,
                                  max_blocks_per_seq)
        self._prefix_map: dict[bytes, int] = {}
        self._alloc_storage(cache_config.kv_dtype)
        # blocks the scheduler expects to need soon (current + upcoming
        # decode groups): eviction takes them only as a last resort
        self.protected: set[int] = set()
        # blocks of the held decode group: evicted strictly after every
        # other candidate, including `protected`
        self.decode_hot: set[int] = set()
        # called when a demand fetch finds no HBM slot to free (every
        # resident block pinned, or the host tier too full to take a
        # demote): the engine frees an idle session's KV and returns True,
        # or returns False when it has none
        self.reclaim_hook = None
        # set by engines with fused rounds: maintain() leaves queued
        # migrations for the next round's batch (`take_migration_plan`)
        self.defer_migrations = False
        self.stats = CacheRuntimeStatistics()

    def _alloc_storage(self, kv_dtype: KVDtype) -> None:
        """(Re)allocate the pools and the host store in `kv_dtype`'s storage
        width; the directory and the tables do not depend on it."""
        self.kv_dtype = kv_dtype
        c = self.model_config
        cc = self.config
        dp = c.head_dim // kv_pack(kv_dtype)
        elem = kv_storage_dtype(kv_dtype)
        S = cc.num_hbm_blocks + 1     # + the guard slot
        kv_shape = (c.num_layers, S, self.kv_heads, cc.block_size, dp)
        dev = self.device
        self.k_pools = torch.zeros(kv_shape, dtype=elem, device=dev)
        self.v_pools = torch.zeros(kv_shape, dtype=elem, device=dev)
        self.k_scales = torch.ones(kv_shape[:-1], dtype=torch.float32,
                                   device=dev)
        self.v_scales = torch.ones(kv_shape[:-1], dtype=torch.float32,
                                   device=dev)
        if self._device_mode:
            self.store = DeviceHostStore(
                cc.num_host_blocks, c.num_layers, cc.block_size,
                self.kv_heads, dp, elem, pin=dev.type == "cuda")
            self.host = None
            self.transfer = MigrationPlanner(self.store.bytes_per_block)
        else:
            self.host = HostStore(cc.num_host_blocks, c.num_layers,
                                  cc.block_size, self.kv_heads, dp, elem)
            self.store = None
            self.transfer = TransferEngine(self.host, dev)
        self.transfer.lockstep = self.lockstep

    def rebuild_storage(self, kv_dtype: KVDtype) -> None:
        """Cross-width scheme switch (e.g. INT8 -> INT4 or -> BF16): new
        pools and host store in the new storage width. Only when no block
        is live, since bytes cannot be read across widths (same-width
        schemes switch on a live pool, `Engine.set_kv_dtype`). The
        directory stays; the prefix map clears (its blocks died with the
        last live sequence)."""
        d = self.directory
        self.transfer.poll(d, wait=True)
        if (d.hbm_free != self.config.num_hbm_blocks
                or d.host_free != self.config.num_host_blocks):
            raise ValueError(
                "cross-width scheme switch requires an idle cache "
                f"(live blocks: hbm {self.config.num_hbm_blocks - d.hbm_free}, "
                f"host {self.config.num_host_blocks - d.host_free})")
        self._prefix_map.clear()
        self.config.kv_dtype = kv_dtype
        self._alloc_storage(kv_dtype)

    @property
    def device_mode(self) -> bool:
        return self._device_mode

    @property
    def pools(self):
        return (self.k_pools, self.v_pools, self.k_scales, self.v_scales)

    @property
    def guard_slot(self) -> int:
        return self.config.num_hbm_blocks

    # -- migration ------------------------------------------------------------

    def dispatch_migrations(self, limit_batches: int | None = None) -> int:
        """Issue queued migrations, one batch per direction at a time
        (device backend). Returns blocks moved."""
        assert self._device_mode
        moved = 0
        batches = 0
        while self.transfer.queued:
            if limit_batches is not None and batches >= limit_batches:
                break
            ups, downs, up_bids, down_bids = self.transfer.take_plan(
                MIGRATE_BATCH)
            self._issue(ups, downs, up_bids, down_bids)
            moved += len(up_bids) + len(down_bids)
            batches += 1
            self.stats.migrate_dispatches += 1
        return moved

    def _issue(self, ups, downs, up_bids, down_bids) -> None:
        """One batch: `migrate_program` on the CPU; on the card
        `copy_batch` on the copy stream, in flight until its event."""
        mig = pad_migration(ups, downs, self.guard_slot,
                            self.store.guard_slot)
        if self.copier is None:
            migrate_program(self.pools, self.store, mig)
            self.transfer.commit(up_bids, down_bids, self.directory)
            return
        # a demote reads its block after the last round that wrote it, and
        # a promote writes its slot after every round already dispatched
        # that may read the slot's old contents
        self.copier.wait_for_compute()
        pools, store = self.pools, self.store
        done, keep = self.copier.run(
            lambda mark: copy_batch(pools, store, mig, mark))
        self.transfer.commit(up_bids, down_bids, self.directory, done=done,
                             up_slots=[d for _, d in ups], keep=keep)

    def _free_soon(self) -> int:
        """Free HBM slots, counting those held by demotes in flight."""
        return self.directory.hbm_free + self.transfer.inflight_down

    def _got_slot(self, before: int) -> bool:
        """True once hbm_free exceeds `before`; waits for a held slot when
        none came free otherwise."""
        if self.directory.hbm_free <= before:
            self.transfer.settle(self.directory, 1)
        return self.directory.hbm_free > before

    def order_round(self, slots) -> None:
        """Make the current stream wait (on the device) for the batches in
        flight that promote into any of `slots`, the HBM slots a round
        reads or writes. Other batches go on overlapping it."""
        if self.copier is None or not self.transfer.inflight:
            return
        self.transfer.poll(self.directory)
        for done in self.transfer.waits_for(
                np.unique(np.asarray(slots)).tolist()):
            self.copier.compute_waits(done)

    def order_after_migrations(self) -> None:
        """Make the current stream wait (on the device) for every batch in
        flight: the host-streamed path and fused rounds touch store rows
        and pool slots that a migration on the copy stream may still be
        copying (a reused host slot)."""
        if self.copier is None or not self.transfer.inflight:
            return
        self.transfer.poll(self.directory)
        if self.transfer.inflight:
            # the copy stream completes in order: its last event is enough
            self.copier.compute_waits(self.transfer.inflight[-1].done)

    def drain(self) -> None:
        """Issue every queued migration and wait until all have landed."""
        if not self._device_mode:
            self.transfer.drain(self.pools, self.directory)
            return
        self.dispatch_migrations()
        self.transfer.poll(self.directory, wait=True)

    def take_migration_plan(self):
        """Pop one migration batch for a fused round. Excess beyond one
        batch a direction is issued on its own first (rare). Returns
        (mig [4, M] int32, up_bids, down_bids); pass the ids to
        `commit_migration` right after dispatching the round."""
        assert self._device_mode
        while (self.transfer.pending_up > MIGRATE_BATCH
               or self.transfer.pending_down > MIGRATE_BATCH):
            self.dispatch_migrations(1)
        ups, downs, up_bids, down_bids = self.transfer.take_plan(
            MIGRATE_BATCH)
        mig = pad_migration(ups, downs, self.guard_slot,
                            self.store.guard_slot)
        return mig, up_bids, down_bids

    def commit_migration(self, up_bids: list[int],
                         down_bids: list[int]) -> None:
        """Finalize a fused round's batch: it ran on the round's stream, so
        it is complete for everything queued after the round."""
        self.transfer.commit(up_bids, down_bids, self.directory)
        self.pool.sync_moved()

    # -- sequence capacity ----------------------------------------------------

    def add_seq(self) -> int | None:
        return self.pool.add_seq()

    def extend_seq(self, seq_slot: int, new_total_tokens: int) -> bool:
        """Grow; on HBM pressure, evict cold blocks first. False = true OOM."""
        need = self.pool.blocks_needed(seq_slot, new_total_tokens)
        if need <= self.directory.hbm_free:
            return self.pool.extend(seq_slot, new_total_tokens)
        if not self._device_mode:
            self._evict(need - self.directory.hbm_free)
            if need > self.directory.hbm_free:
                # only clean drops free slots at once; dirty writebacks must
                # be flushed and completed first
                self.transfer.flush(self.pools, self.directory)
                self.transfer.poll(self.directory, wait=True)
        else:
            self.transfer.poll(self.directory)
            free = self._free_soon()
            if need > free:
                self._evict(need - free)
                # a demote's slot frees when its batch is issued, on the
                # card when its copies have completed
                self.dispatch_migrations()
            if need > self.directory.hbm_free:
                self.transfer.settle(self.directory,
                                     need - self.directory.hbm_free)
        return self.pool.extend(seq_slot, new_total_tokens)

    def free_seq(self, seq_slot: int) -> None:
        self.pool.free_seq(seq_slot)

    # -- prefix caching -------------------------------------------------------
    #
    # Content-addressed reuse of FULL prompt-prefix blocks: block i's key is
    # a chained blake2b over (scheme, tokens of blocks 0..i), so only true
    # prefixes (aligned at position 0) can match. Matched blocks are claimed
    # via BlockPool.share_block (refcounted); entries whose block died are
    # pruned on lookup.

    def _prefix_keys(self, prompt, scheme, upto_blocks: int) -> list[bytes]:
        bs = self.config.block_size
        keys = []
        digest = hashlib.blake2b(repr(scheme).encode(), digest_size=16).digest()
        for i in range(upto_blocks):
            h = hashlib.blake2b(digest, digest_size=16)
            h.update(np.asarray(prompt[i * bs:(i + 1) * bs],
                                np.int32).tobytes())
            digest = h.digest()
            keys.append(digest)
        return keys

    def match_prefix(self, prompt: list[int], scheme) -> tuple[int, list[int]]:
        """Longest cached full-block prefix of `prompt` under `scheme`.
        Returns (matched_tokens, bids); at least the prompt's last token is
        always left to recompute (its logits seed generation)."""
        if not self.config.enable_prefix_cache:
            return 0, []
        bs = self.config.block_size
        nb = (len(prompt) - 1) // bs
        bids: list[int] = []
        for key in self._prefix_keys(prompt, scheme, nb):
            bid = self._prefix_map.get(key)
            if bid is None or not self.pool.is_live(bid):
                if bid is not None:
                    self._prefix_map.pop(key, None)
                break
            bids.append(bid)
        return len(bids) * bs, bids

    def claim_prefix(self, seq_slot: int, bids: list[int]) -> None:
        for bid in bids:
            self.pool.share_block(seq_slot, bid)
        self.stats.prefix_hit_blocks += len(bids)
        self.stats.prefix_tokens_reused += len(bids) * self.config.block_size

    def register_prefix(self, seq_slot: int, prompt: list[int],
                        prefilled_tokens: int, scheme) -> None:
        """Publish a sequence's completed full prompt blocks for reuse.
        First live writer wins (claimants then share that block)."""
        if not self.config.enable_prefix_cache:
            return
        bs = self.config.block_size
        nb = min(prefilled_tokens // bs, (len(prompt) - 1) // bs)
        if nb <= 0:
            return
        blocks = self.pool.seq(seq_slot).blocks
        for i, key in enumerate(self._prefix_keys(prompt, scheme, nb)):
            bid = blocks[i] if i < len(blocks) else None
            if bid is None:
                continue
            cur = self._prefix_map.get(key)
            if cur is None or not self.pool.is_live(cur):
                self._prefix_map[key] = bid
        if len(self._prefix_map) > 8 * self.config.total_blocks:
            self._prefix_map = {k: b for k, b in self._prefix_map.items()
                                if self.pool.is_live(b)}

    def retire_out_of_window(self, seq_slot: int,
                             first_live_block: int) -> list[tuple[int, int]]:
        """Free a sequence's leading blocks once a sliding attention window
        has moved past them (the Mistral-family rolling KV buffer): the
        attention kernels never read blocks below
        `(seq_len - window) // block_size`, so their slots return to the
        pool at once. Returns the freed (block_idx, bid) pairs."""
        freed = self.pool.retire_below(seq_slot, first_live_block)
        self.stats.window_retired_blocks += len(freed)
        return freed

    # -- residency management -------------------------------------------------

    def seq_nonresident_blocks(self, seq_slot: int) -> list[int]:
        return [
            bid for bid in self.pool.seq(seq_slot).live_blocks
            if self.directory.entry(bid).state == BlockState.HOST
        ]

    def touch_seq(self, seq_slot: int) -> None:
        """Record accesses for every block of a scheduled sequence."""
        for bid in self.pool.seq(seq_slot).live_blocks:
            self.directory.access(bid)

    def ensure_resident(self, seq_slots: list[int]) -> int:
        """Demand-fetch every non-resident block of the given sequences
        (promotes migrate now; queued writebacks ride along). Returns blocks
        fetched. The numpy backend blocks on the staged copies (the
        sync_fetch_page analog)."""
        if not self._device_mode:
            return self._ensure_resident_numpy(seq_slots)
        fetched = self.prepare_resident(seq_slots)
        if self.transfer.pending_up:
            self.dispatch_migrations()
        return fetched

    def prepare_resident(self, seq_slots: list[int]) -> int:
        """Enqueue demand promotes (and cancel queued writebacks) for the
        given sequences; table rows sync to the reserved target slots
        (device backend)."""
        assert self._device_mode
        fetched = 0
        for s in seq_slots:
            for b in self.pool.seq(s).live_blocks:
                if self.directory.entry(b).state == BlockState.IN_FLIGHT_DOWN:
                    self.transfer.cancel_queued_demote(b, self.directory)
            fetched += self._promote_nonresident(s)
        if fetched:
            self.stats.demand_fetch_events += 1
            self.stats.demand_fetch_blocks += fetched
        self._sync_tables(seq_slots)
        return fetched

    def _promote_nonresident(self, seq_slot: int) -> int:
        """Enqueue a promote of each of the sequence's HOST blocks, making
        HBM room (or reclaiming an idle session) first. Returns blocks
        enqueued."""
        fetched = 0
        for bid in self.seq_nonresident_blocks(seq_slot):
            while self.directory.hbm_free == 0:
                if not self._make_room() and not (
                        self.reclaim_hook is not None
                        and self.reclaim_hook()):
                    raise RuntimeError(
                        "cannot make HBM room for demand fetch: all "
                        "resident blocks pinned — batch exceeds HBM capacity")
            host_slot, hbm_slot = self.directory.start_promote(bid)
            self.transfer.enqueue_promote(bid, host_slot, hbm_slot)
            fetched += 1
        return fetched

    def _ensure_resident_numpy(self, seq_slots: list[int]) -> int:
        fetched = 0
        settle_up = False
        for s in seq_slots:
            # blocks mid-flight downward: cancel writebacks still queued
            # (instant: the HBM copy never moved); only copies already in
            # flight force a wait. A loop: the in-flight cap means one
            # flush + poll may not drain every queued writeback.
            while True:
                inflight_down = [
                    b for b in self.pool.seq(s).live_blocks
                    if self.directory.entry(b).state
                    == BlockState.IN_FLIGHT_DOWN]
                if not inflight_down:
                    break
                remaining = [b for b in inflight_down
                             if not self.transfer.cancel_queued_demote(
                                 b, self.directory)]
                if not remaining:
                    break
                self.transfer.flush(self.pools, self.directory)
                self.transfer.poll(self.directory, wait=True)
            fetched += self._promote_nonresident(s)
            # prefetched blocks still staging (IN_FLIGHT_UP) must land before
            # this sequence decodes: its table row points at their slots
            settle_up = settle_up or any(
                self.directory.entry(b).state == BlockState.IN_FLIGHT_UP
                for b in self.pool.seq(s).live_blocks)
        if fetched or settle_up:
            if fetched:
                self.stats.demand_fetch_events += 1
                self.stats.demand_fetch_blocks += fetched
            self.transfer.flush(self.pools, self.directory, wait_up=True)
            self._sync_tables(seq_slots)
        return fetched

    def _make_room(self) -> bool:
        """Free at least one HBM slot now, waiting only when the one to be
        had is held by a demote in flight. False if nothing can be
        reclaimed (everything pinned)."""
        if not self._device_mode:
            return self._make_room_numpy()
        before = self.directory.hbm_free
        if self.transfer.queued:
            self.dispatch_migrations()
        if self._got_slot(before):
            return True
        cands = self._evict_candidates(max(1, self.directory.hbm_pressure()))
        if not cands:
            return False
        self._demote(cands)
        self.dispatch_migrations()
        return self._got_slot(before)

    def _make_room_numpy(self) -> bool:
        before = self.directory.hbm_free
        if self.transfer.queued or self.transfer.inflight_down:
            # settle in-flight traffic: completed writebacks free their
            # slots outright; completed promotes turn reserved slots into
            # evictable (unpinned) blocks
            self.transfer.flush(self.pools, self.directory, wait_up=True)
            self.transfer.poll(self.directory, wait=True)
            self.pool.sync_moved()
            if self.directory.hbm_free > before:
                return True
        cands = self._evict_candidates(max(1, self.directory.hbm_pressure()))
        if not cands:
            return False
        before = self.directory.hbm_free
        self._demote(cands)
        self.transfer.flush(self.pools, self.directory)
        self.transfer.poll(self.directory, wait=True)
        return self.directory.hbm_free > before

    def prefetch_blocks(self, bids: list[int]) -> int:
        """Asynchronous promote of specific blocks (prefetcher path). Stops
        at the landing-zone reserve, so prefetch and eviction never churn
        the same blocks."""
        started = 0
        floor = self.directory.config.num_reserved_blocks
        if self._device_mode:
            self.transfer.poll(self.directory)
        for bid in bids:
            e = self.directory.entry(bid)
            if e.state != BlockState.HOST:
                continue
            if self.directory.hbm_free <= floor:
                break
            host_slot, hbm_slot = self.directory.start_promote(bid, prefetch=True)
            self.transfer.enqueue_promote(bid, host_slot, hbm_slot)
            started += 1
        return started

    def pin_seq(self, seq_slot: int, pinned: bool) -> None:
        for bid in self.pool.seq(seq_slot).live_blocks:
            (self.directory.pin if pinned else self.directory.unpin)(bid)

    # -- background maintenance -----------------------------------------------

    def maintain(self) -> None:
        """One tick: demote under pressure, migrate what is queued (unless
        `defer_migrations` leaves it to the next fused round), re-sync
        block-table rows."""
        self.transfer.poll(self.directory)
        if not self._device_mode:
            pressure = self.directory.hbm_pressure()
            if pressure > 0:
                self._evict(pressure)
            self.pool.reap_deferred()
            self.transfer.flush(self.pools, self.directory)
            self.pool.sync_moved()
            return
        # queued and in-flight demotes free their slots when their copies
        # land: count them as already reclaiming so deferred flushing
        # doesn't over-demote
        pressure = (self.directory.hbm_pressure() - self.transfer.pending_down
                    - self.transfer.inflight_down)
        if pressure > 0:
            self._evict(pressure)
        self.pool.reap_deferred()
        if not self.defer_migrations and self.transfer.queued:
            # promotes migrate now and queued writebacks ride along; lone
            # writebacks wait for a full batch unless the reserve runs low
            if (self.transfer.pending_up
                    or self.transfer.pending_down >= MIGRATE_BATCH
                    or self._free_soon()
                    < self.directory.config.num_reserved_blocks // 2):
                self.dispatch_migrations()
        self.pool.sync_moved()

    def _evict_candidates(self, n: int) -> list[int]:
        """Eviction order for round-robin decode: among unprotected blocks,
        evict MOST-recently-used first (under a cyclic schedule it is needed
        furthest in the future); protected blocks only as a last resort, the
        held decode group's blocks after those."""
        cands = self.directory.evict_candidates(
            n + len(self.protected) + len(self.decode_hot)
            + self.config.num_hbm_blocks // 2)
        hot = self.decode_hot
        cool = [b for b in cands if b not in hot]
        unprot = [b for b in cool if b not in self.protected]
        unprot.sort(key=lambda b: -self.directory.entry(b).last_access)
        ordered = (unprot + [b for b in cool if b in self.protected]
                   + [b for b in cands if b in hot])
        return ordered[:n]

    def _demote(self, bids: list[int]) -> None:
        for bid in bids:
            try:
                res = self.directory.start_demote(bid, eviction=True)
            except DirectoryError:
                break  # no host slot free (e.g. HBM-only config)
            if res is not None:
                hbm_slot, host_slot = res
                self.transfer.enqueue_demote(bid, hbm_slot, host_slot)
            self.stats.maintain_demotes += 1

    def _evict(self, n: int) -> None:
        self._demote(self._evict_candidates(n))

    def _sync_tables(self, seq_slots: list[int]) -> None:
        self.pool.sync_moved()
        for s in seq_slots:
            for i, bid in enumerate(self.pool.seq(s).blocks):
                if bid is None:
                    continue
                e = self.directory.entry(bid)
                if e.hbm_slot >= 0 and self.pool.table.get(s, i) != e.hbm_slot:
                    self.pool.table.set(s, i, e.hbm_slot)

    # -- statistics -----------------------------------------------------------

    def get_statistics(self) -> dict:
        return {
            "directory": self.directory.get_statistics().as_dict(),
            "transfer": self.transfer.get_statistics().as_dict(),
            "pool": self.pool.get_statistics().as_dict(),
            "runtime": self.stats.as_dict(),
            "compression": self.compression_statistics(),
            "hbm_free": self.directory.hbm_free,
            "host_free": self.directory.host_free,
        }

    def compression_statistics(self) -> dict:
        """Storage ratio vs bf16 KV and the effective token-capacity
        expansion vs an uncompressed HBM-only cache. Bytes are this rank's
        (its `kv_heads`; the engine's "mesh" statistics give the whole
        mesh's)."""
        c = self.model_config
        cc = self.config
        bytes_tok = compressed_bytes_per_token(self.kv_heads, c.head_dim,
                                               self.kv_dtype) * c.num_layers
        bf16_tok = compressed_bytes_per_token(self.kv_heads, c.head_dim,
                                              KVDtype.BF16) * c.num_layers
        pooling = (cc.num_hbm_blocks + cc.num_host_blocks) / cc.num_hbm_blocks
        ratio = bf16_tok / bytes_tok
        return {
            "kv_dtype": self.kv_dtype.value,
            "bytes_per_token_per_layer": bytes_tok // c.num_layers,
            "storage_ratio_vs_bf16": round(ratio, 3),
            "capacity_expansion_pooling": round(pooling, 2),
            "effective_capacity_expansion": round(pooling * ratio, 2),
            "hbm_token_capacity": cc.num_hbm_blocks * cc.block_size,
            "total_token_capacity": cc.total_blocks * cc.block_size,
        }

    def reset_statistics(self) -> None:
        self.directory.reset_statistics()
        self.transfer.reset_statistics()
        self.pool.reset_statistics()
        self.stats.reset()
