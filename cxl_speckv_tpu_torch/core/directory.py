"""Block residency directory — the coherence brain of the tiered KV cache.

Copy of `cxl_speckv_tpu/core/directory.py`, kept here so the port imports nothing
of the JAX package.

TPU-native replacement for the reference MESI coherence machinery: the host
shadow directory (`src/cxl_memory/coherence_manager.cpp:20-457`), the FPGA
home-agent directory (`hardware/rtl/coherence_directory.v:6-363`), and the
3-tier page state tracking in `src/cxl_memory/cxl_memory_manager.cpp`.

Why not MESI: on TPU there is exactly one writer per KV block (the decode step
appends tokens on-device; the host never mutates KV contents), so the
sharer-invalidation half of MESI is unnecessary. What remains is *residency*:
which tier holds the authoritative copy of each block, whether a host backing
copy is stale (dirty bit), and in-flight migration state so the scheduler
never gathers a block that is mid-transfer (SURVEY.md section 7.0 concept map,
"block residency directory").

States (per logical block):

    FREE            no storage anywhere
    HBM             authoritative copy in the device HBM pool; may also have a
                    clean host backing copy (enables free demotion)
    HOST            authoritative copy in host DRAM only
    IN_FLIGHT_UP    host->HBM copy in progress (prefetch or demand fetch);
                    HBM slot reserved, host copy still authoritative
    IN_FLIGHT_DOWN  HBM->host writeback in progress; HBM copy still readable
                    (single-writer: contents cannot change mid-flight)

The dirty bit means the HBM copy is newer than any host copy (a block that
received appends since its last writeback). A clean HBM block with a live host
backing copy can be demoted instantly by dropping the HBM copy — the analog of
a writeback that is free because the line is in SHARED state.

This module only mutates *metadata*; actual data movement is driven by
`cxl_speckv_tpu_torch.runtime.kv_cache.TieredKVCache` and its
`runtime.transfer.MigrationPlanner`, which call back into
`complete_promote` / `complete_demote` when a batch is issued. On the card
a demoted block's HBM slot stays held until the batch's copies complete
(`release_hbm_slot`).

The statistics surface mirrors the reference coherence + memory-manager
counters (`coherence_manager.h:72-85`, `cxl_memory_manager.h:73-83`) and the
live state histogram of `coherence_directory.v:329-355`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from cxl_speckv_tpu_torch.config import CacheConfig
from cxl_speckv_tpu_torch.core.stats import Statistics, ratio


class BlockState(enum.Enum):
    FREE = 0
    HBM = 1
    HOST = 2
    IN_FLIGHT_UP = 3
    IN_FLIGHT_DOWN = 4


@dataclass
class DirectoryEntry:
    bid: int
    state: BlockState = BlockState.FREE
    hbm_slot: int = -1
    host_slot: int = -1
    dirty: bool = False
    pinned: bool = False
    # Set when the block was brought HBM-resident by the prefetcher and has
    # not been accessed since — consumed by prefetch hit-rate accounting
    # (reference misprediction tracking, speculative_prefetcher.cpp:84-97).
    prefetched: bool = False
    access_count: int = 0
    last_access: int = 0


@dataclass
class DirectoryStatistics(Statistics):
    """Counters mirroring `coherence_manager.h:72-85` + `cxl_memory_manager.h:73-83`."""

    accesses: int = 0
    hbm_hits: int = 0            # access found the block HBM-readable
    demand_misses: int = 0       # access found the block HOST-only (sync fetch needed)
    inflight_hits: int = 0       # access found the block IN_FLIGHT_UP (prefetch in progress)
    allocations: int = 0
    frees: int = 0
    promotions: int = 0          # completed host->HBM migrations
    demotions: int = 0           # completed HBM->host writebacks
    clean_drops: int = 0         # free demotions (clean block, host copy live)
    evictions: int = 0           # demotions/drops forced by HBM pressure
    prefetch_fills: int = 0      # promotions initiated by the prefetcher
    prefetch_hits: int = 0       # prefetched blocks subsequently accessed
    prefetch_wasted: int = 0     # prefetched blocks evicted/freed unaccessed (mispredictions)
    oom_events: int = 0          # allocation failures (caller must preempt)

    @property
    def hit_rate(self) -> float:
        return ratio(self.hbm_hits + self.inflight_hits, self.accesses)

    @property
    def demand_miss_rate(self) -> float:
        return ratio(self.demand_misses, self.accesses)

    @property
    def prefetch_accuracy(self) -> float:
        return ratio(self.prefetch_hits, self.prefetch_hits + self.prefetch_wasted)

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["hit_rate"] = self.hit_rate
        d["demand_miss_rate"] = self.demand_miss_rate
        d["prefetch_accuracy"] = self.prefetch_accuracy
        return d


class DirectoryError(RuntimeError):
    """Illegal state transition — indicates a runtime/scheduler bug."""


@dataclass
class _SlotPool:
    """Free-list over a fixed range of physical slots."""

    capacity: int
    free: list[int] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.free = list(range(self.capacity - 1, -1, -1))

    def take(self) -> int:
        if not self.free:
            raise DirectoryError("slot pool exhausted")
        return self.free.pop()

    def put(self, slot: int) -> None:
        self.free.append(slot)

    @property
    def num_free(self) -> int:
        return len(self.free)


class ResidencyDirectory:
    """Authoritative residency metadata for every logical KV block."""

    def __init__(self, config: CacheConfig):
        config.validate()
        self.config = config
        self._entries: dict[int, DirectoryEntry] = {}
        self._hbm = _SlotPool(config.num_hbm_blocks)
        self._host = _SlotPool(config.num_host_blocks)
        self._next_bid = 0
        self._clock = 0
        # blocks whose physical HBM slot changed since last take_moved() —
        # consumers re-sync block-table rows from this set
        self._moved: set[int] = set()
        self.stats = DirectoryStatistics()

    def take_moved(self) -> set[int]:
        moved, self._moved = self._moved, set()
        return moved

    # -- introspection ------------------------------------------------------

    def entry(self, bid: int) -> DirectoryEntry:
        try:
            return self._entries[bid]
        except KeyError:
            raise DirectoryError(f"unknown block {bid}") from None

    def __contains__(self, bid: int) -> bool:
        return bid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hbm_free(self) -> int:
        return self._hbm.num_free

    @property
    def host_free(self) -> int:
        return self._host.num_free

    def state_counts(self) -> dict[str, int]:
        """Live state histogram (analog of `coherence_directory.v:329-355`)."""
        counts = {s.name: 0 for s in BlockState}
        for e in self._entries.values():
            counts[e.state.name] += 1
        counts["FREE"] = 0  # FREE entries are deleted, not retained
        return counts

    def dump_state(self, limit: int = 64) -> str:
        """Debug dump (analog of `coherence_manager.cpp:332-369`)."""
        lines = [
            f"ResidencyDirectory: {len(self._entries)} blocks, "
            f"hbm_free={self.hbm_free}/{self.config.num_hbm_blocks}, "
            f"host_free={self.host_free}/{self.config.num_host_blocks}"
        ]
        for bid, e in sorted(self._entries.items())[:limit]:
            lines.append(
                f"  bid={bid} {e.state.name} hbm={e.hbm_slot} host={e.host_slot}"
                f"{' dirty' if e.dirty else ''}{' pinned' if e.pinned else ''}"
                f"{' prefetched' if e.prefetched else ''} acc={e.access_count}"
            )
        return "\n".join(lines)

    # -- lifecycle ----------------------------------------------------------

    def allocate(self, *, pinned: bool = True) -> int | None:
        """Allocate a new logical block, HBM-resident (appends write to HBM).

        Returns the block id, or None on HBM exhaustion after free-demoting
        what it can (the caller must then demote dirty blocks or preempt a
        sequence — the backpressure the reference lacks, SURVEY.md section 5).
        """
        if self._hbm.num_free == 0 and not self._reclaim_clean(1):
            self.stats.oom_events += 1
            return None
        bid = self._next_bid
        self._next_bid += 1
        self._clock += 1
        e = DirectoryEntry(
            bid=bid,
            state=BlockState.HBM,
            hbm_slot=self._hbm.take(),
            dirty=True,  # no host copy yet
            pinned=pinned,
            last_access=self._clock,
        )
        self._entries[bid] = e
        self.stats.allocations += 1
        return bid

    def allocate_host(self) -> int | None:
        """Allocate a new logical block directly in the HOST tier (streamed
        sequences whose KV never enters the HBM pool — the capacity-
        expansion limit case, `docs/ARCHITECTURE.md:271`). The host copy is
        authoritative from birth (dirty=False has no meaning host-side).
        Returns the block id, or None on host-tier exhaustion."""
        if self._host.num_free == 0:
            self.stats.oom_events += 1
            return None
        bid = self._next_bid
        self._next_bid += 1
        self._clock += 1
        e = DirectoryEntry(
            bid=bid,
            state=BlockState.HOST,
            host_slot=self._host.take(),
            last_access=self._clock,
        )
        self._entries[bid] = e
        self.stats.allocations += 1
        return bid

    def free(self, bid: int) -> None:
        e = self.entry(bid)
        if e.state in (BlockState.IN_FLIGHT_UP, BlockState.IN_FLIGHT_DOWN):
            raise DirectoryError(f"cannot free block {bid} mid-transfer ({e.state.name})")
        if e.prefetched:
            self.stats.prefetch_wasted += 1
        if e.hbm_slot >= 0:
            self._hbm.put(e.hbm_slot)
        if e.host_slot >= 0:
            self._host.put(e.host_slot)
        del self._entries[bid]
        self._moved.discard(bid)
        self.stats.frees += 1

    # -- access path --------------------------------------------------------

    def access(self, bid: int) -> BlockState:
        """Record an access; returns the current state so the caller can
        decide between fast path (HBM / IN_FLIGHT_DOWN: readable now),
        wait (IN_FLIGHT_UP), or demand fetch (HOST).

        Analog of `CoherenceManager::request_read` hit/miss accounting
        (`coherence_manager.cpp:33-70`).
        """
        e = self.entry(bid)
        self._clock += 1
        e.access_count += 1
        e.last_access = self._clock
        self.stats.accesses += 1
        if e.prefetched:
            e.prefetched = False
            self.stats.prefetch_hits += 1
        if e.state in (BlockState.HBM, BlockState.IN_FLIGHT_DOWN):
            self.stats.hbm_hits += 1
        elif e.state == BlockState.IN_FLIGHT_UP:
            self.stats.inflight_hits += 1
        elif e.state == BlockState.HOST:
            self.stats.demand_misses += 1
        else:
            raise DirectoryError(f"access to FREE block {bid}")
        return e.state

    def mark_dirty(self, bid: int) -> None:
        """Record an append (device-side write) to an HBM-resident block.

        Any host backing copy becomes stale and its slot is released —
        the analog of write-invalidation (`coherence_manager.cpp:72-108`)
        collapsed to the single-writer case.
        """
        e = self.entry(bid)
        if e.state != BlockState.HBM:
            raise DirectoryError(f"append to non-HBM block {bid} ({e.state.name})")
        e.dirty = True
        if e.host_slot >= 0:
            self._host.put(e.host_slot)
            e.host_slot = -1

    def pin(self, bid: int) -> None:
        self.entry(bid).pinned = True

    def unpin(self, bid: int) -> None:
        self.entry(bid).pinned = False

    # -- migration: host -> HBM (promote / prefetch) ------------------------

    def start_promote(self, bid: int, *, prefetch: bool = False) -> tuple[int, int]:
        """HOST -> IN_FLIGHT_UP. Returns (host_slot, hbm_slot) for the copy.

        Analog of `CXLMemoryManager::promote_to_l1`
        (`cxl_memory_manager.cpp:130-160`) made asynchronous.
        """
        e = self.entry(bid)
        if e.state != BlockState.HOST:
            raise DirectoryError(f"promote of block {bid} in state {e.state.name}")
        if self._hbm.num_free == 0 and not self._reclaim_clean(1):
            raise DirectoryError("promote with no free HBM slot; demote first")
        e.hbm_slot = self._hbm.take()
        e.state = BlockState.IN_FLIGHT_UP
        e.prefetched = prefetch
        return e.host_slot, e.hbm_slot

    def complete_promote(self, bid: int) -> None:
        e = self.entry(bid)
        if e.state != BlockState.IN_FLIGHT_UP:
            raise DirectoryError(f"complete_promote of block {bid} in state {e.state.name}")
        e.state = BlockState.HBM
        e.dirty = False  # host copy retained as clean backing store
        # arrival counts as a touch: a freshly-promoted block must not look
        # LRU-cold, or eviction reclaims prefetched blocks before their turn
        # (prefetch->evict->prefetch thrash)
        self._clock += 1
        e.last_access = self._clock
        self._moved.add(bid)
        self.stats.promotions += 1
        if e.prefetched:
            self.stats.prefetch_fills += 1

    # -- migration: HBM -> host (demote / writeback) ------------------------

    def start_demote(self, bid: int, *, eviction: bool = False) -> tuple[int, int] | None:
        """HBM -> IN_FLIGHT_DOWN (dirty) or instant HOST (clean drop).

        Returns (hbm_slot, host_slot) when a writeback copy is required, or
        None when the block was clean and dropped instantly (its HBM slot is
        already released). Analog of `CoherenceManager::writeback` M->S
        (`coherence_manager.cpp:137-158`) + `demote_to_l3`.
        """
        e = self.entry(bid)
        if e.state != BlockState.HBM:
            raise DirectoryError(f"demote of block {bid} in state {e.state.name}")
        if e.pinned:
            raise DirectoryError(f"demote of pinned block {bid}")
        if eviction:
            self.stats.evictions += 1
        if not e.dirty and e.host_slot >= 0:
            self._hbm.put(e.hbm_slot)
            e.hbm_slot = -1
            e.state = BlockState.HOST
            self.stats.clean_drops += 1
            if e.prefetched:
                e.prefetched = False
                self.stats.prefetch_wasted += 1
            return None
        if e.host_slot < 0:
            e.host_slot = self._host.take()
        e.state = BlockState.IN_FLIGHT_DOWN
        return e.hbm_slot, e.host_slot

    def cancel_demote(self, bid: int) -> None:
        """IN_FLIGHT_DOWN -> HBM for a writeback whose copy never started
        (still queued): the HBM copy was readable all along, so the block
        simply stays resident. The reserved host slot is released — a
        dirty writeback means any prior host copy was already stale."""
        e = self.entry(bid)
        if e.state != BlockState.IN_FLIGHT_DOWN:
            raise DirectoryError(f"cancel_demote of block {bid} in state {e.state.name}")
        e.state = BlockState.HBM
        if e.host_slot >= 0:
            self._host.put(e.host_slot)
            e.host_slot = -1

    def complete_demote(self, bid: int, *, hold_slot: bool = False) -> int:
        """IN_FLIGHT_DOWN -> HOST. Returns the block's former HBM slot,
        which returns to the free list now, or with `hold_slot` stays out
        of it until `release_hbm_slot` (a copy on the card may still be
        reading it)."""
        e = self.entry(bid)
        if e.state != BlockState.IN_FLIGHT_DOWN:
            raise DirectoryError(f"complete_demote of block {bid} in state {e.state.name}")
        slot = e.hbm_slot
        if not hold_slot:
            self._hbm.put(slot)
        e.hbm_slot = -1
        e.dirty = False
        e.state = BlockState.HOST
        self.stats.demotions += 1
        if e.prefetched:
            e.prefetched = False
            self.stats.prefetch_wasted += 1
        return slot

    def release_hbm_slot(self, slot: int) -> None:
        """Return an HBM slot held by `complete_demote(hold_slot=True)`."""
        self._hbm.put(slot)

    # -- eviction policy ----------------------------------------------------

    def _reclaim_clean(self, n: int) -> int:
        """Free-demote up to n clean unpinned HBM blocks (no data movement)."""
        dropped = 0
        candidates = [
            e for e in self._entries.values()
            if e.state == BlockState.HBM and not e.pinned and not e.dirty and e.host_slot >= 0
        ]
        candidates.sort(key=lambda e: e.last_access)
        for e in candidates[:n]:
            self.start_demote(e.bid, eviction=True)
            dropped += 1
        return dropped

    def evict_candidates(self, n: int) -> list[int]:
        """Pick up to n unpinned HBM blocks to demote, coldest-first.

        Clean blocks sort before dirty ones at equal coldness (their demotion
        is free); "hot" blocks (access_count > hot_access_threshold,
        reference `cxl_memory_manager.cpp:245-255`) are only chosen once all
        cold candidates are exhausted. LRU analog of `evict_l1_lru`
        (`cxl_memory_manager.cpp:285-293`).
        """
        hot_thr = self.config.hot_access_threshold
        candidates = [
            e for e in self._entries.values()
            if e.state == BlockState.HBM and not e.pinned
        ]
        candidates.sort(key=lambda e: (e.access_count > hot_thr, e.last_access, e.dirty))
        return [e.bid for e in candidates[:n]]

    def hbm_pressure(self) -> int:
        """How many HBM slots must be reclaimed to restore the prefetch
        landing-zone reserve (the L2-buffer analog). 0 when healthy."""
        return max(0, self.config.num_reserved_blocks - self._hbm.num_free)

    # -- statistics ---------------------------------------------------------

    def get_statistics(self) -> DirectoryStatistics:
        return self.stats

    def reset_statistics(self) -> None:
        self.stats.reset()
