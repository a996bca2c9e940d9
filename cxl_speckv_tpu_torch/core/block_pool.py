"""Per-sequence KV block allocation.

Copy of `cxl_speckv_tpu/core/block_pool.py`, kept here so the port imports nothing
of the JAX package.

The framework-facing allocator, analog of the reference
`CXLMemoryAllocator` (`src/integration/memory_allocator.cpp:16-166`) and
`SpeckvAllocator` (`host/src/speckv_allocator.cpp:8-138`): sequences allocate
KV capacity in fixed-size blocks ("pages", reference 4KB — here
`block_size` tokens), the pool tracks the logical blocks per sequence, and the
residency directory tracks where each block physically lives.

Unlike the reference's byte-granular `cxl_malloc(size, layer_id)`, allocation
here is *token*-granular and *layer-unified*: one logical block covers that
token range in every layer's K and V pools (the same physical slot indexes
every layer pool). This turns the reference's per-layer ioctl storm (80
prefetch calls per token, SURVEY.md section 3.2 "hot loops") into one
whole-block migration covering all layers — larger DMA, fewer operations.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cxl_speckv_tpu_torch.config import CacheConfig
from cxl_speckv_tpu_torch.core.block_table import BlockTable
from cxl_speckv_tpu_torch.core.directory import BlockState, ResidencyDirectory
from cxl_speckv_tpu_torch.core.stats import Statistics


@dataclass
class SeqAlloc:
    seq_slot: int
    num_tokens: int = 0
    # logical bids, position-indexed (block_idx == token_pos // block_size).
    # Entries retired by a sliding window become None placeholders so the
    # position indexing stays valid; `live_blocks` skips them.
    blocks: list[int | None] = field(default_factory=list)

    @property
    def live_blocks(self) -> list[int]:
        return [b for b in self.blocks if b is not None]


@dataclass
class PoolStatistics(Statistics):
    """Analog of `memory_allocator.h:42-48` allocator counters."""

    seqs_allocated: int = 0
    seqs_freed: int = 0
    blocks_allocated: int = 0
    blocks_freed: int = 0
    peak_blocks: int = 0
    alloc_failures: int = 0
    blocks_shared: int = 0       # prefix-cache share events (extra refs)


class BlockPool:
    """Maps sequence slots to ordered logical blocks; owns the block table.

    Blocks may be SHARED between sequences (prefix caching): `share_block`
    adds an existing block to another sequence under a reference count; the
    underlying directory block is freed only when the last reference drops.
    Shared blocks are always FULL prompt blocks, which no sequence ever
    writes again (generated tokens land in blocks past the prompt), so
    sharing is read-only by construction."""

    def __init__(self, config: CacheConfig, directory: ResidencyDirectory,
                 max_seqs: int, max_blocks_per_seq: int):
        self.config = config
        self.directory = directory
        self.table = BlockTable(max_seqs, max_blocks_per_seq)
        self._seqs: dict[int, SeqAlloc] = {}
        self._free_slots = list(range(max_seqs - 1, -1, -1))
        self._deferred_free: list[int] = []
        # bid -> set of (seq_slot, block_idx) holding it (>1 when shared)
        self._bid_loc: dict[int, set[tuple[int, int]]] = {}
        self._refs: dict[int, int] = {}
        self.stats = PoolStatistics()

    # -- sequence lifecycle -------------------------------------------------

    def add_seq(self) -> int | None:
        """Claim a sequence slot; None when all slots are busy."""
        if not self._free_slots:
            return None
        slot = self._free_slots.pop()
        self._seqs[slot] = SeqAlloc(seq_slot=slot)
        self.stats.seqs_allocated += 1
        return slot

    def free_seq(self, seq_slot: int) -> None:
        seq = self._seqs.pop(seq_slot)
        for idx, bid in enumerate(seq.blocks):
            if bid is not None:
                self._free_block(bid, loc=(seq_slot, idx))
        self.table.clear_row(seq_slot)
        self._free_slots.append(seq_slot)
        self.stats.seqs_freed += 1

    def _free_block(self, bid: int, loc: tuple[int, int] | None = None) -> None:
        if loc is not None and bid in self._bid_loc:
            self._bid_loc[bid].discard(loc)
        refs = self._refs.get(bid, 1) - 1
        if refs > 0:
            # still referenced by another sequence (shared prefix block)
            self._refs[bid] = refs
            return
        self._refs.pop(bid, None)
        self._bid_loc.pop(bid, None)
        e = self.directory.entry(bid)
        # A block mid-transfer cannot be freed yet; the transfer engine
        # frees it on completion via the deferred-free list.
        if e.state in (BlockState.IN_FLIGHT_UP, BlockState.IN_FLIGHT_DOWN):
            self._deferred_free.append(bid)
        else:
            self.directory.free(bid)
            self.stats.blocks_freed += 1

    def retire_below(self, seq_slot: int,
                     first_live_block: int) -> list[tuple[int, int]]:
        """Free leading blocks that fell wholly out of a sliding attention
        window (Mistral family): once every live query position is past a
        block, no current or future query can attend to it (windows only
        move right), so its slot returns to the pool — live KV per sequence
        is bounded by ~window tokens (the paged rolling buffer). Retired
        entries stay as None placeholders so block_idx == pos // block_size
        keeps indexing `blocks`. Returns the freed (block_idx, bid) pairs."""
        seq = self._seqs[seq_slot]
        freed: list[tuple[int, int]] = []
        for i in range(min(first_live_block, len(seq.blocks))):
            bid = seq.blocks[i]
            if bid is None:
                continue
            seq.blocks[i] = None
            self._free_block(bid, loc=(seq_slot, i))
            freed.append((i, bid))
        return freed

    def reap_deferred(self) -> None:
        """Free blocks whose in-flight transfers have since completed."""
        still = []
        for bid in self._deferred_free:
            e = self.directory.entry(bid)
            if e.state in (BlockState.IN_FLIGHT_UP, BlockState.IN_FLIGHT_DOWN):
                still.append(bid)
            else:
                self.directory.free(bid)
                self.stats.blocks_freed += 1
        self._deferred_free[:] = still

    # -- capacity growth ----------------------------------------------------

    def blocks_needed(self, seq_slot: int, new_total_tokens: int) -> int:
        seq = self._seqs[seq_slot]
        want = -(-new_total_tokens // self.config.block_size)  # ceil
        return max(0, want - len(seq.blocks))

    def extend(self, seq_slot: int, new_total_tokens: int) -> bool:
        """Grow a sequence to cover new_total_tokens. Returns False on OOM
        (no HBM slot available) — the scheduler then evicts or preempts
        (the backpressure path the reference lacks, SURVEY.md section 5)."""
        seq = self._seqs[seq_slot]
        need = self.blocks_needed(seq_slot, new_total_tokens)
        for _ in range(need):
            # blocks are born unpinned: only the active decode batch pins
            # (a pinned-at-birth block would deadlock the pool once more
            # sequences have prefilled than HBM holds)
            bid = self.directory.allocate(pinned=False)
            if bid is None:
                self.stats.alloc_failures += 1
                return False
            e = self.directory.entry(bid)
            self.table.set(seq_slot, len(seq.blocks), e.hbm_slot)
            self._bid_loc[bid] = {(seq_slot, len(seq.blocks))}
            self._refs[bid] = 1
            seq.blocks.append(bid)
            self.stats.blocks_allocated += 1
        seq.num_tokens = new_total_tokens
        live = sum(len(s.live_blocks) for s in self._seqs.values())
        self.stats.peak_blocks = max(self.stats.peak_blocks, live)
        return True

    # -- prefix sharing -----------------------------------------------------

    def is_live(self, bid: int) -> bool:
        """True while at least one sequence references bid (bids are never
        reused, so this also validates prefix-cache entries)."""
        return self._refs.get(bid, 0) > 0

    def share_block(self, seq_slot: int, bid: int) -> None:
        """Append an existing (live, full) block to seq_slot as its next
        logical block under an additional reference — the prefix-cache hit
        path. The block's KV is reused verbatim; the claiming sequence must
        be at exactly the matching position (block_idx == current length)."""
        if not self.is_live(bid):
            raise KeyError(f"block {bid} is not live")
        seq = self._seqs[seq_slot]
        idx = len(seq.blocks)
        e = self.directory.entry(bid)
        self._refs[bid] += 1
        self._bid_loc[bid].add((seq_slot, idx))
        self.table.set(seq_slot, idx, e.hbm_slot)
        seq.blocks.append(bid)
        seq.num_tokens = idx * self.config.block_size + self.config.block_size
        self.stats.blocks_shared += 1

    # -- accessors ----------------------------------------------------------

    def seq(self, seq_slot: int) -> SeqAlloc:
        return self._seqs[seq_slot]

    def live_seqs(self) -> list[int]:
        return list(self._seqs)

    def last_block(self, seq_slot: int) -> int:
        return self._seqs[seq_slot].blocks[-1]

    def refresh_slot(self, seq_slot: int, block_idx: int) -> None:
        """Re-sync the table entry after a migration changed the HBM slot."""
        bid = self._seqs[seq_slot].blocks[block_idx]
        e = self.directory.entry(bid)
        self.table.set(seq_slot, block_idx, e.hbm_slot)

    def locate(self, bid: int) -> tuple[int, int] | None:
        locs = self._bid_loc.get(bid)
        return next(iter(locs)) if locs else None

    def sync_moved(self) -> int:
        """Refresh table rows for blocks whose physical slot changed
        (promotions) since the last call — every holder's row for shared
        blocks. Returns rows touched."""
        n = 0
        for bid in self.directory.take_moved():
            locs = self._bid_loc.get(bid)
            if not locs:
                continue
            e = self.directory.entry(bid)
            if e.hbm_slot >= 0:
                for slot, idx in locs:
                    self.table.set(slot, idx, e.hbm_slot)
                    n += 1
        return n

    def get_statistics(self) -> PoolStatistics:
        return self.stats

    def reset_statistics(self) -> None:
        self.stats.reset()
