"""Migration queue and in-flight state for the host tier
(`runtime/hoststore.py`).

Counterpart of `cxl_speckv_tpu/runtime/transfer.py`, `MigrationPlanner` and
`TransferStatistics` (the numpy host-store backend, `HostStore` and
`TransferEngine`, waits for a later slice). A migration is a
(bid, src_slot, dst_slot) record: `take_plan` pops up to one batch per
direction, the caller issues the batch, then `commit` finalizes directory
state.

A batch committed with a completion object (on the card: the CUDA event
recorded after its copies on the cache's copy stream; anything with
`query()` and `synchronize()`) stays in flight until `poll` sees it
complete, the counterpart of the JAX `TransferEngine.poll`: its demoted
blocks are HOST at once (a later promote of one reads the store after the
copy, by the copy stream's order), but their HBM slots are held out of the
free list, so nothing is allocated into or written over a slot that a copy
may still be reading. The record also keeps every tensor the copies use
alive, and names the slots the batch promotes into, so that a round can
wait for exactly the batches it reads (`waits_for`). A batch committed
without one completes when it is issued: the CPU path and the fused
rounds, whose copies run on the round's own stream.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from cxl_speckv_tpu_torch.core.stats import Statistics


@dataclass
class TransferStatistics(Statistics):
    """Analog of driver op counts (`speckv_driver.h:72-77`) + engine stats."""

    up_transfers: int = 0          # blocks migrated host -> HBM
    down_transfers: int = 0        # blocks migrated HBM -> host
    up_batches: int = 0
    down_batches: int = 0
    bytes_up: int = 0
    bytes_down: int = 0
    polls: int = 0                 # polls that found a batch in flight
    up_wait_ms: float = 0.0        # host blocked on a batch for its promotes
    down_wait_ms: float = 0.0      # host blocked on a batch for its slots


@dataclass
class InFlight:
    """One issued batch whose copies may still run."""

    done: object                   # completion: query() / synchronize()
    up_slots: frozenset            # HBM slots the batch promotes into
    held: list                     # demoted HBM slots, free once it completes
    keep: object                   # the tensors the copies use


class MigrationPlanner:
    """Queued promotes and demotes, taken one batch per direction, and the
    batches in flight."""

    def __init__(self, bytes_per_block: int):
        self._up: list[tuple[int, int, int]] = []    # (bid, host_slot, hbm_slot)
        self._down: list[tuple[int, int, int]] = []  # (bid, hbm_slot, host_slot)
        self._inflight: list[InFlight] = []
        self._bytes_per_block = bytes_per_block
        self.stats = TransferStatistics()

    def enqueue_promote(self, bid: int, host_slot: int, hbm_slot: int) -> None:
        self._up.append((bid, host_slot, hbm_slot))

    def enqueue_demote(self, bid: int, hbm_slot: int, host_slot: int) -> None:
        self._down.append((bid, hbm_slot, host_slot))

    def cancel_queued_demote(self, bid: int, directory) -> bool:
        """Demotes only move when issued, so a queued writeback always
        cancels instantly (the block's HBM copy never moved)."""
        for i, (b, _, _) in enumerate(self._down):
            if b == bid:
                del self._down[i]
                directory.cancel_demote(bid)
                return True
        return False

    @property
    def queued(self) -> int:
        return len(self._up) + len(self._down)

    @property
    def pending_up(self) -> int:
        return len(self._up)

    @property
    def pending_down(self) -> int:
        return len(self._down)

    @property
    def inflight_down(self) -> int:
        """HBM slots held by demotes still in flight."""
        return sum(len(b.held) for b in self._inflight)

    @property
    def inflight(self) -> list[InFlight]:
        return self._inflight

    def take_plan(self, batch: int):
        """Pop up to `batch` ops per direction: (ups, downs) slot-pair lists
        + bid lists for commit."""
        ups, self._up = self._up[:batch], self._up[batch:]
        downs, self._down = self._down[:batch], self._down[batch:]
        return ([(h, d) for _, h, d in ups],
                [(d, h) for _, d, h in downs],
                [b for b, _, _ in ups],
                [b for b, _, _ in downs])

    def commit(self, up_bids: list[int], down_bids: list[int], directory,
               done=None, up_slots=(), keep=()) -> None:
        """Mark an issued plan's blocks migrated. With `done` (the batch's
        completion) the batch stays in flight until `poll` retires it: the
        demoted blocks' HBM slots stay held, `keep` stays alive, and rounds
        reading `up_slots` wait for it."""
        for bid in up_bids:
            directory.complete_promote(bid)
        held = [directory.complete_demote(bid, hold_slot=done is not None)
                for bid in down_bids]
        if done is not None and (up_bids or down_bids):
            self._inflight.append(InFlight(
                done, frozenset(up_slots), held, keep))
        if up_bids:
            self.stats.up_transfers += len(up_bids)
            self.stats.up_batches += 1
            self.stats.bytes_up += len(up_bids) * self._bytes_per_block
        if down_bids:
            self.stats.down_transfers += len(down_bids)
            self.stats.down_batches += 1
            self.stats.bytes_down += len(down_bids) * self._bytes_per_block

    def _retire(self, b: InFlight, directory) -> None:
        for slot in b.held:
            directory.release_hbm_slot(slot)
        self._inflight.remove(b)

    def _wait(self, b: InFlight) -> None:
        """Block the host until `b` completes, timed into the wait stats."""
        t0 = time.monotonic()
        b.done.synchronize()
        ms = (time.monotonic() - t0) * 1e3
        if b.held:
            self.stats.down_wait_ms += ms
        else:
            self.stats.up_wait_ms += ms

    def poll(self, directory, *, wait: bool = False) -> int:
        """Retire completed batches in issue order (a copy stream completes
        in order); with `wait` block until every batch has. Returns the HBM
        slots released."""
        if not self._inflight:
            return 0
        self.stats.polls += 1
        freed = 0
        for b in list(self._inflight):
            if not b.done.query():
                if not wait:
                    break
                self._wait(b)
            freed += len(b.held)
            self._retire(b, directory)
        return freed

    def settle(self, directory, n: int) -> int:
        """Block until at least `n` held HBM slots are free again (or none
        is in flight), waiting for the oldest batches first. Returns the
        slots released."""
        freed = self.poll(directory)
        while freed < n and self._inflight:
            b = self._inflight[0]
            self._wait(b)
            freed += len(b.held)
            self._retire(b, directory)
        return freed

    def waits_for(self, slots) -> list:
        """Completions of the batches in flight that promote into any of
        `slots`."""
        s = set(slots)
        return [b.done for b in self._inflight if b.up_slots & s]

    def get_statistics(self) -> TransferStatistics:
        return self.stats

    def reset_statistics(self) -> None:
        self.stats.reset()
