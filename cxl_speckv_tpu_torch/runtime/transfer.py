"""Block migration between the HBM pools and the host tier.

Counterpart of `cxl_speckv_tpu/runtime/transfer.py`, the whole module:

- `MigrationPlanner` is the migration queue of the "device" host-store
  backend (`runtime/hoststore.py`, the default);
- `HostStore` and `TransferEngine` are the "numpy" backend
  (`CacheConfig.host_store_backend="numpy"`): a pageable host-process store
  with background-staged promotes and polled demotes.

A migration is a (bid, src_slot, dst_slot) record. In the device backend
`take_plan` pops up to one batch per direction, the caller issues the
batch, then `commit` finalizes directory state.

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
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

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
        # mesh serving: every poll waits, so that a batch retires at the
        # same call on every rank whatever its copies' timing
        self.lockstep = False

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
        wait = wait or self.lockstep
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


# ---------------------------------------------------------------------------
# the "numpy" backend: a pageable host store and its transfer engine
# ---------------------------------------------------------------------------

class HostStore:
    """The host tier as pageable CPU tensors, one block spanning all layers
    (the JAX package's numpy `HostStore`): k / v [host_slots, L, Hkv, bs,
    D/pack] in the pool's element type, scales [host_slots, L, Hkv, bs]
    float32 (init 1). K is token-major like V, the port's pool layout."""

    def __init__(self, host_slots: int, num_layers: int, block_size: int,
                 num_kv_heads: int, head_dim_packed: int,
                 kv_elem_dtype: torch.dtype):
        shape = (host_slots, num_layers, num_kv_heads, block_size,
                 head_dim_packed)
        self.k = torch.zeros(shape, dtype=kv_elem_dtype)
        self.v = torch.zeros(shape, dtype=kv_elem_dtype)
        self.ks = torch.ones(shape[:-1], dtype=torch.float32)
        self.vs = torch.ones(shape[:-1], dtype=torch.float32)

    @property
    def bytes_per_block(self) -> int:
        return sum(t[0].numel() * t.element_size()
                   for t in (self.k, self.v, self.ks, self.vs))


_TRANSFER_BATCH = 16  # fixed migration batch (descriptor-ring depth analog)


@dataclass
class _PendingDown:
    bids: list[int]
    host_slots: list[int]
    arrays: tuple       # k, v, ks, vs [nb, ...]: host tensors once `done`
    done: object        # CUDA event after the D2H copies; None on the CPU
    keep: tuple = ()    # the gathered device tensors the copies read


@dataclass
class _PendingUp:
    ups: list[tuple[int, int, int]]
    future: object      # Future -> ((kd, vd, ksd, vsd, slots), event)


class TransferEngine:
    """Batches block migrations between the HBM pools and a `HostStore`.

    Promotes are two-phase so the host-to-device copy overlaps decode: a
    one-worker stager thread gathers the batch's store rows and copies them
    to the device (phase a); the next `flush()` scatters batches whose
    staging finished into the pools (phase b) and only then marks their
    blocks HBM-resident. Demotes gather their slots into a batch buffer,
    copy it to the host, and stay IN_FLIGHT_DOWN until `poll()` sees the
    copy done and writes the rows into the store.

    On the card (`device` "cuda") the store is pageable, so a copy from it
    holds the host thread that issues it: the stager thread copies into a
    device staging buffer on its own stream and records an event, and
    `flush` makes the compute stream wait for that event before the
    scatter. A demote batch is gathered on the compute stream (so it reads
    what every round before it wrote) into a device buffer, which a side
    stream copies into a pinned bounce buffer after an event; `poll` is the
    copy's `event.query()`, then a host copy into the store. The copy reads
    the gathered buffer, not the pool, so an HBM slot that a later round
    writes cannot change what is written back. With `timings` a list, each
    staged or bounced batch appends (direction, blocks, start, end) CUDA
    events.
    """

    def __init__(self, host_store: HostStore, device="cpu",
                 max_inflight_down: int = 16):
        self.host = host_store
        self.device = torch.device(device)
        self.max_inflight_down = max_inflight_down
        self._up_queue: list[tuple[int, int, int]] = []    # (bid, host_slot, hbm_slot)
        self._down_queue: list[tuple[int, int, int]] = []  # (bid, hbm_slot, host_slot)
        self._pending_down: list[_PendingDown] = []
        self._pending_up: list[_PendingUp] = []
        self._stager = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="speckv-stager")
        cuda = self.device.type == "cuda"
        self._stage_stream = torch.cuda.Stream(self.device) if cuda else None
        self._d2h_stream = torch.cuda.Stream(self.device) if cuda else None
        self.timings: list | None = None
        self.stats = TransferStatistics()
        # mesh serving: every flush and poll waits (`MigrationPlanner`)
        self.lockstep = False

    def _stage_up(self, ups, guard_slot: int):
        """Worker: store rows -> staging tensors [nb, ...] on the device
        (rows past the batch hold zeros and target the guard slot)."""
        nb, n = _TRANSFER_BATCH, len(ups)
        h = self.host
        hs = torch.tensor([u[1] for u in ups], dtype=torch.long)
        kd = torch.zeros((nb, *h.k.shape[1:]), dtype=h.k.dtype)
        vd = torch.zeros_like(kd)
        ksd = torch.ones((nb, *h.ks.shape[1:]), dtype=torch.float32)
        vsd = torch.ones_like(ksd)
        kd[:n], vd[:n], ksd[:n], vsd[:n] = h.k[hs], h.v[hs], h.ks[hs], h.vs[hs]
        slots = torch.full((nb,), guard_slot, dtype=torch.long)
        slots[:n] = torch.tensor([u[2] for u in ups], dtype=torch.long)
        arrs = (kd, vd, ksd, vsd, slots)
        if self._stage_stream is None:
            return arrs, None
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._stage_stream):
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stage_stream)
            arrs = tuple(t.to(self.device, non_blocking=True) for t in arrs)
            done = torch.cuda.Event(enable_timing=True)
            done.record(self._stage_stream)
        if self.timings is not None:
            self.timings.append(("up", n, start, done))
        return arrs, done

    # -- enqueue (the descriptor ring analog) -------------------------------

    def enqueue_promote(self, bid: int, host_slot: int, hbm_slot: int) -> None:
        self._up_queue.append((bid, host_slot, hbm_slot))

    def enqueue_demote(self, bid: int, hbm_slot: int, host_slot: int) -> None:
        self._down_queue.append((bid, hbm_slot, host_slot))

    def cancel_queued_demote(self, bid: int, directory) -> bool:
        """Cancel a writeback that has not been gathered yet: the block's HBM
        copy was readable all along, so it just stays resident. Returns False
        when the copy is already in flight (the caller must wait it out)."""
        for i, (b, _, _) in enumerate(self._down_queue):
            if b == bid:
                del self._down_queue[i]
                directory.cancel_demote(bid)
                return True
        return False

    @property
    def inflight_down(self) -> int:
        return sum(len(p.bids) for p in self._pending_down)

    @property
    def inflight_up(self) -> int:
        return sum(len(p.ups) for p in self._pending_up)

    @property
    def queued(self) -> int:
        return len(self._up_queue) + len(self._down_queue) + self.inflight_up

    # -- flush: batched scatters in, batched gathers out --------------------

    def flush(self, pools, directory, *, wait_up: bool = False):
        """Apply migrations to `pools` (k, v, ks, vs, written in place;
        returned for the JAX call shape). Queued promotes go to the stager
        (phase a); staged batches are scattered into the pools (phase b)
        and their blocks complete, all of them with `wait_up` (the demand
        path, or `lockstep`). Queued demotes are gathered and their copies
        to the host issued; they complete in `poll()`."""
        wait_up = wait_up or self.lockstep
        nb = _TRANSFER_BATCH
        k, v, ks, vs = pools
        guard = k.shape[1] - 1
        while self._up_queue:
            ups = self._up_queue[:nb]
            del self._up_queue[:nb]
            self._pending_up.append(_PendingUp(
                ups=ups, future=self._stager.submit(self._stage_up, ups,
                                                    guard)))

        still = []
        for p in self._pending_up:
            if not (wait_up or p.future.done()):
                still.append(p)
                continue
            t0 = time.monotonic()
            (kd, vd, ksd, vsd, slots), done = p.future.result()
            self.stats.up_wait_ms += (time.monotonic() - t0) * 1e3
            if done is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(done)
                for t in (kd, vd, ksd, vsd, slots):
                    t.record_stream(cur)
            k[:, slots] = kd.transpose(0, 1)
            v[:, slots] = vd.transpose(0, 1)
            ks[:, slots] = ksd.transpose(0, 1)
            vs[:, slots] = vsd.transpose(0, 1)
            for bid, _, _ in p.ups:
                directory.complete_promote(bid)
            self.stats.up_transfers += len(p.ups)
            self.stats.up_batches += 1
            self.stats.bytes_up += len(p.ups) * self.host.bytes_per_block
        self._pending_up = still

        while self._down_queue and self.inflight_down < self.max_inflight_down:
            downs = self._down_queue[:nb]
            del self._down_queue[:nb]
            # padding gathers slot 0, sliced off in poll
            idx = [d[1] for d in downs] + [0] * (nb - len(downs))
            slots = torch.tensor(idx, dtype=torch.long, device=k.device)
            gathered = tuple(t[:, slots].transpose(0, 1).contiguous()
                             for t in (k, v, ks, vs))
            arrays, done, keep = gathered, None, ()
            if self._d2h_stream is not None:
                arrays, done = self._bounce(gathered, len(downs))
                keep = gathered
            self._pending_down.append(_PendingDown(
                bids=[d[0] for d in downs], host_slots=[d[2] for d in downs],
                arrays=arrays, done=done, keep=keep))
            self.stats.down_batches += 1
        return pools

    def _bounce(self, gathered, n: int):
        """Copy a gathered batch to pinned host buffers on the side stream,
        after the compute stream's gather. Returns (host tensors, event)."""
        side, cur = self._d2h_stream, torch.cuda.current_stream(self.device)
        ready = torch.cuda.Event()
        ready.record(cur)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            start = torch.cuda.Event(enable_timing=True)
            start.record(side)
            out = tuple(torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                        for g in gathered)
            for o, g in zip(out, gathered):
                o.copy_(g, non_blocking=True)
                g.record_stream(side)
            done = torch.cuda.Event(enable_timing=True)
            done.record(side)
        if self.timings is not None:
            self.timings.append(("down", n, start, done))
        return out, done

    # -- poll: the SPECKV_IOCTL_POLL_DONE analog ----------------------------

    def poll(self, directory, *, wait: bool = False) -> int:
        """Retire completed demotes into the host store. Returns the number
        of blocks retired. With wait=True, blocks until every pending demote
        has (the flush_all analog, and every poll under `lockstep`)."""
        self.stats.polls += 1
        wait = wait or self.lockstep
        done = 0
        still = []
        for p in self._pending_down:
            ready = p.done is None or p.done.query()
            if not ready and not wait:
                still.append(p)
                continue
            t0 = time.monotonic()
            if not ready:
                p.done.synchronize()
            self.stats.down_wait_ms += (time.monotonic() - t0) * 1e3
            hs = torch.tensor(p.host_slots, dtype=torch.long)
            n = len(p.host_slots)
            h = self.host
            for store, got in zip((h.k, h.v, h.ks, h.vs), p.arrays):
                store[hs] = got[:n].cpu()
            for bid in p.bids:
                directory.complete_demote(bid)
            done += len(p.bids)
            self.stats.down_transfers += len(p.bids)
            self.stats.bytes_down += len(p.bids) * self.host.bytes_per_block
        self._pending_down = still
        return done

    def drain(self, pools, directory):
        """Flush everything and wait (destructor-flush analog,
        `coherence_manager.cpp:28-31`)."""
        while self._up_queue or self._down_queue or self._pending_up:
            pools = self.flush(pools, directory, wait_up=True)
            self.poll(directory, wait=True)
        self.poll(directory, wait=True)
        return pools

    def get_statistics(self) -> TransferStatistics:
        return self.stats

    def reset_statistics(self) -> None:
        self.stats.reset()
