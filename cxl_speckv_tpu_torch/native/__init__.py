"""ctypes bindings for the native (C++) residency directory and block pool.

Counterpart of `cxl_speckv_tpu/native/__init__.py`: the C++ runtime of
`native/speckv_runtime.cpp` and `native/speckv_c_api.cpp`, bound with the
interfaces of the port's `core/directory.py` (`NativeResidencyDirectory`)
and `core/block_pool.py` (`NativeBlockPool`). `runtime/kv_cache.
TieredKVCache(native=True)`, or `native=None` with `SPECKV_NATIVE=1`,
selects them.

The library builds at first use with `g++ -O2 -std=c++17 -fPIC -shared`
(the flags of `native/Makefile`) into `cxl_speckv_tpu_torch/_build/`,
named by a digest of the sources, the header and the flags, as
`ops/cuda_build.py` names the kernels; nothing is written into `native/`.
A failed build raises: nothing falls back to the Python directory.

One addition to the C API's semantics: the port's directory can keep a
demoted block's HBM slot off the free list until a copy on the card has
read it (`complete_demote(hold_slot=True)`, `release_hbm_slot`), and the
C API has no such call. The binding holds the slot with a pinned
placeholder block allocated into it at once (the slot pool hands out the
slot it took back last), and frees the placeholder on release. Placeholders
are left out of every count the binding reports (statistics, `len`,
`state_counts`) and are never eviction candidates (pinned), so the
directory's behaviour and statistics are the Python directory's; only the
block ids and access clock of later blocks differ, by the same monotone
shift.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from cxl_speckv_tpu_torch.config import CacheConfig
from cxl_speckv_tpu_torch.core.block_pool import PoolStatistics
from cxl_speckv_tpu_torch.core.block_table import BlockTable
from cxl_speckv_tpu_torch.core.directory import (
    BlockState,
    DirectoryError,
    DirectoryStatistics,
)

_REPO = Path(__file__).resolve().parents[2]
SOURCES = [_REPO / "native" / "speckv_runtime.cpp",
           _REPO / "native" / "speckv_c_api.cpp"]
HEADER = _REPO / "native" / "speckv_runtime.hpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
_lib = None

_STATS_FIELDS = (
    "accesses", "hbm_hits", "demand_misses", "inflight_hits", "allocations",
    "frees", "promotions", "demotions", "clean_drops", "evictions",
    "prefetch_fills", "prefetch_hits", "prefetch_wasted", "oom_events",
)

_ERRORS = {
    -1: "unknown block",
    -2: "illegal state transition",
    -3: "block is pinned",
    -4: "no free slot",
    -5: "block mid-transfer",
}


class _EntryInfo(ctypes.Structure):
    _fields_ = [
        ("state", ctypes.c_int32),
        ("hbm_slot", ctypes.c_int32),
        ("host_slot", ctypes.c_int32),
        ("dirty", ctypes.c_int32),
        ("pinned", ctypes.c_int32),
        ("prefetched", ctypes.c_int32),
        ("access_count", ctypes.c_int64),
        ("last_access", ctypes.c_int64),
    ]


def library_path() -> Path:
    src = b"".join(p.read_bytes() for p in [*SOURCES, HEADER])
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libspeckv_runtime-{digest[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises RuntimeError if the compiler is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native runtime needs a C++ compiler (g++ or "
                           "$CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                        *map(str, SOURCES)], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"building the native runtime failed:\n"
                           f"{p.stdout}{p.stderr}")
    os.replace(tmp, path)
    return path


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
    p32, p64 = ctypes.POINTER(i32), ctypes.POINTER(i64)
    sigs = {
        "speckv_pool_create": ([u64, i32, i32, i32], u64),
        "speckv_pool_destroy": ([u64], None),
        "speckv_pool_add_seq": ([u64], i32),
        "speckv_pool_free_seq": ([u64, i32], i32),
        "speckv_pool_blocks_needed": ([u64, i32, i64], i32),
        "speckv_pool_extend": ([u64, i32, i64], i32),
        "speckv_pool_retire_below": ([u64, i32, i32, p64, p64, i32], i32),
        "speckv_pool_reap_deferred": ([u64], None),
        "speckv_pool_refresh_slot": ([u64, i32, i32], i32),
        "speckv_pool_locate": ([u64, i64, p32], i64),
        "speckv_pool_sync_moved": ([u64], i32),
        "speckv_pool_live_seqs": ([u64, p32, i32], i32),
        "speckv_pool_seq_tokens": ([u64, i32], i64),
        "speckv_pool_seq_blocks": ([u64, i32, p64, i32], i32),
        "speckv_pool_last_block": ([u64, i32], i64),
        "speckv_pool_has_seq": ([u64, i32], i32),
        "speckv_pool_is_live": ([u64, i64], i32),
        "speckv_pool_share_block": ([u64, i32, i64], i32),
        "speckv_pool_table": ([u64], ctypes.POINTER(i32)),
        "speckv_pool_stats": ([u64, p64], i32),
        "speckv_pool_reset_stats": ([u64], None),
        "speckv_dir_create": ([i32, i32, i32, i32], u64),
        "speckv_dir_destroy": ([u64], None),
        "speckv_dir_allocate": ([u64, i32], i64),
        "speckv_dir_allocate_host": ([u64], i64),
        "speckv_dir_free_block": ([u64, i64], i32),
        "speckv_dir_access": ([u64, i64], i32),
        "speckv_dir_mark_dirty": ([u64, i64], i32),
        "speckv_dir_pin": ([u64, i64, i32], i32),
        "speckv_dir_start_promote": ([u64, i64, i32, p32, p32], i32),
        "speckv_dir_complete_promote": ([u64, i64], i32),
        "speckv_dir_start_demote": ([u64, i64, i32, p32, p32], i32),
        "speckv_dir_complete_demote": ([u64, i64], i32),
        "speckv_dir_cancel_demote": ([u64, i64], i32),
        "speckv_dir_evict_candidates": ([u64, i32, p64], i32),
        "speckv_dir_hbm_free": ([u64], i32),
        "speckv_dir_host_free": ([u64], i32),
        "speckv_dir_pressure": ([u64], i32),
        "speckv_dir_size": ([u64], i64),
        "speckv_dir_entry": ([u64, i64, ctypes.POINTER(_EntryInfo)], i32),
        "speckv_dir_stats": ([u64, p64], i32),
        "speckv_dir_reset_stats": ([u64], None),
        "speckv_dir_take_moved": ([u64, p64, i32], i32),
        "speckv_dir_state_counts": ([u64, p64], i32),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


class _EntryView:
    """Read view over one native entry, with DirectoryEntry's fields."""

    __slots__ = ("_dir", "bid")

    def __init__(self, d: "NativeResidencyDirectory", bid: int):
        self._dir = d
        self.bid = bid

    def _info(self) -> _EntryInfo:
        info = _EntryInfo()
        rc = self._dir._lib.speckv_dir_entry(self._dir._h, self.bid,
                                             ctypes.byref(info))
        if rc < 0:
            raise DirectoryError(f"unknown block {self.bid}")
        return info

    @property
    def state(self) -> BlockState:
        return BlockState(self._info().state)

    @property
    def hbm_slot(self) -> int:
        return self._info().hbm_slot

    @property
    def host_slot(self) -> int:
        return self._info().host_slot

    @property
    def dirty(self) -> bool:
        return bool(self._info().dirty)

    @property
    def pinned(self) -> bool:
        return bool(self._info().pinned)

    @property
    def prefetched(self) -> bool:
        return bool(self._info().prefetched)

    @property
    def access_count(self) -> int:
        return self._info().access_count

    @property
    def last_access(self) -> int:
        return self._info().last_access


class NativeResidencyDirectory:
    """Drop-in replacement for `core.directory.ResidencyDirectory`."""

    def __init__(self, config: CacheConfig):
        config.validate()
        self.config = config
        self._lib = load_library()
        self._h = self._lib.speckv_dir_create(
            config.num_hbm_blocks, config.num_host_blocks,
            config.num_reserved_blocks, config.hot_access_threshold)
        self._held: dict[int, int] = {}   # held HBM slot -> placeholder bid
        self._ph_allocs = 0               # placeholder allocations / frees
        self._ph_frees = 0                # since the last statistics reset

    def __del__(self):
        try:
            self._lib.speckv_dir_destroy(self._h)
        except Exception:
            pass

    def _check(self, rc: int, op: str, bid=None) -> int:
        if rc < 0:
            raise DirectoryError(f"{op}({bid}): {_ERRORS.get(rc, rc)}")
        return rc

    def entry(self, bid: int) -> _EntryView:
        v = _EntryView(self, bid)
        v._info()  # raises on unknown block
        return v

    def __contains__(self, bid: int) -> bool:
        info = _EntryInfo()
        return (bid not in self._held.values() and self._lib.speckv_dir_entry(
            self._h, bid, ctypes.byref(info)) == 0)

    def __len__(self) -> int:
        return self._lib.speckv_dir_size(self._h) - len(self._held)

    @property
    def hbm_free(self) -> int:
        return self._lib.speckv_dir_hbm_free(self._h)

    @property
    def host_free(self) -> int:
        return self._lib.speckv_dir_host_free(self._h)

    def allocate(self, *, pinned: bool = True) -> int | None:
        bid = self._lib.speckv_dir_allocate(self._h, int(pinned))
        return None if bid < 0 else bid

    def allocate_host(self) -> int | None:
        bid = self._lib.speckv_dir_allocate_host(self._h)
        return None if bid < 0 else bid

    def free(self, bid: int) -> None:
        self._check(self._lib.speckv_dir_free_block(self._h, bid), "free", bid)

    def access(self, bid: int) -> BlockState:
        return BlockState(self._check(
            self._lib.speckv_dir_access(self._h, bid), "access", bid))

    def mark_dirty(self, bid: int) -> None:
        self._check(self._lib.speckv_dir_mark_dirty(self._h, bid),
                    "mark_dirty", bid)

    def pin(self, bid: int) -> None:
        self._check(self._lib.speckv_dir_pin(self._h, bid, 1), "pin", bid)

    def unpin(self, bid: int) -> None:
        self._check(self._lib.speckv_dir_pin(self._h, bid, 0), "unpin", bid)

    def start_promote(self, bid: int, *,
                      prefetch: bool = False) -> tuple[int, int]:
        hs, ds = ctypes.c_int32(), ctypes.c_int32()
        self._check(self._lib.speckv_dir_start_promote(
            self._h, bid, int(prefetch), ctypes.byref(hs), ctypes.byref(ds)),
            "start_promote", bid)
        return hs.value, ds.value

    def complete_promote(self, bid: int) -> None:
        self._check(self._lib.speckv_dir_complete_promote(self._h, bid),
                    "complete_promote", bid)

    def start_demote(self, bid: int, *,
                     eviction: bool = False) -> tuple[int, int] | None:
        ds, hs = ctypes.c_int32(), ctypes.c_int32()
        rc = self._check(self._lib.speckv_dir_start_demote(
            self._h, bid, int(eviction), ctypes.byref(ds), ctypes.byref(hs)),
            "start_demote", bid)
        return None if rc == 0 else (ds.value, hs.value)

    def complete_demote(self, bid: int, *, hold_slot: bool = False) -> int:
        """IN_FLIGHT_DOWN -> HOST. Returns the block's former HBM slot,
        which returns to the free list now, or with `hold_slot` stays out
        of it until `release_hbm_slot` (a placeholder takes it)."""
        slot = self.entry(bid).hbm_slot
        self._check(self._lib.speckv_dir_complete_demote(self._h, bid),
                    "complete_demote", bid)
        if hold_slot:
            ph = self._lib.speckv_dir_allocate(self._h, 1)
            if ph < 0 or self.entry(ph).hbm_slot != slot:
                raise DirectoryError(f"complete_demote({bid}): could not hold "
                                     f"HBM slot {slot}")
            self._held[slot] = ph
            self._ph_allocs += 1
        return slot

    def release_hbm_slot(self, slot: int) -> None:
        """Return an HBM slot held by `complete_demote(hold_slot=True)`."""
        self.free(self._held.pop(slot))
        self._ph_frees += 1

    def cancel_demote(self, bid: int) -> None:
        self._check(self._lib.speckv_dir_cancel_demote(self._h, bid),
                    "cancel_demote", bid)

    def evict_candidates(self, n: int) -> list[int]:
        out = (ctypes.c_int64 * max(n, 1))()
        m = self._check(self._lib.speckv_dir_evict_candidates(self._h, n, out),
                        "evict_candidates")
        return [out[i] for i in range(m)]

    def hbm_pressure(self) -> int:
        return self._lib.speckv_dir_pressure(self._h)

    def state_counts(self) -> dict[str, int]:
        out = (ctypes.c_int64 * 5)()
        self._check(self._lib.speckv_dir_state_counts(self._h, out),
                    "state_counts")
        counts = {s.name: out[s.value] for s in BlockState}
        counts[BlockState.HBM.name] -= len(self._held)
        return counts

    def take_moved(self) -> set[int]:
        out = (ctypes.c_int64 * 4096)()
        moved: set[int] = set()
        while True:
            m = self._lib.speckv_dir_take_moved(self._h, out, 4096)
            moved.update(out[i] for i in range(m))
            if m < 4096:
                return moved

    def get_statistics(self) -> DirectoryStatistics:
        out = (ctypes.c_int64 * 14)()
        self._check(self._lib.speckv_dir_stats(self._h, out), "stats")
        st = DirectoryStatistics(**dict(zip(_STATS_FIELDS, out)))
        st.allocations -= self._ph_allocs
        st.frees -= self._ph_frees
        return st

    @property
    def stats(self) -> DirectoryStatistics:
        return self.get_statistics()

    def reset_statistics(self) -> None:
        self._lib.speckv_dir_reset_stats(self._h)
        self._ph_allocs = self._ph_frees = 0


# ---------------------------------------------------------------------------
# the C++ per-sequence allocator, drop-in for core.block_pool.BlockPool
# ---------------------------------------------------------------------------

_POOL_STATS_FIELDS = (
    "seqs_allocated", "seqs_freed", "blocks_allocated", "blocks_freed",
    "peak_blocks", "alloc_failures", "blocks_shared",
)


class _NativeSeqView:
    """SeqAlloc-compatible view over one native sequence."""

    __slots__ = ("_pool", "seq_slot")

    def __init__(self, pool: "NativeBlockPool", seq_slot: int):
        self._pool = pool
        self.seq_slot = seq_slot

    @property
    def blocks(self) -> list:
        return self._pool._seq_blocks(self.seq_slot)

    @property
    def live_blocks(self) -> list:
        return [b for b in self.blocks if b is not None]

    @property
    def num_tokens(self) -> int:
        return self._pool._lib.speckv_pool_seq_tokens(
            self._pool._h, self.seq_slot)


class _NativeTable(BlockTable):
    """BlockTable whose storage is the C++ pool's table, mapped zero-copy."""

    def __init__(self, pool: "NativeBlockPool",
                 max_seqs: int, max_blocks_per_seq: int):
        self.max_seqs = max_seqs
        self.max_blocks_per_seq = max_blocks_per_seq
        ptr = pool._lib.speckv_pool_table(pool._h)
        self._table = np.ctypeslib.as_array(
            ptr, shape=(max_seqs, max_blocks_per_seq))


class NativeBlockPool:
    """Drop-in replacement for `core.block_pool.BlockPool` over the C++
    allocator, paired with a `NativeResidencyDirectory` (the C++ pool
    allocates and frees through the same directory object)."""

    def __init__(self, config, directory: NativeResidencyDirectory,
                 max_seqs: int, max_blocks_per_seq: int):
        if not isinstance(directory, NativeResidencyDirectory):
            raise TypeError("NativeBlockPool requires the native directory")
        self.config = config
        self.directory = directory
        self._lib = load_library()
        self._h = self._lib.speckv_pool_create(
            directory._h, max_seqs, max_blocks_per_seq, config.block_size)
        if not self._h:
            raise RuntimeError("native pool creation failed")
        self.table = _NativeTable(self, max_seqs, max_blocks_per_seq)
        self._max_blocks = max_blocks_per_seq

    def __del__(self):
        try:
            self._lib.speckv_pool_destroy(self._h)
        except Exception:
            pass

    def add_seq(self):
        slot = self._lib.speckv_pool_add_seq(self._h)
        return None if slot < 0 else slot

    def free_seq(self, seq_slot: int) -> None:
        if self._lib.speckv_pool_free_seq(self._h, seq_slot) < 0:
            raise KeyError(seq_slot)

    def retire_below(self, seq_slot: int,
                     first_live_block: int) -> list[tuple[int, int]]:
        cap = self._max_blocks
        idx = (ctypes.c_int64 * cap)()
        bid = (ctypes.c_int64 * cap)()
        n = self._lib.speckv_pool_retire_below(
            self._h, seq_slot, first_live_block, idx, bid, cap)
        if n < 0:
            raise KeyError(seq_slot)
        return [(int(idx[i]), int(bid[i])) for i in range(min(n, cap))]

    def reap_deferred(self) -> None:
        self._lib.speckv_pool_reap_deferred(self._h)

    def blocks_needed(self, seq_slot: int, new_total_tokens: int) -> int:
        n = self._lib.speckv_pool_blocks_needed(
            self._h, seq_slot, new_total_tokens)
        if n < 0:
            raise KeyError(seq_slot)
        return n

    def extend(self, seq_slot: int, new_total_tokens: int) -> bool:
        rc = self._lib.speckv_pool_extend(self._h, seq_slot, new_total_tokens)
        if rc < 0:
            raise KeyError(seq_slot)
        return bool(rc)

    def _seq_blocks(self, seq_slot: int) -> list:
        cap = self._max_blocks
        out = (ctypes.c_int64 * cap)()
        n = self._lib.speckv_pool_seq_blocks(self._h, seq_slot, out, cap)
        if n < 0:
            raise KeyError(seq_slot)
        return [None if out[i] < 0 else int(out[i])
                for i in range(min(n, cap))]

    def seq(self, seq_slot: int) -> _NativeSeqView:
        if not self._lib.speckv_pool_has_seq(self._h, seq_slot):
            raise KeyError(seq_slot)
        return _NativeSeqView(self, seq_slot)

    def live_seqs(self) -> list:
        cap = self.table.max_seqs
        out = (ctypes.c_int32 * cap)()
        n = self._lib.speckv_pool_live_seqs(self._h, out, cap)
        return [int(out[i]) for i in range(min(n, cap))]

    def last_block(self, seq_slot: int) -> int:
        bid = self._lib.speckv_pool_last_block(self._h, seq_slot)
        if bid < 0:
            raise KeyError(seq_slot)
        return bid

    def refresh_slot(self, seq_slot: int, block_idx: int) -> None:
        if self._lib.speckv_pool_refresh_slot(self._h, seq_slot,
                                              block_idx) < 0:
            raise KeyError((seq_slot, block_idx))

    def locate(self, bid: int):
        idx = ctypes.c_int32()
        slot = self._lib.speckv_pool_locate(self._h, bid, ctypes.byref(idx))
        return None if slot < 0 else (int(slot), int(idx.value))

    def sync_moved(self) -> int:
        return self._lib.speckv_pool_sync_moved(self._h)

    def is_live(self, bid: int) -> bool:
        return bool(self._lib.speckv_pool_is_live(self._h, bid))

    def share_block(self, seq_slot: int, bid: int) -> None:
        rc = self._lib.speckv_pool_share_block(self._h, seq_slot, bid)
        if rc < 0:
            raise KeyError(f"share_block({seq_slot}, {bid}): {rc}")

    def get_statistics(self) -> PoolStatistics:
        out = (ctypes.c_int64 * 7)()
        if self._lib.speckv_pool_stats(self._h, out) < 0:
            raise RuntimeError("pool stats failed")
        return PoolStatistics(**dict(zip(_POOL_STATS_FIELDS, out)))

    @property
    def stats(self) -> PoolStatistics:
        return self.get_statistics()

    def reset_statistics(self) -> None:
        self._lib.speckv_pool_reset_stats(self._h)
