"""The tiered KV cache: a scripted sequence of extend / ensure_resident /
prefetch / maintain / free calls gives the port's `TieredKVCache` the same
directory statistics, migration counts and block tables as the JAX
package's, blocks that migrate to the host tier and back keep their bytes
in every storage width, and `rebuild_storage` switches an idle cache to
another width as the JAX package's does."""

import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import CacheConfig as JCacheConfig
from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.runtime.kv_cache import TieredKVCache as JCache
from cxl_speckv_tpu_torch.config import CacheConfig, KVDtype
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.runtime.hoststore import (
    MIGRATE_BATCH,
    DeviceHostStore,
    migrate_program,
    pad_migration,
)
from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache

BS, HBM, HOST, MAX_SEQS, MAX_BLOCKS = 8, 10, 40, 8, 8


def caches(kv="int8", **kw):
    args = dict(block_size=BS, num_hbm_blocks=HBM, num_host_blocks=HOST, **kw)
    j = JCache(JCacheConfig(kv_dtype=JKV(kv), **args), j_tiny(), MAX_SEQS,
               MAX_BLOCKS, native=False)
    t = TieredKVCache(CacheConfig(kv_dtype=KVDtype(kv), **args),
                      tiny_test_config(), MAX_SEQS, MAX_BLOCKS, device="cpu")
    return j, t


def snapshot(c, slots):
    st = c.get_statistics()
    tr = st["transfer"]
    return {"directory": st["directory"], "pool": st["pool"],
            "moves": {k: tr[k] for k in ("up_transfers", "down_transfers",
                                         "up_batches", "down_batches",
                                         "bytes_up", "bytes_down")},
            "runtime": st["runtime"], "hbm_free": st["hbm_free"],
            "host_free": st["host_free"],
            "tables": [np.asarray(c.pool.table.row(s)).tolist() for s in slots],
            "queued": c.transfer.queued}


def script(c, log):
    """Three sequences against a 10-block HBM pool: growth under pressure,
    demand fetches in rotation, a prefetch, a pinned batch, frees."""
    slots = [c.add_seq() for _ in range(3)]
    log.append(snapshot(c, slots))
    for s, n in zip(slots, (30, 26, 20)):           # 4 + 4 + 3 blocks > 10
        assert c.extend_seq(s, n)
        c.maintain()
        log.append(snapshot(c, slots))
    for rnd in range(4):                             # round-robin decode groups
        s = slots[rnd % 3]
        c.pin_seq(s, True)
        c.touch_seq(s)
        c.ensure_resident([s])
        c.extend_seq(s, c.pool.seq(s).num_tokens + 5)
        c.pin_seq(s, False)
        c.protected = set(c.pool.seq(slots[(rnd + 1) % 3]).live_blocks)
        c.prefetch_blocks(c.seq_nonresident_blocks(slots[(rnd + 1) % 3]))
        c.maintain()
        log.append(snapshot(c, slots))
    c.free_seq(slots[1])
    c.maintain()
    log.append(snapshot(c, slots))
    c.ensure_resident([slots[0], slots[2]])
    c.maintain()
    log.append(snapshot(c, slots))


def test_scripted_sequence_matches_jax():
    j, t = caches()
    jl, tl = [], []
    script(j, jl)
    script(t, tl)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert a == b, f"step {i} differs"
    st = tl[-1]["moves"]
    assert st["up_transfers"] > 0 and st["down_transfers"] > 0


def test_prefix_cache_matches_jax():
    j, t = caches()
    prompt = list(range(1, 30))
    for c in (j, t):
        s = c.add_seq()
        c.extend_seq(s, len(prompt))
        c.register_prefix(s, prompt, len(prompt), c.kv_dtype)
        s2 = c.add_seq()
        matched, bids = c.match_prefix(prompt + [99], c.kv_dtype)
        c.claim_prefix(s2, bids)
        c.ref = (matched, bids, c.get_statistics()["runtime"])
    assert t.ref == j.ref
    assert t.ref[0] == 24          # three full blocks; the last token recomputes


def test_evict_candidates_order_matches_jax():
    j, t = caches()
    for c in (j, t):
        slots = [c.add_seq() for _ in range(3)]
        for s, n in zip(slots, (16, 16, 24)):
            c.extend_seq(s, n)
            c.touch_seq(s)
        c.touch_seq(slots[0])
        c.protected = set(c.pool.seq(slots[1]).live_blocks)
        c.decode_hot = set(c.pool.seq(slots[2]).live_blocks[:1])
        c.order = c._evict_candidates(7)
    assert t.order == j.order


def _fill(t, gen):
    """Random bytes and scales in every HBM slot of the port's pools."""
    for p in t.pools[:2]:
        p.copy_(torch.randint(-127, 128, p.shape, generator=gen).to(p.dtype))
    for p in t.pools[2:]:
        p.copy_(torch.rand(p.shape, generator=gen))


@pytest.mark.parametrize("kv", ["int8", "bf16", "int4", "fp8"])
def test_blocks_survive_round_trip(kv):
    """Every block keeps its bytes through demotion to the host tier and
    promotion back into (another) HBM slot."""
    _, t = caches(kv)
    gen = torch.Generator().manual_seed(0)
    a, b = t.add_seq(), t.add_seq()
    t.extend_seq(a, 6 * BS)
    _fill(t, gen)

    def blocks_of(s):
        t._sync_tables([s])
        row = np.asarray(t.pool.table.row(s))[:len(t.pool.seq(s).blocks)]
        return [tuple(p[:, int(slot)].clone() for p in t.pools) for slot in row]

    before = blocks_of(a)
    t.extend_seq(b, 7 * BS)          # 6 + 7 > 10: a's blocks go to the host
    assert t.get_statistics()["transfer"]["down_transfers"] > 0
    assert t.seq_nonresident_blocks(a)
    t.ensure_resident([a])           # ... and come back
    assert not t.seq_nonresident_blocks(a)
    assert t.get_statistics()["transfer"]["up_transfers"] > 0
    for want, got in zip(before, blocks_of(a)):
        for w, g in zip(want, got):
            assert torch.equal(w, g)


def test_rebuild_storage_when_idle():
    """Idle: new pools and host store in the new width (INT4 halves the
    last dim), the prefix map cleared, the directory kept, as in the JAX
    cache. Busy: ValueError."""
    j, t = caches()
    prompt = list(range(1, 30))
    for c in (j, t):
        s = c.add_seq()
        c.extend_seq(s, len(prompt))
        c.register_prefix(s, prompt, len(prompt), c.kv_dtype)
        with pytest.raises(ValueError, match="idle cache"):
            c.rebuild_storage(c.kv_dtype)
        c.free_seq(s)
        c.maintain()
    dirs = j.directory.get_statistics().as_dict()
    assert t.directory.get_statistics().as_dict() == dirs
    j.rebuild_storage(JKV.INT4)
    t.rebuild_storage(KVDtype.INT4)
    assert t.kv_dtype == t.config.kv_dtype == KVDtype.INT4
    assert t.k_pools.shape[-1] == tiny_test_config().head_dim // 2
    assert t.store.arrays[0].shape[-1] == tiny_test_config().head_dim // 2
    assert not t._prefix_map and not j._prefix_map
    assert t.directory.get_statistics().as_dict() == dirs
    assert t.compression_statistics() == j.compression_statistics()
    t.rebuild_storage(KVDtype.BF16)
    assert t.k_pools.dtype == t.store.arrays[0].dtype == torch.bfloat16


def test_migrate_program_rows():
    """One batch moves whole blocks (all layers) both ways; pad lanes at
    the guard slots move nothing; demotes read the pre-promote pools."""
    L, S, H, D = 2, 5, 2, 4
    gen = torch.Generator().manual_seed(1)
    pools = (torch.randint(-9, 9, (L, S + 1, H, BS, D), generator=gen).to(torch.int8),
             torch.randint(-9, 9, (L, S + 1, H, BS, D), generator=gen).to(torch.int8),
             torch.rand((L, S + 1, H, BS), generator=gen),
             torch.rand((L, S + 1, H, BS), generator=gen))
    store = DeviceHostStore(6, L, BS, H, D, torch.int8, pin=False)
    for a in store.arrays:
        a.copy_(torch.rand(a.shape, generator=gen).mul(9).to(a.dtype))
    old = [p.clone() for p in pools]
    old_store = [a.clone() for a in store.arrays]
    # slot 2 demotes to host slot 4 while host slot 1 promotes into slot 2
    mig = pad_migration([(1, 2)], [(2, 4)], S, 6)
    assert mig.shape == (4, MIGRATE_BATCH)
    migrate_program(pools, store, mig)
    for p, o, a, oa in zip(pools, old, store.arrays, old_store):
        for li in range(L):
            assert torch.equal(a[4 * L + li], o[li, 2])       # demoted
            assert torch.equal(p[li, 2], oa[1 * L + li])      # promoted
        keep = [s for s in range(S + 1) if s != 2]
        assert torch.equal(p[:, keep], o[:, keep])
        rows = [r for r in range(7 * L) if r // L != 4]
        assert torch.equal(a[rows], oa[rows])
