"""The pageable host store (`CacheConfig.host_store_backend="numpy"`,
`runtime/transfer.py:HostStore` / `TransferEngine`) against the JAX
package's, on the CPU:

- the six cases of `tests/test_transfer.py` (a demote / promote round trip,
  a batch of distinct blocks, a demand fetch, the landing zone, the
  prefetch path, an extend that evicts) driven through both packages'
  caches: the same assertions on each, the host store's bytes equal
  between them, and equal transfer statistics;
- the engine on the numpy backend: the same tokens as the device backend
  and as an ample pool, migrations both ways, fused rounds and the
  host-streamed path off (the JAX engine's rule), and the JAX engine on
  its numpy backend at the same tokens.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import (
    CFG,
    JPARAMS,
    PARAMS,
    JCacheConfig,
    JEngine,
    JEngineConfig,
    JKV,
    JPrefetchConfig,
    JSystemConfig,
)

from cxl_speckv_tpu.core.directory import BlockState as JBlockState
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.runtime.kv_cache import TieredKVCache as JTieredKVCache
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.core.directory import BlockState
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache
from cxl_speckv_tpu_torch.runtime.transfer import HostStore, TransferEngine


class JaxSide:
    """`tests/test_transfer.py`'s helpers on the JAX cache."""

    state = JBlockState

    @staticmethod
    def cache(hbm, host):
        cc = JCacheConfig(block_size=8, num_hbm_blocks=hbm,
                          num_host_blocks=host, kv_dtype=JKV.INT8,
                          prefetch_reserve_frac=0.25,
                          host_store_backend="numpy")
        return JTieredKVCache(cc, j_tiny(), max_seqs=4, max_blocks_per_seq=8,
                              native=False)

    @staticmethod
    def fill_block(kvc, seq, block_idx, value):
        bid = kvc.pool.seq(seq).blocks[block_idx]
        slot = kvc.directory.entry(bid).hbm_slot
        k, v, ks, vs = kvc.pools
        k = k.at[:, slot].set(jnp.full(k.shape[2:], value, k.dtype))
        ks = ks.at[:, slot].set(float(value))
        kvc.set_pools((k, v, ks, vs))
        kvc.directory.mark_dirty(bid)
        return bid, slot

    @staticmethod
    def flush(kvc, **kw):
        kvc.set_pools(kvc.transfer.flush(kvc.pools, kvc.directory, **kw))

    @staticmethod
    def k_slot(kvc, slot):
        """Layer 0, head 0, token 0 of K at an HBM slot (the JAX pool is kT:
        [L, S, D, Hkv * bs])."""
        return np.asarray(kvc.pools[0])[0, slot, :, 0]

    @staticmethod
    def store(kvc):
        return [np.asarray(a) for a in (kvc.host.k, kvc.host.v, kvc.host.ks,
                                        kvc.host.vs)]


class PortSide:
    state = BlockState

    @staticmethod
    def cache(hbm, host):
        cc = CacheConfig(block_size=8, num_hbm_blocks=hbm,
                         num_host_blocks=host, kv_dtype=KVDtype.INT8,
                         prefetch_reserve_frac=0.25,
                         host_store_backend="numpy")
        return TieredKVCache(cc, tiny_test_config(), max_seqs=4,
                             max_blocks_per_seq=8, device="cpu", native=False)

    @staticmethod
    def fill_block(kvc, seq, block_idx, value):
        bid = kvc.pool.seq(seq).blocks[block_idx]
        slot = kvc.directory.entry(bid).hbm_slot
        kvc.k_pools[:, slot] = value
        kvc.k_scales[:, slot] = float(value)
        kvc.directory.mark_dirty(bid)
        return bid, slot

    @staticmethod
    def flush(kvc, **kw):
        kvc.transfer.flush(kvc.pools, kvc.directory, **kw)

    @staticmethod
    def k_slot(kvc, slot):
        return kvc.k_pools[0, slot, 0, 0].numpy()

    @staticmethod
    def store(kvc):
        return [t.numpy() for t in (kvc.host.k, kvc.host.v, kvc.host.ks,
                                    kvc.host.vs)]


def demote(side, kvc, bid):
    res = kvc.directory.start_demote(bid)
    assert res is not None
    kvc.transfer.enqueue_demote(bid, *res)


def case_roundtrip(side):
    kvc = side.cache(8, 16)
    s = kvc.add_seq()
    assert kvc.extend_seq(s, 16)
    bid, slot = side.fill_block(kvc, s, 0, 7)
    kvc.pin_seq(s, False)
    demote(side, kvc, bid)
    side.flush(kvc)
    kvc.transfer.poll(kvc.directory, wait=True)
    e = kvc.directory.entry(bid)
    assert e.state == side.state.HOST
    assert (side.store(kvc)[0][e.host_slot, 0, 0] == 7).all()
    assert side.store(kvc)[2][e.host_slot].max() == 7.0
    host_slot, hbm_slot = kvc.directory.start_promote(bid)
    kvc.transfer.enqueue_promote(bid, host_slot, hbm_slot)
    side.flush(kvc, wait_up=True)
    assert kvc.directory.entry(bid).state == side.state.HBM
    assert (side.k_slot(kvc, hbm_slot) == 7).all()
    st = kvc.transfer.get_statistics()
    assert st.up_transfers == 1 and st.down_transfers == 1
    assert st.bytes_up == st.bytes_down == kvc.host.bytes_per_block
    return kvc


def case_batched(side):
    kvc = side.cache(8, 16)
    s = kvc.add_seq()
    kvc.extend_seq(s, 32)
    bids = [side.fill_block(kvc, s, i, i + 1)[0] for i in range(4)]
    kvc.pin_seq(s, False)
    for bid in bids:
        demote(side, kvc, bid)
    side.flush(kvc)
    kvc.transfer.poll(kvc.directory, wait=True)
    for i, bid in enumerate(bids):
        e = kvc.directory.entry(bid)
        assert side.store(kvc)[0][e.host_slot, 0, 0, 0, 0] == i + 1
    for bid in bids:
        kvc.transfer.enqueue_promote(bid, kvc.directory.entry(bid).host_slot,
                                     kvc.directory.start_promote(bid)[1])
    side.flush(kvc, wait_up=True)
    for i, bid in enumerate(bids):
        slot = kvc.directory.entry(bid).hbm_slot
        assert side.k_slot(kvc, slot)[0] == i + 1
    return kvc


def case_demand_fetch(side):
    kvc = side.cache(8, 16)
    s = kvc.add_seq()
    kvc.extend_seq(s, 24)
    bid, _ = side.fill_block(kvc, s, 1, 5)
    kvc.pin_seq(s, False)
    demote(side, kvc, bid)
    side.flush(kvc)
    kvc.transfer.poll(kvc.directory, wait=True)
    assert kvc.seq_nonresident_blocks(s) == [bid]
    assert kvc.ensure_resident([s]) == 1
    assert kvc.seq_nonresident_blocks(s) == []
    assert kvc.stats.demand_fetch_blocks == 1
    e = kvc.directory.entry(bid)
    assert kvc.pool.table.get(s, 1) == e.hbm_slot
    assert side.k_slot(kvc, e.hbm_slot)[0] == 5
    return kvc


def case_landing_zone(side):
    kvc = side.cache(8, 16)                       # reserve = 2
    s = kvc.add_seq()
    kvc.extend_seq(s, 7 * 8)
    kvc.pin_seq(s, False)
    assert kvc.directory.hbm_pressure() == 1
    kvc.maintain()
    kvc.transfer.poll(kvc.directory, wait=True)
    assert kvc.directory.hbm_pressure() == 0
    assert kvc.stats.maintain_demotes >= 1
    return kvc


def case_prefetch(side):
    kvc = side.cache(8, 16)
    s = kvc.add_seq()
    kvc.extend_seq(s, 16)
    kvc.pin_seq(s, False)
    bid = kvc.pool.seq(s).blocks[0]
    kvc.directory.mark_dirty(bid)                 # force the writeback path
    demote(side, kvc, bid)
    side.flush(kvc)
    kvc.transfer.poll(kvc.directory, wait=True)
    assert kvc.prefetch_blocks([bid]) == 1
    side.flush(kvc, wait_up=True)
    assert kvc.directory.entry(bid).prefetched
    kvc.touch_seq(s)
    st = kvc.directory.get_statistics()
    assert st.prefetch_hits == 1 and st.hit_rate == 1.0
    return kvc


def case_oom_extend(side):
    kvc = side.cache(4, 16)
    s1 = kvc.add_seq()
    assert kvc.extend_seq(s1, 3 * 8)
    kvc.pin_seq(s1, False)
    s2 = kvc.add_seq()
    assert kvc.extend_seq(s2, 2 * 8)
    assert kvc.pool.stats.alloc_failures == 0
    assert len(kvc.pool.seq(s2).blocks) == 2
    return kvc


CASES = {f.__name__[5:]: f for f in (case_roundtrip, case_batched,
                                     case_demand_fetch, case_landing_zone,
                                     case_prefetch, case_oom_extend)}


@pytest.mark.parametrize("case", list(CASES))
def test_transfer_case_matches_jax(case):
    want = CASES[case](JaxSide)
    got = CASES[case](PortSide)
    for g, w in zip(PortSide.store(got), JaxSide.store(want)):
        np.testing.assert_array_equal(g, w)
    gs, ws = got.transfer.get_statistics(), want.transfer.get_statistics()
    for k in ("up_transfers", "down_transfers", "up_batches", "down_batches",
              "bytes_up", "bytes_down", "polls"):
        assert getattr(gs, k) == getattr(ws, k), k
    assert (got.directory.get_statistics().as_dict()
            == want.directory.get_statistics().as_dict())


def test_host_store_layout_and_drain():
    hs = HostStore(5, 2, 8, 2, 16, torch.int8)
    assert hs.k.shape == (5, 2, 2, 8, 16) and hs.ks.shape == (5, 2, 2, 8)
    assert not hs.k.is_cuda and bool((hs.ks == 1).all())
    assert hs.bytes_per_block == 2 * (2 * 2 * 8 * 16) + 2 * (2 * 2 * 8 * 4)
    te = TransferEngine(hs, "cpu")
    assert te.queued == 0 and te.inflight_down == 0
    kvc = PortSide.cache(8, 16)
    s = kvc.add_seq()
    kvc.extend_seq(s, 32)
    kvc.pin_seq(s, False)
    for b in kvc.pool.seq(s).blocks[:3]:
        demote(PortSide, kvc, b)
    assert kvc.transfer.queued == 3
    kvc.drain()
    assert kvc.transfer.queued == 0 and kvc.transfer.inflight_down == 0
    assert kvc.directory.state_counts()["HOST"] == 3
    # a queued writeback cancels at once; one in flight does not
    b = kvc.pool.seq(s).blocks[3]
    demote(PortSide, kvc, b)
    assert kvc.transfer.cancel_queued_demote(b, kvc.directory)
    assert kvc.directory.entry(b).state == BlockState.HBM


def system(backend, hbm, host, horizon=4, fused=False,
           mods=(CacheConfig, EngineConfig, KVDtype, PrefetchConfig,
                 SystemConfig)):
    cc, ec, kvd, pc, sc = mods
    return sc(cache=cc(block_size=8, num_hbm_blocks=hbm, num_host_blocks=host,
                       kv_dtype=kvd("int8"), host_store_backend=backend),
              prefetch=pc(enabled=True, depth=2),
              engine=ec(max_batch_size=2, max_seq_len=128, prefill_chunk=32,
                        decode_horizon=horizon, fused_rounds=fused))


def serve(eng, ps, n=12):
    ids = [eng.add_request(p, max_new_tokens=n) for p in ps]
    outs = {o.req_id: o.tokens for o in eng.run()}
    return [outs[i] for i in ids]


def test_numpy_backend_engine_equals_device_and_ample():
    rng = np.random.RandomState(3)
    ps = [rng.randint(1, CFG.vocab_size, rng.randint(6, 24)).tolist()
          for _ in range(8)]
    eng = Engine(CFG, system("numpy", 14, 256, fused=True), params=PARAMS,
                 device="cpu", enable_lstm=False)
    assert not eng.kvc.device_mode and eng.kvc.store is None
    assert not eng._fused_rounds and not eng.kvc.defer_migrations
    assert eng._stream_max_blocks == 0
    got = serve(eng, ps)
    st = eng.get_statistics()
    assert st["transfer"]["up_transfers"] > 0
    assert st["transfer"]["down_transfers"] > 0
    assert eng.kvc.transfer.queued == 0
    dev = serve(Engine(CFG, system("device", 14, 256), params=PARAMS,
                       device="cpu", enable_lstm=False), ps)
    ample = serve(Engine(CFG, system("device", 256, 0), params=PARAMS,
                         device="cpu", enable_lstm=False), ps)
    assert got == dev == ample
    mods = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig, JSystemConfig)
    jeng = JEngine(j_tiny(), system("numpy", 14, 256, mods=mods),
                   params=JPARAMS, use_pallas=True, enable_lstm=False)
    assert serve(jeng, ps) == got
