"""KV compression schemes in the port's engine, on the CPU (plain attention
versions): the runtime scheme knob `Engine.set_kv_dtype` and per-layer
schemes `CacheConfig.layer_kv_dtypes`, ported from the JAX package's
tests/test_scheme_switch.py (all but its mesh test) and
tests/test_mixed_layers.py, with the same invariants:

- the knob changes encodings, never results: every request's tokens equal
  those of an engine fixed to the scheme it was submitted under;
- a degenerate all-INT8 (all-FP8) table equals the uniform engine, and a
  mixed table's tokens do not depend on tiering.

Then the port's engine against the JAX engine, for the same call sequence
and params (`params_from_jax`): the mid-serve switch and the mixed table,
ample and tiered. A divergence passes only as a near-tie
(`test_torch_engine.assert_same_or_near_tie`); the JAX engine runs its
Pallas kernels in interpret mode.
"""

import numpy as np
import pytest

from cxl_speckv_tpu.config import CacheConfig as JCacheConfig
from cxl_speckv_tpu.config import EngineConfig as JEngineConfig
from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.config import PrefetchConfig as JPrefetchConfig
from cxl_speckv_tpu.config import SystemConfig as JSystemConfig
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models.configs import tiny_test_config

from test_torch_engine import (
    JPARAMS,
    PARAMS,
    assert_same_or_near_tie,
    prompts,
)

CFG = tiny_test_config()
MIXED = tuple(KVDtype.INT8 if i % 2 == 0 else KVDtype.FP8
              for i in range(CFG.num_layers))
TORCH = (CacheConfig, EngineConfig, PrefetchConfig, SystemConfig)
JAX = (JCacheConfig, JEngineConfig, JPrefetchConfig, JSystemConfig)


def system(kv_dtype, hbm, host, batch, seq, horizon, layer_dtypes, mods):
    cc, ec, pc, sc = mods
    return sc(cache=cc(block_size=8, num_hbm_blocks=hbm, num_host_blocks=host,
                       kv_dtype=kv_dtype, layer_kv_dtypes=layer_dtypes),
              prefetch=pc(enabled=True, depth=2),
              engine=ec(max_batch_size=batch, max_seq_len=seq,
                        prefill_chunk=32, decode_horizon=horizon))


def make_engine(kv_dtype=KVDtype.INT8, hbm=32, host=64, horizon=2,
                layer_dtypes=None, batch=4, seq=96):
    """The JAX tests' engines: test_scheme_switch.py's by default,
    test_mixed_layers.py's with batch 2 and seq 128."""
    return Engine(CFG, system(kv_dtype, hbm, host, batch, seq, horizon,
                              layer_dtypes, TORCH), params=PARAMS,
                  device="cpu", enable_lstm=False)


def jax_engine(kv_dtype=JKV.INT8, hbm=32, host=64, horizon=2,
               layer_dtypes=None, batch=4, seq=96):
    return JEngine(j_tiny(), system(kv_dtype, hbm, host, batch, seq, horizon,
                                    layer_dtypes, JAX),
                   params=JPARAMS, use_pallas=True, enable_lstm=False)


def mixed_engine(**kw):
    return make_engine(layer_dtypes=MIXED, hbm=kw.pop("hbm", 256),
                       host=kw.pop("host", 256), batch=2, seq=128, **kw)


def serve(eng, ps, gen=10) -> list[list[int]]:
    ids = [eng.add_request(p, max_new_tokens=gen) for p in ps]
    outs = {o.req_id: o.tokens for o in eng.run()}
    return [outs[i] for i in ids]


def test_width_switch_semantics():
    eng = make_engine(KVDtype.INT8)
    eng.set_kv_dtype(KVDtype.FP8)       # byte <-> byte: live switch
    eng.set_kv_dtype("int8")            # accepts raw enum values
    eng.set_kv_dtype(KVDtype.INT4)      # cross-width on an idle engine
    assert eng.kvc.kv_dtype == KVDtype.INT4
    eng.set_kv_dtype(KVDtype.INT8)
    assert eng.kvc.kv_dtype == KVDtype.INT8
    assert eng.kvc.k_pools.shape[-1] == CFG.head_dim


def switch_mid_serve(eng, ps8, ps_fp8, fp8, gen=10):
    """Serve the INT8 cohort three steps, switch to FP8, add the FP8
    cohort, run to the end. Returns (tokens of both cohorts, the statistics
    right after the switch, the statistics at the end)."""
    ids8 = [eng.add_request(p, max_new_tokens=gen) for p in ps8]
    for _ in range(3):
        eng.step()
    eng.set_kv_dtype(fp8)
    idsf = [eng.add_request(p, max_new_tokens=gen) for p in ps_fp8]
    mid = eng.get_statistics()
    outs = {o.req_id: o.tokens for o in eng.run()}
    return [outs[i] for i in ids8 + idsf], mid, eng.get_statistics()


def test_switch_mid_serve_matches_fixed_engines():
    """Both cohorts coexist in one pool and each matches an engine fixed
    to its scheme."""
    ps8, ps_fp8 = prompts(3, seed=1), prompts(3, seed=2)
    got, mid, st = switch_mid_serve(make_engine(KVDtype.INT8), ps8, ps_fp8,
                                    KVDtype.FP8)
    assert st["kv_scheme_current"] == "fp8"
    assert set(mid["kv_scheme_live_tokens"]) <= {"int8", "fp8"}
    assert got[:3] == serve(make_engine(KVDtype.INT8), ps8)
    assert got[3:] == serve(make_engine(KVDtype.FP8), ps_fp8)


def test_switch_mid_serve_matches_jax_engine():
    ps8, ps_fp8 = prompts(3, seed=1), prompts(3, seed=2)
    got, mid, st = switch_mid_serve(make_engine(KVDtype.INT8), ps8, ps_fp8,
                                    KVDtype.FP8)
    want, jmid, jst = switch_mid_serve(jax_engine(JKV.INT8), ps8, ps_fp8,
                                       JKV.FP8)
    assert_same_or_near_tie(ps8 + ps_fp8, got, want)
    for key in ("kv_scheme_current", "kv_scheme_live_tokens"):
        assert mid[key] == jmid[key] and st[key] == jst[key], key


def test_mixed_scheme_decode_batch():
    """Lanes of different schemes in one decode rotation: dispatches split
    by scheme and every lane still finishes."""
    eng = make_engine(KVDtype.INT8, horizon=4)
    a = eng.add_request(prompts(1, 3)[0], max_new_tokens=12)
    eng.set_kv_dtype(KVDtype.FP8)
    b = eng.add_request(prompts(1, 4)[0], max_new_tokens=12)
    outs = {o.req_id: o for o in eng.run()}
    assert len(outs[a].tokens) == 12 and len(outs[b].tokens) == 12
    st = eng.get_statistics()
    assert st["kv_scheme_live_tokens"] == {}   # all finished
    # the two lanes decode in separate dispatches
    assert st["scheduler"]["decode_batches"] > 12 // 4


def test_fp8_engine_matches_fp8_storage_roundtrip():
    """FP8 bytes round-trip through migration: oversubscribed == ample."""
    ps = prompts(4, seed=9)
    ample = serve(make_engine(KVDtype.FP8, hbm=64, host=0), ps)
    tight_eng = make_engine(KVDtype.FP8, hbm=8, host=64)
    assert serve(tight_eng, ps) == ample
    assert tight_eng.get_statistics()["transfer"]["up_transfers"] > 0


def test_cross_width_switch_idle_rebuild():
    """INT8 -> INT4 -> BF16 on an idle engine: the pools rebuild in the new
    width and serving matches a fresh engine of that scheme."""
    p = [np.random.RandomState(11).randint(1, CFG.vocab_size, 12).tolist()]
    eng = make_engine(KVDtype.INT8)
    serve(eng, p, gen=6)
    eng.set_kv_dtype(KVDtype.INT4)
    assert eng.kvc.kv_dtype == KVDtype.INT4
    assert eng.kvc.k_pools.shape[-1] == CFG.head_dim // 2
    assert serve(eng, p, gen=6) == serve(make_engine(KVDtype.INT4), p, gen=6)
    eng.set_kv_dtype(KVDtype.BF16)
    assert serve(eng, p, gen=6) == serve(make_engine(KVDtype.BF16), p, gen=6)


def test_cross_width_switch_rejected_while_busy():
    eng = make_engine(KVDtype.INT8)
    eng.add_request([5, 6, 7, 8], max_new_tokens=8)
    eng.step()
    with pytest.raises(ValueError, match="idle engine"):
        eng.set_kv_dtype(KVDtype.INT4)
    eng.set_kv_dtype(KVDtype.FP8)       # same width stays legal mid-serve
    eng.run()


@pytest.mark.parametrize("uni", [KVDtype.INT8, KVDtype.FP8])
def test_degenerate_table_matches_uniform(uni):
    ps = prompts(4, seed=1)
    want = serve(make_engine(kv_dtype=uni, hbm=256, host=256, horizon=1,
                             batch=2, seq=128), ps)
    got = serve(make_engine(layer_dtypes=(uni,) * CFG.num_layers, hbm=256,
                            host=256, horizon=1, batch=2, seq=128), ps)
    assert got == want


def test_mixed_table_tiering_invisible():
    """Oversubscribed mixed-scheme engine == ample mixed-scheme engine; a
    live per-layer table reports its tokens as "mixed8"."""
    ps = prompts(6, seed=3)
    ample = serve(mixed_engine(horizon=1), ps)
    eng = mixed_engine(hbm=12, horizon=4)
    for p in ps:
        eng.add_request(p, max_new_tokens=10)
    eng.step()
    assert set(eng.get_statistics()["kv_scheme_live_tokens"]) == {"mixed8"}
    outs = {o.req_id: o.tokens for o in eng.run()}
    assert [outs[i] for i in range(len(ps))] == ample
    assert eng.get_statistics()["transfer"]["up_transfers"] > 0


@pytest.mark.parametrize("hbm,horizon", [(256, 1), (12, 4)])
def test_mixed_table_matches_jax_engine(hbm, horizon):
    ps = prompts(6, seed=3)
    jmixed = tuple(JKV(d.value) for d in MIXED)
    want = serve(jax_engine(layer_dtypes=jmixed, hbm=hbm, host=256,
                            horizon=horizon, batch=2, seq=128), ps)
    got = serve(mixed_engine(hbm=hbm, horizon=horizon), ps)
    assert_same_or_near_tie(ps, got, want)


def test_mixed_table_validation():
    with pytest.raises(ValueError):
        CacheConfig(layer_kv_dtypes=(KVDtype.INT4,) * CFG.num_layers).validate()
    with pytest.raises(ValueError, match="layer_kv_dtypes has 1 entries"):
        make_engine(layer_dtypes=(KVDtype.INT8,))
    eng = mixed_engine()
    with pytest.raises(ValueError, match="per-layer scheme table"):
        eng.set_kv_dtype(KVDtype.FP8)
