"""The port's engine end to end on the CPU (plain attention versions):

- an oversubscribed HBM pool (blocks migrating every step) emits the same
  greedy tokens as an ample pool, at decode horizons 1 and 4;
- the port's and the JAX package's engines, on `tiny_test_config()` with
  the JAX weights carried over, emit the same greedy tokens at horizons 1
  and 4. A divergence passes only as a near-tie: the two tokens are the
  top two of the dense logits there, less than NEAR_TIE apart (the
  reference's rule, ROADMAP.md "Token level"). The JAX engine runs its
  Pallas kernels in interpret mode, as the port runs bfloat16 attention
  compute;
- the automatic decode horizon is derived as the JAX engine derives it,
  `enable_lstm=True` builds the prefetch predictor, an engine with fused
  rounds builds, and a host-streamed request and a session turn that only
  the host-streamed path can serve are served.
"""

import jax
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import CacheConfig as JCacheConfig
from cxl_speckv_tpu.config import EngineConfig as JEngineConfig
from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.config import PrefetchConfig as JPrefetchConfig
from cxl_speckv_tpu.config import SystemConfig as JSystemConfig
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.models.llama import init_params as j_init_params
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.models.llama import forward_dense

CFG = tiny_test_config()
JPARAMS = j_init_params(j_tiny(), jax.random.PRNGKey(42))
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS))
NEAR_TIE = 0.06


def system(hbm, host, batch, horizon, kv="int8", chunk=32, quantum=1,
           mods=(CacheConfig, EngineConfig, KVDtype, PrefetchConfig,
                 SystemConfig)):
    cc, ec, kvd, pc, sc = mods
    return sc(cache=cc(block_size=8, num_hbm_blocks=hbm, num_host_blocks=host,
                       kv_dtype=kvd(kv)),
              prefetch=pc(enabled=True, depth=2),
              engine=ec(max_batch_size=batch, max_seq_len=128,
                        prefill_chunk=chunk, decode_horizon=horizon,
                        sched_quantum=quantum))


def engine(hbm=256, host=256, batch=2, horizon=1, **kw):
    return Engine(CFG, system(hbm, host, batch, horizon, **kw), params=PARAMS,
                  device="cpu", enable_lstm=False)


def jax_engine(hbm=256, host=256, batch=2, horizon=1, **kw):
    mods = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig, JSystemConfig)
    return JEngine(j_tiny(), system(hbm, host, batch, horizon, mods=mods, **kw),
                   params=JPARAMS, use_pallas=True, enable_lstm=False)


def prompts(n, seed=3, lo=6, hi=24):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG.vocab_size, rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def assert_same_or_near_tie(ps, got, want):
    """Token lists equal, or diverging first at a near-tie."""
    for p, g, w in zip(ps, got, want):
        if g == w:
            continue
        i = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), None)
        assert i is not None, f"lengths differ without a token diverging: {g} {w}"
        ctx = torch.tensor([p + g[:i]])
        logits = forward_dense(PARAMS, CFG, ctx)[0, -1]
        top = torch.topk(logits, 2)
        assert {g[i], w[i]} == set(top.indices.tolist()), (p, g, w, i)
        gap = float(top.values[0] - top.values[1])
        assert gap < NEAR_TIE, f"divergence at a gap of {gap}"


@pytest.mark.parametrize("horizon", [1, 4])
def test_oversubscribed_equals_ample(horizon):
    ps = prompts(8)
    ample = engine(horizon=horizon).generate(ps, max_new_tokens=12)
    # a fused round pre-extends every lane by horizon - 1 tokens
    tight_eng = engine(hbm=12 if horizon == 1 else 14, horizon=horizon)
    tight = tight_eng.generate(ps, max_new_tokens=12)
    assert tight == ample
    assert all(len(t) == 12 or t[-1] == CFG.eos_token_id for t in tight)
    st = tight_eng.get_statistics()
    assert st["transfer"]["down_transfers"] > 0
    assert st["transfer"]["up_transfers"] > 0
    assert st["engine"]["requests_finished"] == 8


@pytest.mark.parametrize("horizon", [1, 4])
def test_matches_jax_engine(horizon):
    ps = prompts(6, seed=5)
    jeng = jax_engine(hbm=14, horizon=horizon)
    want = jeng.generate(ps, max_new_tokens=10)
    eng = engine(hbm=14, horizon=horizon)
    got = eng.generate(ps, max_new_tokens=10)
    assert_same_or_near_tie(ps, got, want)
    st = eng.get_statistics()
    assert st["engine"]["prefill_dispatches"] > 0
    assert st["scheduler"]["decode_batches"] > 0
    assert st["transfer"]["up_transfers"] > 0
    if got == want:
        # the same tokens through the same scheduler and cache: the same
        # residency decisions, migrations and prefix reuse
        jst = jeng.get_statistics()
        for key in ("transfer", "directory", "scheduler", "pool", "runtime"):
            assert st[key] == jst[key], key


def test_statistics_and_stops():
    eng = engine(batch=2, horizon=1)
    ps = prompts(3, seed=7)
    free = eng.generate(ps[:1], max_new_tokens=6)[0]
    eng.add_request(ps[0], max_new_tokens=6, stop_token_ids=[free[2]])
    eng.add_request(ps[0], max_new_tokens=6, stop_sequences=[free[1:3]])
    eng.add_request(ps[1], max_new_tokens=3)
    outs = {o.req_id: o for o in eng.run()}
    assert outs[1].tokens == free[:3] and outs[1].finish_reason == "stop"
    assert outs[2].tokens == free[:1] and outs[2].finish_reason == "stop"
    assert outs[3].finish_reason == "length" and len(outs[3].tokens) == 3
    st = eng.get_statistics()
    for key in ("engine", "scheduler", "directory", "transfer", "phases",
                "prefetch", "compression"):
        assert key in st
    assert st["engine"]["requests_finished"] == 4
    assert st["engine"]["tokens_generated"] >= 12
    assert st["engine"]["p50_ttft_ms"] > 0


def test_sampled_requests_finish_and_are_seeded():
    """Temperature / top-p lanes sample on the device from a seeded
    generator: the same seed gives the same tokens."""
    ps = prompts(4, seed=9)

    def run(seed):
        eng = Engine(CFG, system(256, 256, 2, 4), params=PARAMS, device="cpu",
                     seed=seed)
        return eng.generate(ps, max_new_tokens=8, temperature=0.8, top_p=0.9)

    a, b = run(1), run(1)
    assert a == b
    assert all(1 <= len(t) <= 8 for t in a)


def test_runtime_prefetch_depth_knob():
    """`set_prefetch_depth` clamps to [min_depth, max_depth], as the JAX
    engine's does (`tests/test_engine.py:191-196`)."""
    eng, ref = engine(), jax_engine()
    pf = eng.config.prefetch
    eng.set_prefetch_depth(6)
    assert eng.prefetcher.depth == 6
    eng.set_prefetch_depth(100)
    assert eng.prefetcher.depth == pf.max_depth
    eng.set_prefetch_depth(0)
    assert eng.prefetcher.depth == pf.min_depth
    for depth in (6, 100, 0, -3, pf.min_depth, pf.max_depth):
        eng.set_prefetch_depth(depth)
        ref.set_prefetch_depth(depth)
        assert eng.prefetcher.depth == ref.prefetcher.depth


def test_unported_paths_raise():
    # the automatic horizon and the prefetch LSTM are ported: horizon 0 is
    # derived (and written back) as the JAX engine derives it, and
    # enable_lstm=True builds the predictor
    eng = engine(horizon=0)
    assert eng.config.engine.decode_horizon >= 1
    assert (eng.config.engine.decode_horizon
            == jax_engine(horizon=0).config.engine.decode_horizon)
    eng = Engine(CFG, system(32, 32, 2, 1), params=PARAMS, device="cpu",
                 enable_lstm=True)
    assert eng.prefetcher.predictor is not None
    # fused rounds are ported: the engine builds and folds migrations
    # into its rounds (tests/test_torch_migrate.py serves them)
    sc = system(32, 32, 2, 1)
    sc.engine.fused_rounds = True
    eng = Engine(CFG, sc, params=PARAMS, device="cpu")
    assert eng._fused_rounds and eng.kvc.defer_migrations
    eng = engine(hbm=6, host=64)
    # past the 4-block pooled capacity: served host-streamed
    rid = eng.add_request(list(range(1, 60)), max_new_tokens=4)
    out = {o.req_id: o for o in eng.run()}[rid]
    assert out.finish_reason in ("length", "eos") and out.tokens
    assert eng.get_statistics()["engine"]["stream_chunks"] == 2
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request([], max_new_tokens=4)
    # a session turn that only the host-streamed path can serve: the
    # reclaimed history re-prefills past the 4-block pooled capacity
    sid = eng.add_request(list(range(1, 13)), max_new_tokens=4, session=True)
    eng.run()
    assert eng._reclaim_idle_session()
    rid = eng.continue_session(sid, list(range(1, 17)), max_new_tokens=4)
    out = {o.req_id: o for o in eng.run()}[rid]
    assert out.finish_reason in ("length", "eos") and out.tokens
    sess = eng.get_session(sid)
    assert sess.reprefills == 1 and sess.live and sess.stream_bids
