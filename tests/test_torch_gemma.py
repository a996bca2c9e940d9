"""Gemma-2 and Mistral in the port against the JAX package, on tiny configs
with the JAX weights carried over by `params_from_jax`:

- GEMMA: `tests/test_gemma.py`'s tiny Gemma-2 (window 6 on alternating
  layers, attention cap 30, final cap 10, GeGLU, sandwich norms, 1 + w
  norms, scaled embeddings, query scale 10^-0.5); GEMMA_TIED adds the tied
  head Gemma-2 has;
- MISTRAL: the tiny config with a uniform window of 16 (2 blocks of 8), so
  the engine retires out-of-window blocks.

Held: `forward_dense` logits within 1e-4 (float32, plain and W8A16);
chunked prefill then fused decode with equal greedy tokens and pools; the
port's engine against the JAX engine (greedy tokens equal, or diverging at
a near-tie, as `tests/test_torch_engine.py` holds them; equal statistics,
`window_retired_blocks` included); tiered == ample in the port; the
retirement-window gating. The JAX side runs its Pallas kernels in interpret
mode, as its own tests do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import CacheConfig as JCacheConfig
from cxl_speckv_tpu.config import EngineConfig as JEngineConfig
from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.config import PrefetchConfig as JPrefetchConfig
from cxl_speckv_tpu.config import SystemConfig as JSystemConfig
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.ops.quant import kv_storage_dtype as j_storage_dtype
from cxl_speckv_tpu.ops.wquant import quantize_weights as j_quantize_weights
from cxl_speckv_tpu.runtime.kv_cache import TieredKVCache as JCache
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models import llama as tl
from cxl_speckv_tpu_torch.models.configs import (
    gemma2_9b,
    mistral_7b,
    tiny_test_config,
)
from cxl_speckv_tpu_torch.models.convert import params_from_jax, pools_from_jax
from cxl_speckv_tpu_torch.ops.quant import kv_storage_dtype
from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache

GEMMA = dict(sliding_window=6, attn_pattern=(True, False), attn_softcap=30.0,
             final_softcap=10.0, norm_offset=True, post_norms=True,
             act_fn="gelu_tanh", embed_scale=True, query_scale=10.0**-0.5)
FAMILIES = {"gemma": GEMMA, "gemma_tied": dict(GEMMA, tie_embeddings=True),
            "mistral": dict(sliding_window=16)}
DENSE_TOL = 1e-4
SCALE_RTOL = 1e-6      # a few float32 ulps
LSB_SHARE = 1e-3       # stored int8 values one step apart (near-ties)
NEAR_TIE = 0.06
BS, SLOTS, MB, CHUNK = 8, 12, 4, 16


def configs(family):
    kw = FAMILIES[family]
    return (dataclasses.replace(j_tiny(), **kw),
            dataclasses.replace(tiny_test_config(), **kw))


def jax_params(family, seed=7):
    return jl.init_params(configs(family)[0], jax.random.PRNGKey(seed))


def carried(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("family", ["gemma", "gemma_tied", "mistral"])
def test_forward_dense_matches_jax(family, w8):
    """19 tokens: past both windows, so the sliding layers' masks bind."""
    jcfg, cfg = configs(family)
    jp = jax_params(family)
    jp = j_quantize_weights(jp) if w8 else jp
    toks = np.random.RandomState(1).randint(1, cfg.vocab_size, (2, 19))
    want = np.asarray(jl.forward_dense(jp, jcfg, jnp.asarray(toks)))
    got = tl.forward_dense(carried(jp), cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=DENSE_TOL,
                               atol=DENSE_TOL)


def test_gemma_conventions_take_effect():
    """The softcap bounds the logits and the window changes them: the port
    is not matching JAX by both ignoring a feature."""
    _, cfg = configs("gemma")
    params = carried(jax_params("gemma"))
    toks = torch.from_numpy(np.random.RandomState(2).randint(1, 256, (1, 19)))
    logits = tl.forward_dense(params, cfg, toks)
    assert float(logits.abs().max()) < cfg.final_softcap
    wide = dataclasses.replace(cfg, sliding_window=64)
    early, late = logits[0, :6], logits[0, 7:]
    wide_logits = tl.forward_dense(params, wide, toks)[0]
    torch.testing.assert_close(wide_logits[:6], early)       # window not hit
    assert float((wide_logits[7:] - late).abs().max()) > 1e-3


def _jax_pools(jcfg):
    dt = j_storage_dtype(JKV.INT8)
    L, S, Hkv, D = jcfg.num_layers, SLOTS + 1, jcfg.num_kv_heads, jcfg.head_dim
    return [jnp.zeros((L, S, D, Hkv * BS), dt),
            jnp.zeros((L, S, Hkv, BS, D), dt),
            jnp.ones((L, S, 1, Hkv * BS), jnp.float32),
            jnp.ones((L, S, 1, Hkv * BS), jnp.float32)]


def _torch_pools(cfg):
    shape = (cfg.num_layers, SLOTS + 1, cfg.num_kv_heads, BS, cfg.head_dim)
    dt = kv_storage_dtype(KVDtype.INT8)
    return (torch.zeros(shape, dtype=dt), torch.zeros(shape, dtype=dt),
            torch.ones(shape[:-1]), torch.ones(shape[:-1]))


def _assert_pools_equal(jpools, tpools, num_kv_heads):
    """Stored int8 K/V equal but for near-tie LSB flips (at most LSB_SHARE
    of them, one step each), scales to a few ulps: the rule of
    `tests/test_torch_llama.py:_assert_pools_equal`."""
    conv = pools_from_jax(*[np.asarray(a) for a in jpools], num_kv_heads)
    for want, got, name in zip(conv, tpools, ("k", "v", "k_scale", "v_scale")):
        assert want.shape == got.shape, name
        if name.endswith("scale"):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=SCALE_RTOL, atol=0,
                                       err_msg=f"pool {name}")
            continue
        d = np.abs(got.numpy().astype(np.int64) - want.numpy().astype(np.int64))
        assert d.max() <= 1, f"pool {name}: a value off by {d.max()} steps"
        assert (d > 0).mean() <= LSB_SHARE, f"pool {name}: {(d > 0).sum()} off"


@pytest.mark.parametrize("family", ["gemma", "mistral"])
def test_prefill_then_decode_matches_jax(family):
    """Two prefill dispatches (the second over pool context, the window
    binding in both families), then a fused 3-step decode: greedy tokens
    equal, pools equal."""
    jcfg, cfg = configs(family)
    jp = jax_params(family)
    params = carried(jp)
    rng = np.random.RandomState(2)
    guard = SLOTS
    tables = np.array([[3, 7, 1, guard], [10, 0, 5, guard]], np.int32)
    prompts = [rng.randint(1, cfg.vocab_size, 21),
               rng.randint(1, cfg.vocab_size, 9)]

    def prefill_packed(lanes):      # lanes: [(start, n)] per lane
        p = np.zeros((2, 4 + MB + CHUNK), np.int32)
        p[:, 3] = 1
        for i, (start, n) in enumerate(lanes):
            p[i, 0], p[i, 1] = start, n
            p[i, 4:4 + MB] = tables[i]
            p[i, 4 + MB:4 + MB + n] = prompts[i][start:start + n]
        return p

    waves = [prefill_packed([(0, 16), (0, 9)]),
             prefill_packed([(16, 5), (0, 0)])]
    jpools, tpools = _jax_pools(jcfg), _torch_pools(cfg)
    jtoks, ttoks = [], []
    for packed in waves:
        out = jl.prefill_batch_packed(jp, jcfg, JKV.INT8, jnp.asarray(packed),
                                      *jpools, max_blocks=MB, use_pallas=True)
        jtoks.append(np.asarray(out[0]))
        jpools = list(out[1:5])
        ttoks.append(tl.prefill_batch_packed(params, cfg, KVDtype.INT8,
                                             packed, tpools,
                                             max_blocks=MB).numpy())
    np.testing.assert_array_equal(ttoks[0][1], jtoks[0][1])
    np.testing.assert_array_equal(ttoks[1][0], jtoks[1][0])
    _assert_pools_equal(jpools, tpools, cfg.num_kv_heads)

    horizon = 3
    dp = np.zeros((2, MB + 4), np.int32)
    dp[:, 4:] = tables
    dp[0, :2] = ttoks[1][0], 21           # first token and its position
    dp[1, :2] = ttoks[0][1], 9
    out = jl.decode_multi_packed(jp, jcfg, JKV.INT8, jnp.asarray(dp),
                                 *jpools, horizon=horizon, use_pallas=True)
    got = tl.decode_multi_packed(params, cfg, KVDtype.INT8, dp, tpools,
                                 horizon=horizon)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out[0]))
    _assert_pools_equal(out[1:5], tpools, cfg.num_kv_heads)


def system(hbm, host, mods=(CacheConfig, EngineConfig, KVDtype,
                            PrefetchConfig, SystemConfig)):
    cc, ec, kvd, pc, sc = mods
    return sc(cache=cc(block_size=BS, num_hbm_blocks=hbm, num_host_blocks=host,
                       kv_dtype=kvd("int8")),
              prefetch=pc(enabled=True, depth=2),
              engine=ec(max_batch_size=2, max_seq_len=128, prefill_chunk=16,
                        decode_horizon=4, sched_quantum=1))


def prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, rng.randint(6, 24)).tolist() for _ in range(n)]


def assert_same_or_near_tie(params, cfg, ps, got, want):
    """Token lists equal, or diverging first at a near-tie of the dense
    logits (the reference's rule, ROADMAP.md "Token level")."""
    for p, g, w in zip(ps, got, want):
        if g == w:
            continue
        i = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), None)
        assert i is not None, f"lengths differ without a token diverging: {g} {w}"
        logits = tl.forward_dense(params, cfg, torch.tensor([p + g[:i]]))[0, -1]
        top = torch.topk(logits, 2)
        assert {g[i], w[i]} == set(top.indices.tolist()), (p, g, w, i)
        assert float(top.values[0] - top.values[1]) < NEAR_TIE


@pytest.mark.parametrize("family", ["gemma", "mistral"])
def test_engine_matches_jax_engine(family):
    """Tiered engines (14 HBM blocks) of both packages: the same greedy
    tokens and, given those, the same residency decisions, migrations and
    retirements. Mistral's window (16) is far below prompt + 24 new
    tokens, so blocks retire, the same number in both."""
    jcfg, cfg = configs(family)
    jp = jax_params(family, seed=42)
    params = carried(jp)
    ps = prompts(6, seed=5)
    mods = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig, JSystemConfig)
    jeng = JEngine(jcfg, system(14, 256, mods=mods), params=jp,
                   use_pallas=True, enable_lstm=False)
    want = jeng.generate(ps, max_new_tokens=24)
    eng = Engine(cfg, system(14, 256), params=params, device="cpu",
                 enable_lstm=False)
    got = eng.generate(ps, max_new_tokens=24)
    assert_same_or_near_tie(params, cfg, ps, got, want)
    st, jst = eng.get_statistics(), jeng.get_statistics()
    assert st["transfer"]["up_transfers"] > 0
    retired = st["runtime"]["window_retired_blocks"]
    assert retired == jst["runtime"]["window_retired_blocks"]
    assert (retired > 0) == (family == "mistral")
    if got == want:
        for key in ("transfer", "directory", "scheduler", "pool", "runtime"):
            assert st[key] == jst[key], key


@pytest.mark.parametrize("family", ["gemma_tied", "mistral"])
def test_tiered_equals_ample(family):
    """Oversubscribed HBM (10 blocks, migrating every step) emits what an
    ample pool emits, through window masks, caps and retirement."""
    _, cfg = configs(family)
    params = carried(jax_params(family, seed=3))
    ps = prompts(6, seed=9)

    def run(hbm, host):
        eng = Engine(cfg, system(hbm, host), params=params, device="cpu")
        return eng.generate(ps, max_new_tokens=24), eng.get_statistics()

    ample, sa = run(256, 0)
    tight, st = run(10, 256)
    assert tight == ample
    assert all(len(t) == 24 or t[-1] == cfg.eos_token_id for t in tight)
    assert st["transfer"]["up_transfers"] > 0
    assert st["transfer"]["down_transfers"] > 0
    retired = st["runtime"]["window_retired_blocks"]
    assert retired == sa["runtime"]["window_retired_blocks"]
    assert (retired > 0) == (family == "mistral")


def test_retirement_window_gating():
    """Only uniformly windowed models retire: Gemma-2's global layers keep
    full KV."""
    gemma, mistral = configs("gemma")[1], configs("mistral")[1]
    assert gemma.retirement_window is None
    assert dataclasses.replace(gemma, attn_pattern=(True,)).retirement_window == 6
    assert gemma2_9b().retirement_window is None
    assert mistral.retirement_window == 16
    assert mistral_7b().retirement_window == 4096
    params = carried(jax_params("mistral"))
    assert Engine(mistral, system(32, 32), params=params,
                  device="cpu").scheduler.window_tokens == 16
    params = carried(jax_params("gemma"))
    assert Engine(gemma, system(32, 32), params=params,
                  device="cpu").scheduler.window_tokens is None


def test_retire_out_of_window_matches_jax_cache():
    """`retire_out_of_window` frees the same leading blocks as the JAX
    cache's, counts them, and leaves the rest of the sequence live."""
    args = dict(block_size=BS, num_hbm_blocks=10, num_host_blocks=40)
    j = JCache(JCacheConfig(kv_dtype=JKV.INT8, **args), j_tiny(), 4, 8,
               native=False)
    t = TieredKVCache(CacheConfig(kv_dtype=KVDtype.INT8, **args),
                      tiny_test_config(), 4, 8, device="cpu")
    results = []
    for c in (j, t):
        s = c.add_seq()
        assert c.extend_seq(s, 40)                     # 5 blocks
        first = c.retire_out_of_window(s, 3)
        again = c.retire_out_of_window(s, 3)           # already retired
        c.maintain()
        results.append((first, again, c.pool.seq(s).blocks,
                        c.directory.hbm_free, c.stats.window_retired_blocks))
    assert results[1] == results[0]
    first, again, blocks, _, count = results[1]
    assert [i for i, _ in first] == [0, 1, 2] and again == [] and count == 3
    assert blocks[:3] == [None] * 3 and None not in blocks[3:]
