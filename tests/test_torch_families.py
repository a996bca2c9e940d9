"""Qwen3, Gemma-3 and Qwen3-MoE in the port against the JAX package, on
tiny configs with the JAX weights carried over by `params_from_jax`:

- QWEN3: the tiny config with the per-head q/k RMSNorm (plain);
- GEMMA3: six layers in Gemma-3's 5:1 pattern (window 6 on five layers, one
  global), the 1 + w q/k norm, sandwich norms, GeGLU, scaled embeddings, a
  tied head, query scale 10^-0.5, and two RoPE bases: the sliding layers'
  local theta 10000 unscaled, the global layer's theta 50000 under linear
  scaling by 2, so that window, local base and factor all bind at 19
  tokens;
- QWEN3_MOE: Qwen3's q/k norm over an 8-expert top-2 MoE MLP with top-k
  renormalisation (`moe_norm_topk`).

Held: the rope frequencies (global, local, linear, both); `_qkv` with the
q/k norm, plain and offset; `forward_dense` logits within 2e-4 at float32,
plain and W8A16; the init trees' layout; chunked prefill then fused decode
(greedy tokens equal, pools within `tests/test_torch_gemma.py`'s bounds);
the port's engine against the JAX engine, tiered and ample (greedy tokens
equal or first diverging at a near-tie), a streamed Gemma-3 request, and a
Qwen3 engine with n-gram speculation. The JAX side runs its reference
attention (`use_pallas=False`), as its own engine tests do; its Pallas
kernels are held to that reference by its own tests.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gemma import (
    _jax_pools,
    _torch_pools,
    assert_same_or_near_tie,
)

from cxl_speckv_tpu.config import CacheConfig as JCacheConfig
from cxl_speckv_tpu.config import EngineConfig as JEngineConfig
from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.config import PrefetchConfig as JPrefetchConfig
from cxl_speckv_tpu.config import SystemConfig as JSystemConfig
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.ops.wquant import quantize_weights as j_quantize_weights
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
    gemma3_12b,
    phi3_mini,
    qwen3_8b,
    qwen3_moe_30b,
    tiny_test_config,
)
from cxl_speckv_tpu_torch.models.convert import params_from_jax, pools_from_jax
from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

QWEN3 = dict(qk_norm=True, rms_eps=1e-6)
GEMMA3 = dict(num_layers=6, sliding_window=6,
              attn_pattern=(True, True, True, True, True, False),
              qk_norm=True, norm_offset=True, post_norms=True,
              act_fn="gelu_tanh", embed_scale=True, query_scale=10.0**-0.5,
              tie_embeddings=True, rope_theta=50000.0,
              rope_local_theta=10000.0, rope_linear_factor=2.0, rms_eps=1e-6)
QWEN3_MOE = dict(qk_norm=True, rms_eps=1e-6, num_experts=8,
                 num_experts_per_tok=2, moe_norm_topk=True,
                 intermediate_size=32)
FAMILIES = {"qwen3": QWEN3, "gemma3": GEMMA3, "qwen3_moe": QWEN3_MOE}
DENSE_TOL = 2e-4
# Pools at float32 attention compute, layer by layer: stored int8 one step
# apart on at most LSB_SHARE of a layer's values (`tests/test_torch_gemma.py`'s
# near-tie rule) and scales within SCALE_RTOL, layer 1 within 2e-6 as
# `tests/test_torch_streaming.py` holds it (Gemma-3: 1.14e-6). Gemma-3's
# layers 2-5 read KV in which such one-step flips already sit: a flip moves
# that layer's attention output by ~1/127 of a value, so below it one-step
# flips reach 0.2% of a layer's values and scales differ by up to 0.29%
# (dense logits, which read no int8 KV, stay 2e-5 apart). Held there to one
# step on at most 3% of a layer's values, scales within 1%.
LSB_SHARE, SCALE_RTOL = 1e-3, (1e-6, 2e-6)
DEEP_LSB_SHARE, DEEP_SCALE_RTOL = 0.03, 1e-2
BS, SLOTS, MB, CHUNK = 8, 12, 4, 16
PORT = (CacheConfig, EngineConfig, KVDtype, PrefetchConfig, SystemConfig)
JAX = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig, JSystemConfig)


def configs(family, **kw):
    kw = dict(FAMILIES[family], **kw)
    return (dataclasses.replace(j_tiny(), **kw),
            dataclasses.replace(tiny_test_config(), **kw))


@functools.lru_cache(maxsize=None)
def jax_params(family, seed=7):
    return jl.init_params(configs(family)[0], jax.random.PRNGKey(seed))


def carried(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


ROPES = {"global": {}, "linear": dict(rope_linear_factor=4.0),
         "local": dict(rope_local_theta=10000.0, rope_theta=1e6),
         "both": dict(rope_local_theta=10000.0, rope_theta=1e6,
                      rope_linear_factor=8.0)}


@pytest.mark.parametrize("kind", list(ROPES))
def test_rope_frequency_pair_matches_jax(kind):
    """Global and local inverse frequencies equal the JAX package's; the
    local base is unscaled and the factor divides the global ones only."""
    jc = dataclasses.replace(j_tiny(), **ROPES[kind])
    tc = dataclasses.replace(tiny_test_config(), **ROPES[kind])
    (jg, jloc), (tg, tloc) = jl.rope_frequency_pair(jc), tl.rope_frequency_pair(tc)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    has_local = "rope_local_theta" in ROPES[kind]
    assert (tloc is not None) == (jloc is not None) == has_local
    if tloc is not None:
        np.testing.assert_allclose(tloc.numpy(), np.asarray(jloc), rtol=1e-6)
        unscaled = tl.rope_frequencies(dataclasses.replace(
            tc, rope_theta=tc.rope_local_theta, rope_linear_factor=None))
        torch.testing.assert_close(tloc, unscaled, rtol=0, atol=0)
    if tc.rope_linear_factor:
        plain = tl.rope_frequencies(dataclasses.replace(
            tc, rope_linear_factor=None))
        torch.testing.assert_close(tg * tc.rope_linear_factor, plain)


def test_layer_ropes_pick_by_window():
    """Sliding layers take the local base, the global layer the scaled
    global one; a model without a local base uses the global in every
    layer."""
    _, cfg = configs("gemma3")
    glob, loc = tl.rope_frequency_pair(cfg)
    ropes = tl.layer_ropes(cfg, "cpu")
    for r, w in zip(ropes, cfg.layer_windows()):
        assert torch.equal(r, loc if w is not None else glob)
    assert not torch.allclose(glob, loc)
    _, q3 = configs("qwen3")
    assert all(torch.equal(r, tl.rope_frequencies(q3))
               for r in tl.layer_ropes(q3, "cpu"))


@pytest.mark.parametrize("offset", [False, True])
def test_qkv_qk_norm_matches_jax(offset):
    """The per-head q/k RMSNorm after the projections (and biases), before
    RoPE: plain (Qwen3) and 1 + w (Gemma-3)."""
    kw = dict(qk_norm=True, norm_offset=offset, attn_bias=True)
    jcfg = dataclasses.replace(j_tiny(), **kw)
    cfg = dataclasses.replace(tiny_test_config(), **kw)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(3))
    lp = {k: v[0] for k, v in jp["layers"].items()}
    h = np.random.RandomState(0).randn(3, 5, cfg.hidden_size).astype(np.float32)
    want = jl._qkv(jnp.asarray(h), lp, jcfg)
    got = tl._qkv(torch.from_numpy(h), tl.layer_params(carried(jp), 0), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # the norm takes effect: per head, q's RMS over D is its weight's scale
    plain = tl._qkv(torch.from_numpy(h), {
        k: v for k, v in tl.layer_params(carried(jp), 0).items()
        if k not in ("q_norm", "k_norm")}, cfg)
    assert not torch.allclose(plain[0], got[0])
    torch.testing.assert_close(plain[2], got[2])          # v untouched


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_dense_matches_jax(family, w8):
    """19 tokens: past the 6-token window of Gemma-3's sliding layers."""
    jcfg, cfg = configs(family)
    jp = jax_params(family)
    jp = j_quantize_weights(jp) if w8 else jp
    toks = np.random.RandomState(1).randint(1, cfg.vocab_size, (2, 19))
    want = np.asarray(jl.forward_dense(jp, jcfg, jnp.asarray(toks)))
    got = tl.forward_dense(carried(jp), cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=DENSE_TOL,
                               atol=DENSE_TOL)


@pytest.mark.parametrize("change", ["window", "local_theta", "linear_factor",
                                    "qk_norm"])
def test_gemma3_conventions_take_effect(change):
    """Each Gemma-3 convention changes the logits past the window: the port
    is not matching JAX by both ignoring one."""
    _, cfg = configs("gemma3")
    params = carried(jax_params("gemma3"))
    toks = torch.from_numpy(np.random.RandomState(2).randint(1, 256, (1, 19)))
    other = {"window": dict(sliding_window=64),
             "local_theta": dict(rope_local_theta=None),
             "linear_factor": dict(rope_linear_factor=None),
             "qk_norm": {}}[change]
    p2 = params
    if change == "qk_norm":
        p2 = {**params, "layers": {k: v for k, v in params["layers"].items()
                                   if k not in ("q_norm", "k_norm")}}
    a = tl.forward_dense(params, cfg, toks)[0]
    b = tl.forward_dense(p2, dataclasses.replace(cfg, **other), toks)[0]
    assert float((a[7:] - b[7:]).abs().max()) > 1e-3


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_tree_layout(family):
    """`init_params` and `init_params_quantized` give the JAX trees' leaves,
    shapes and classes (q/k norms [L, D] near 1, unquantized)."""
    jcfg, cfg = configs(family)
    jp = jax_params(family)
    jq = j_quantize_weights(jp)
    gen = torch.Generator().manual_seed(0)
    tp, tq = tl.init_params(cfg, gen), tl.init_params_quantized(cfg, gen)
    for j, t in ((jp, tp), (jq, tq)):
        assert set(t) == set(j) and set(t["layers"]) == set(j["layers"])
        leaves = {"embed": (j["embed"], t["embed"]),
                  **{k: (j["layers"][k], t["layers"][k]) for k in j["layers"]}}
        for k, (jv, tv) in leaves.items():
            assert isinstance(tv, QuantizedTensor) == hasattr(jv, "axis"), k
            assert tuple(tv.shape) == tuple(jv.shape), k
            if hasattr(jv, "axis"):
                assert tuple(tv.s.shape) == tuple(jv.s.shape), k
    for t in (tp, tq):
        for k in ("q_norm", "k_norm"):
            w = t["layers"][k]
            assert w.shape == (cfg.num_layers, cfg.head_dim)
            assert 0.5 < float(w.mean()) < 1.5 and float(w.std()) > 0.01


@pytest.mark.parametrize("name", ["qwen3-8b", "gemma3-12b", "qwen3-moe-30b",
                                  "phi3-mini"])
def test_presets_match_jax(name):
    """The port's copies of the presets equal the JAX package's, field by
    field."""
    from cxl_speckv_tpu.models.configs import PRESETS as J_PRESETS
    from cxl_speckv_tpu_torch.models.configs import PRESETS

    assert (dataclasses.asdict(PRESETS[name]())
            == dataclasses.asdict(J_PRESETS[name]()))


def test_check_supported_accepts_the_families():
    for cfg in (qwen3_8b(), gemma3_12b(), qwen3_moe_30b(), phi3_mini()):
        tl.check_supported(cfg)
    assert gemma3_12b().retirement_window is None
    wins = gemma3_12b().layer_windows()
    assert wins[:6] == (1024,) * 5 + (None,) and len(wins) == 48


def test_params_from_jax_carries_qk_norms():
    """`params_from_jax` crosses the q/k norm leaves unchanged, plain and
    W8A16 (where they stay unquantized)."""
    jp = jax_params("qwen3")
    for tree in (jp, j_quantize_weights(jp)):
        t = carried(tree)
        for k in ("q_norm", "k_norm"):
            assert isinstance(t["layers"][k], torch.Tensor)
            np.testing.assert_array_equal(t["layers"][k].numpy(),
                                          np.asarray(tree["layers"][k]))


def _assert_pools_equal(jpools, tpools, num_kv_heads):
    """Layer by layer: stored values at most one step apart, on at most
    LSB_SHARE (DEEP_LSB_SHARE past layer 1) of the layer's values; scales
    within SCALE_RTOL (DEEP_SCALE_RTOL past layer 1)."""
    conv = pools_from_jax(*[np.asarray(a) for a in jpools], num_kv_heads)
    for want, got, name in zip(conv, tpools, ("k", "v", "k_scale", "v_scale")):
        assert want.shape == got.shape, name
        for li, (w, g) in enumerate(zip(want.numpy(), got.numpy())):
            deep = li >= len(SCALE_RTOL)
            if name.endswith("scale"):
                rtol = DEEP_SCALE_RTOL if deep else SCALE_RTOL[li]
                np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                           err_msg=f"{name} layer {li}")
                continue
            d = np.abs(g.astype(np.int64) - w.astype(np.int64))
            assert d.max() <= 1, f"{name} layer {li}: off by {d.max()} steps"
            share = (d > 0).mean()
            assert share <= (DEEP_LSB_SHARE if deep else LSB_SHARE), (
                f"{name} layer {li}: {share:.4f} of the values off")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_then_decode_matches_jax(family):
    """Two prefill dispatches (the second over pool context; Gemma-3's
    window binds), then a fused 3-step decode: greedy tokens equal, pools
    equal but for near-tie LSB flips (float32 attention compute, where the
    plain kernels of both packages agree to float32 rounding)."""
    jcfg, cfg = configs(family, attn_compute_dtype="float32")
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
                                      *jpools, max_blocks=MB, use_pallas=False)
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
                                 *jpools, horizon=horizon, use_pallas=False)
    got = tl.decode_multi_packed(params, cfg, KVDtype.INT8, dp, tpools,
                                 horizon=horizon)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out[0]))
    _assert_pools_equal(out[1:5], tpools, cfg.num_kv_heads)


def system(hbm, host, mods=PORT, seq=128, horizon=4, prefetch=True, **ekw):
    cc, ec, kvd, pc, sc = mods
    return sc(cache=cc(block_size=BS, num_hbm_blocks=hbm, num_host_blocks=host,
                       kv_dtype=kvd("int8")),
              prefetch=pc(enabled=prefetch, depth=2),
              engine=ec(max_batch_size=2, max_seq_len=seq, prefill_chunk=16,
                        decode_horizon=horizon, sched_quantum=1, **ekw))


def prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, rng.randint(6, 24)).tolist() for _ in range(n)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_matches_jax_engine(family):
    """The port's engines, tiered (12 HBM blocks) and ample, against the
    JAX engine's tiered one: the same greedy tokens (or a first divergence
    at a near-tie) and, given those, the same residency decisions and
    migrations; the port's tiered tokens equal its ample ones; nothing
    retires (Gemma-3 has a global layer)."""
    jcfg, cfg = configs(family)
    jp = jax_params(family, seed=42)
    params = carried(jp)
    ps = prompts(4, seed=5)
    jeng = JEngine(jcfg, system(12, 256, mods=JAX), params=jp,
                   use_pallas=False, enable_lstm=False)
    want = jeng.generate(ps, max_new_tokens=16)
    jst = jeng.get_statistics()
    outs = {}
    for label, hbm, host in (("tiered", 12, 256), ("ample", 256, 0)):
        eng = Engine(cfg, system(hbm, host), params=params, device="cpu",
                     enable_lstm=False)
        outs[label] = eng.generate(ps, max_new_tokens=16)
        st = eng.get_statistics()
        assert (st["transfer"]["up_transfers"] > 0) == (label == "tiered")
        assert st["runtime"]["window_retired_blocks"] == 0
        assert_same_or_near_tie(params, cfg, ps, outs[label], want)
        if label == "tiered" and outs[label] == want:
            for key in ("transfer", "directory", "scheduler", "pool",
                        "runtime"):
                assert st[key] == jst[key], key
    assert outs["tiered"] == outs["ample"]
    assert jst["transfer"]["up_transfers"] > 0


def test_gemma3_streamed_request_matches_jax():
    """A 40-token Gemma-3 request past the pooled capacity (6 HBM blocks of
    8) streams from the host tier (mixed windows: per-wave fetches) in both
    packages: the same greedy tokens and stream counts."""
    jcfg, cfg = configs("gemma3", attn_compute_dtype="float32")
    jp = jax_params("gemma3", seed=11)
    ps = [np.random.RandomState(4).randint(1, 256, 40).tolist()]
    kw = dict(hbm=6, host=64, seq=64, horizon=4, prefetch=False)
    jeng = JEngine(jcfg, system(mods=JAX, **kw), params=jp, use_pallas=False,
                   enable_lstm=False)
    want = jeng.generate(ps, max_new_tokens=6)
    eng = Engine(cfg, system(**kw), params=carried(jp), device="cpu")
    got = eng.generate(ps, max_new_tokens=6)
    assert got == want
    st, jst = eng.get_statistics()["engine"], jeng.get_statistics()["engine"]
    assert st["stream_chunks"] == jst["stream_chunks"] == 3
    assert st["stream_tokens"] == jst["stream_tokens"] > 0


def test_qwen3_ngram_spec_matches_jax_and_plain():
    """n-gram speculation on a tiered Qwen3 engine: the JAX spec engine's
    tokens, and the port's own plain greedy tokens."""
    jcfg, cfg = configs("qwen3")
    jp = jax_params("qwen3", seed=9)
    params = carried(jp)
    rng = np.random.RandomState(6)
    motif = rng.randint(1, 256, 5).tolist()
    ps = [motif * 3 + rng.randint(1, 256, 3).tolist() for _ in range(4)]
    spec = dict(spec_ngram=True, spec_gamma=3)
    jeng = JEngine(jcfg, system(14, 256, mods=JAX, horizon=1), params=jp,
                   use_pallas=False, enable_lstm=False, **spec)
    want = jeng.generate(ps, max_new_tokens=16)
    eng = Engine(cfg, system(14, 256, horizon=1), params=params,
                 device="cpu", enable_lstm=False, **spec)
    got = eng.generate(ps, max_new_tokens=16)
    assert_same_or_near_tie(params, cfg, ps, got, want)
    plain = Engine(cfg, system(14, 256, horizon=1), params=params,
                   device="cpu", enable_lstm=False)
    assert got == plain.generate(ps, max_new_tokens=16)
    assert eng.get_statistics()["spec"]["rounds"] > 0
