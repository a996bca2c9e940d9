"""GPT-OSS in the port against the JAX package, on `tests/test_gpt_oss.py`'s
tiny config (float32, 4 experts top-2, window 6 on alternating layers,
sinks, q/k/v and o biases) and a YaRN variant of it, with the JAX weights
carried over by `params_from_jax`. Inputs are numpy draws from a seed;
the JAX side runs its Pallas kernels in interpret mode, as its own tests
do, and the port's kernel wrappers run their plain versions (CPU tensors).

Tolerances, each with its reason:
- YaRN inverse frequencies and `sm_scale`: rtol 1e-6 (a few float32 ulps;
  the ramp is computed in float32 on both sides);
- router combine weights: the same selected experts, weights rtol 1e-6;
- `moe_ffn`: 2e-5 in float32 (products summed in another order), 2e-4
  under W8A16 (int8 weights scaled per channel on larger values);
- `quantize_weights`: q and s bit-exact;
- attention with sinks, plain vs the Pallas kernels: 2e-4 (the JAX kernel
  tests' own);
- `forward_dense` and decode logits: 1e-4 (float32, as
  `tests/test_torch_gemma.py`); stored pool values equal but for
  near-tie one-step flips, scales to a few ulps;
- engines: greedy tokens equal, or diverging at a near-tie (top-2 swapped,
  gap < 0.06; ROADMAP "Token level"), or after a top-k router flip where
  the k-th and (k+1)-th router logits of some token were within 1e-5.
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
from cxl_speckv_tpu.models import moe as jmoe
from cxl_speckv_tpu.models.configs import YarnRope as JYarn
from cxl_speckv_tpu.models.configs import gpt_oss_20b as j_gpt_oss_20b
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.ops import wquant as jw
from cxl_speckv_tpu.ops.chunk_attention_pallas import (
    paged_chunk_attention_pallas,
)
from cxl_speckv_tpu.ops.paged_attention import paged_attention as j_decode
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models import llama as tl
from cxl_speckv_tpu_torch.models import moe as tmoe
from cxl_speckv_tpu_torch.models.configs import YarnRope, gpt_oss_20b
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax, pools_from_jax
from cxl_speckv_tpu_torch.ops import wquant as tw
from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
    paged_chunk_attention_cuda,
)
from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention

from helpers import build_pools

GPT_OSS = dict(attn_sinks=True, o_bias=True, attn_bias=True, num_experts=4,
               num_experts_per_tok=2, moe_style="gpt_oss", sliding_window=6,
               attn_pattern=(True, False))
YARN = dict(GPT_OSS, max_seq_len=64)
FAMILIES = {
    "gpt_oss": GPT_OSS,
    # HF GptOssConfig's tiny YaRN (tests/test_gpt_oss.py:test_hf_parity)
    "gpt_oss_yarn": YARN,
    # Qwen2: the q/k/v bias alone
    "qwen2_bias": dict(attn_bias=True),
}
YARN_ROPE = dict(factor=2.0, original_max_position=32, beta_fast=32.0,
                 beta_slow=1.0)
SCALE_RTOL = 1e-6
ROUTER_RTOL = 1e-6
MOE_TOL = {False: 2e-5, True: 2e-4}
ATTN_TOL = 2e-4
DENSE_TOL = 1e-4
LSB_SHARE = 1e-3
NEAR_TIE = 0.06
ROUTER_TIE = 1e-5
BS, SLOTS, MB, CHUNK = 8, 12, 4, 16


def configs(family):
    kw = FAMILIES[family]
    jc = dataclasses.replace(j_tiny(), **kw)
    tc = dataclasses.replace(tiny_test_config(), **kw)
    if family == "gpt_oss_yarn":
        jc = dataclasses.replace(jc, rope_yarn=JYarn(**YARN_ROPE))
        tc = dataclasses.replace(tc, rope_yarn=YarnRope(**YARN_ROPE))
    return jc, tc


def jax_params(family, seed=4):
    return jl.init_params(configs(family)[0], jax.random.PRNGKey(seed))


def carried(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# configuration, rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["gpt_oss_yarn", "gpt_oss_20b"])
def test_yarn_rope_frequencies_and_sm_scale(family):
    if family == "gpt_oss_20b":
        jc, tc = j_gpt_oss_20b(), gpt_oss_20b()
    else:
        jc, tc = configs(family)
    want = np.asarray(jl.rope_frequencies(jc))
    got = tl.rope_frequencies(tc).numpy()
    np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0)
    np.testing.assert_allclose(tc.sm_scale, jc.sm_scale, rtol=SCALE_RTOL)
    # YaRN binds: the frequencies are not the unscaled ones
    plain = tl.rope_frequencies(dataclasses.replace(tc, rope_yarn=None))
    assert not torch.allclose(plain, tl.rope_frequencies(tc))


def test_gpt_oss_20b_is_supported_and_keeps_global_layers():
    cfg = gpt_oss_20b()
    tl.check_supported(cfg)
    assert cfg.retirement_window is None          # global layers: no retiring
    assert cfg.layer_windows()[:2] == (128, None)
    assert cfg.q_group == 8 and cfg.head_dim == 64


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------

ROUTERS = {"mixtral": ("mixtral", True), "qwen2_moe": ("mixtral", False),
           "gpt_oss": ("gpt_oss", True)}


@pytest.mark.parametrize("router", list(ROUTERS))
def test_router_combine_weights_match_jax(router):
    style, norm = ROUTERS[router]
    rng = np.random.RandomState(11)
    x = rng.randn(37, 24).astype(np.float32)
    w = rng.randn(24, 8).astype(np.float32) * 0.3
    b = rng.randn(8).astype(np.float32) * 0.1 if style == "gpt_oss" else None
    want = np.asarray(jmoe.router_combine_weights(
        jnp.asarray(x), jnp.asarray(w), 3,
        None if b is None else jnp.asarray(b), style, norm))
    got = tmoe.router_combine_weights(t(x), t(w), 3,
                                      None if b is None else t(b), style,
                                      norm).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert ((got > 0).sum(-1) == 3).all()
    np.testing.assert_allclose(got, want, rtol=ROUTER_RTOL, atol=0)


MOE_CASES = {
    "gpt_oss": dict(moe_style="gpt_oss"),
    "qwen2_moe_shared": dict(moe_norm_topk=False, moe_shared_expert=40),
}


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("impl,cf", [("dense", 2.0), ("dispatch", 2.0),
                                     ("dispatch", 0.5)])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_jax(case, impl, cf, w8):
    """Dense and capacity-dispatch modes; cf 0.5 drops tokens (checked)."""
    kw = dict(num_experts=4, num_experts_per_tok=2, moe_impl=impl,
              moe_capacity_factor=cf, **MOE_CASES[case])
    jc = dataclasses.replace(j_tiny(), **kw)
    tc = dataclasses.replace(tiny_test_config(), **kw)
    jp = jl.init_params(jc, jax.random.PRNGKey(21))
    jp = jw.quantize_weights(jp) if w8 else jp
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    tlp = tl.layer_params(carried(jp), 0)
    x = np.random.RandomState(22).randn(19, jc.hidden_size).astype(np.float32)
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(x), jlp, jc))
    got = tmoe.moe_ffn(t(x), tlp, tc).numpy()
    np.testing.assert_allclose(got, want, rtol=MOE_TOL[w8], atol=MOE_TOL[w8])
    if cf < 1:
        # capacity 19 * 2 * 0.5 / 4 -> 5 < the busiest expert's load
        cw = tmoe.router_combine_weights(t(x), tlp["router"], 2,
                                         tlp.get("router_bias"), tc.moe_style,
                                         tc.moe_norm_topk)
        assert int((cw > 0).sum(0).max()) > 5


def test_moe_dispatch_without_drops_equals_dense():
    kw = dict(GPT_OSS, moe_capacity_factor=2.0)
    _, tc = configs("gpt_oss")
    lp = tl.layer_params(carried(jax_params("gpt_oss")), 1)
    x = t(np.random.RandomState(23).randn(9, tc.hidden_size).astype(np.float32))
    dense = tmoe.moe_ffn(x, lp, dataclasses.replace(tc, **kw))
    disp = tmoe.moe_ffn(x, lp, dataclasses.replace(tc, moe_impl="dispatch",
                                                   **kw))
    torch.testing.assert_close(disp, dense, rtol=MOE_TOL[False],
                               atol=MOE_TOL[False])


# ---------------------------------------------------------------------------
# ops/wquant.py, init
# ---------------------------------------------------------------------------

def test_quantize_weights_gpt_oss_tree_matches_jax():
    """Same leaves quantized or kept, q and s bit-exact; expert scales
    [L, E, 1, I]."""
    jp = jax_params("gpt_oss", seed=3)
    want = carried(jw.quantize_weights(jp))
    got = tw.quantize_weights(carried(jp))
    assert set(got["layers"]) == set(want["layers"])
    for k, w in got["layers"].items():
        c = want["layers"][k]
        assert isinstance(w, tw.QuantizedTensor) == isinstance(
            c, tw.QuantizedTensor), k
        if isinstance(w, tw.QuantizedTensor):
            assert w.axis == c.axis == -2
            np.testing.assert_array_equal(w.q.numpy(), c.q.numpy())
            np.testing.assert_array_equal(w.s.numpy().view(np.uint32),
                                          c.s.numpy().view(np.uint32))
        else:
            np.testing.assert_array_equal(w.numpy(), c.numpy())
    cfg = configs("gpt_oss")[1]
    L, E, I = cfg.num_layers, cfg.num_experts, cfg.intermediate_size
    assert got["layers"]["gate"].s.shape == (L, E, 1, I)
    assert not isinstance(got["layers"]["router"], tw.QuantizedTensor)
    assert not isinstance(got["layers"]["sinks"], tw.QuantizedTensor)
    # a >= 3-D leaf nobody classified raises; a 2-D one passes through
    odd = dict(carried(jp), layers=dict(got["layers"],
                                        mystery=torch.zeros(2, 3, 4)))
    with pytest.raises(ValueError, match="unclassified"):
        tw.quantize_weights(odd)
    odd["layers"]["mystery"] = torch.zeros(2, 3)
    assert tw.quantize_weights(odd)["layers"]["mystery"].shape == (2, 3)


def test_qeinsum_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 16).astype(np.float32)
    w = rng.randn(3, 16, 12).astype(np.float32)
    jq = jw.quantize_tensor(jnp.asarray(w))
    tq = tw.quantize_tensor(t(w))
    want = np.asarray(jw.qeinsum("ech,ehi->eci", jnp.asarray(x), jq))
    got = tw.qeinsum("ech,ehi->eci", t(x), tq).numpy()
    np.testing.assert_allclose(got, want, rtol=MOE_TOL[False],
                               atol=MOE_TOL[False])


@pytest.mark.parametrize("family", ["gpt_oss", "qwen2_moe"])
def test_init_params_quantized_tree_matches_jax_layout(family):
    """Quantize-at-init draws expert by expert into the layout of JAX
    `quantize_weights(init_params(...))`: keys, shapes, dtypes, axes."""
    kw = (GPT_OSS if family == "gpt_oss"
          else dict(num_experts=4, moe_norm_topk=False, moe_shared_expert=40))
    jc = dataclasses.replace(j_tiny(), dtype="bfloat16", **kw)
    tc = dataclasses.replace(tiny_test_config(), dtype="bfloat16", **kw)
    want = carried(jw.quantize_weights(jl.init_params(jc,
                                                      jax.random.PRNGKey(0))))
    got = tl.init_params_quantized(tc, torch.Generator().manual_seed(0))

    def layout(tree):
        out = {}
        for k, v in [*((k, v) for k, v in tree.items() if k != "layers"),
                     *tree["layers"].items()]:
            out[k] = ((tuple(v.q.shape), v.q.dtype, tuple(v.s.shape),
                       v.s.dtype, v.axis) if isinstance(v, tw.QuantizedTensor)
                      else (tuple(v.shape), v.dtype))
        return out

    assert layout(got) == layout(want)
    # the draws land in every expert: no expert's scales are left unset
    assert (got["layers"]["gate"].s > 0).all()


# ---------------------------------------------------------------------------
# attention with sinks: the plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------

def _sink_pools(lens, kv, seed):
    c = configs("gpt_oss")[0]
    rng = np.random.RandomState(seed)
    keys = [jnp.asarray(rng.randn(n, c.num_kv_heads, c.head_dim)
                        .astype(np.float32)) for n in lens]
    vals = [jnp.asarray(rng.randn(n, c.num_kv_heads, c.head_dim)
                        .astype(np.float32)) for n in lens]
    kp, vp, ks, vs, table, seq_lens, _, _ = build_pools(
        keys, vals, BS, num_slots=32, kv_dtype=JKV(kv))
    return ((kp, vp, ks, vs), pools_from_jax(kp, vp, ks, vs, c.num_kv_heads),
            table, seq_lens)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_decode_sinks_match_jax_kernel(kv, window):
    c = configs("gpt_oss")[0]
    lens = (0, 5, 17, 31)                     # a seq_len 0 lane: zeros
    jpools, tpools, table, seq_lens = _sink_pools(lens, kv, seed=1)
    rng = np.random.RandomState(2)
    q = rng.randn(len(lens), c.num_q_heads, c.head_dim).astype(np.float32)
    sinks = (rng.randn(c.num_q_heads) * 2).astype(np.float32)
    want = j_decode(jnp.asarray(q), *jpools, table, seq_lens, JKV(kv),
                    interpret=True, window=window, sinks=jnp.asarray(sinks))
    got = paged_attention(t(q), *tpools, t(table), t(seq_lens), KVDtype(kv),
                          window=window, sinks=t(sinks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    assert not got[0].any()
    plain = paged_attention(t(q), *tpools, t(table), t(seq_lens), KVDtype(kv),
                            window=window)
    assert not np.allclose(plain.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_chunk_sinks_match_jax_kernel(kv, window):
    c = configs("gpt_oss")[0]
    starts = (0, 9, 26)
    T = 8
    jpools, tpools, table, _ = _sink_pools([max(s, 1) for s in starts], kv,
                                           seed=3)
    rng = np.random.RandomState(4)
    q = rng.randn(len(starts), T, c.num_q_heads, c.head_dim).astype(np.float32)
    kn = rng.randn(len(starts), T, c.num_kv_heads, c.head_dim).astype(
        np.float32)
    vn = rng.randn(*kn.shape).astype(np.float32)
    sinks = (rng.randn(c.num_q_heads) * 2).astype(np.float32)
    start = np.array(starts, np.int32)
    want = paged_chunk_attention_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *jpools, table,
        jnp.asarray(start), JKV(kv), interpret=True, window=window,
        sinks=jnp.asarray(sinks))
    got = paged_chunk_attention_cuda(t(q), t(kn), t(vn), *tpools, t(table),
                                     t(start), KVDtype(kv), window=window,
                                     sinks=t(sinks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("family", ["gpt_oss", "gpt_oss_yarn", "qwen2_bias"])
def test_forward_dense_matches_jax(family, w8):
    """16 tokens: past the window of 6, so the sliding layers bind."""
    jc, tc = configs(family)
    jp = jax_params(family)
    jp = jw.quantize_weights(jp) if w8 else jp
    toks = np.random.RandomState(1).randint(1, tc.vocab_size, (2, 16))
    want = np.asarray(jl.forward_dense(jp, jc, jnp.asarray(toks)))
    got = tl.forward_dense(carried(jp), tc, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=DENSE_TOL,
                               atol=DENSE_TOL)


def test_gpt_oss_features_take_effect():
    """Sinks, o_bias and q/k/v biases each change the logits: the port is
    not matching JAX by ignoring a feature on both sides."""
    _, tc = configs("gpt_oss")
    params = carried(jax_params("gpt_oss"))
    toks = torch.from_numpy(np.random.RandomState(2).randint(1, 256, (1, 12)))
    base = tl.forward_dense(params, tc, toks)
    for drop in (("sinks",), ("o_bias",), ("q_bias", "k_bias", "v_bias")):
        layers = {k: v for k, v in params["layers"].items() if k not in drop}
        other = tl.forward_dense(dict(params, layers=layers), tc, toks)
        assert float((other - base).abs().max()) > 1e-3, drop


def _jax_pools(jc):
    from cxl_speckv_tpu.ops.quant import kv_storage_dtype

    dt = kv_storage_dtype(JKV.INT8)
    L, S, Hkv, D = jc.num_layers, SLOTS + 1, jc.num_kv_heads, jc.head_dim
    return [jnp.zeros((L, S, D, Hkv * BS), dt),
            jnp.zeros((L, S, Hkv, BS, D), dt),
            jnp.ones((L, S, 1, Hkv * BS), jnp.float32),
            jnp.ones((L, S, 1, Hkv * BS), jnp.float32)]


def _torch_pools(tc):
    shape = (tc.num_layers, SLOTS + 1, tc.num_kv_heads, BS, tc.head_dim)
    return (torch.zeros(shape, dtype=torch.int8),
            torch.zeros(shape, dtype=torch.int8),
            torch.ones(shape[:-1]), torch.ones(shape[:-1]))


def _assert_pools_equal(jpools, tpools, num_kv_heads):
    conv = pools_from_jax(*[np.asarray(a) for a in jpools], num_kv_heads)
    for want, got, name in zip(conv, tpools, ("k", "v", "k_scale", "v_scale")):
        assert want.shape == got.shape, name
        if name.endswith("scale"):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=SCALE_RTOL, atol=0, err_msg=name)
            continue
        d = np.abs(got.numpy().astype(np.int64) - want.numpy().astype(np.int64))
        assert d.max() <= 1, f"pool {name}: a value off by {d.max()} steps"
        assert (d > 0).mean() <= LSB_SHARE, f"pool {name}: {(d > 0).sum()} off"


def test_prefill_then_decode_matches_jax():
    """Two prefill dispatches (the second over pool context; the window of
    6 binds in both), a fused 3-step decode, then one decode step's logits:
    tokens equal, pools equal, logits within 1e-4."""
    jc, tc = configs("gpt_oss")
    jp = jax_params("gpt_oss", seed=7)
    params = carried(jp)
    rng = np.random.RandomState(2)
    guard = SLOTS
    tables = np.array([[3, 7, 1, guard], [10, 0, 5, guard]], np.int32)
    prompts = [rng.randint(1, tc.vocab_size, 21),
               rng.randint(1, tc.vocab_size, 9)]

    def prefill_packed(lanes):      # lanes: [(start, n)] per lane
        p = np.zeros((2, 4 + MB + CHUNK), np.int32)
        p[:, 3] = 1
        for i, (start, n) in enumerate(lanes):
            p[i, 0], p[i, 1] = start, n
            p[i, 4:4 + MB] = tables[i]
            p[i, 4 + MB:4 + MB + n] = prompts[i][start:start + n]
        return p

    jpools, tpools = _jax_pools(jc), _torch_pools(tc)
    jtoks, ttoks = [], []
    for packed in (prefill_packed([(0, 16), (0, 9)]),
                   prefill_packed([(16, 5), (0, 0)])):
        out = jl.prefill_batch_packed(jp, jc, JKV.INT8, jnp.asarray(packed),
                                      *jpools, max_blocks=MB, use_pallas=True)
        jtoks.append(np.asarray(out[0]))
        jpools = list(out[1:5])
        ttoks.append(tl.prefill_batch_packed(params, tc, KVDtype.INT8, packed,
                                             tpools, max_blocks=MB).numpy())
    np.testing.assert_array_equal(ttoks[0][1], jtoks[0][1])
    np.testing.assert_array_equal(ttoks[1][0], jtoks[1][0])
    _assert_pools_equal(jpools, tpools, tc.num_kv_heads)

    dp = np.zeros((2, MB + 4), np.int32)
    dp[:, 4:] = tables
    dp[0, :2] = ttoks[1][0], 21
    dp[1, :2] = ttoks[0][1], 9
    out = jl.decode_multi_packed(jp, jc, JKV.INT8, jnp.asarray(dp), *jpools,
                                 horizon=3, use_pallas=True)
    got = tl.decode_multi_packed(params, tc, KVDtype.INT8, dp, tpools,
                                 horizon=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out[0]))
    jpools = list(out[1:5])
    _assert_pools_equal(jpools, tpools, tc.num_kv_heads)

    tok = got.numpy()[:, -1].astype(np.int32)
    pos = np.array([24, 12], np.int32)
    want = jl.decode_step(jp, jc, JKV.INT8, jnp.asarray(tok), jnp.asarray(pos),
                          *jpools, jnp.asarray(tables), jnp.asarray(pos + 1),
                          use_pallas=True)[0]
    logits = tl.decode_step(params, tc, KVDtype.INT8, t(tok), t(pos), tpools,
                            t(tables), t(pos + 1))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                               rtol=DENSE_TOL, atol=DENSE_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def system(hbm, host, kv, mods=(CacheConfig, EngineConfig, KVDtype,
                                PrefetchConfig, SystemConfig)):
    cc, ec, kvd, pc, sc = mods
    return sc(cache=cc(block_size=BS, num_hbm_blocks=hbm, num_host_blocks=host,
                       kv_dtype=kvd(kv)),
              prefetch=pc(enabled=True, depth=2),
              engine=ec(max_batch_size=2, max_seq_len=96, prefill_chunk=16,
                        decode_horizon=2, sched_quantum=1))


def prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, rng.randint(8, 20)).tolist() for _ in range(n)]


def router_margin(params, cfg, tokens) -> float:
    """The least gap between the k-th and (k+1)-th router logits over every
    token and layer of a dense forward of `tokens`."""
    gaps = []
    real = tmoe.router_combine_weights

    def spy(x2d, router_w, top_k, router_b=None, *a, **kw):
        logits = x2d.float() @ router_w.float()
        if router_b is not None:
            logits = logits + router_b.float()
        top = torch.topk(logits, top_k + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return real(x2d, router_w, top_k, router_b, *a, **kw)

    tmoe.router_combine_weights = spy
    try:
        tl.forward_dense(params, cfg, torch.tensor([tokens]))
    finally:
        tmoe.router_combine_weights = real
    return min(gaps)


def assert_same_or_tie(params, cfg, ps, got, want):
    """Token lists equal, or diverging first at a near-tie of the dense
    logits, or at a context where a router top-k choice is a tie."""
    for p, g, w in zip(ps, got, want):
        if g == w:
            continue
        i = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), None)
        assert i is not None, f"lengths differ without a token diverging: {g} {w}"
        ctx = p + g[:i]
        logits = tl.forward_dense(params, cfg, torch.tensor([ctx]))[0, -1]
        top = torch.topk(logits, 2)
        if ({g[i], w[i]} == set(top.indices.tolist())
                and float(top.values[0] - top.values[1]) < NEAR_TIE):
            continue
        assert router_margin(params, cfg, ctx) < ROUTER_TIE, (p, g, w, i)


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_engine_matches_jax_engine(kv):
    """Tiered engines (14 HBM blocks) of both packages on the same
    weights: the same greedy tokens (or a tie, above) and, given those, the
    same migrations and residency."""
    jc, tc = configs("gpt_oss")
    jp = jax_params("gpt_oss", seed=42)
    params = carried(jp)
    ps = prompts(5, seed=5)
    mods = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig, JSystemConfig)
    jeng = JEngine(jc, system(14, 256, kv, mods=mods), params=jp,
                   use_pallas=True, enable_lstm=False)
    want = jeng.generate(ps, max_new_tokens=12)
    eng = Engine(tc, system(14, 256, kv), params=params, device="cpu",
                 enable_lstm=False)
    got = eng.generate(ps, max_new_tokens=12)
    assert_same_or_tie(params, tc, ps, got, want)
    st, jst = eng.get_statistics(), jeng.get_statistics()
    assert st["transfer"]["up_transfers"] > 0
    assert st["runtime"]["window_retired_blocks"] == 0
    if got == want:
        for key in ("transfer", "directory", "scheduler", "pool", "runtime"):
            assert st[key] == jst[key], key


def test_tiered_equals_ample():
    """Oversubscribed HBM (10 blocks, migrating every step) emits what an
    ample pool emits, and nothing retires (global layers)."""
    _, tc = configs("gpt_oss")
    params = carried(jax_params("gpt_oss", seed=5))
    ps = prompts(6, seed=6)

    def run(hbm, host):
        eng = Engine(tc, system(hbm, host, "int8"), params=params,
                     device="cpu")
        return eng.generate(ps, max_new_tokens=12), eng.get_statistics()

    ample, _ = run(256, 0)
    tight, st = run(10, 256)
    assert tight == ample
    assert st["transfer"]["up_transfers"] > 0
    assert st["transfer"]["down_transfers"] > 0
    assert st["runtime"]["window_retired_blocks"] == 0
