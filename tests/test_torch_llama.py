"""The port's Llama against the JAX package's, on `tiny_test_config()`
(float32 weights, bfloat16 attention compute) with the JAX weights carried
over by `params_from_jax`:

- `forward_dense` logits within 1e-4 (float32; the matmuls sum in another
  order);
- batched chunked prefill then fused multi-step decode, for every KV
  scheme and a per-layer INT8 / FP8 table: greedy tokens equal and the
  pools equal to the JAX pools after the layout conversion (stored values
  to the last step, scales to a few ulps: `_assert_pools_equal`). The JAX
  side runs its Pallas kernels in interpret mode, as its own tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.ops.wquant import quantize_weights as j_quantize_weights
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.models import llama as tl
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax, pools_from_jax

JCFG = j_tiny()
CFG = tiny_test_config()
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(7))
DENSE_TOL = 1e-4
SCALE_RTOL = 1e-6     # a few float32 ulps
LSB_SHARE = 1e-3      # stored values one step apart (see _assert_pools_equal)
BF16_STEP = 2.0 ** -8  # bfloat16 spacing relative to a value
BS, SLOTS, MB, CHUNK = 8, 12, 4, 16


def carried(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def test_configs_are_copies():
    assert CFG.__dict__ == JCFG.__dict__ or all(
        getattr(CFG, k) == getattr(JCFG, k) for k in JCFG.__dataclass_fields__)
    assert CFG.sm_scale == JCFG.sm_scale and CFG.q_group == JCFG.q_group


def test_rope_frequencies_match():
    from cxl_speckv_tpu.models.configs import llama_3_8b as j8
    from cxl_speckv_tpu_torch.models.configs import llama_3_8b as t8

    for jc, tc in ((JCFG, CFG), (j8(), t8())):      # plain and Llama-3 banded
        want = np.asarray(jl.rope_frequencies(jc))
        got = tl.rope_frequencies(tc).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("w8", [False, True])
def test_forward_dense_matches_jax(w8):
    jp = j_quantize_weights(JPARAMS) if w8 else JPARAMS
    toks = np.random.RandomState(1).randint(1, CFG.vocab_size, (2, 11))
    want = np.asarray(jl.forward_dense(jp, JCFG, jnp.asarray(toks)))
    got = tl.forward_dense(carried(jp), CFG, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=DENSE_TOL,
                               atol=DENSE_TOL)


def test_unported_features_raise():
    import dataclasses

    # sinks, experts, biases and YaRN are ported (tests/test_torch_gpt_oss.py),
    # the q/k norm and per-layer / linear RoPE too (tests/test_torch_families.py)
    with pytest.raises(NotImplementedError, match="act_fn"):
        tl.init_params(dataclasses.replace(CFG, act_fn="gelu"),
                       torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="MIXED8 is internal"):
        tl.layer_kv_schemes(KVDtype.MIXED8, CFG.num_layers)
    with pytest.raises(ValueError, match="INT8 or FP8"):
        tl.layer_kv_schemes((KVDtype.INT8, KVDtype.INT4), CFG.num_layers)


# a per-layer table for the 2-layer tiny model: INT8, then FP8
MIXED = "mixed"
SCHEMES = ["int8", "bf16", "int4", "fp8", MIXED]


def _schemes(kv):
    """(JAX kv_dtype, the port's kv_dtype, the storage scheme) of `kv`."""
    if kv == MIXED:
        return ((JKV.INT8, JKV.FP8), (KVDtype.INT8, KVDtype.FP8), "int8")
    return JKV(kv), KVDtype(kv), kv


def _jax_pools(kv):
    from cxl_speckv_tpu.ops.quant import kv_storage_dtype

    c, dt = JCFG, kv_storage_dtype(JKV(_schemes(kv)[2]))
    L, S, Hkv = c.num_layers, SLOTS + 1, c.num_kv_heads
    D = c.head_dim // (2 if kv == "int4" else 1)
    return [jnp.zeros((L, S, D, Hkv * BS), dt),
            jnp.zeros((L, S, Hkv, BS, D), dt),
            jnp.ones((L, S, 1, Hkv * BS), jnp.float32),
            jnp.ones((L, S, 1, Hkv * BS), jnp.float32)]


def _torch_pools(kv):
    from cxl_speckv_tpu_torch.ops.quant import kv_pack, kv_storage_dtype

    c, store = CFG, KVDtype(_schemes(kv)[2])
    shape = (c.num_layers, SLOTS + 1, c.num_kv_heads, BS,
             c.head_dim // kv_pack(store))
    return (torch.zeros(shape, dtype=kv_storage_dtype(store)),
            torch.zeros(shape, dtype=kv_storage_dtype(store)),
            torch.ones(shape[:-1]), torch.ones(shape[:-1]))


def _raw(t: torch.Tensor) -> np.ndarray:
    """The tensor's bits (bfloat16 as int16, float32 as int32)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def _steps(t: torch.Tensor, kinds) -> np.ndarray:
    """Stored values as positions on their grid, so that neighbours are one
    apart: INT4 nibbles unpacked; FP8 bytes (sign and magnitude) as signed
    magnitudes; other kinds as their bits (`_raw`). `kinds` gives each
    layer's scheme."""
    from cxl_speckv_tpu_torch.ops.quant import unpack_int4

    out = []
    for li, kind in enumerate(kinds):
        x = t[li]
        if kind == KVDtype.INT4:
            x = unpack_int4(x).numpy().astype(np.int64)
        elif kind == KVDtype.FP8:
            b = x.numpy().view(np.uint8).astype(np.int64)
            x = np.where(b & 0x80, -(b & 0x7F), b & 0x7F)
        else:
            x = _raw(x).astype(np.int64)
        out.append(x)
    return np.stack(out)


def _assert_pools_equal(jpools, tpools, kv="int8"):
    """Stored K/V equal to the last step, scales to a few ulps. The K/V
    projections sum in another order in XLA and in PyTorch, so a float32
    value can differ in its last bits: a token's scale then differs by an
    ulp, and now and then a stored value lands one step away (one int8
    LSB, a step of the token's int8 / int4 / e4m3 grid; for bfloat16, one
    step at the pool's largest magnitude, BF16_STEP of it: bfloat16
    attention compute carries such a flip on into later layers' values) —
    the reference's own near-tie rule (ROADMAP.md, "Token level"). At most
    LSB_SHARE of the values may."""
    kv_dtype = _schemes(kv)[1]
    kinds = (kv_dtype if isinstance(kv_dtype, tuple)
             else (kv_dtype,) * CFG.num_layers)
    conv = pools_from_jax(*[np.asarray(a) for a in jpools], CFG.num_kv_heads)
    for want, got, name in zip(conv, tpools, ("k", "v", "k_scale", "v_scale")):
        assert want.shape == got.shape, name
        if name.endswith("scale"):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=SCALE_RTOL, atol=0,
                                       err_msg=f"pool {name}")
            continue
        if got.dtype == torch.bfloat16:
            g, w = got.float().numpy(), want.float().numpy()
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=BF16_STEP * np.abs(w).max(),
                                       err_msg=f"pool {name}")
            assert (g != w).mean() <= LSB_SHARE, f"pool {name}"
            continue
        d = np.abs(_steps(got, kinds) - _steps(want, kinds))
        assert d.max() <= 1, f"pool {name}: a value off by {d.max()} steps"
        assert (d > 0).mean() <= LSB_SHARE, f"pool {name}: {(d > 0).sum()} off"


@pytest.mark.parametrize("kv", SCHEMES)
def test_prefill_then_decode_matches_jax(kv):
    """Two prefill dispatches (the second with pool context and an idle
    lane), then a fused 3-step decode: tokens equal, pools equal
    (`_assert_pools_equal`; for INT4 this also shows that the JAX pool's
    sublane-packed kT rows convert to the port's token-major bytes as
    they are)."""
    jkv, tkv, _ = _schemes(kv)
    rng = np.random.RandomState(2)
    guard = SLOTS
    tables = np.array([[3, 7, 1, guard], [10, 0, 5, guard]], np.int32)
    prompts = [rng.randint(1, CFG.vocab_size, 21), rng.randint(1, CFG.vocab_size, 9)]

    def prefill_packed(lanes):      # lanes: [(start, n)] per lane
        p = np.zeros((2, 4 + MB + CHUNK), np.int32)
        p[:, 3] = 1
        for i, (start, n) in enumerate(lanes):
            p[i, 0], p[i, 1] = start, n
            p[i, 4:4 + MB] = tables[i]
            p[i, 4 + MB:4 + MB + n] = prompts[i][start:start + n]
        return p

    waves = [prefill_packed([(0, 16), (0, 9)]), prefill_packed([(16, 5), (0, 0)])]
    jpools, tpools = _jax_pools(kv), _torch_pools(kv)
    jtoks, ttoks = [], []
    for packed in waves:
        out = jl.prefill_batch_packed(JPARAMS, JCFG, jkv, jnp.asarray(packed),
                                      *jpools, max_blocks=MB, use_pallas=True)
        jtoks.append(np.asarray(out[0]))
        jpools = list(out[1:5])
        ttoks.append(tl.prefill_batch_packed(carried(JPARAMS), CFG, tkv,
                                             packed, tpools,
                                             max_blocks=MB).numpy())
    np.testing.assert_array_equal(ttoks[0][1], jtoks[0][1])
    np.testing.assert_array_equal(ttoks[1][0], jtoks[1][0])
    _assert_pools_equal(jpools, tpools, kv)

    horizon = 3
    dp = np.zeros((2, MB + 4), np.int32)
    dp[:, 4:] = tables
    dp[0, :2] = ttoks[1][0], 21           # first token and its position
    dp[1, :2] = ttoks[0][1], 9
    out = jl.decode_multi_packed(JPARAMS, JCFG, jkv, jnp.asarray(dp),
                                 *jpools, horizon=horizon, use_pallas=True)
    got = tl.decode_multi_packed(carried(JPARAMS), CFG, tkv, dp, tpools,
                                 horizon=horizon)
    assert got.shape == (2, horizon) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(out[0]))
    _assert_pools_equal(out[1:5], tpools, kv)


def test_decode_step_logits_match_jax():
    """One decode step over a pool that prefill filled: logits within
    1e-4 of the JAX step's."""
    kv = "int8"
    tables = np.array([[2, 4, SLOTS, SLOTS]], np.int32)
    toks = np.random.RandomState(3).randint(1, CFG.vocab_size, 10)
    packed = np.zeros((1, 4 + MB + CHUNK), np.int32)
    packed[0, 1] = 10
    packed[0, 4:4 + MB] = tables[0]
    packed[0, 4 + MB:14 + MB] = toks
    jpools, tpools = _jax_pools(kv), _torch_pools(kv)
    out = jl.prefill_batch_packed(JPARAMS, JCFG, JKV(kv), jnp.asarray(packed),
                                  *jpools, max_blocks=MB, use_pallas=True)
    params = carried(JPARAMS)
    tl.prefill_batch_packed(params, CFG, KVDtype(kv), packed, tpools,
                            max_blocks=MB)
    tok = np.asarray(out[0])
    pos = np.array([10], np.int32)
    want = jl.decode_step(JPARAMS, JCFG, JKV(kv), jnp.asarray(tok),
                          jnp.asarray(pos), *out[1:5], jnp.asarray(tables),
                          jnp.asarray(pos + 1), use_pallas=True)[0]
    got = tl.decode_step(params, CFG, KVDtype(kv), torch.from_numpy(tok.copy()),
                         torch.from_numpy(pos), tpools,
                         torch.from_numpy(tables), torch.from_numpy(pos + 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DENSE_TOL,
                               atol=DENSE_TOL)


def test_init_params_quantized_layout():
    """Quantize-at-init gives the same tree layout as init + quantize."""
    from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor, quantize_weights

    gen = torch.Generator().manual_seed(0)
    q = tl.init_params_quantized(CFG, gen)
    ref = quantize_weights(tl.init_params(CFG, torch.Generator().manual_seed(0)))
    assert set(q) == set(ref) and set(q["layers"]) == set(ref["layers"])
    for k, w in q["layers"].items():
        r = ref["layers"][k]
        assert type(w) is type(r)
        if isinstance(w, QuantizedTensor):
            assert w.q.shape == r.q.shape and w.s.shape == r.s.shape
            assert w.axis == r.axis and w.q.dtype == torch.int8
    assert q["embed"].axis == -1 and q["lm_head"].axis == -2
