"""W4A16 weights on the port (`ops/wquant.py` at bits 4, `ops/w4_unpack.py`)
against the JAX package's `ops/wquant.py`, on the CPU at tiny sizes:

- `quantize_tensor(bits=4)`: values and scales bit-exact (axes -2 / -1, a
  stacked [L, in, out] and an expert stack [L, E, in, out]), packed two
  nibbles a byte along the last axis in the half-split order; the logical
  shape, layer slicing, an odd last axis and `.T` refusing;
- `quantize_weights(bits=4)`: the whole tree equal to the JAX tree carried
  by `params_from_jax` (its int4 leaves packed on the way), the embedding
  int8;
- `mm` / `qeinsum` within 2e-4 at float32 (the matmuls sum in other
  orders), the plain unpack equal to `unpack_int4`;
- `forward_dense` and two prefill chunks' logits within 2e-4 of the JAX
  package's (float32 tiny config);
- the engine at `weight_dtype="int4"` equal to the same engine given the
  tree quantized beforehand, and to the JAX engine at int4 (equal, or first
  diverging at a near-tie of the dense int4 logits);
- `init_params_quantized(bits=4)` (dense and expert stacks), the HF
  conversion at "int4" bit-exact with the JAX converter, a checkpoint round
  trip bit-equal with `bits` in its index, and `params_byte_size` counting
  the packed bytes as the JAX package counts them.
"""

import dataclasses
import json

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
from cxl_speckv_tpu.ops import wquant as jw
from cxl_speckv_tpu.utils.dispatch import params_byte_size as j_byte_size
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models import llama as tl
from cxl_speckv_tpu_torch.models import load_params, save_params
from cxl_speckv_tpu_torch.models.checkpoint import INDEX
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.ops import wquant as tw
from cxl_speckv_tpu_torch.ops.quant import unpack_int4
from cxl_speckv_tpu_torch.ops.w4_unpack import w4_unpack, w4_unpack_plain
from cxl_speckv_tpu_torch.utils.dispatch import params_byte_size

TOL = 2e-4
NEAR_TIE = 0.06
JCFG = j_tiny()
CFG = tiny_test_config()
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(11))


def carried(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree))


def jax_values(jq) -> np.ndarray:
    return np.asarray(jq.q).astype(np.int8)


def np_pack(v: np.ndarray) -> np.ndarray:
    """int8 values -> half-split nibble bytes along the last axis."""
    d2 = v.shape[-1] // 2
    u = v.view(np.uint8)
    return ((u[..., :d2] & 0x0F) | (u[..., d2:] << 4)).view(np.int8)


def assert_q_equal(tq, jq):
    assert tq.bits == 4 and tq.axis == jq.axis
    assert tq.shape == tuple(jq.q.shape)
    np.testing.assert_array_equal(unpack_int4(tq.q).numpy(), jax_values(jq))
    np.testing.assert_array_equal(tq.q.numpy(), np_pack(jax_values(jq)))
    np.testing.assert_array_equal(tq.s.numpy().view(np.uint32),
                                  np.asarray(jq.s).view(np.uint32))


@pytest.mark.parametrize("shape,axis", [((24, 40), -2), ((24, 40), -1),
                                        ((3, 16, 8), -2),
                                        ((2, 3, 16, 10), -2)])
def test_quantize_tensor_int4_bit_exact(shape, axis):
    w = np.random.RandomState(len(shape) + axis).randn(*shape).astype(
        np.float32)
    w[..., 0, :] = 0.0                    # an all-zero row / channel
    w.flat[5] = 1e-30
    jq = jw.quantize_tensor(jnp.asarray(w), axis=axis, bits=4)
    tq = tw.quantize_tensor(torch.from_numpy(w), axis=axis, bits=4)
    assert_q_equal(tq, jq)
    assert int(unpack_int4(tq.q).abs().max()) <= 7
    np.testing.assert_array_equal(tq.dequantize().numpy(),
                                  np.asarray(jq.dequantize()))


def test_int4_tensor_surface():
    w = torch.from_numpy(np.random.RandomState(3).randn(3, 16, 8)
                         .astype(np.float32))
    tq = tw.quantize_tensor(w, bits=4)
    one = tq[1]
    assert one.bits == 4 and one.shape == (16, 8) and one.q.shape == (16, 4)
    assert one.s.shape == (1, 8) and one.axis == -2
    assert tq[:2].shape == (2, 16, 8)
    with pytest.raises(ValueError, match="even"):
        tw.quantize_tensor(torch.zeros(4, 5), bits=4)
    with pytest.raises(ValueError, match="int4"):
        _ = tw.quantize_tensor(torch.zeros(4, 6), axis=-1, bits=4).T
    np.testing.assert_array_equal(
        w4_unpack(tq.q, torch.float32).numpy(),
        unpack_int4(tq.q).float().numpy())
    assert w4_unpack_plain(tq.q, torch.bfloat16).dtype == torch.bfloat16
    # pack_int4 inverts unpack_int4 on every nibble value
    vals = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)
    assert torch.equal(unpack_int4(tw.pack_int4(vals)), vals)


def test_quantize_weights_int4_tree_matches_jax():
    jq = jw.quantize_weights(JPARAMS, bits=4)
    want = carried(jq)
    got = tw.quantize_weights(carried(JPARAMS), bits=4)
    assert got["embed"].bits == 8 and want["embed"].bits == 8
    assert got["lm_head"].bits == 4
    pairs = [("embed", got["embed"], want["embed"]),
             ("lm_head", got["lm_head"], want["lm_head"])]
    pairs += [(k, v, want["layers"][k]) for k, v in got["layers"].items()]
    for name, g, w in pairs:
        if isinstance(g, tw.QuantizedTensor):
            assert (g.bits, g.axis) == (w.bits, w.axis), name
            assert torch.equal(g.q, w.q) and torch.equal(g.s, w.s), name
        else:
            assert torch.equal(g, w), name
    # idempotent on a quantized tree
    again = tw.quantize_weights(got, bits=4)
    assert again["layers"]["q"] is got["layers"]["q"]


def test_mm_and_qeinsum_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(5, 24).astype(np.float32)
    w = rng.randn(24, 40).astype(np.float32)
    jq = jw.quantize_tensor(jnp.asarray(w), bits=4)
    tq = tw.quantize_tensor(torch.from_numpy(w), bits=4)
    want = np.asarray(jw.mm(jnp.asarray(x), jq))
    got = tw.mm(torch.from_numpy(x), tq).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the MoE expert einsums over a stack [E, in, out]
    xe = rng.randn(3, 4, 24).astype(np.float32)
    we = rng.randn(3, 24, 10).astype(np.float32)
    jqe = jw.quantize_tensor(jnp.asarray(we), bits=4)
    tqe = tw.quantize_tensor(torch.from_numpy(we), bits=4)
    want = np.asarray(jw.qeinsum("ech,ehi->eci", jnp.asarray(xe), jqe))
    got = tw.qeinsum("ech,ehi->eci", torch.from_numpy(xe), tqe).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    before = tw.quantized_calls[4]
    tw.mm(torch.from_numpy(x), tq)
    assert tw.quantized_calls[4] == before + 1


def test_forward_dense_and_prefill_logits_match_jax():
    jq = jw.quantize_weights(JPARAMS, bits=4)
    tq = carried(jq)
    toks = np.random.RandomState(5).randint(1, CFG.vocab_size, (2, 13))
    want = np.asarray(jl.forward_dense(jq, JCFG, jnp.asarray(toks)))
    got = tl.forward_dense(tq, CFG, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # two prefill chunks of one sequence, the second over the pool context
    L, S, bs, Hkv, D = CFG.num_layers, 5, 8, CFG.num_kv_heads, CFG.head_dim
    jpools = [jnp.zeros((L, S, D, Hkv * bs), jnp.int8),
              jnp.zeros((L, S, Hkv, bs, D), jnp.int8),
              jnp.ones((L, S, 1, Hkv * bs), jnp.float32),
              jnp.ones((L, S, 1, Hkv * bs), jnp.float32)]
    tpools = (torch.zeros((L, S, Hkv, bs, D), dtype=torch.int8),
              torch.zeros((L, S, Hkv, bs, D), dtype=torch.int8),
              torch.ones((L, S, Hkv, bs)), torch.ones((L, S, Hkv, bs)))
    row = np.array([2, 0, 3, 4], np.int32)
    seq = toks[0]
    for start, n in ((0, 8), (8, 5)):
        out = jl.prefill_chunk(jq, JCFG, JKV.INT8, jnp.asarray(seq[start:start + n]),
                               jnp.int32(start), *jpools, jnp.asarray(row),
                               use_pallas=True)
        jpools = list(out[1:5])
        got = tl.prefill_chunk(tq, CFG, KVDtype.INT8,
                               torch.from_numpy(seq[start:start + n].copy()),
                               start, tpools, torch.from_numpy(row))
        np.testing.assert_allclose(got.numpy(), np.asarray(out[0]), rtol=TOL,
                                   atol=TOL)


def system(wq, mods=(CacheConfig, EngineConfig, KVDtype, PrefetchConfig,
                     SystemConfig)):
    cc, ec, kvd, pc, sc = mods
    return sc(cache=cc(block_size=8, num_hbm_blocks=10, num_host_blocks=64,
                       kv_dtype=kvd("int8")),
              prefetch=pc(enabled=True, depth=2),
              engine=ec(max_batch_size=2, max_seq_len=64, prefill_chunk=16,
                        decode_horizon=1, weight_dtype=wq))


def run(eng, ps, n=12):
    ids = [eng.add_request(p, max_new_tokens=n) for p in ps]
    outs = {o.req_id: o.tokens for o in eng.run()}
    return [outs[i] for i in ids]


def test_engine_int4_equals_prequantized_and_jax():
    """`tests/test_wquant.py:test_engine_int4_serves_and_is_deterministic`
    on the port: quantizing at engine build equals serving the tree
    quantized beforehand; the JAX engine at int4 gives the same tokens, or
    first diverges at a near-tie of the dense int4 logits."""
    rng = np.random.RandomState(3)
    ps = [rng.randint(1, CFG.vocab_size, rng.randint(6, 24)).tolist()
          for _ in range(6)]
    params = carried(JPARAMS)
    eng = Engine(CFG, system("int4"), params=params, device="cpu",
                 enable_lstm=False)
    assert eng.params["layers"]["up"].bits == 4
    assert eng.params["embed"].bits == 8
    a = run(eng, ps)
    pre = tw.quantize_weights(params, bits=4)
    b = run(Engine(CFG, system("native"), params=pre, device="cpu",
                   enable_lstm=False), ps)
    assert a == b
    assert all(len(t) == 12 or t[-1] == CFG.eos_token_id for t in a)
    st = eng.get_statistics()["transfer"]
    assert st["up_transfers"] > 0 and st["down_transfers"] > 0
    mods = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig, JSystemConfig)
    want = run(JEngine(JCFG, system("int4", mods), params=JPARAMS,
                       use_pallas=True, enable_lstm=False), ps)
    for p, g, w in zip(ps, a, want):
        if g == w:
            continue
        i = next(k for k, (x, y) in enumerate(zip(g, w)) if x != y)
        logits = tl.forward_dense(pre, CFG, torch.tensor([p + g[:i]]))[0, -1]
        top = torch.topk(logits, 2)
        assert {g[i], w[i]} == set(top.indices.tolist())
        assert float(top.values[0] - top.values[1]) < NEAR_TIE


@pytest.mark.parametrize("moe", [False, True])
def test_init_params_quantized_int4(moe):
    cfg = CFG if not moe else dataclasses.replace(
        CFG, num_experts=4, num_experts_per_tok=2, intermediate_size=32)
    p = tl.init_params_quantized(cfg, torch.Generator().manual_seed(0),
                                 bits=4)
    ref = tw.quantize_weights(
        tl.init_params(cfg, torch.Generator().manual_seed(0)), bits=4)
    assert p["embed"].bits == 8 and p["embed"].axis == -1
    assert p["lm_head"].bits == 4 and p["lm_head"].q.shape == (64, 128)
    for k, w in p["layers"].items():
        r = ref["layers"][k]
        assert type(w) is type(r), k
        if isinstance(w, tw.QuantizedTensor):
            assert (w.bits, w.axis) == (4, -2), k
            assert w.q.shape == r.q.shape and w.s.shape == r.s.shape, k
            assert w.shape == r.shape, k
    if moe:
        assert p["layers"]["gate"].q.shape == (2, 4, 64, 16)
        assert p["layers"]["router"].dtype == torch.float32
    toks = torch.tensor([[3, 9, 27, 1]])
    assert torch.isfinite(tl.forward_dense(p, cfg, toks)).all()


def hf_state_dict(cfg, seed=0) -> dict:
    """Random float32 tensors under HF's names for a Llama or a Mixtral-style
    MoE of `cfg`'s shapes ([out, in] linear weights)."""
    rng = np.random.RandomState(seed)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qd, kvd = cfg.num_q_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    w = lambda *shape: rng.randn(*shape).astype(np.float32) * 0.1
    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": w(H),
          "lm_head.weight": w(V, H)}
    for i in range(cfg.num_layers):
        lay = f"model.layers.{i}."
        sd.update({lay + "input_layernorm.weight": w(H),
                   lay + "post_attention_layernorm.weight": w(H),
                   lay + "self_attn.q_proj.weight": w(qd, H),
                   lay + "self_attn.k_proj.weight": w(kvd, H),
                   lay + "self_attn.v_proj.weight": w(kvd, H),
                   lay + "self_attn.o_proj.weight": w(H, qd)})
        if cfg.num_experts:
            moe = lay + "block_sparse_moe."
            sd[moe + "gate.weight"] = w(cfg.num_experts, H)
            for e in range(cfg.num_experts):
                sd.update({f"{moe}experts.{e}.w1.weight": w(I, H),
                           f"{moe}experts.{e}.w3.weight": w(I, H),
                           f"{moe}experts.{e}.w2.weight": w(H, I)})
        else:
            sd.update({lay + "mlp.gate_proj.weight": w(I, H),
                       lay + "mlp.up_proj.weight": w(I, H),
                       lay + "mlp.down_proj.weight": w(H, I)})
    return sd


@pytest.mark.parametrize("moe", [False, True])
def test_hf_convert_int4_bit_exact(moe):
    """`params_from_hf_state_dict(weight_dtype="int4")` equals the JAX
    converter's tree at int4, carried across, bit for bit (a Llama and a
    Mixtral-style expert stack)."""
    from cxl_speckv_tpu.models import hf_convert as jhf
    from cxl_speckv_tpu_torch.models import hf_convert as thf

    moe_kw = dict(num_experts=4, num_experts_per_tok=2, intermediate_size=32)
    jc = dataclasses.replace(JCFG, **moe_kw) if moe else JCFG
    tc = dataclasses.replace(CFG, **moe_kw) if moe else CFG
    sd = hf_state_dict(tc)
    want = carried(jhf.params_from_hf_state_dict(sd, jc, weight_dtype="int4"))
    got = thf.params_from_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tc,
        weight_dtype="int4", device="cpu")
    leaves = [(k, got[k], want[k]) for k in got if k != "layers"]
    leaves += [(k, v, want["layers"][k]) for k, v in got["layers"].items()]
    assert set(got["layers"]) == set(want["layers"])
    for name, g, w in leaves:
        if isinstance(w, tw.QuantizedTensor):
            assert (g.bits, g.axis) == (w.bits, w.axis), name
            assert torch.equal(g.q, w.q) and torch.equal(g.s, w.s), name
        else:
            assert torch.equal(g, w), name
    assert got["embed"].bits == 8 and got["layers"]["down"].bits == 4
    if moe:
        assert got["layers"]["gate"].q.shape == (2, 4, 64, 16)


def test_checkpoint_round_trip_and_byte_size(tmp_path):
    tree = tl.init_params_quantized(CFG, torch.Generator().manual_seed(2),
                                    bits=4)
    save_params(tree, tmp_path)
    index = json.loads((tmp_path / INDEX).read_text())["leaves"]
    assert index["layers/q"]["bits"] == 4 and index["embed"]["bits"] == 8
    back = load_params(tmp_path, like=tree, device="cpu")
    for k in ("embed", "lm_head"):
        assert back[k].bits == tree[k].bits
        assert torch.equal(back[k].q, tree[k].q)
    for k, w in tree["layers"].items():
        b = back["layers"][k]
        if isinstance(w, tw.QuantizedTensor):
            assert b.bits == 4 and torch.equal(b.q, w.q)
            assert torch.equal(b.s, w.s)
        else:
            assert torch.equal(b, w)
    # the packed bytes, as the JAX package counts its int4 tree
    jq = jw.quantize_weights(JPARAMS, bits=4)
    assert params_byte_size(carried(jq)) == j_byte_size(jq)
    assert (params_byte_size(carried(jq))
            < params_byte_size(carried(jw.quantize_weights(JPARAMS))))
