"""Attention: the port's plain decode (K1) and chunk (K2) versions against
the JAX package's Pallas kernels in interpret mode, on the same pools after
the layout conversion, for every storage scheme (INT8, BF16, INT4, FP8, and
MIXED8 with either scheme id). Tolerance 2e-4 (the JAX kernel tests' own),
at both compute dtypes: the plain versions round q and p * v_scale through
the compute dtype at the TPU kernels' points. Kernel-vs-plain cases need
the card and live in tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.ops.chunk_attention import (
    paged_chunk_attention as j_chunk_ref,
)
from cxl_speckv_tpu.ops.chunk_attention_pallas import (
    paged_chunk_attention_pallas,
)
from cxl_speckv_tpu.ops.paged_attention import paged_attention as j_decode
from cxl_speckv_tpu.ops.paged_attention_ref import (
    paged_attention_ref as j_decode_ref,
)
from cxl_speckv_tpu.ops.paged_attention_ref import (
    prefill_attention_ref as j_prefill_ref,
)
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.models.convert import pools_from_jax
from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
    paged_chunk_attention_cuda,
)
from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention
from cxl_speckv_tpu_torch.ops.paged_attention_ref import prefill_attention_ref

from helpers import build_pools

BLOCK = 8
HQ, HKV, D = 4, 2, 32
TOL = 2e-4
CD = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCHEMES = ["int8", "bf16", "int4", "fp8"]


def make_pools(lens, kv, seed):
    rng = np.random.RandomState(seed)
    keys = [jnp.asarray(rng.randn(L, HKV, D).astype(np.float32)) for L in lens]
    vals = [jnp.asarray(rng.randn(L, HKV, D).astype(np.float32)) for L in lens]
    kp, vp, ks, vs, table, seq_lens, _, _ = build_pools(
        keys, vals, BLOCK, num_slots=32, kv_dtype=JKV(kv))
    jpools = (kp, vp, ks, vs)
    tpools = pools_from_jax(kp, vp, ks, vs, HKV)
    return jpools, tpools, table, seq_lens


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", SCHEMES)
def test_decode_matches_jax_kernel(kv, cd):
    lens = (0, 5, 17, 32)                  # a seq_len 0 lane gives zeros
    jpools, tpools, table, seq_lens = make_pools(lens, kv, seed=1)
    q = np.random.RandomState(2).randn(len(lens), HQ, D).astype(np.float32)
    want = j_decode(jnp.asarray(q), *jpools, table, seq_lens, JKV(kv),
                    interpret=True, compute_dtype=CD[cd][0])
    got = paged_attention(t(q), *tpools, t(table), t(seq_lens), KVDtype(kv),
                          compute_dtype=CD[cd][1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert not got[0].any()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", SCHEMES)
@pytest.mark.parametrize("T", [5, 12])
def test_chunk_matches_jax_kernel(kv, cd, T):
    starts = (0, 13, 20)                   # lane 0: zero-context chunk
    jpools, tpools, table, _ = make_pools(starts, kv, seed=3)
    rng = np.random.RandomState(4)
    q = rng.randn(len(starts), T, HQ, D).astype(np.float32)
    kn = rng.randn(len(starts), T, HKV, D).astype(np.float32)
    vn = rng.randn(len(starts), T, HKV, D).astype(np.float32)
    start = np.array(starts, np.int32)
    want = paged_chunk_attention_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *jpools, table,
        jnp.asarray(start), JKV(kv), interpret=True,
        compute_dtype=CD[cd][0])
    got = paged_chunk_attention_cuda(t(q), t(kn), t(vn), *tpools, t(table),
                                     t(start), KVDtype(kv),
                                     compute_dtype=CD[cd][1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("kv", ["int4", "fp8"])
def test_plain_decode_other_schemes_match_jax_reference(kv):
    """The plain version reads INT4 / FP8 pools as the JAX package's plain
    reference does, too."""
    lens = (3, 17, 26)
    jpools, tpools, table, seq_lens = make_pools(lens, kv, seed=5)
    q = np.random.RandomState(6).randn(len(lens), HQ, D).astype(np.float32)
    want = j_decode_ref(jnp.asarray(q), *jpools, table, seq_lens, JKV(kv))
    got = paged_attention(t(q), *tpools, t(table), t(seq_lens), KVDtype(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("sid", [0, 1])
def test_mixed8_matches_jax_kernel(sid, cd):
    """A MIXED8 layer's bytes read as INT8 (scheme id 0) or FP8 (1), in
    decode and chunk, as the JAX kernels' MIXED8 mode reads them."""
    lens = (0, 7, 17, 30)
    jpools, tpools, table, seq_lens = make_pools(lens, ("int8", "fp8")[sid],
                                                 seed=12 + sid)
    rng = np.random.RandomState(13)
    q = rng.randn(len(lens), HQ, D).astype(np.float32)
    kw = dict(compute_dtype=CD[cd][0], scheme_id=jnp.int32(sid))
    want = j_decode(jnp.asarray(q), *jpools, table, seq_lens, JKV.MIXED8,
                    interpret=True, **kw)
    got = paged_attention(t(q), *tpools, t(table), t(seq_lens), KVDtype.MIXED8,
                          compute_dtype=CD[cd][1], scheme_id=sid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    T = 6
    qc = rng.randn(len(lens), T, HQ, D).astype(np.float32)
    kn = rng.randn(len(lens), T, HKV, D).astype(np.float32)
    vn = rng.randn(len(lens), T, HKV, D).astype(np.float32)
    want = paged_chunk_attention_pallas(
        jnp.asarray(qc), jnp.asarray(kn), jnp.asarray(vn), *jpools, table,
        seq_lens, JKV.MIXED8, interpret=True, **kw)
    got = paged_chunk_attention_cuda(t(qc), t(kn), t(vn), *tpools, t(table),
                                     t(seq_lens), KVDtype.MIXED8,
                                     compute_dtype=CD[cd][1], scheme_id=sid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_fp8_nan_bytes_outside_the_context_read_as_zero():
    """FP8 NaN bytes (0x7F) in every pool row no lane holds (the guard
    slot, unused slots, the tails of partly filled blocks) leave the output
    finite and equal to the JAX kernel's on the same bytes."""
    lens = (5, 17, 26)
    jpools, _, table, seq_lens = make_pools(lens, "fp8", seed=14)
    live = np.zeros((32, BLOCK), bool)             # [slot, offset]
    for row, n in zip(np.asarray(table), lens):
        for i in range(-(-n // BLOCK)):
            live[row[i], :min(BLOCK, n - i * BLOCK)] = True
    kT, v = np.array(jpools[0]), np.array(jpools[1])
    kT[~np.tile(live, (1, HKV))[:, None, :].repeat(D, 1)] = 0x7F
    v[~live[:, None, :, None].repeat(HKV, 1).repeat(D, 3)] = 0x7F
    jpools = (jnp.asarray(kT), jnp.asarray(v), *jpools[2:])
    tpools = pools_from_jax(*jpools, HKV)
    assert (tpools[1] == 0x7F).any() and (tpools[0] == 0x7F).any()
    q = np.random.RandomState(15).randn(len(lens), HQ, D).astype(np.float32)
    want = j_decode(jnp.asarray(q), *jpools, table, seq_lens, JKV.FP8,
                    interpret=True)
    got = paged_attention(t(q), *tpools, t(table), t(seq_lens), KVDtype.FP8)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_plain_window_softcap_sinks_match_jax_reference():
    """The plain versions carry the window / softcap / sinks variants of
    the JAX references (the CUDA kernels take window and softcap and raise
    for sinks)."""
    lens = (6, 21, 30)
    jpools, tpools, table, seq_lens = make_pools(lens, "int8", seed=7)
    rng = np.random.RandomState(8)
    q = rng.randn(len(lens), HQ, D).astype(np.float32)
    sinks = rng.randn(HQ).astype(np.float32)
    kw = dict(window=9, softcap=5.0)
    want = j_decode_ref(jnp.asarray(q), *jpools, table, seq_lens, JKV.INT8,
                        sinks=jnp.asarray(sinks), **kw)
    got = paged_attention(t(q), *tpools, t(table), t(seq_lens), KVDtype.INT8,
                          sinks=t(sinks), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)

    T = 6
    qc = rng.randn(len(lens), T, HQ, D).astype(np.float32)
    kn = rng.randn(len(lens), T, HKV, D).astype(np.float32)
    vn = rng.randn(len(lens), T, HKV, D).astype(np.float32)
    want = j_chunk_ref(jnp.asarray(qc), jnp.asarray(kn), jnp.asarray(vn),
                       *jpools, table, seq_lens, JKV.INT8,
                       sinks=jnp.asarray(sinks), **kw)
    got = paged_chunk_attention_cuda(t(qc), t(kn), t(vn), *tpools, t(table),
                                     t(seq_lens), KVDtype.INT8,
                                     sinks=t(sinks), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("start", [0, 10])
def test_prefill_reference_matches_jax(start):
    rng = np.random.RandomState(9)
    T = 7
    jpools, tpools, table, _ = make_pools((max(start, 1),), "int8", seed=10)
    q = rng.randn(T, HQ, D).astype(np.float32)
    kn = rng.randn(T, HKV, D).astype(np.float32)
    vn = rng.randn(T, HKV, D).astype(np.float32)
    want = j_prefill_ref(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                         start, *jpools, block_table_row=table[0],
                         kv_dtype=JKV.INT8)
    got = prefill_attention_ref(t(q), t(kn), t(vn), start, *tpools,
                                block_table_row=t(table[0]),
                                kv_dtype=KVDtype.INT8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_pool_conversion_round_trip():
    """pools_from_jax maps the kT layout to token-major rows: every stored
    token's K row equals the JAX pool's column for that token."""
    jpools, tpools, table, seq_lens = make_pools((11, 20), "int8", seed=11)
    kT = np.asarray(jpools[0])                      # [S, D, Hkv*bs]
    k = tpools[0].numpy()                           # [S, Hkv, bs, D]
    for h in range(HKV):
        for o in range(BLOCK):
            np.testing.assert_array_equal(k[:, h, o, :],
                                          kT[:, :, h * BLOCK + o])
    np.testing.assert_array_equal(
        tpools[2].numpy().reshape(32, -1), np.asarray(jpools[2])[:, 0])
    assert jax.device_count() >= 1
