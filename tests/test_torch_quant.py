"""KV quantization: the port's bytes and scales are bit-exact with the JAX
package's `ops/quant.py` for every scheme."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.ops import quant as jq
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops import quant as tq

SCHEMES = ["bf16", "int8", "int4", "fp8"]


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(5, 3, 32).astype(np.float32) * 3.0
    x[0, 0] = 0.0                                  # all-zero row: scale floor
    # exact .5 ties after scaling: amax 127 -> scale 1, values k + 0.5
    x[1, 0] = np.arange(32) - 15.5
    x[1, 0, 0] = 127.0
    x[2, 1, :4] = [1e-30, -1e-30, 5e4, -5e4]       # extreme magnitudes
    return x


def _bytes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(np.uint16)


def _to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantize_bytes_and_scales_bit_exact(scheme):
    x = _inputs()
    jvals, jsc = jq.quantize_kv(jnp.asarray(x), JKV(scheme))
    tvals, tsc = tq.quantize_kv(torch.from_numpy(x), KVDtype(scheme))
    np.testing.assert_array_equal(_bytes(_to_np(tvals)), _bytes(jvals))
    np.testing.assert_array_equal(tsc.numpy().view(np.uint32),
                                  np.asarray(jsc).view(np.uint32))
    # pool encoding (FP8 bits in int8 bytes) is bit-exact too
    jenc = np.asarray(jq.encode_for_pool(jvals, JKV(scheme)))
    tenc = tq.encode_for_pool(tvals, KVDtype(scheme))
    assert tenc.dtype == tq.kv_storage_dtype(KVDtype(scheme))
    np.testing.assert_array_equal(_bytes(_to_np(tenc)), _bytes(jenc))


def test_int8_round_half_even_ties():
    # scale = 127/127 = 1 exactly, so x / scale keeps the .5 ties
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    q, s = tq.quantize_kv(torch.from_numpy(x), KVDtype.INT8)
    assert float(s[0, 0]) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_dequantize_matches_jax(scheme):
    x = _inputs(1)
    jvals, jsc = jq.quantize_kv(jnp.asarray(x), JKV(scheme))
    enc = np.array(jq.encode_for_pool(jvals, JKV(scheme)))
    want = np.asarray(jq.dequantize_kv(jnp.asarray(enc), jsc, JKV(scheme)))
    t_enc = (torch.from_numpy(enc.view(np.uint16)).view(torch.bfloat16)
             if scheme == "bf16" else torch.from_numpy(enc))
    got = tq.dequantize_kv(t_enc, torch.from_numpy(np.array(jsc)),
                           KVDtype(scheme)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fp8_nan_bytes_decode_to_zero():
    raw = np.array([[0x7F, -1, 0x38, 0x00]], np.int8)     # +NaN, -NaN, 1.0, 0
    scale = np.ones((1, 1), np.float32)
    want = np.asarray(jq.dequantize_kv(jnp.asarray(raw), jnp.asarray(scale),
                                       JKV.FP8))
    got = tq.dequantize_kv(torch.from_numpy(raw), torch.from_numpy(scale),
                           KVDtype.FP8).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [[0.0, 0.0, 1.0, 0.0]]


def test_int4_half_split_unpack():
    x = _inputs(2)
    q, _ = tq.quantize_kv(torch.from_numpy(x), KVDtype.INT4)
    jqv, _ = jq.quantize_kv(jnp.asarray(x), JKV.INT4)
    np.testing.assert_array_equal(tq.unpack_int4(q).numpy(),
                                  np.asarray(jq._unpack_int4(jqv)))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_storage_accounting(scheme):
    assert (tq.compressed_bytes_per_token(8, 128, KVDtype(scheme))
            == jq.compressed_bytes_per_token(8, 128, JKV(scheme)))
    assert (torch.empty(0, dtype=tq.kv_storage_dtype(KVDtype(scheme))).element_size()
            == jnp.dtype(jq.kv_storage_dtype(JKV(scheme))).itemsize)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_from_pool_inverts_encoding(scheme):
    x = _inputs(3)
    tvals, _ = tq.quantize_kv(torch.from_numpy(x), KVDtype(scheme))
    back = tq.decode_from_pool(tq.encode_for_pool(tvals, KVDtype(scheme)),
                               KVDtype(scheme))
    assert back.dtype == tvals.dtype
    np.testing.assert_array_equal(_bytes(_to_np(back)), _bytes(_to_np(tvals)))
    jvals, _ = jq.quantize_kv(jnp.asarray(x), JKV(scheme))
    jback = jq.decode_from_pool(jq.encode_for_pool(jvals, JKV(scheme)),
                                JKV(scheme))
    np.testing.assert_array_equal(_bytes(_to_np(back)), _bytes(jback))


@pytest.mark.parametrize("sid", [0, 1])
def test_quantize_dual_bit_exact(sid):
    """Per-layer MIXED8: bytes and scales of either scheme id equal the JAX
    package's `quantize_kv_dual`."""
    x = _inputs(4)
    jvals, jsc = jq.quantize_kv_dual(jnp.asarray(x), jnp.int32(sid))
    tvals, tsc = tq.quantize_kv_dual(torch.from_numpy(x), sid)
    assert tvals.dtype == torch.int8
    np.testing.assert_array_equal(_bytes(tvals.numpy()), _bytes(jvals))
    np.testing.assert_array_equal(tsc.numpy().view(np.uint32),
                                  np.asarray(jsc).view(np.uint32))


@pytest.mark.parametrize("sid", [0, 1])
def test_dequantize_dual_matches_jax(sid):
    """Every byte value, NaN bytes (0x7F, 0xFF) included: FP8 reads them as
    0, INT8 as 127 / -1."""
    raw = np.arange(-128, 128, dtype=np.int8).reshape(8, 32)
    scale = np.random.RandomState(5).rand(8, 1).astype(np.float32)
    want = np.asarray(jq.dequantize_dual(jnp.asarray(raw), jnp.asarray(scale),
                                         jnp.int32(sid)))
    got = tq.dequantize_dual(torch.from_numpy(raw), torch.from_numpy(scale),
                             sid).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(
        tq.dequant_values(torch.from_numpy(raw), KVDtype.MIXED8, sid).numpy(),
        tq.dequant_values(torch.from_numpy(raw),
                          (KVDtype.INT8, KVDtype.FP8)[sid]).numpy())


@pytest.mark.parametrize("scheme", SCHEMES + ["mixed8"])
def test_storage_width_class_matches_jax(scheme):
    assert (tq.storage_width_class(KVDtype(scheme))
            == jq.storage_width_class(JKV(scheme)))


def test_scheme_id_table_matches_jax():
    table = (KVDtype.INT8, KVDtype.FP8, KVDtype.FP8, KVDtype.INT8)
    want = jq.scheme_id_table(tuple(JKV(d.value) for d in table))
    assert tq.scheme_id_table(table) == tuple(np.asarray(want).tolist())
    assert tq.scheme_id_table(KVDtype.INT8) is None
    assert jq.scheme_id_table(JKV.INT8) is None
    with pytest.raises(ValueError, match="scheme id"):
        tq.dequant_values(torch.zeros(4, dtype=torch.int8), KVDtype.MIXED8)


@pytest.mark.parametrize("scheme", SCHEMES + ["mixed8"])
def test_kv_storage_shape_matches_jax(scheme):
    for shape in ((4, 3, 32), (7, 2), (1, 128)):
        assert (tq.kv_storage_shape(shape, KVDtype(scheme))
                == jq.kv_storage_shape(shape, JKV(scheme)))
    if scheme == "int4":
        with pytest.raises(ValueError, match="even"):
            tq.kv_storage_shape((4, 5), KVDtype.INT4)
        with pytest.raises(ValueError, match="even"):
            jq.kv_storage_shape((4, 5), JKV.INT4)


@pytest.mark.parametrize("scheme", SCHEMES + ["mixed8"])
def test_quantization_rms_error_matches_jax(scheme):
    """The round trip's relative RMS error equals the JAX package's (to
    float32 rounding: the means sum in other orders); MIXED8 has no single
    quantizer and raises in both."""
    x = _inputs(6)
    if scheme == "mixed8":
        with pytest.raises(ValueError):
            tq.quantization_rms_error(torch.from_numpy(x), KVDtype.MIXED8)
        with pytest.raises(ValueError):
            jq.quantization_rms_error(jnp.asarray(x), JKV.MIXED8)
        return
    got = tq.quantization_rms_error(torch.from_numpy(x), KVDtype(scheme))
    want = float(jq.quantization_rms_error(jnp.asarray(x), JKV(scheme)))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=0)
    assert float(got) < {"bf16": 0.01, "int8": 0.02, "int4": 0.2,
                         "fp8": 0.05}[scheme]
