"""The premise of K2's tensor-core path (`csrc/chunk_attention.cu`,
`chunk_mma_kernel`): every value a pool can store, decoded by the port's
`ops/quant.py:dequant_values`, is exact in bfloat16, and the product of a
bf16-rounded query element with any such value is exact in float32. So
the context products q.K and round(p * vs).V lose nothing on bf16 tensor
cores, and only the order of the float32 sums differs from the plain
version. The decoded values are also held to the JAX package's
(`cxl_speckv_tpu/ops/quant.py:dequantize_kv` with unit scales), bit for
bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.ops import quant as jq
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops.quant import dequant_values

SCHEMES = ["int8", "fp8", "int4", "bf16"]
ALL_BYTES = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.int8)


def stored(scheme: str) -> torch.Tensor:
    """Raw pool storage holding every value the scheme can store: all 256
    bytes (INT8, FP8; INT4 as [256, 1], whose two nibbles cover all 16 in
    both halves of a row), or for BF16 a sample: 4096 random bit patterns
    with exponents in [-60, 60] and the signed zeros."""
    if scheme == "int4":
        return ALL_BYTES.reshape(256, 1)
    if scheme != "bf16":
        return ALL_BYTES
    rng = np.random.RandomState(0)
    sign = rng.randint(0, 2, 4096) << 15
    exp = rng.randint(127 - 60, 127 + 61, 4096) << 7
    bits = (sign | exp | rng.randint(0, 128, 4096)).astype(np.uint16)
    bits = np.concatenate([bits, np.array([0, 0x8000], np.uint16)])
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def bf16_queries() -> torch.Tensor:
    """q elements rounded through bf16, as the kernel rounds them: normal
    draws at scales 1e-3 .. 1e3 (Gemma-2's chip cases scale q by 16)."""
    rng = np.random.RandomState(1)
    x = rng.randn(6, 512) * np.array([1e-3, 0.1, 1.0, 16.0, 100.0, 1e3])[:, None]
    return torch.from_numpy(x.astype(np.float32)).reshape(-1).to(
        torch.bfloat16).float()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_stored_values_are_exact_in_bf16(scheme):
    vals = dequant_values(stored(scheme), KVDtype(scheme))
    assert vals.dtype == torch.float32 and torch.isfinite(vals).all()
    assert torch.equal(vals.to(torch.bfloat16).float(), vals)
    if scheme == "int8":
        assert torch.equal(vals, torch.arange(-128, 128).float().roll(128))
    if scheme == "int4":
        assert set(vals[:, 0].tolist()) == set(range(-8, 8))
        assert set(vals[:, 1].tolist()) == set(range(-8, 8))
    if scheme == "fp8":
        nan = (ALL_BYTES.view(torch.uint8) & 0x7F) == 0x7F
        assert int(nan.sum()) == 2 and not vals[nan].any()
        assert len(set(vals[~nan].tolist())) == 253      # +0 == -0
    ref = jq.dequantize_kv(jnp.asarray(_np(stored(scheme))), jnp.float32(1.0),
                           JKV(scheme))
    np.testing.assert_array_equal(np.asarray(ref), vals.numpy())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bf16_query_products_are_exact_in_f32(scheme):
    vals = dequant_values(stored(scheme), KVDtype(scheme)).reshape(-1)
    q = bf16_queries()
    got = (q[:, None] * vals[None, :]).double()
    want = q.double()[:, None] * vals.double()[None, :]
    assert torch.equal(got, want)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()
