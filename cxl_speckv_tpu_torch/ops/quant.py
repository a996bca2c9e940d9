"""KV-cache quantization, in PyTorch.

Counterpart of `cxl_speckv_tpu/ops/quant.py`; bytes and scales are
bit-exact with it (tests/test_torch_quant.py). Fixed-ratio quantization with
one float32 scale per (token, head) row of the head_dim vector:

- INT8: scale = max(amax, 1e-8) / 127, q = round-half-even(x / scale)
  clipped to [-127, 127].
- INT4: the same with qmax 7, two signed nibbles per byte, HALF-SPLIT
  (low nibble element i, high nibble element i + D/2).
- FP8: e4m3 with scale max(amax, 1e-8) / 448; the pool stores the e4m3 bits
  in int8 bytes, and NaN bytes decode to 0.
- BF16: stored as is, scale 1.
- MIXED8: a scheme per layer (`CacheConfig.layer_kv_dtypes`), INT8 or FP8
  in the same int8 bytes; a layer's scheme id (0 = INT8, 1 = FP8) says how
  its bytes read. The port's layer loop is Python, so the id is a host
  integer (the JAX package carries it as a traced scalar).

All functions are shape-polymorphic over leading dims and quantize along
the last axis (head_dim).
"""

from __future__ import annotations

import torch

from cxl_speckv_tpu_torch.config import KVDtype

_INT8_MAX = 127.0
_INT4_MAX = 7.0
_FP8_MAX = 448.0  # float8_e4m3 max normal


def kv_storage_dtype(kv_dtype: KVDtype) -> torch.dtype:
    """Physical element type of the quantized KV pool. All 1-byte schemes
    share int8 storage (FP8 bits are stored in int8 bytes)."""
    return {
        KVDtype.BF16: torch.bfloat16,
        KVDtype.INT8: torch.int8,
        KVDtype.INT4: torch.int8,  # two nibbles packed per int8
        KVDtype.FP8: torch.int8,   # e4m3 bits stored in int8 bytes
        KVDtype.MIXED8: torch.int8,
    }[kv_dtype]


def storage_width_class(kv_dtype: KVDtype) -> str:
    """Schemes in the same class share pool storage and may be switched
    between on a live pool (`Engine.set_kv_dtype`); another class needs
    new storage (`TieredKVCache.rebuild_storage`)."""
    return {
        KVDtype.BF16: "bf16",
        KVDtype.INT8: "byte",
        KVDtype.FP8: "byte",
        KVDtype.MIXED8: "byte",
        KVDtype.INT4: "byte-packed",
    }[kv_dtype]


def kv_pack(kv_dtype: KVDtype) -> int:
    """Logical head_dim elements per stored element."""
    return 2 if kv_dtype == KVDtype.INT4 else 1


def encode_for_pool(q: torch.Tensor, kv_dtype: KVDtype) -> torch.Tensor:
    """Values from `quantize_kv` -> the pool's physical element type."""
    if kv_dtype == KVDtype.FP8:
        return q.view(torch.int8)
    return q


def decode_from_pool(raw: torch.Tensor, kv_dtype: KVDtype) -> torch.Tensor:
    """Pool storage -> the scheme's logical values (inverse of
    `encode_for_pool`)."""
    if kv_dtype == KVDtype.FP8:
        return raw.view(torch.float8_e4m3fn)
    return raw


def _row_scale(xf: torch.Tensor, qmax: float) -> torch.Tensor:
    amax = xf.abs().amax(dim=-1, keepdim=True)
    return torch.clamp_min(amax, 1e-8) / qmax


def quantize_kv(x: torch.Tensor,
                kv_dtype: KVDtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize [..., head_dim] to (values, scales[..., 1] float32)."""
    if kv_dtype == KVDtype.BF16:
        return (x.to(torch.bfloat16),
                torch.ones((*x.shape[:-1], 1), dtype=torch.float32,
                           device=x.device))
    xf = x.float()
    if kv_dtype == KVDtype.INT8:
        scale = _row_scale(xf, _INT8_MAX)
        q = torch.clamp(torch.round(xf / scale), -_INT8_MAX, _INT8_MAX)
        return q.to(torch.int8), scale
    if kv_dtype == KVDtype.INT4:
        scale = _row_scale(xf, _INT4_MAX)
        q = torch.clamp(torch.round(xf / scale), -_INT4_MAX,
                        _INT4_MAX).to(torch.int32)
        d2 = q.shape[-1] // 2
        lo = q[..., :d2] & 0x0F
        hi = q[..., d2:] & 0x0F
        packed = (lo | (hi << 4)).to(torch.uint8)
        return packed.view(torch.int8), scale
    if kv_dtype == KVDtype.FP8:
        scale = _row_scale(xf, _FP8_MAX)
        return (xf / scale).to(torch.float8_e4m3fn), scale
    raise ValueError(f"unknown kv_dtype {kv_dtype}")


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """Unpack [..., D//2] half-split nibbles to [..., D] int8 in [-8, 7]."""
    r = q.to(torch.int32)
    lo = (r << 28) >> 28           # sign-extend the low nibble
    hi = (r << 24) >> 28           # sign-extend the high nibble
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def decoded_scheme(kv_dtype: KVDtype, scheme_id=None) -> KVDtype:
    """The scheme a pool's bytes are read as: MIXED8 reads INT8 (scheme id
    0) or FP8 (1); any other scheme reads as itself."""
    if kv_dtype != KVDtype.MIXED8:
        return kv_dtype
    if scheme_id is None or int(scheme_id) not in (0, 1):
        raise ValueError(f"MIXED8 needs a scheme id of 0 or 1, got {scheme_id}")
    return KVDtype.INT8 if int(scheme_id) == 0 else KVDtype.FP8


def scheme_id_table(kv_dtype) -> tuple[int, ...] | None:
    """A per-layer scheme tuple -> its scheme ids (0 = INT8, 1 = FP8), or
    None for a uniform scheme."""
    if isinstance(kv_dtype, tuple):
        return tuple(0 if d == KVDtype.INT8 else 1 for d in kv_dtype)
    return None


def quantize_kv_dual(x: torch.Tensor,
                     scheme_id) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize [..., head_dim] under scheme id 0 (INT8) or 1 (FP8) ->
    (pool bytes int8, scales): `quantize_kv` + `encode_for_pool` of the
    selected scheme, bit-exact with the JAX package's `quantize_kv_dual`."""
    scheme = decoded_scheme(KVDtype.MIXED8, scheme_id)
    q, scale = quantize_kv(x, scheme)
    return encode_for_pool(q, scheme), scale


def dequantize_dual(raw: torch.Tensor, scale: torch.Tensor, scheme_id,
                    out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of `quantize_kv_dual` on pool bytes; FP8 NaN bytes read 0."""
    return (dequant_values(raw, KVDtype.MIXED8, scheme_id) * scale).to(out_dtype)


def dequant_values(raw: torch.Tensor, kv_dtype: KVDtype,
                   scheme_id=None) -> torch.Tensor:
    """Raw pool storage -> float32 values, scales NOT applied. Every stored
    value is exact in float32 (and in bfloat16). MIXED8 needs the layer's
    `scheme_id`."""
    kv_dtype = decoded_scheme(kv_dtype, scheme_id)
    if kv_dtype == KVDtype.INT4:
        return unpack_int4(raw).float()
    if kv_dtype == KVDtype.FP8:
        x = (raw.view(torch.float8_e4m3fn) if raw.dtype == torch.int8
             else raw).float()
        return torch.nan_to_num(x, nan=0.0)
    return raw.float()


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, kv_dtype: KVDtype,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of `quantize_kv` up to rounding."""
    if kv_dtype == KVDtype.BF16:
        return q.to(out_dtype)
    return (dequant_values(q, kv_dtype) * scale).to(out_dtype)


def compressed_bytes_per_token(num_kv_heads: int, head_dim: int,
                               kv_dtype: KVDtype) -> int:
    """Storage bytes per token per layer for K+V including the scale
    sideband."""
    elem = {KVDtype.BF16: 2.0, KVDtype.INT8: 1.0, KVDtype.INT4: 0.5,
            KVDtype.FP8: 1.0}[kv_dtype]
    data = 2 * num_kv_heads * head_dim * elem           # K and V
    sideband = 0 if kv_dtype == KVDtype.BF16 else 2 * num_kv_heads * 4
    return int(data + sideband)
