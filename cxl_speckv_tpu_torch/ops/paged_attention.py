"""K1: paged decode attention, a CUDA kernel for Hopper.

Counterpart of `cxl_speckv_tpu/ops/paged_attention.py` (the Pallas TPU
kernel `paged_attention`); the kernel source is `csrc/paged_attention.cu`,
whose header gives its design and what bounds it. `paged_attention` takes
the port's token-major pools and computes what the TPU kernel computes:
one query token per lane over its quantized pool context, reached through
the block table, with dequantization fused into the attention.

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version `ops/paged_attention_ref.paged_attention_ref`. The kernel takes the
storage kind (INT8, BF16, FP8, INT4; MIXED8 with its `scheme_id` launches as
INT8 or FP8), the sliding window and the tanh softcap as launch arguments;
sinks, which it does not cover yet, raise NotImplementedError on CUDA.
"""

from __future__ import annotations

from collections import Counter

import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops import cuda_build
from cxl_speckv_tpu_torch.ops.paged_attention_ref import paged_attention_ref
from cxl_speckv_tpu_torch.ops.quant import decoded_scheme, kv_pack

# the kernels' storage kinds (csrc/kv_tile.cuh)
KV_KINDS = {KVDtype.INT8: 0, KVDtype.BF16: 1, KVDtype.FP8: 2, KVDtype.INT4: 3}


def check_cuda_call(name: str, kv_dtype: KVDtype, scheme_id, compute_dtype,
                    sinks, pools, tensors) -> KVDtype:
    """Shared argument checks of the CUDA attention wrappers. Returns the
    scheme the kernel decodes (MIXED8 resolved by `scheme_id`)."""
    kind = decoded_scheme(kv_dtype, scheme_id)
    if sinks is not None:
        raise NotImplementedError(f"{name}: attention sinks are not ported "
                                  "to CUDA")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{name}: compute dtype {compute_dtype}")
    want = torch.bfloat16 if kind == KVDtype.BF16 else torch.int8
    k_pool, v_pool, k_scale, v_scale = pools
    if k_pool.dtype != want or v_pool.dtype != want:
        raise ValueError(f"{name}: pools must be {want} for {kv_dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError(f"{name}: scales must be float32")
    if k_pool.shape != v_pool.shape or k_scale.shape != k_pool.shape[:3] \
            or v_scale.shape != k_scale.shape:
        raise ValueError(f"{name}: pool/scale shapes disagree")
    dev = k_pool.device
    for t in (*pools, *tensors):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
    for t in pools:
        if not t.is_contiguous():
            raise ValueError(f"{name}: pools must be contiguous")
    return kind


def check_head_dim(name: str, kind: KVDtype, D: int, k_pool) -> None:
    """A pool row holds D / pack stored elements; the tile loader reads four
    at a time (INT4: four bytes, so D % 8 == 0)."""
    pack = kv_pack(kind)
    if k_pool.shape[-1] * pack != D or D % (4 * pack):
        raise ValueError(f"{name}: head_dim {D} does not fit pool rows of "
                         f"{k_pool.shape[-1]} for {kind}")


def launch_variant(window: int | None, softcap: float | None) -> tuple:
    """(window, softcap) as the kernels take them: 0 = none."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return int(window or 0), float(softcap or 0.0)


def paged_attention(
    q: torch.Tensor,             # [B, Hq, D]
    k_pool: torch.Tensor,        # [S, Hkv, bs, D/pack] int8 bytes or bf16
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,       # [S, Hkv, bs] f32
    v_scale: torch.Tensor,
    block_table: torch.Tensor,   # [B, max_blocks] int32
    seq_lens: torch.Tensor,      # [B] int32
    kv_dtype: KVDtype,
    sm_scale: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
    window: int | None = None,
    softcap: float | None = None,
    sinks: torch.Tensor | None = None,
    scheme_id: int | None = None,  # MIXED8: 0 = INT8, 1 = FP8 bytes
) -> torch.Tensor:
    """Decode attention -> [B, Hq, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
            kv_dtype, sm_scale=sm_scale, compute_dtype=compute_dtype,
            window=window, softcap=softcap, sinks=sinks, scheme_id=scheme_id)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    kind = check_cuda_call("paged_attention", kv_dtype, scheme_id,
                           compute_dtype, sinks,
                           (k_pool, v_pool, k_scale, v_scale),
                           (q, block_table, seq_lens))
    win, cap = launch_variant(window, softcap)
    B, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    check_head_dim("paged_attention", kind, D, k_pool)
    if Hq % Hkv or Hq // Hkv > 8 or D > 256:
        raise ValueError(f"paged_attention: unsupported shape q {tuple(q.shape)}"
                         f" pool {tuple(k_pool.shape)}")
    if block_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("paged_attention: block_table / seq_lens batch")
    if sm_scale is None:
        sm_scale = D ** -0.5
    qf = q.float().contiguous()
    table = block_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    fn = cuda_build.kernel("paged_attention")
    err = fn(qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr(), v_scale.data_ptr(), table.data_ptr(),
             lens.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, bs,
             table.shape[1], KV_KINDS[kind],
             int(compute_dtype == torch.bfloat16), win, float(sm_scale),
             cap, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("paged_attention", err)
    paged_attention.launches[kind.value, win] += 1
    return out.to(q.dtype)


# kernel launches by (the scheme decoded, e.g. "int8" also for a MIXED8
# layer of scheme id 0; the window, 0 = none) since the count was last
# cleared; CPU calls are not counted. The total is the sum of the values.
paged_attention.launches = Counter()
