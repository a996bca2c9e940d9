"""K2: paged chunk attention, a CUDA kernel for Hopper.

Counterpart of `cxl_speckv_tpu/ops/chunk_attention_pallas.py` (the Pallas TPU
kernel `paged_chunk_attention_pallas`), named after what it now is. The
kernel source is `csrc/chunk_attention.cu`, whose header gives its design
and bound: T fresh queries per lane attend to the lane's quantized pool
context through the block table, then causally to the fresh chunk in IEEE
float32 (batched chunked prefill; speculative verify with T = gamma + 1).

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version `ops/chunk_attention.paged_chunk_attention`. The storage kind
(MIXED8 with its `scheme_id` as INT8 or FP8), window, softcap and sinks are
launch arguments, as in K1.
"""

from __future__ import annotations

from collections import Counter

import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops import cuda_build
from cxl_speckv_tpu_torch.ops.chunk_attention import paged_chunk_attention
from cxl_speckv_tpu_torch.ops.paged_attention import (
    KV_KINDS,
    check_cuda_call,
    check_head_dim,
    count_launch,
    launch_variant,
    sink_logits,
)

# query rows per CTA: R * head_dim <= 8192 (the kernel's accumulator)
_ROW_ELEMS = 8192


def rows_per_cta(T: int, group: int, head_dim: int) -> int:
    return max(1, min(64, _ROW_ELEMS // head_dim, T * group))


def paged_chunk_attention_cuda(
    q: torch.Tensor,             # [B, T, Hq, D]
    k_new: torch.Tensor,         # [B, T, Hkv, D] fresh keys (store-rounded)
    v_new: torch.Tensor,
    k_pool: torch.Tensor,        # [S, Hkv, bs, D/pack] int8 bytes or bf16
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,       # [S, Hkv, bs] f32
    v_scale: torch.Tensor,
    block_table: torch.Tensor,   # [B, max_blocks] int32
    start_pos: torch.Tensor,     # [B] int32
    kv_dtype: KVDtype,
    sm_scale: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
    window: int | None = None,
    softcap: float | None = None,
    sinks: torch.Tensor | None = None,
    scheme_id: int | None = None,  # MIXED8: 0 = INT8, 1 = FP8 bytes
) -> torch.Tensor:
    """Chunk attention -> [B, T, Hq, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_chunk_attention(
            q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, block_table,
            start_pos, kv_dtype, sm_scale=sm_scale,
            compute_dtype=compute_dtype, window=window, softcap=softcap,
            sinks=sinks, scheme_id=scheme_id)
    if q.device.type != "cuda":
        raise ValueError(f"paged_chunk_attention: unsupported device {q.device}")
    kind = check_cuda_call("paged_chunk_attention", kv_dtype, scheme_id,
                           compute_dtype, (k_pool, v_pool, k_scale, v_scale),
                           (q, k_new, v_new, block_table, start_pos))
    win, cap = launch_variant(window, softcap)
    B, T, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    check_head_dim("paged_chunk_attention", kind, D, k_pool)
    if (Hq % Hkv or D > _ROW_ELEMS
            or k_new.shape != (B, T, Hkv, D) or v_new.shape != k_new.shape):
        raise ValueError(f"paged_chunk_attention: unsupported shape q "
                         f"{tuple(q.shape)} k_new {tuple(k_new.shape)} pool "
                         f"{tuple(k_pool.shape)}")
    if block_table.shape[0] != B or start_pos.shape != (B,):
        raise ValueError("paged_chunk_attention: block_table / start_pos batch")
    if sm_scale is None:
        sm_scale = D ** -0.5
    sk = sink_logits("paged_chunk_attention", sinks, Hq, q.device)
    qf = q.float().contiguous()
    kf = k_new.float().contiguous()
    vf = v_new.float().contiguous()
    table = block_table.to(torch.int32).contiguous()
    start = start_pos.to(torch.int32).contiguous()
    out = torch.empty((B, T, Hq, D), dtype=torch.float32, device=q.device)
    fn = cuda_build.kernel("chunk_attention")
    err = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), k_pool.data_ptr(),
             v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
             table.data_ptr(), start.data_ptr(),
             None if sk is None else sk.data_ptr(), out.data_ptr(), B, T, Hq,
             Hkv, D, bs, table.shape[1], rows_per_cta(T, Hq // Hkv, D),
             KV_KINDS[kind], int(compute_dtype == torch.bfloat16), win,
             float(sm_scale), cap,
             torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("paged_chunk_attention", err)
    count_launch(paged_chunk_attention_cuda, kind, win, sk)
    return out.to(q.dtype)


# kernel launches by (scheme decoded, window), as K1's `launches` and
# `sink_launches`; CPU calls are not counted. The total is the sum of the
# values.
paged_chunk_attention_cuda.launches = Counter()
paged_chunk_attention_cuda.sink_launches = Counter()
