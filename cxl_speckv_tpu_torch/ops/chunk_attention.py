"""Plain PyTorch chunk attention over paged quantized context.

Counterpart of `cxl_speckv_tpu/ops/chunk_attention.py`, and the plain version
of kernel K2 (`ops/chunk_attention_cuda.py`): each lane scores a chunk of T
fresh queries (a prefill chunk, or gamma + 1 verify tokens), causal within
the chunk, with full attention to the lane's pool context (positions <
start_pos). Context blocks stream through an online softmax at the kernels'
rounding points (see `ops/paged_attention_ref.py`); the fresh chunk is
float32 throughout, with q rounded through `compute_dtype` first.
"""

from __future__ import annotations

import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops.paged_attention_ref import (
    NEG_INF,
    _round,
    finalize,
    gather_block,
    online_update,
    soft_cap,
)


def paged_chunk_attention(
    q: torch.Tensor,             # [B, T, Hq, D] fresh queries (rope applied)
    k_new: torch.Tensor,         # [B, T, Hkv, D] fresh keys (store-rounded)
    v_new: torch.Tensor,
    k_pool: torch.Tensor,        # [S, Hkv, bs, D/pack]
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,       # [S, Hkv, bs] f32
    v_scale: torch.Tensor,
    block_table: torch.Tensor,   # [B, max_blocks] int32
    start_pos: torch.Tensor,     # [B] int32: pool tokens < start_pos are context
    kv_dtype: KVDtype,
    sm_scale: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
    window: int | None = None,
    softcap: float | None = None,
    sinks: torch.Tensor | None = None,   # [Hq] learned sink logits
    scheme_id: int | None = None,        # MIXED8: 0 = INT8, 1 = FP8 bytes
) -> torch.Tensor:
    """Returns [B, T, Hq, D] in q's dtype."""
    B, T, Hq, D = q.shape
    _, Hkv, bs, _ = v_pool.shape
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    dev = q.device
    start = start_pos.long()
    t_idx = torch.arange(T, device=dev)
    # rows of a kv head are (t, g) pairs: [B, Hkv, T*G, D]
    qg = _round(q.reshape(B, T, Hkv, G, D).permute(0, 2, 1, 3, 4)
                .reshape(B, Hkv, T * G, D), compute_dtype)
    row_t = t_idx.repeat_interleave(G)                         # [T*G]
    R = T * G
    state = (torch.full((B, Hkv, R, 1), NEG_INF, device=dev),
             torch.zeros((B, Hkv, R, 1), device=dev),
             torch.zeros((B, Hkv, R, D), device=dev))

    # ---- pool context (online softmax over blocks) ----
    pools = (k_pool, v_pool, k_scale, v_scale)
    nblk = min(-(-int(start.max()) // bs) if B else 0, block_table.shape[1])
    for i in range(nblk):
        k, v, ks, vs = gather_block(pools, block_table[:, i].long(), kv_dtype,
                                    scheme_id)
        s = (qg @ k.transpose(-1, -2)) * ks[:, :, None, :] * sm_scale
        s = soft_cap(s, softcap)
        pos = i * bs + torch.arange(bs, device=dev)
        ok = (pos[None, :] < start[:, None])[:, None, None, :]  # [B,1,1,bs]
        if window is not None:
            # row t sits at absolute position start + t and attends
            # positions in [start + t - window + 1, start + t]
            lo = start[:, None] + row_t[None, :] - window        # [B, R]
            ok = ok & (pos[None, None, :] > lo[:, :, None])[:, None]
        state = online_update(state, s, ok, v, vs[:, :, None, :],
                              compute_dtype)

    # ---- fresh chunk: causal, float32 ----
    kf = k_new.float().permute(0, 2, 1, 3)                     # [B, Hkv, T, D]
    vf = v_new.float().permute(0, 2, 1, 3)
    s = soft_cap((qg @ kf.transpose(-1, -2)) * sm_scale,          # [B,Hkv,R,T]
                 softcap)
    ok = row_t[:, None] >= t_idx[None, :]
    if window is not None:
        ok = ok & (row_t[:, None] - t_idx[None, :] < window)
    state = online_update(state, s, ok, vf, None, compute_dtype)

    sk = None
    if sinks is not None:
        sk = sinks.reshape(1, Hkv, G).float().repeat(1, 1, T)[..., None]
    out = finalize(state, sk)                                  # [B,Hkv,R,D]
    return (out.reshape(B, Hkv, T, G, D).permute(0, 2, 1, 3, 4)
            .reshape(B, T, Hq, D).to(q.dtype))
