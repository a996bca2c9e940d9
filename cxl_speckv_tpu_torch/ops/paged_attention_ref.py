"""Plain PyTorch paged attention over the quantized block pool.

Counterpart of `cxl_speckv_tpu/ops/paged_attention_ref.py`. `paged_attention_ref`
is the plain version of kernel K1 (`ops/paged_attention.py`): the CPU path,
and what the kernel is held against on the card.

Pool layout (per layer; K token-major like V, the host store's row layout):
    k_pool, v_pool     [num_slots, Hkv, block_size, head_dim/pack]
    k_scale, v_scale   [num_slots, Hkv, block_size] float32

It walks the block table one block at a time with an online softmax, like
the kernels, and rounds at the kernels' points: q through `compute_dtype`
before q.K, the K scale on the scores after q.K, and p * v_scale through
`compute_dtype` before PV. Softmax statistics and the accumulator are
float32. With compute_dtype float32 it equals the JAX reference's math.
`paged_attention_ref(..., num_splits=k)` is the split form of K1's grid:
each lane's attended blocks divided evenly among k walks (`split_ranges`),
whose (m, l, acc) `merge_splits` combines with the sink, as the kernel's
merge pass does.
"""

from __future__ import annotations

import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops.quant import dequant_values

NEG_INF = -1e30


def soft_cap(s: torch.Tensor, softcap: float | None) -> torch.Tensor:
    """Gemma-2 tanh score softcapping (no-op when None)."""
    return s if softcap is None else softcap * torch.tanh(s / softcap)


def sink_softmax(scores: torch.Tensor, sink: torch.Tensor | None) -> torch.Tensor:
    """Softmax with a learned per-head sink logit in the denominator
    (GPT-OSS attention sinks): softmax([scores, sink]) with the sink column
    dropped. `sink` broadcasts against scores[..., :1]; None = softmax."""
    if sink is None:
        return torch.softmax(scores, dim=-1)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), sink)
    p = torch.exp(scores - m)
    return p / (p.sum(dim=-1, keepdim=True) + torch.exp(sink - m))


def _round(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return x.to(compute_dtype).float()


def online_update(state, s, ok, v, vs, compute_dtype):
    """One online-softmax step. state = (m, l, acc) with m, l [..., R, 1]
    and acc [..., R, D]; s, ok [..., R, C]; v [..., C, D]; vs [..., 1, C]
    (None for the float32 fresh-chunk part: no scale, no rounding)."""
    m, l, acc = state
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.where(ok, torch.exp(s - m_new), torch.zeros_like(s))
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = p if vs is None else _round(p * vs, compute_dtype)
    acc = acc * alpha + pv @ v
    return m_new, l, acc


def finalize(state, sinks: torch.Tensor | None) -> torch.Tensor:
    """acc / l, with an optional sink logit (shaped like m) joining the
    denominator; rows that saw no token give zeros."""
    m, l, acc = state
    if sinks is not None:
        m_fin = torch.maximum(m, sinks)
        a2 = torch.exp(m - m_fin)
        l = l * a2 + torch.exp(sinks - m_fin)
        acc = acc * a2
    return acc / torch.clamp_min(l, 1e-30)


def split_ranges(seq_lens: torch.Tensor, bs: int, max_blocks: int,
                 window: int | None, num_splits: int):
    """(begin, end) [B, num_splits]: the blocks each split of a lane walks,
    as K1's grid divides them -- the lane's attended blocks [first, nblk),
    first = max(len - window, 0) // bs, nblk = min(ceil(len / bs),
    max_blocks), split s taking [first + n * s // S, first + n * (s + 1) //
    S), n = nblk - first. Blocks below `first` are never read."""
    nblk = torch.clamp((seq_lens + bs - 1) // bs, max=max_blocks)
    lo = (torch.clamp(seq_lens - window, min=0) if window is not None
          else torch.zeros_like(seq_lens))
    first = lo // bs
    n = torch.clamp(nblk - first, min=0)
    s = torch.arange(num_splits + 1, device=seq_lens.device)
    edges = first[:, None] + n[:, None] * s[None, :] // num_splits
    return edges[:, :-1], edges[:, 1:]


def merge_splits(state, sinks: torch.Tensor | None) -> torch.Tensor:
    """The splits' states (m, l [B, S, ..., 1], acc [B, S, ..., D]) -> the
    output, as K1's merge kernel computes it: M = max(max_s m_s, sink),
    out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M) +
    e^(sink - M), 1e-30), summed over s in order. An empty split (m =
    -1e30, l = 0, acc = 0) adds 0."""
    m, l, acc = state
    M = m.amax(dim=1)
    if sinks is not None:
        M = torch.maximum(M, sinks)
    w = torch.exp(m - M[:, None])
    den = torch.zeros_like(M)
    num = torch.zeros_like(acc[:, 0])
    for s in range(m.shape[1]):
        den = den + l[:, s] * w[:, s]
        num = num + acc[:, s] * w[:, s]
    if sinks is not None:
        den = den + torch.exp(sinks - M)
    return num / torch.clamp_min(den, 1e-30)


def gather_block(pools, slots: torch.Tensor, kv_dtype: KVDtype,
                 scheme_id=None):
    """Block `slots` [B] of each lane -> float32 K, V [B, Hkv, bs, D] and
    scales [B, Hkv, bs]."""
    k_pool, v_pool, k_scale, v_scale = pools
    return (dequant_values(k_pool[slots], kv_dtype, scheme_id),
            dequant_values(v_pool[slots], kv_dtype, scheme_id),
            k_scale[slots], v_scale[slots])


def paged_attention_ref(
    q: torch.Tensor,             # [B, Hq, D]
    k_pool: torch.Tensor,        # [S, Hkv, bs, D/pack]
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,       # [S, Hkv, bs] f32
    v_scale: torch.Tensor,
    block_table: torch.Tensor,   # [B, max_blocks] int32
    seq_lens: torch.Tensor,      # [B] int32, includes the token being decoded
    kv_dtype: KVDtype,
    sm_scale: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
    window: int | None = None,
    softcap: float | None = None,
    sinks: torch.Tensor | None = None,   # [Hq] learned sink logits
    scheme_id: int | None = None,        # MIXED8: 0 = INT8, 1 = FP8 bytes
    num_splits: int | None = None,       # K1's context splits; None = 1
) -> torch.Tensor:
    """Decode-step attention, one query token per lane -> [B, Hq, D] in
    q's dtype. With `window`, the query at position len - 1 attends only to
    positions >= len - window. Split s of a lane walks its blocks in order
    (step j takes block begin + j of every split at once); one split
    finalizes as the unsplit walk does, several merge (`merge_splits`)."""
    B, Hq, D = q.shape
    _, Hkv, bs, _ = v_pool.shape
    G = Hq // Hkv
    S = num_splits or 1
    if sm_scale is None:
        sm_scale = D ** -0.5
    seq_lens = seq_lens.long()
    dev = q.device
    qg = _round(q.reshape(B, 1, Hkv, G, D), compute_dtype)
    state = (torch.full((B, S, Hkv, G, 1), NEG_INF, device=dev),
             torch.zeros((B, S, Hkv, G, 1), device=dev),
             torch.zeros((B, S, Hkv, G, D), device=dev))
    pools = (k_pool, v_pool, k_scale, v_scale)
    table = block_table.long()
    max_blocks = table.shape[1]
    begin, end = split_ranges(seq_lens, bs, max_blocks, window, S)
    lo = (seq_lens - window if window is not None
          else torch.full_like(seq_lens, -1))
    steps = int((end - begin).max()) if B else 0
    for j in range(steps):
        blk = begin + j                                         # [B, S]
        slots = torch.gather(table, 1, torch.clamp(blk, max=max_blocks - 1))
        k, v, ks, vs = (x.reshape(B, S, *x.shape[1:]) for x in gather_block(
            pools, slots.flatten(), kv_dtype, scheme_id))
        s = (qg @ k.transpose(-1, -2)) * ks[:, :, :, None, :] * sm_scale
        s = soft_cap(s, softcap)
        pos = blk[..., None] * bs + torch.arange(bs, device=dev)  # [B, S, bs]
        ok = ((blk < end)[..., None] & (pos < seq_lens[:, None, None])
              & (pos >= lo[:, None, None]))
        state = online_update(state, s, ok[:, :, None, None, :], v,
                              vs[:, :, :, None, :], compute_dtype)
    sk = (sinks.reshape(1, Hkv, G, 1).float() if sinks is not None else None)
    if S == 1:
        out = finalize(tuple(x[:, 0] for x in state), sk)
    else:
        out = merge_splits(state, sk)
    return out.reshape(B, Hq, D).to(q.dtype)


def prefill_attention_ref(
    q: torch.Tensor,             # [T, Hq, D] fresh queries
    k_new: torch.Tensor,         # [T, Hkv, D] fresh keys
    v_new: torch.Tensor,
    start_pos: int,              # absolute position of q[0]
    k_pool: torch.Tensor | None = None,
    v_pool: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    block_table_row: torch.Tensor | None = None,   # [max_blocks]
    kv_dtype: KVDtype = KVDtype.INT8,
    sm_scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
    sinks: torch.Tensor | None = None,
    scheme_id: int | None = None,
) -> torch.Tensor:
    """Chunked-prefill attention for one sequence, dense float32: causal
    over the fresh chunk plus full attention to the `start_pos` context
    tokens already in the pool."""
    T, Hq, D = q.shape
    Hkv = k_new.shape[1]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    dev = q.device
    qg = q.reshape(T, Hkv, G, D).float()
    scores_new = soft_cap(torch.einsum("thgd,shd->hgts", qg, k_new.float())
                          * sm_scale, softcap)
    t_idx = torch.arange(T, device=dev)
    causal = t_idx[:, None] >= t_idx[None, :]
    if window is not None:
        causal = causal & (t_idx[:, None] - t_idx[None, :] < window)
    scores_new = scores_new.masked_fill(~causal, NEG_INF)
    sk = sinks.reshape(Hkv, G, 1, 1).float() if sinks is not None else None
    if not (start_pos and k_pool is not None):
        w = sink_softmax(scores_new, sk)
        out = torch.einsum("hgts,shd->thgd", w, v_new.float())
        return out.reshape(T, Hq, D).to(q.dtype)
    bs = v_pool.shape[2]
    slots = block_table_row.long()
    L = slots.shape[0] * bs
    flat = lambda x: x.transpose(1, 2).reshape(L, Hkv, *x.shape[3:])
    k_ctx = flat(dequant_values(k_pool[slots], kv_dtype, scheme_id))
    v_ctx = flat(dequant_values(v_pool[slots], kv_dtype, scheme_id))
    ks = flat(k_scale[slots])                                  # [L, Hkv]
    vs = flat(v_scale[slots])
    scores_ctx = soft_cap(torch.einsum("thgd,lhd->hgtl", qg, k_ctx)
                          * ks.T[:, None, None, :] * sm_scale, softcap)
    pos = torch.arange(L, device=dev)
    ctx_ok = (pos[None, :] < start_pos).expand(T, L)
    if window is not None:
        lower = start_pos + t_idx - window + 1
        ctx_ok = ctx_ok & (pos[None, :] >= lower[:, None])
    scores_ctx = scores_ctx.masked_fill(~ctx_ok, NEG_INF)
    w = sink_softmax(torch.cat([scores_ctx, scores_new], dim=-1), sk)
    w_ctx, w_new = w[..., :L], w[..., L:]
    out = torch.einsum("hgtl,lhd->thgd", w_ctx * vs.T[:, None, None, :], v_ctx)
    out = out + torch.einsum("hgts,shd->thgd", w_new, v_new.float())
    return out.reshape(T, Hq, D).to(q.dtype)
