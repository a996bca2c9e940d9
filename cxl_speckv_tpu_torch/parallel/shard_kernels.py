"""The attention kernels K1 and K2 on one rank's shard of a mesh.

Counterpart of `cxl_speckv_tpu/parallel/shard_kernels.py`, where
`jax.shard_map` runs the unmodified single-chip Pallas kernels on each
chip's [B/dp, Hkv/tp] slice. Here each rank already holds that slice: its
q / k / v columns give it the query heads of its own kv heads (kv-head-major
layout, `parallel/sharding.py`), its pools hold only those kv heads, and
`lane_slice` picks its lanes. So every (lane, kv head) reduction is
rank-local, and the wrappers hand the kernels this rank's lanes, heads,
pool shard and sinks unchanged: K1 (`ops.paged_attention.paged_attention`)
and K2 (`ops.chunk_attention_cuda.paged_chunk_attention_cuda`) launch on a
CUDA tensor, their plain versions run on a CPU tensor, as in single-rank
serving. A shape that is not this rank's shard raises; nothing swaps in
another attention.

A batch whose lane count does not divide dp (a single-sequence prefill, a
draft's one-lane pass) runs on every dp rank whole: the JAX package's
batch-replicated branch (`_batch_axis`).

`exchange_rows` keeps the dp replicas of the pools equal: a rank appends KV
only for its own lanes, so after a pass every rank copies the rows the
others appended. At every round boundary the real slots (not the guard
slot, which nothing reads) of the pools of ranks with the same tp index are
then bitwise equal, and so are their host stores, which only ever receive
pool rows.
"""

from __future__ import annotations

import torch

from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
    paged_chunk_attention_cuda,
)
from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention


def lane_slice(mesh, b: int) -> slice | None:
    """This dp rank's lanes of a b-lane batch, or None when every rank runs
    all of them (no mesh, dp 1, or b not a multiple of dp)."""
    if mesh is None or mesh.dp == 1 or b % mesh.dp:
        return None
    n = b // mesh.dp
    lo = mesh.coords["dp"] * n
    return slice(lo, lo + n)


def shard_heads(config, mesh) -> tuple[int, int]:
    """(query heads, kv heads) a rank of `mesh` holds: the model's over tp
    (over 1 without a mesh). The model reshapes q / k / v to these counts,
    so a tp shard that has lost its mesh fails at its first layer."""
    tp = 1 if mesh is None else mesh.tp
    return config.num_q_heads // tp, config.num_kv_heads // tp


def _check_shard(mesh, config, q_heads: int, pool_heads: int) -> None:
    if (q_heads, pool_heads) != shard_heads(config, mesh):
        raise ValueError(
            f"not this rank's shard: {q_heads} q heads over a pool of "
            f"{pool_heads} kv heads at tp={1 if mesh is None else mesh.tp} "
            f"(the model has {config.num_q_heads} / {config.num_kv_heads})")


def sharded_paged_attention(mesh, config, *, compute_dtype, softcap=None):
    """K1 on this rank's shard (the whole model without a mesh): q
    [B_r, Hq/tp, D] over pools [S, Hkv/tp, bs, Dp], sinks [Hq/tp]; returns
    [B_r, Hq/tp, D]."""

    def attend(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
               kv_dtype, **kw):
        _check_shard(mesh, config, q.shape[1], k_pool.shape[1])
        return paged_attention(q, k_pool, v_pool, k_scale, v_scale,
                               block_table, seq_lens, kv_dtype,
                               compute_dtype=compute_dtype, softcap=softcap,
                               **kw)

    return attend


def sharded_chunk_attention(mesh, config, *, compute_dtype, softcap=None):
    """K2 on this rank's shard (the whole model without a mesh): q
    [B_r, T, Hq/tp, D], k_new / v_new [B_r, T, Hkv/tp, D] over pools
    [S, Hkv/tp, bs, Dp]; returns [B_r, T, Hq/tp, D]."""

    def attend_chunk(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                     block_table, start_pos, kv_dtype, **kw):
        _check_shard(mesh, config, q.shape[2], k_pool.shape[1])
        return paged_chunk_attention_cuda(
            q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, block_table,
            start_pos, kv_dtype, compute_dtype=compute_dtype,
            softcap=softcap, **kw)

    return attend_chunk


def exchange_rows(pools, mesh, lanes: slice | None, slots: torch.Tensor,
                  offs: torch.Tensor) -> None:
    """After a pass in which lane b appended KV at (slots[b, j], offs[b, j])
    of every layer (slots / offs [B, n] for the whole batch), give every dp
    rank the rows the others appended: one all-gather over dp of the bytes
    of this rank's lanes' rows, written back at every lane's positions in
    lane order. No-op when the batch ran whole on every rank."""
    if lanes is None:
        return
    s_l = slots[lanes].reshape(-1)
    o_l = offs[lanes].reshape(-1)
    n_l = s_l.numel()
    rows = [p[:, s_l, :, o_l] for p in pools]   # [n_l, L, Hkv, (Dp)]
    widths = [r[0].numel() * r.element_size() for r in rows]
    blob = torch.cat([r.contiguous().view(torch.uint8).reshape(n_l, -1)
                      for r in rows], dim=1)
    blob = mesh.all_gather(blob, "dp", 0)          # [n_l * dp, bytes]
    s_all, o_all = slots.reshape(-1), offs.reshape(-1)
    at = 0
    for p, r, w in zip(pools, rows, widths):
        vals = blob[:, at:at + w].contiguous().view(r.dtype)
        p[:, s_all, :, o_all] = vals.reshape(-1, *r.shape[1:])
        at += w
