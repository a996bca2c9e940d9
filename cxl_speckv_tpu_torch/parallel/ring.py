"""Sequence parallelism: ring attention over an "sp" line.

Counterpart of `cxl_speckv_tpu/parallel/ring.py`. The sequence splits into
S chunks of T/S tokens; line index i holds positions i * T/S ... (i + 1) *
T/S - 1, computes their q / k / v (RoPE at the global positions), and in
every layer the k / v chunks travel around the ring (`LineMesh.shift`, the
counterpart of `lax.ppermute`) while each rank folds the chunk it holds
into its queries' online softmax (`ring_update`). After S - 1 hops every
rank has seen every chunk; the sinks join last (`ring_finish`). Attention
memory stays O(T/S) a rank. The logits are gathered along the line, so that
every rank returns the whole [B, T, V].

This is the offline-scoring and long-prefill forward (no KV cache); the
decode serving path keeps dp / ep / tp and the tiered paged cache.
"""

from __future__ import annotations

import functools

import torch

from cxl_speckv_tpu_torch.models.configs import LlamaConfig
from cxl_speckv_tpu_torch.models.llama import (
    _embed,
    _final_logits,
    _norm,
    attention_mask,
    check_supported,
    dense_layer,
    layer_params,
    layer_ropes,
)
from cxl_speckv_tpu_torch.ops.paged_attention_ref import (
    NEG_INF,
    finalize,
    online_update,
    soft_cap,
)
from cxl_speckv_tpu_torch.parallel.mesh import LineMesh


def check_split(config: LlamaConfig, seq_len: int, parts: int) -> None:
    """The JAX package's refusals: a sequence not divisible by the line,
    and a layer count not divisible by an alternating attention pattern."""
    c = config
    if seq_len % parts:
        raise ValueError(f"seq len {seq_len} not divisible by sp={parts}")
    if (len(set(c.layer_windows())) > 1
            and c.num_layers % len(c.attn_pattern)):
        raise ValueError("num_layers not divisible by attn_pattern period")


def ring_update(q, k_chunk, v_chunk, q_pos, kv_pos0: int, m, l, acc, *,
                config: LlamaConfig, window: int | None = None):
    """Fold one KV chunk into the online softmax of the local queries.

    q [B, Hkv, G, Tl, D] float32; k_chunk / v_chunk [B, Tc, Hkv, D], the
    chunk whose first token sits at global position `kv_pos0`; q_pos [Tl]
    the queries' global positions; m, l [B, Hkv, G, Tl, 1] and acc
    [B, Hkv, G, Tl, D] the running max, denominator and numerator. Scores
    take the softcap, then the causal and window masks at global
    positions. Returns the new (m, l, acc)."""
    c = config
    kv_pos = kv_pos0 + torch.arange(k_chunk.shape[1], device=q_pos.device)
    k = k_chunk.float().permute(0, 2, 1, 3)[:, :, None]     # [B,Hkv,1,Tc,D]
    v = v_chunk.float().permute(0, 2, 1, 3)[:, :, None]
    s = soft_cap((q @ k.transpose(-1, -2)) * c.sm_scale, c.attn_softcap)
    return online_update((m, l, acc), s,
                         attention_mask(q_pos, kv_pos, window), v, None,
                         torch.float32)


def ring_finish(m, l, acc, sinks) -> torch.Tensor:
    """The attention output [B, Tl, Hkv * G * D] of the folded state, the
    learned sink logits (`sinks` [Hkv * G] or None) joining the max and
    the denominator after every chunk."""
    B, hkv, G, Tl, D = acc.shape
    sk = (None if sinks is None
          else sinks.reshape(hkv, G).float()[None, :, :, None, None])
    out = finalize((m, l, acc), sk)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tl, -1)


def ring_attention_local(q, k, v, sinks, *, q_pos, mesh: LineMesh,
                         config: LlamaConfig, window: int | None = None):
    """This rank's attention output [B, Tl, hq * D] over the whole
    sequence: q / k / v [B, Tl, heads, D] of the local chunk; the k / v
    chunks rotate S - 1 hops around the ring (k and v stacked into one
    shift). At hop j this rank holds the chunk of index (i - j) mod S."""
    c = config
    B, Tl, hkv, D = k.shape
    qg = (q.reshape(B, Tl, hkv, c.q_group, D).float()
          .permute(0, 2, 3, 1, 4))                           # [B,Hkv,G,Tl,D]
    m = torch.full((B, hkv, c.q_group, Tl, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, hkv, c.q_group, Tl, D), dtype=torch.float32,
                      device=q.device)
    kv = torch.stack((k, v))
    S, i = mesh.size, mesh.index
    for j in range(S):
        m, l, acc = ring_update(qg, kv[0], kv[1], q_pos, ((i - j) % S) * Tl,
                                m, l, acc, config=c, window=window)
        if j < S - 1:
            kv = mesh.shift(kv, torch.empty_like(kv))
    return ring_finish(m, l, acc, sinks)


def sp_forward_dense(params: dict, config: LlamaConfig,
                     token_ids: torch.Tensor, *,
                     mesh: LineMesh) -> torch.Tensor:
    """Full causal forward with the sequence split over `mesh` (an "sp"
    `LineMesh`) and ring attention in every layer: logits [B, T, V]
    float32 on every rank of the world, equal to `forward_dense`'s up to
    the online softmax's summation order. Every rank passes the whole tree
    and the whole [B, T] tokens."""
    c = config
    check_supported(c)
    S = mesh.size
    B, T = token_ids.shape
    check_split(c, T, S)
    dev = token_ids.device
    i = mesh.index
    if i is None:            # past the line: line index 0 sends the result
        out = torch.empty((B, T, c.vocab_size), dtype=torch.float32,
                          device=dev)
        return mesh.broadcast(out, 0)
    Tl = T // S
    q_pos = i * Tl + torch.arange(Tl, device=dev)
    ropes = layer_ropes(c, dev)
    x = _embed(params, c, token_ids[:, i * Tl:(i + 1) * Tl])
    for li, window in enumerate(c.layer_windows()):
        x = dense_layer(x, layer_params(params, li), c, q_pos, ropes[li],
                        functools.partial(ring_attention_local, q_pos=q_pos,
                                          mesh=mesh, config=c,
                                          window=window))
    logits = _final_logits(_norm(x, params["final_norm"], c), params, c)
    out = mesh.all_gather(logits, 1)
    return out if S == mesh.world else mesh.broadcast(out, 0)
