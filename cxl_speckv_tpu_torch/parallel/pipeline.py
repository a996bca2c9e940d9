"""Pipeline parallelism: a GPipe microbatch pipeline over a "pp" line.

Counterpart of `cxl_speckv_tpu/parallel/pipeline.py`. The layer stack
[L, ...] splits into S stages of L/S consecutive layers (`stage_params`);
line index s runs stage s, and the activations of a microbatch pass one hop
a tick to stage s + 1 (`LineMesh.shift`, the counterpart of the JAX
package's `lax.ppermute` inside `shard_map`): S + M - 1 ticks for M
microbatches, a bubble of (S - 1) / (S + M - 1). A stage skips its bubble
ticks, and only the last one computes logits; it broadcasts them to every
rank, as the JAX package's zero-elsewhere `psum` replicates them.

This is the offline-scoring forward (no KV cache): perplexity evals,
reward and distillation scoring of a model whose layers do not fit one
card. The decode serving path stays dp / ep / tp.
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
    masked_attention,
    torch_dtype,
)
from cxl_speckv_tpu_torch.parallel.mesh import LineMesh


def check_split(config: LlamaConfig, batch: int, stages: int,
                microbatches: int) -> None:
    """The JAX package's refusals: layers not divisible by the stages, a
    batch not divisible by the microbatches, and stages that would misalign
    an alternating attention pattern."""
    c = config
    if c.num_layers % stages:
        raise ValueError(f"num_layers={c.num_layers} not divisible by "
                         f"pp={stages}")
    if batch % microbatches:
        raise ValueError(f"batch {batch} not divisible by microbatches "
                         f"{microbatches}")
    if len(set(c.layer_windows())) > 1:
        period = len(c.attn_pattern)
        if (c.num_layers // stages) % period:
            raise ValueError(
                f"per-stage layers {c.num_layers // stages} not divisible "
                f"by attn_pattern period {period} — stages would misalign "
                f"the pattern")


def stage_params(params: dict, stage: int, num_stages: int) -> dict:
    """Stage `stage`'s tree: layers stage * L/S ... (stage + 1) * L/S - 1 of
    the stacked [L, ...] leaves (views; a quantized leaf slices its q and
    scale), the rest of the tree as it is."""
    L = next(iter(params["layers"].values())).shape[0]
    if L % num_stages:
        raise ValueError(f"num_layers={L} not divisible by pp={num_stages}")
    n = L // num_stages
    out = dict(params)
    out["layers"] = {k: v[stage * n:(stage + 1) * n]
                     for k, v in params["layers"].items()}
    return out


def pipeline_forward(params: dict, config: LlamaConfig,
                     token_ids: torch.Tensor, *, mesh: LineMesh,
                     num_microbatches: int = 4) -> torch.Tensor:
    """Full causal forward, logits [B, T, V] float32 on every rank of the
    world, pipelined over `mesh` (a "pp" `LineMesh`). The layer math is
    `forward_dense`'s (`models.llama.dense_layer`, each layer by its global
    index); only the microbatch rows differ, so the logits equal dense ones
    to float32 rounding. Every rank passes the whole tree and the tokens."""
    c = config
    check_supported(c)
    S, M = mesh.size, num_microbatches
    B, T = token_ids.shape
    check_split(c, B, S, M)
    mb = B // M
    dev = token_ids.device
    out = torch.empty((M, mb, T, c.vocab_size), dtype=torch.float32,
                      device=dev)
    s = mesh.index
    if s is not None:
        staged = stage_params(params, s, S)
        n = c.num_layers // S
        positions = torch.arange(T, device=dev)
        ropes = layer_ropes(c, dev)
        wins = c.layer_windows()
        attend = {w: functools.partial(
            masked_attention, mask=attention_mask(positions, positions, w),
            config=c) for w in set(wins)}
        mbs = token_ids.reshape(M, mb, T)
        act = (mb, T, c.hidden_size)
        x = None
        for t in range(S + M - 1):
            m = t - s                     # the microbatch stage s holds
            busy = 0 <= m < M
            if busy:
                if s == 0:
                    x = _embed(params, c, mbs[m])
                for j in range(n):
                    li = s * n + j
                    x = dense_layer(x, layer_params(staged, j), c, positions,
                                    ropes[li], attend[wins[li]])
                if s == S - 1:
                    out[m] = _final_logits(_norm(x, params["final_norm"], c),
                                           params, c)
            # stage s hands microbatch m on; stage s - 1 hands it m + 1
            recv = (torch.empty(act, dtype=torch_dtype(c.dtype), device=dev)
                    if s > 0 and 0 <= m + 1 < M else None)
            x = mesh.shift(x if busy and s < S - 1 else None, recv)
    return mesh.broadcast(out, S - 1).reshape(B, T, -1)
