"""Offline batch scoring: per-token prompt logprobs from one full forward.

Counterpart of `cxl_speckv_tpu/engine/scoring.py`. Serving scores prompts
through the chunked prefill over the quantized KV pools (echo scoring,
`Engine.add_request(prompt_logprobs=True)`); this is the other regime:
whole prompts scored at the model's precision with no KV pools at all
(perplexity evals, reranking, distillation scoring).

One entry point, three executions of the same math on the device the
weights live on:

- `mode="dense"`: `models.llama.forward_dense` in this process; on a
  mesh-cut tree with the serving path's tp / ep collectives;
- `mode="pp"`: the GPipe pipeline over a "pp" line of ranks
  (`parallel.pipeline.pipeline_forward`), the layers split by stage, for
  a model whose layers do not fit one card;
- `mode="sp"`: ring attention over an "sp" line
  (`parallel.ring.sp_forward_dense`), the sequence split, for a prompt
  whose activations do not fit one card.

pp and sp run in a `torch.distributed` world of one process a rank
(`parallel/distributed.py`): every rank calls `score_prompts` with the same
arguments and gets every score back.
"""

from __future__ import annotations

import numpy as np
import torch

from cxl_speckv_tpu_torch.models.llama import forward_dense
from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor
from cxl_speckv_tpu_torch.parallel import pipeline, ring
from cxl_speckv_tpu_torch.parallel.mesh import LineMesh
from cxl_speckv_tpu_torch.parallel.sharding import mesh_of


def _pad_batch(prompts: list[list[int]], multiple_b: int,
               multiple_t: int) -> tuple[np.ndarray, int, int]:
    B = len(prompts)
    T = max(len(p) for p in prompts)
    T = -(-T // multiple_t) * multiple_t
    Bp = -(-B // multiple_b) * multiple_b
    toks = np.zeros((Bp, T), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    return toks, B, T


def params_device(params: dict) -> torch.device:
    """The device the tree's embedding lives on."""
    e = params["embed"]
    return (e.q if isinstance(e, QuantizedTensor) else e).device


def score_prompts(params, config, prompts: list[list[int]], *,
                  mode: str = "dense", parallel_size: int | None = None,
                  num_microbatches: int = 4,
                  devices=None) -> list[list[float]]:
    """Per-token log p(prompt[i] | prompt[:i]) for each prompt, from one
    full forward. Entry i of each result scores prompt token i + 1 (the
    first token is unconditioned), the serving path's prompt_logprobs
    convention.

    mode "pp" / "sp" lay a line of `parallel_size` ranks (default: the
    world's size, 1 with no world) over ranks 0 ... parallel_size - 1 of
    the initialized world, and pipeline the layers over it in
    `num_microbatches` microbatches (the batch padded to a multiple) or
    ring the sequence around it (the length padded to a multiple of the
    line): equal to dense up to summation order. Every rank of the world
    calls this with the same arguments; a rank past the line gets the
    scores by broadcast. A `parallel_size` larger than the world raises
    ValueError, as does a tree cut for a (dp, ep, tp) mesh. `devices` (the
    JAX package's device list) has no counterpart: the world's ranks are
    the devices, and any value but None raises ValueError."""
    if not prompts or any(len(p) < 2 for p in prompts):
        raise ValueError("each prompt needs >= 2 tokens to score")
    if mode not in ("dense", "pp", "sp"):
        raise ValueError(f"unknown scoring mode {mode!r}")
    if devices is not None:
        raise ValueError("devices has no counterpart in the port: pp / sp "
                         "run over the ranks of the torch.distributed world "
                         "(parallel_size of them)")
    dev = params_device(params)
    if mode == "dense":
        toks, B, T = _pad_batch(prompts, 1, 1)
        ids = torch.from_numpy(toks).to(dev)
        with torch.no_grad():
            logits = forward_dense(params, config, ids)
    else:
        if mesh_of(params) is not None:
            raise ValueError(f"score_prompts(mode={mode!r}) takes a whole "
                             "tree, not one cut for a (dp, ep, tp) mesh")
        S = parallel_size or (torch.distributed.get_world_size()
                              if torch.distributed.is_initialized() else 1)
        if mode == "pp":
            toks, B, T = _pad_batch(prompts, num_microbatches, 1)
            pipeline.check_split(config, len(toks), S, num_microbatches)
        else:
            toks, B, T = _pad_batch(prompts, 1, S)
            ring.check_split(config, T, S)
        ids = torch.from_numpy(toks).to(dev)
        with LineMesh(mode, S, device=dev) as mesh, torch.no_grad():
            if mode == "pp":
                logits = pipeline.pipeline_forward(
                    params, config, ids, mesh=mesh,
                    num_microbatches=num_microbatches)
            else:
                logits = ring.sp_forward_dense(params, config, ids,
                                               mesh=mesh)
    with torch.no_grad():
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        chosen = torch.gather(lp, -1, ids[:, 1:, None].long())[..., 0]
    chosen = chosen.cpu().numpy()
    return [chosen[i, : len(p) - 1].tolist() for i, p in enumerate(prompts)]
