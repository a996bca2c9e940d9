"""Offline batch scoring: per-token prompt logprobs from one full forward.

Counterpart of `cxl_speckv_tpu/engine/scoring.py`. Serving scores prompts
through the chunked prefill over the quantized KV pools (echo scoring,
`Engine.add_request(prompt_logprobs=True)`); this is the other regime:
whole prompts scored at the model's precision with no KV pools at all
(perplexity evals, reranking, distillation scoring).

`mode="dense"` runs `models.llama.forward_dense` on the device the weights
live on; on a mesh-cut tree it runs with the serving path's tp / ep
collectives. The JAX package's pipeline (`"pp"`) and ring-attention
(`"sp"`) executions of the same math belong to the offline-scoring half of
its `parallel` package, which the port has not ported yet: they raise
NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from cxl_speckv_tpu_torch.models.llama import forward_dense
from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor


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
    convention. `parallel_size`, `num_microbatches` and `devices` belong to
    the unported "pp" / "sp" modes."""
    if not prompts or any(len(p) < 2 for p in prompts):
        raise ValueError("each prompt needs >= 2 tokens to score")
    if mode in ("pp", "sp"):
        raise NotImplementedError(
            f"not ported yet: score_prompts(mode={mode!r}) needs "
            f"parallel/pipeline.py and parallel/ring.py, the next slice of "
            f"the port (ROADMAP queue 1 item 5)")
    if mode != "dense":
        raise ValueError(f"unknown scoring mode {mode!r}")
    toks, B, T = _pad_batch(prompts, 1, 1)
    ids = torch.from_numpy(toks).to(params_device(params))
    with torch.no_grad():
        logits = forward_dense(params, config, ids)
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        chosen = torch.gather(lp, -1, ids[:, 1:, None].long())[..., 0]
    chosen = chosen.cpu().numpy()
    return [chosen[i, : len(p) - 1].tolist() for i, p in enumerate(prompts)]
