"""Sparse mixture-of-experts MLP (Mixtral, Qwen-MoE and GPT-OSS families).

Counterpart of `cxl_speckv_tpu/models/moe.py`, the whole module. Router
semantics follow `config.moe_style`:

- "mixtral" (HF `MixtralSparseMoeBlock`): softmax over ALL experts in
  float32, top-k, then renormalize the selected weights (`moe_norm_topk`;
  Qwen2-MoE keeps the raw probabilities);
- "gpt_oss" (HF `GptOssTopKRouter` / `GptOssExperts`): biased router
  logits, top-k on the LOGITS, softmax over the selected values; experts
  use biased projections and the clamped gated activation
  (u.clamp(-7, 7) + 1) * g * sigmoid(1.702 g) with g = min(g, 7).

Two compute modes, as in the JAX package:

- "dense" (the config default): every expert runs every token and the
  combine weights zero the unselected ones. At decode batch sizes every
  expert's weights are read anyway, so skipping work saves no bytes.
- "dispatch": GShard capacity bucketing with one-hot dispatch products;
  each expert takes at most C = ceil(N * k * cf / E) tokens (at least 1, at
  most N) in arrival order, and a token past an expert's capacity loses
  that expert's share of the output.

The expert products go through `ops.wquant.qeinsum`: one batched launch
of the fused int8 matmul (`ops/w8a16_mm.py`) at W8A16, of the fused int4
one (`ops/w4a16_mm.py`) at W4A16, over an expert stack [E, in, out]; the
dense mode's one x expanded over the experts is read in place by the int8
kernel. The JAX package computes them outside any Pallas kernel.

On a mesh (`parallel/sharding.py`) a rank holds E/ep experts, each with its
tp slice of the FFN, and the shared expert's tp slice. The router is whole,
so every rank routes every token; a rank combines its own experts' weighted
partial outputs and one all-reduce over ep x tp sums them. The terms that
must enter the sum once are added by one rank: GPT-OSS's down_bias by the
tp index 0 of the expert's owner, the shared expert by ep index 0.
"""

from __future__ import annotations

import torch

from cxl_speckv_tpu_torch.models.configs import LlamaConfig
from cxl_speckv_tpu_torch.ops.wquant import mm, qeinsum

_GPT_OSS_ALPHA = 1.702
_GPT_OSS_LIMIT = 7.0


def router_combine_weights(x2d: torch.Tensor, router_w: torch.Tensor,
                           top_k: int, router_b: torch.Tensor | None = None,
                           style: str = "mixtral",
                           norm_topk: bool = True) -> torch.Tensor:
    """Per-token combine weights over all experts: x2d [N, H], router_w
    [H, E] -> [N, E] float32 with exactly `top_k` non-zero entries a row."""
    logits = x2d.float() @ router_w.float()                       # [N, E]
    if router_b is not None:
        logits = logits + router_b.float()
    if style == "gpt_oss":
        vals, idx = torch.topk(logits, top_k, dim=-1)
        vals = torch.softmax(vals, dim=-1)
    else:
        vals, idx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
        if norm_topk:
            vals = vals / vals.sum(dim=-1, keepdim=True)
    return torch.zeros_like(logits).scatter(-1, idx, vals)


def _shared_expert(x2d: torch.Tensor, lp) -> torch.Tensor:
    """Qwen2-MoE shared expert: a dense SwiGLU on every token, scaled by
    sigmoid(x @ shared_expert_gate); zero without shared-expert leaves."""
    if "shared_gate" not in lp:
        return torch.zeros_like(x2d)
    h = (torch.nn.functional.silu(mm(x2d, lp["shared_gate"]))
         * mm(x2d, lp["shared_up"]))
    out = mm(h, lp["shared_down"])
    scale = torch.sigmoid((x2d.float() @ lp["shared_expert_gate"].float())
                          [:, None])
    return out * scale.to(out.dtype)


def _expert_ffn(xe: torch.Tensor, lp, style: str,
                down_bias: bool = True) -> torch.Tensor:
    """Gated MLP batched over experts: xe [E, C, H] -> [E, C, H]. The
    GPT-OSS biases are added in the activation dtype before the clamp;
    `down_bias` False leaves the last one out (a tp rank other than 0)."""
    g = qeinsum("ech,ehi->eci", xe, lp["gate"])
    u = qeinsum("ech,ehi->eci", xe, lp["up"])
    if style == "gpt_oss":
        g = torch.clamp(g + lp["gate_bias"][:, None, :], max=_GPT_OSS_LIMIT)
        u = torch.clamp(u + lp["up_bias"][:, None, :], -_GPT_OSS_LIMIT,
                        _GPT_OSS_LIMIT)
        h = (u + 1.0) * (g * torch.sigmoid(g * _GPT_OSS_ALPHA))
        y = qeinsum("eci,eih->ech", h, lp["down"])
        return y + lp["down_bias"][:, None, :] if down_bias else y
    return qeinsum("eci,eih->ech", torch.nn.functional.silu(g) * u,
                   lp["down"])


def moe_ffn(x2d: torch.Tensor, lp, config: LlamaConfig,
            mesh=None) -> torch.Tensor:
    """Sparse-MoE MLP over a flat token batch x2d [N, H]; lp holds router
    [H, E], gate / up [E, H, I], down [E, I, H] (+ the GPT-OSS biases), or
    on a `mesh` this rank's experts and FFN slices (module docstring).
    Returns [N, H] in x2d's dtype."""
    c = config
    El = lp["gate"].shape[0]
    N, H = x2d.shape
    cw = router_combine_weights(x2d, lp["router"], c.num_experts_per_tok,
                                lp.get("router_bias"), c.moe_style,
                                c.moe_norm_topk)
    E = cw.shape[1]
    e0 = mesh.coords["ep"] * El if mesh is not None else 0
    bias = mesh is None or mesh.coords["tp"] == 0
    shared = (_shared_expert(x2d, lp)
              if mesh is None or mesh.coords["ep"] == 0
              else torch.zeros_like(x2d))

    def total(out):
        if mesh is not None:
            out = mesh.all_reduce(out + shared, ("ep", "tp"))
            return out.to(x2d.dtype)
        return (out + shared).to(x2d.dtype)

    if c.moe_impl == "dense":
        ye = _expert_ffn(x2d[None].expand(El, N, H), lp, c.moe_style, bias)
        out = torch.einsum("ne,enh->nh", cw[:, e0:e0 + El].to(ye.dtype), ye)
        return total(out)
    if c.moe_impl != "dispatch":
        raise ValueError(f"unknown moe_impl {c.moe_impl!r}")

    # capacity per expert; cf >= E / k means no token can drop
    cap = int(-(-N * c.num_experts_per_tok * c.moe_capacity_factor // E))
    cap = max(1, min(cap, N))
    selected = cw > 0                                             # [N, E]
    # arrival-order position of each (token, expert) pair in e's bucket
    pos = torch.cumsum(selected.int(), dim=0) - 1
    pos = torch.where(selected & (pos < cap), pos, torch.full_like(pos, cap))
    # one-hot over cap + 1 columns, the last (a drop) cut off
    disp = torch.nn.functional.one_hot(pos.long(), cap + 1)[..., :cap]
    disp = disp[:, e0:e0 + El].to(x2d.dtype)                      # [N, E, C]
    xe = torch.einsum("nec,nh->ech", disp, x2d)                   # [E, C, H]
    ye = _expert_ffn(xe, lp, c.moe_style, bias)
    comb = disp.float() * cw[:, e0:e0 + El, None]                 # [N, E, C]
    out = torch.einsum("nec,ech->nh", comb.to(ye.dtype), ye)
    return total(out)
