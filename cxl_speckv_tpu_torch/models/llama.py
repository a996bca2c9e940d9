"""Llama-family model in PyTorch over the paged quantized KV cache.

Counterpart of `cxl_speckv_tpu/models/llama.py`, main-path subset: the
parameter tree and its random init (plain and quantize-at-init), the
building blocks, `decode_step` / `decode_multi` / `decode_multi_packed`
(fused multi-step decode with sampling on the device, optionally returning
each step's logits and raw logprobs, with the sampling-penalty plane), the
batched chunked prefill `prefill_batch_packed` (also the first token's
logprobs, per-position prompt scores and the penalty hooks),
the single-sequence `prefill_chunk`, the speculative verify pass
`verify_step`, the host-streamed lanes (`stream_step`,
`stream_step_batched`, `stream_decode_multi_batched`: context read from the
host tier through `ops/stream_attention.py`, no kernel), and
`forward_dense`. Families: Llama,
Mistral (uniform sliding window), Gemma-2 (alternating sliding / global
layers, tanh softcaps, GeGLU, sandwich norms, 1 + w RMSNorm, scaled
embeddings, tied head) and GPT-OSS (learned attention sinks, q/k/v and o
biases, YaRN rope, the clamped-activation MoE MLP of `models/moe.py`, on
alternating sliding / global layers); the MoE MLP and the q/k/v bias also
serve Mixtral / Qwen-MoE and Qwen2 trees.

Parameters are a plain dict with the JAX package's tree layout (layer
weights stacked on a leading [L] axis). PyTorch runs eagerly, so the layer
scan and the horizon loop are Python loops, and the pools are updated IN
PLACE (the JAX functions return new pools). Numerics follow the HF
conventions as the JAX package does: rotate-half RoPE, Llama-3 banded or
YaRN rope scaling, RMSNorm in float32. Each layer passes its own window
(`config.layer_windows()[li]`) and the attention softcap to the kernels:
the layer loop is Python, so the JAX package's period-grouped scan has no
counterpart here.

Attention goes through the kernel wrappers `ops.paged_attention.
paged_attention` (K1, decode) and `ops.chunk_attention_cuda.
paged_chunk_attention_cuda` (K2, prefill and verify): the CUDA kernels for
tensors on the card, their plain versions for tensors on the CPU.

`kv_dtype` is one scheme for every layer, or a tuple of per-layer schemes
(INT8 / FP8, `CacheConfig.layer_kv_dtypes`): layer li then quantizes with
its own scheme and attends as MIXED8 with its scheme id
(`layer_kv_schemes`).

Model features outside this slice (qk-norm, linear / per-layer rope,
activations other than SiLU and tanh-GELU) raise NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.models import moe
from cxl_speckv_tpu_torch.models.configs import LlamaConfig
from cxl_speckv_tpu_torch.ops import wquant
from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
    paged_chunk_attention_cuda,
)
from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention
from cxl_speckv_tpu_torch.ops.paged_attention_ref import sink_softmax, soft_cap
from cxl_speckv_tpu_torch.ops.quant import (
    dequantize_kv,
    encode_for_pool,
    quantize_kv,
    scheme_id_table,
)
from cxl_speckv_tpu_torch.ops.stream_attention import (
    merge_chunk_causal,
    stream_context_attention,
    stream_context_attention_slab,
)
from cxl_speckv_tpu_torch.ops.wquant import (
    QuantizedTensor,
    mm,
    quantize_tensor,
    take_rows,
)
from cxl_speckv_tpu_torch.runtime.hoststore import (
    fetch_blocks,
    stage_layers,
    stash_blocks,
)

Params = dict[str, Any]
Pools = tuple  # (k_pools, v_pools, k_scales, v_scales), [L, S + 1, ...]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(config: LlamaConfig) -> None:
    """Raise NotImplementedError for a config feature outside this slice."""
    c = config
    unported = {
        "qk_norm": c.qk_norm,
        "act_fn": c.act_fn not in ("silu", "gelu_tanh"),
        "rope_linear_factor": c.rope_linear_factor is not None,
        "rope_local_theta": c.rope_local_theta is not None,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"model features not ported to PyTorch yet: {', '.join(bad)}")


def layer_kv_schemes(kv_dtype, num_layers: int) -> list[tuple]:
    """Per layer: (the scheme its KV is quantized with, the kv_dtype its
    attention reads, the scheme id). A per-layer tuple of INT8 / FP8
    attends as MIXED8 with each layer's id, as the JAX package's layer scan
    does with a traced id; a uniform scheme is the same in every layer."""
    sids = scheme_id_table(kv_dtype)
    if sids is None:
        if kv_dtype == KVDtype.MIXED8:
            raise ValueError("MIXED8 is internal: pass a tuple of per-layer "
                             "schemes")
        return [(kv_dtype, kv_dtype, None)] * num_layers
    if len(kv_dtype) != num_layers or any(
            d not in (KVDtype.INT8, KVDtype.FP8) for d in kv_dtype):
        raise ValueError(f"a per-layer scheme tuple needs {num_layers} "
                         f"entries of INT8 or FP8, got {kv_dtype}")
    return [(d, KVDtype.MIXED8, sid) for d, sid in zip(kv_dtype, sids)]


# ---------------------------------------------------------------------------
# parameter init / structure
# ---------------------------------------------------------------------------

def _normal(shape, fan_in, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32) * fan_in ** -0.5


def init_params(config: LlamaConfig, generator: torch.Generator,
                device="cpu", dtype: torch.dtype | None = None) -> Params:
    """Random-init parameters with the JAX package's tree layout:

    embed [V, H]; layers: attn_norm [L, H], q [L, H, Hq*D], k/v [L, H, Hkv*D],
    o [L, Hq*D, H], mlp_norm [L, H], gate/up [L, H, I], down [L, I, H];
    final_norm [H]; lm_head [H, V] (absent when tie_embeddings); with
    `post_norms` (Gemma-2) also post_attn_norm / post_mlp_norm [L, H]; the
    MoE, bias and sink leaves of `_extra_leaves`. Weights are N(0, 1/fan_in)
    draws from `generator` (a different stream from JAX's: carry JAX
    weights with `convert.params_from_jax`)."""
    c = config
    check_supported(c)
    dtype = dtype or torch_dtype(c.dtype)
    L, H, V = c.num_layers, c.hidden_size, c.vocab_size
    qd, kvd = c.num_q_heads * c.head_dim, c.num_kv_heads * c.head_dim

    def w(shape, fan_in):
        return _normal(shape, fan_in, generator, device).to(dtype)

    params: Params = {
        "embed": w((V, H), H),
        "layers": {
            "attn_norm": torch.ones((L, H), dtype=dtype, device=device),
            "q": w((L, H, qd), H), "k": w((L, H, kvd), H),
            "v": w((L, H, kvd), H), "o": w((L, qd, H), qd),
            "mlp_norm": torch.ones((L, H), dtype=dtype, device=device),
        },
        "final_norm": torch.ones((H,), dtype=dtype, device=device),
    }
    for name, (shape, fan_in) in _mlp_shapes(c).items():
        params["layers"][name] = w((L, *shape), fan_in)
    params["layers"].update(_extra_leaves(c, generator, device, dtype))
    if not c.tie_embeddings:
        params["lm_head"] = w((H, V), H)
    return params


def _mlp_shapes(config: LlamaConfig) -> dict:
    """{name: (per-layer shape, fan_in)} of the MLP matmul weights: the
    dense gate / up / down, or with experts [E, ...] stacks of them, the
    Qwen2-MoE shared expert's and the router [H, E] (which stays in full
    precision under W8A16)."""
    c = config
    H, I = c.hidden_size, c.intermediate_size
    if c.num_experts == 0:
        return {"gate": ((H, I), H), "up": ((H, I), H), "down": ((I, H), I)}
    E, Is = c.num_experts, c.moe_shared_expert
    shapes = {"router": ((H, E), H), "gate": ((E, H, I), H),
              "up": ((E, H, I), H), "down": ((E, I, H), I)}
    if Is > 0:
        shapes.update({"shared_gate": ((H, Is), H), "shared_up": ((H, Is), H),
                       "shared_down": ((Is, H), Is),
                       "shared_expert_gate": ((H,), H)})
    return shapes


def _extra_leaves(config: LlamaConfig, generator, device, dtype) -> dict:
    """The layer leaves beyond the Llama set, [L, ...] in the activation
    dtype, drawn with the JAX init's scales so every path is exercised:
    GPT-OSS router / expert biases N(0, 0.05^2); q/k/v biases and o_bias
    N(0, 0.02^2); sinks N(0, 0.5^2); Gemma-2 sandwich norms N(0, 0.05^2)."""
    c = config
    L, H, I, E = c.num_layers, c.hidden_size, c.intermediate_size, c.num_experts
    qd, kvd = c.num_q_heads * c.head_dim, c.num_kv_heads * c.head_dim
    spec = {}
    if E > 0 and c.moe_style == "gpt_oss":
        spec.update({"router_bias": ((E,), 0.05), "gate_bias": ((E, I), 0.05),
                     "up_bias": ((E, I), 0.05), "down_bias": ((E, H), 0.05)})
    if c.attn_bias:
        spec.update({"q_bias": ((qd,), 0.02), "k_bias": ((kvd,), 0.02),
                     "v_bias": ((kvd,), 0.02)})
    if c.attn_sinks:
        spec["sinks"] = ((c.num_q_heads,), 0.5)
    if c.o_bias:
        spec["o_bias"] = ((H,), 0.02)
    if c.post_norms:
        spec.update({"post_attn_norm": ((H,), 0.05),
                     "post_mlp_norm": ((H,), 0.05)})
    return {name: (torch.randn((L, *shape), generator=generator, device=device)
                   * scale).to(dtype)
            for name, (shape, scale) in spec.items()}


def init_params_quantized(config: LlamaConfig, generator: torch.Generator,
                          device="cpu") -> Params:
    """Random-init straight into W8A16 storage, one matrix at a time: each
    layer's (and, with experts, each expert's) matrix is drawn in float32
    and quantized before the next is drawn, so the full-precision tree
    never exists (Llama-3-8B: ~8 GB of int8 instead of 16 GB of bf16 plus a
    quantized copy; GPT-OSS-20B: one stacked expert leaf alone would need
    ~25 GB of float32). Same tree layout as `init_params` followed by
    `quantize_weights`; the MoE router, biases and sinks stay in the
    activation dtype."""
    c = config
    check_supported(c)
    dtype = torch_dtype(c.dtype)
    L, H, V = c.num_layers, c.hidden_size, c.vocab_size
    qd, kvd = c.num_q_heads * c.head_dim, c.num_kv_heads * c.head_dim
    shapes = {"q": ((H, qd), H), "k": ((H, kvd), H), "v": ((H, kvd), H),
              "o": ((qd, H), qd), **_mlp_shapes(c)}
    layers = {}
    for name, (shape, fan_in) in shapes.items():
        if name not in wquant.LAYER_MM_KEYS:
            layers[name] = _normal((L, *shape), fan_in, generator,
                                   device).to(dtype)
            continue
        q = torch.empty((L, *shape), dtype=torch.int8, device=device)
        s = torch.empty((L, *shape[:-2], 1, shape[-1]), dtype=torch.float32,
                        device=device)
        for idx in np.ndindex(L, *shape[:-2]):        # (layer[, expert])
            qt = quantize_tensor(_normal(shape[-2:], fan_in, generator,
                                         device))
            q[idx], s[idx] = qt.q, qt.s
        layers[name] = QuantizedTensor(q, s, -2)
    layers["attn_norm"] = torch.ones((L, H), dtype=dtype, device=device)
    layers["mlp_norm"] = torch.ones((L, H), dtype=dtype, device=device)
    layers.update(_extra_leaves(c, generator, device, dtype))
    params: Params = {
        "embed": quantize_tensor(_normal((V, H), H, generator, device),
                                 axis=-1),
        "layers": layers,
        "final_norm": torch.ones((H,), dtype=dtype, device=device),
    }
    if not c.tie_embeddings:
        params["lm_head"] = quantize_tensor(
            _normal((H, V), H, generator, device))
    return params


def layer_params(params: Params, li: int) -> dict:
    """Layer `li`'s slice of the stacked layer weights (views)."""
    return {k: v[li] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm; offset=1.0 gives the Gemma convention (multiply by 1 + w)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * (weight + offset) if offset else normed * weight


def _norm(x: torch.Tensor, weight: torch.Tensor,
          config: LlamaConfig) -> torch.Tensor:
    return rms_norm(x, weight, config.rms_eps,
                    1.0 if config.norm_offset else 0.0)


def _embed(params: Params, config: LlamaConfig,
           token_ids: torch.Tensor) -> torch.Tensor:
    x = take_rows(params["embed"], token_ids,
                  dtype=torch_dtype(config.dtype))
    if config.embed_scale:
        # sqrt(H) rounded to the activation dtype first, as JAX and HF do
        # (bf16: sqrt(3584) = 59.87 becomes 59.75)
        x = x * torch.tensor(config.hidden_size ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _final_logits(x: torch.Tensor, params: Params,
                  config: LlamaConfig) -> torch.Tensor:
    head = params["embed"].T if config.tie_embeddings else params["lm_head"]
    return soft_cap(mm(x, head).float(), config.final_softcap)


def rope_frequencies(config: LlamaConfig) -> torch.Tensor:
    """Inverse frequencies [D/2] float32, with Llama-3 banded or YaRN
    scaling (HF-compatible). YaRN's cos/sin attention factor is folded into
    `config.sm_scale`."""
    c = config
    inv = 1.0 / (c.rope_theta ** (torch.arange(0, c.head_dim, 2,
                                               dtype=torch.float32)
                                  / c.head_dim))
    if c.rope_yarn is not None:
        # HF _compute_yarn_parameters: a linear ramp between the beta_fast
        # and beta_slow correction dims blends the factor-scaled and the
        # unscaled frequencies
        y, D = c.rope_yarn, c.head_dim

        def corr_dim(rot):
            return (D * math.log(y.original_max_position
                                 / (rot * 2 * math.pi))
                    / (2 * math.log(c.rope_theta)))

        low, high = corr_dim(y.beta_fast), corr_dim(y.beta_slow)
        if y.truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, D - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp((torch.arange(D // 2, dtype=torch.float32) - low)
                           / (high - low), 0, 1)
        extrap = 1.0 - ramp       # 1 at the low (high-frequency) dims
        return (inv / y.factor) * (1 - extrap) + inv * extrap
    if c.rope_scaling is not None:
        s = c.rope_scaling
        wavelen = 2.0 * math.pi / inv
        low_wl = s.original_max_position / s.low_freq_factor
        high_wl = s.original_max_position / s.high_freq_factor
        smooth = (s.original_max_position / wavelen - s.low_freq_factor) / (
            s.high_freq_factor - s.low_freq_factor)
        inv = torch.where(
            wavelen > low_wl, inv / s.factor,
            torch.where(wavelen < high_wl, inv,
                        (1 - smooth) * inv / s.factor + smooth * inv))
    return inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE, HF convention. x [..., T, heads, D], positions
    [..., T]."""
    angles = positions[..., None].float() * inv_freq    # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]                # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(config: LlamaConfig):
    if config.act_fn == "gelu_tanh":           # Gemma GeGLU
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    return torch.nn.functional.silu


def _mlp(x, gate, up, down, act=torch.nn.functional.silu):
    return mm(act(mm(x, gate)) * mm(x, up), down)


def _ffn(x, lp, config):
    """The dense gated MLP, or the sparse-MoE block over the flattened
    tokens when the layer has a router."""
    if "router" not in lp:
        return _mlp(x, lp["gate"], lp["up"], lp["down"], _act(config))
    return moe.moe_ffn(x.reshape(-1, x.shape[-1]), lp, config).reshape(
        x.shape)


def _qkv(h, lp, config: LlamaConfig = None):
    """q, k, v projections, plus the q/k/v biases (Qwen2, GPT-OSS) before
    RoPE."""
    q, k, v = mm(h, lp["q"]), mm(h, lp["k"]), mm(h, lp["v"])
    if "q_bias" in lp:
        q, k, v = q + lp["q_bias"], k + lp["k_bias"], v + lp["v_bias"]
    return q, k, v


def _block_residuals(x, o_flat, lp, config):
    """o-projection (+ its bias, + Gemma-2 post-attention norm) + residual,
    then the MLP block (+ post-MLP norm) + residual."""
    att = mm(o_flat.to(x.dtype), lp["o"])
    if "o_bias" in lp:
        att = att + lp["o_bias"]
    if "post_attn_norm" in lp:
        att = _norm(att, lp["post_attn_norm"], config)
    x = x + att
    mlp = _ffn(_norm(x, lp["mlp_norm"], config), lp, config)
    if "post_mlp_norm" in lp:
        mlp = _norm(mlp, lp["post_mlp_norm"], config)
    return x + mlp


def _attend_fns(config: LlamaConfig):
    """(decode_attend, chunk_attend) with the config's compute dtype and
    attention softcap; callers pass each layer's window."""
    cd = torch_dtype(config.attn_compute_dtype)
    cap = config.attn_softcap

    def decode(*args, **kw):
        return paged_attention(*args, compute_dtype=cd, softcap=cap, **kw)

    def chunk(*args, **kw):
        return paged_chunk_attention_cuda(*args, compute_dtype=cd,
                                          softcap=cap, **kw)

    return decode, chunk


def _append_kv(pools: Pools, li: int, kenc, venc, ks, vs, slots, offs):
    """Write quantized rows into layer `li` of the pools at (slot, head,
    offset) — plain indexed writes in the token-major layout. slots/offs
    carry kenc's leading dims ([B] decode, [B, T] prefill)."""
    k_pools, v_pools, k_scales, v_scales = pools
    k_pools[li][slots, :, offs] = kenc.to(k_pools.dtype)
    v_pools[li][slots, :, offs] = venc.to(v_pools.dtype)
    k_scales[li][slots, :, offs] = ks[..., 0]
    v_scales[li][slots, :, offs] = vs[..., 0]


# ---------------------------------------------------------------------------
# decode (paged attention over the pools)
# ---------------------------------------------------------------------------

def _decode_core(params: Params, config: LlamaConfig, schemes: list,
                 token_ids: torch.Tensor, positions: torch.Tensor,
                 pools: Pools, block_table: torch.Tensor,
                 seq_lens: torch.Tensor) -> torch.Tensor:
    """One decode step: append each lane's token KV at `positions`, attend
    over the pool including it; returns logits [B, V] float32. `schemes`
    comes from `layer_kv_schemes`."""
    c = config
    B = token_ids.shape[0]
    bs = pools[1].shape[3]
    inv_freq = rope_frequencies(c).to(token_ids.device)
    x = _embed(params, c, token_ids)                      # [B, H]
    # clamped: overshoot steps past a finished lane stay inside the table
    blk = torch.clamp(positions // bs, 0, block_table.shape[1] - 1)
    slots = torch.gather(block_table, 1, blk[:, None].long())[:, 0].long()
    offs = (positions % bs).long()
    attend, _ = _attend_fns(c)
    windows = c.layer_windows()
    for li in range(c.num_layers):
        lp = layer_params(params, li)
        h = _norm(x, lp["attn_norm"], c)
        q, k, v = _qkv(h, lp, c)
        q = apply_rope(q.reshape(B, c.num_q_heads, c.head_dim), positions,
                       inv_freq)
        k = apply_rope(k.reshape(B, c.num_kv_heads, c.head_dim), positions,
                       inv_freq)
        v = v.reshape(B, c.num_kv_heads, c.head_dim)
        scheme, read_as, sid = schemes[li]
        kq, ks = quantize_kv(k, scheme)
        vq, vs = quantize_kv(v, scheme)
        _append_kv(pools, li, encode_for_pool(kq, scheme),
                   encode_for_pool(vq, scheme), ks, vs, slots, offs)
        o = attend(q, pools[0][li], pools[1][li], pools[2][li], pools[3][li],
                   block_table, seq_lens, read_as, sm_scale=c.sm_scale,
                   window=windows[li], sinks=lp.get("sinks"), scheme_id=sid)
        x = _block_residuals(x, o.reshape(B, -1), lp, c)
    x = _norm(x, params["final_norm"], c)
    return _final_logits(x, params, c)


def decode_step(params: Params, config: LlamaConfig, kv_dtype,
                token_ids: torch.Tensor, positions: torch.Tensor,
                pools: Pools, block_table: torch.Tensor,
                seq_lens: torch.Tensor) -> torch.Tensor:
    """One decode step for a batch; the pools update in place. Returns
    logits [B, V]. `kv_dtype`: a scheme, or a tuple of per-layer schemes."""
    return _decode_core(params, config,
                        layer_kv_schemes(kv_dtype, config.num_layers),
                        token_ids, positions, pools, block_table, seq_lens)


def _token_logprobs(logits: torch.Tensor, toks: torch.Tensor, k: int):
    """Raw-distribution logprobs: the chosen token's plus the top-k
    alternatives (ids, logprobs), ordered as `lax.top_k` orders them:
    equal values keep the lower id first, so a greedy token (the first
    maximum, as `argmax` takes it) is the top-1 id even at an exact tie."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(lp, -1, toks[..., None].long())[..., 0]
    tv, ti = torch.topk(lp, k, dim=-1)
    ti, order = torch.sort(ti, dim=-1, stable=True)
    tv, order2 = torch.sort(torch.gather(tv, -1, order), dim=-1,
                            descending=True, stable=True)
    return chosen, torch.gather(ti, -1, order2).to(torch.int32), tv


def decode_multi(params: Params, config: LlamaConfig, kv_dtype,
                 first_tokens: torch.Tensor, start_positions: torch.Tensor,
                 pools: Pools, block_table: torch.Tensor,
                 generator: torch.Generator | None,
                 temperatures: torch.Tensor, top_ps: torch.Tensor | None,
                 pen_info: torch.Tensor | None = None,
                 pen_counts: torch.Tensor | None = None,
                 lstm_params: dict | None = None,
                 lstm_hist: torch.Tensor | None = None,
                 *, horizon: int, sampled: bool = False,
                 nucleus: bool = False, return_logits: bool = False,
                 logprobs_k: int = 0, lstm_eos: int = -1):
    """`horizon` decode steps with sampling on the device: step j feeds the
    token sampled at step j - 1. Callers pre-extend sequences so the table
    covers start .. start + horizon - 1. `sampled` / `nucleus` say whether
    any lane samples (temperature > 0) or uses top-p; when neither, the
    steps are pure argmax and never synchronize with the host. The pools
    update in place.

    Returns tokens [B, horizon] int32 on the device, or a tuple of it and,
    in this order: with `logprobs_k`, the chosen tokens' logprobs
    [B, horizon] and the top-k ids / logprobs [B, horizon, k] of the raw
    distribution (`_token_logprobs`: before temperature, top-p and
    penalties); with `return_logits`, each step's logits [B, horizon, V]
    float32, the proposal distributions that speculative sampling's
    acceptance rule needs (`engine/spec.py`).

    With `pen_info` [B, 5] / `pen_counts` (`engine/sampling.py`), every step
    penalizes before sampling and counts each sampled token into its
    lane's row of the plane, in place.

    With `lstm_params` (the prefetch predictor's tree on this device) and
    `lstm_hist` [B, T] (each lane's bucketed history before the round), the
    round ends with the predictor's continue probability [B] float32 of
    each lane on its post-round history: the pre-round history shifted by
    the round's h tokens, then 1 - p(class `lstm_eos`)
    (`prefetcher.lstm.lstm_pcont`). It comes last in the returned tuple,
    so that it rides home in the round's one copy."""
    from cxl_speckv_tpu_torch.engine.sampling import (
        penalize_and_count,
        sample_tokens,
    )

    schemes = layer_kv_schemes(kv_dtype, config.num_layers)
    toks = first_tokens
    out, lps, step_logits = [], [], []
    sample = lambda lg: sample_tokens(lg, temperatures, generator,
                                      top_ps=top_ps if nucleus else None,
                                      sampled=sampled)
    for j in range(horizon):
        positions = start_positions + j
        logits = _decode_core(params, config, schemes, toks, positions,
                              pools, block_table, positions + 1)
        if pen_counts is not None:
            toks, _ = penalize_and_count(logits, pen_info, pen_counts, sample)
        else:
            toks = sample(logits)
        toks = toks.to(torch.int32)
        out.append(toks)
        if logprobs_k:
            lps.append(_token_logprobs(logits, toks, logprobs_k))
        if return_logits:
            step_logits.append(logits)
    extra = [torch.stack(y, dim=1) for y in zip(*lps)]
    if return_logits:
        extra.append(torch.stack(step_logits, dim=1))
    toks = torch.stack(out, dim=1)
    if lstm_params is not None:
        from cxl_speckv_tpu_torch.prefetcher.lstm import lstm_pcont

        extra.append(lstm_pcont(lstm_params, lstm_hist, toks, lstm_eos))
    return (toks, *extra) if extra else toks


def seeded_generator(device, rng_seed: int, counter: int) -> torch.Generator:
    """The generator of one dispatch's draws, seeded from (rng_seed,
    counter) as the JAX package derives its key."""
    g = torch.Generator(device=device)
    g.manual_seed((rng_seed << 32) + counter)
    return g


def _upload(packed: np.ndarray, pen_info, dev) -> torch.Tensor:
    """The dispatch's int32 inputs in ONE host -> device copy: `packed`,
    then the pen_info columns when given."""
    packed = np.asarray(packed, np.int32)
    if pen_info is not None:
        packed = np.concatenate([packed, np.asarray(pen_info, np.int32)], 1)
    return torch.from_numpy(packed).to(dev)


def decode_multi_packed(params: Params, config: LlamaConfig,
                        kv_dtype, packed: np.ndarray, pools: Pools,
                        pen_info: np.ndarray | None = None,
                        pen_counts: torch.Tensor | None = None,
                        lstm_params: dict | None = None,
                        *, horizon: int, rng_seed: int = 0,
                        return_logits: bool = False, logprobs_k: int = 0,
                        lstm_eos: int = -1, lstm_cols: int = 0):
    """`decode_multi` with every per-round host input in ONE int32 array
    (one host->device copy per round; pen_info [B, 5] rides the same copy):

        packed [B, max_blocks + 4 + lstm_cols]: col 0 = first token, 1 = its
        position, 2 = sampling word (`engine.sampling.encode_sampling`),
        3 = rng counter, then the block-table row (guard-filled), then with
        `lstm_params` the last `lstm_cols` columns: each lane's bucketed
        history for the round's continue-probability leg.

    Returns what `decode_multi` returns."""
    from cxl_speckv_tpu_torch.engine.sampling import decode_sampling

    packed = np.asarray(packed, np.int32)
    dev = pools[0].device
    temps_h, top_ps_h = decode_sampling(torch.from_numpy(packed[:, 2]))
    sampled = bool((temps_h > 0).any())
    nucleus = sampled and bool(((top_ps_h > 0) & (top_ps_h < 1)
                                & (temps_h > 0)).any())
    w = packed.shape[1]
    p = _upload(packed, pen_info if pen_counts is not None else None, dev)
    gen = (seeded_generator(dev, rng_seed, int(packed[0, 3])) if sampled
           else None)
    tw = w - lstm_cols               # end of the block table
    return decode_multi(params, config, kv_dtype, p[:, 0], p[:, 1], pools,
                        p[:, 4:tw], gen, temps_h.to(dev), top_ps_h.to(dev),
                        p[:, w:] if pen_counts is not None else None,
                        pen_counts, lstm_params,
                        p[:, tw:w] if lstm_params is not None else None,
                        horizon=horizon, sampled=sampled,
                        nucleus=nucleus, return_logits=return_logits,
                        logprobs_k=logprobs_k, lstm_eos=lstm_eos)


def decode_round_fused(params: Params, config: LlamaConfig, kv_dtype,
                       packed: np.ndarray, mig: np.ndarray, pools: Pools,
                       store, pen_info: np.ndarray | None = None,
                       pen_counts: torch.Tensor | None = None, *,
                       horizon: int, rng_seed: int = 0, logprobs_k: int = 0):
    """One engine decode round with its migration batch (`mig`, [4, M]
    int32, `runtime.hoststore.pad_migration`): the batch's copies on the
    round's own stream, then `decode_multi_packed` over the updated pools,
    as the JAX `decode_round_fused` runs `migrate_in_graph` and the decode
    in one program. Pools and the host store update in place; returns what
    `decode_multi_packed` returns."""
    from cxl_speckv_tpu_torch.runtime.hoststore import apply_batch

    apply_batch(pools, store, mig)
    return decode_multi_packed(params, config, kv_dtype, packed, pools,
                               pen_info, pen_counts, horizon=horizon,
                               rng_seed=rng_seed, logprobs_k=logprobs_k)


# ---------------------------------------------------------------------------
# chunks of fresh tokens: batched prefill, single-sequence prefill, verify
# ---------------------------------------------------------------------------

def _chunk_forward(params: Params, config: LlamaConfig, kv_dtype,
                   token_ids: torch.Tensor, start: torch.Tensor, pools: Pools,
                   tables: torch.Tensor, write: torch.Tensor) -> torch.Tensor:
    """T fresh tokens a lane [B, T] at start [B] .. start + T - 1, causal
    within the chunk + that lane's quantized pool context (positions <
    start) through K2; returns the final hidden states [B, T, H] (before
    the final norm). The chunk's K/V enter attention as quantize ->
    dequantized values, exactly what a later decode step reads from the
    pool (fresh float32 K/V would disagree with the quantized view near
    ties), and are appended to the pools in place after attention;
    positions where `write` [B, T] is False write the guard slot."""
    c = config
    schemes = layer_kv_schemes(kv_dtype, c.num_layers)
    dev = token_ids.device
    B, T = token_ids.shape
    bs = pools[1].shape[3]
    guard_slot = pools[0].shape[1] - 1
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]  # [B, T]
    blk = torch.clamp(positions // bs, 0, tables.shape[1] - 1)
    slots = torch.gather(tables, 1, blk.long()).long()
    slots = torch.where(write, slots, torch.full_like(slots, guard_slot))
    offs = (positions % bs).long()
    inv_freq = rope_frequencies(c).to(dev)
    x = _embed(params, c, token_ids)                         # [B, T, H]
    _, attend_chunk = _attend_fns(c)
    windows = c.layer_windows()
    for li in range(c.num_layers):
        lp = layer_params(params, li)
        h = _norm(x, lp["attn_norm"], c)
        q, k, v = _qkv(h, lp, c)
        q = apply_rope(q.reshape(B, T, c.num_q_heads, c.head_dim), positions,
                       inv_freq)
        k = apply_rope(k.reshape(B, T, c.num_kv_heads, c.head_dim),
                       positions, inv_freq)
        v = v.reshape(B, T, c.num_kv_heads, c.head_dim)
        scheme, read_as, sid = schemes[li]
        kq, ks = quantize_kv(k, scheme)
        vq, vs = quantize_kv(v, scheme)
        o = attend_chunk(q, dequantize_kv(kq, ks, scheme),
                         dequantize_kv(vq, vs, scheme), pools[0][li],
                         pools[1][li], pools[2][li], pools[3][li], tables,
                         start, read_as, sm_scale=c.sm_scale,
                         window=windows[li], sinks=lp.get("sinks"),
                         scheme_id=sid)
        x = _block_residuals(x, o.reshape(B, T, -1), lp, c)
        _append_kv(pools, li, encode_for_pool(kq, scheme),
                   encode_for_pool(vq, scheme), ks, vs, slots, offs)
    return x


def _prompt_scores(x: torch.Tensor, token_ids: torch.Tensor,
                   valid: torch.Tensor, lanes, params: Params,
                   config: LlamaConfig) -> torch.Tensor:
    """scores [B, T] float32: scores[b, t] = log p(token[b, t + 1] | ..t)
    for t < valid[b] - 1, 0 elsewhere and on lanes not in `lanes`. One
    lane's [T, V] logits at a time: all of them at once at B 8, T 64 and a
    128256-token vocabulary would take 263 MB."""
    B, T = token_ids.shape
    out = torch.zeros(B, T, dtype=torch.float32, device=x.device)
    targets = torch.roll(token_ids, -1, dims=1)            # target[t] = tok[t+1]
    for b in lanes:
        xs = _norm(x[b], params["final_norm"], config)     # [T, H]
        lp = torch.log_softmax(_final_logits(xs, params, config), dim=-1)
        out[b] = torch.gather(lp, -1, targets[b, :, None].long())[:, 0]
    t_idx = torch.arange(T, device=x.device)[None, :]
    return torch.where(t_idx < (valid - 1)[:, None], out,
                       torch.zeros_like(out))


def prefill_batch_packed(params: Params, config: LlamaConfig,
                         kv_dtype, packed: np.ndarray, pools: Pools,
                         pen_info: np.ndarray | None = None,
                         pen_counts: torch.Tensor | None = None,
                         *, max_blocks: int, rng_seed: int = 0,
                         logprobs_k: int = 0,
                         prompt_scores: np.ndarray | None = None):
    """Batched chunked prefill: every prefilling lane's chunk in one pass
    (`_chunk_forward`), each lane's next token sampled on the device.

        packed [B, 4 + max_blocks + T]: col 0 = start position, 1 = valid
        length (0 = inactive lane), 2 = sampling word, 3 = rng counter,
        4:4+max_blocks = table row (guard-filled), the rest = tokens.

    Positions past a lane's valid length write the guard slot. Returns
    tokens [B] int32 on the pools' device, or a tuple of it and, in this
    order: with `logprobs_k`, the sampled token's logprob [B] and the top-k
    ids / logprobs [B, k] (raw distribution, `_token_logprobs`); with
    `prompt_scores` ([B] bool: the lanes that asked), per-position scores
    [B, T] (`_prompt_scores`): the echo surface, whose chunk boundaries the
    engine covers by re-feeding one token a chunk.

    With `pen_info` [B, 5] / `pen_counts`, the penalty hooks run on the
    device, in place: rows flagged for reset zero, this chunk's prompt
    tokens set their presence bit, then the sampled token is penalized and
    (on the prompt-completing chunk only, flag bit 1) counted."""
    from cxl_speckv_tpu_torch.engine.sampling import (
        decode_sampling,
        pen_mark_prompt,
        pen_reset_rows,
        penalize_and_count,
        sample_tokens,
    )

    c = config
    packed = np.asarray(packed, np.int32)
    dev = pools[0].device
    B, w = packed.shape
    T = w - 4 - max_blocks
    temps_h, top_ps_h = decode_sampling(torch.from_numpy(packed[:, 2]))
    sampled = bool((temps_h > 0).any())
    nucleus = sampled and bool(((top_ps_h > 0) & (top_ps_h < 1)
                                & (temps_h > 0)).any())
    p = _upload(packed, pen_info if pen_counts is not None else None, dev)
    valid = p[:, 1]
    token_ids = p[:, 4 + max_blocks:w]
    write = torch.arange(T, device=dev)[None, :] < valid[:, None]
    x = _chunk_forward(params, c, kv_dtype, token_ids.long(), p[:, 0], pools,
                       p[:, 4:4 + max_blocks], write)
    # last valid hidden state per lane -> logits -> sampled token
    last = torch.clamp(valid - 1, 0, T - 1).long()
    x_last = x[torch.arange(B, device=dev), last]
    logits = _final_logits(_norm(x_last, params["final_norm"], c), params, c)
    gen = (seeded_generator(dev, rng_seed, int(packed[0, 3])) if sampled
           else None)
    sample = lambda lg: sample_tokens(lg, temps_h.to(dev), gen,
                                      top_ps=top_ps_h.to(dev) if nucleus
                                      else None, sampled=sampled)
    if pen_counts is not None:
        pen_info_d = p[:, w:]
        pen_reset_rows(pen_info_d, pen_counts)
        pen_mark_prompt(pen_info_d, pen_counts, token_ids, valid)
        toks, _ = penalize_and_count(logits, pen_info_d, pen_counts, sample)
    else:
        toks = sample(logits)
    toks = toks.to(torch.int32)
    extra = list(_token_logprobs(logits, toks, logprobs_k)) if logprobs_k else []
    if prompt_scores is not None:
        lanes = [b for b in range(B) if prompt_scores[b] and packed[b, 1] > 1]
        extra.append(_prompt_scores(x, token_ids, valid, lanes, params, c))
    return (toks, *extra) if extra else toks


def prefill_round_fused(params: Params, config: LlamaConfig, kv_dtype,
                        packed: np.ndarray, mig: np.ndarray, pools: Pools,
                        store, pen_info: np.ndarray | None = None,
                        pen_counts: torch.Tensor | None = None, *,
                        max_blocks: int, rng_seed: int = 0,
                        logprobs_k: int = 0,
                        prompt_scores: np.ndarray | None = None):
    """Batched chunked prefill with the round's migration batch applied
    first on the same stream (session restores and evictions ride the
    round), as the JAX `prefill_round_fused`. Returns what
    `prefill_batch_packed` returns."""
    from cxl_speckv_tpu_torch.runtime.hoststore import apply_batch

    apply_batch(pools, store, mig)
    return prefill_batch_packed(params, config, kv_dtype, packed, pools,
                                pen_info, pen_counts, max_blocks=max_blocks,
                                rng_seed=rng_seed, logprobs_k=logprobs_k,
                                prompt_scores=prompt_scores)


def prefill_chunk(params: Params, config: LlamaConfig, kv_dtype,
                  token_ids: torch.Tensor, start_pos: int, pools: Pools,
                  table_row: torch.Tensor,
                  valid_len: int | None = None) -> torch.Tensor:
    """Prefill one sequence's chunk token_ids [T] at start_pos (the pools
    update in place); the chunk may be right-padded past `valid_len`
    (default T): pad positions write the guard slot and, coming after the
    real tokens, are causally invisible to them. Returns the last valid
    token's logits [V] float32."""
    T = token_ids.shape[0]
    dev = token_ids.device
    valid = T if valid_len is None else int(valid_len)
    start = torch.tensor([int(start_pos)], dtype=torch.int32, device=dev)
    write = (torch.arange(T, device=dev) < valid)[None, :]
    x = _chunk_forward(params, config, kv_dtype, token_ids[None].long(),
                       start, pools, table_row[None], write)
    x_last = _norm(x[0, valid - 1], params["final_norm"], config)
    return _final_logits(x_last[None], params, config)[0]


def verify_step(params: Params, config: LlamaConfig, kv_dtype,
                token_ids: torch.Tensor, start_pos: torch.Tensor,
                pools: Pools, block_tables: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    """Target-model scoring of T tokens a lane in one pass, the
    speculative-decoding verification (the JAX package's `verify_impl`
    body and its jitted `verify_step` in one). token_ids [B, T] = the last
    accepted token, then the drafts; start_pos [B] the position of
    token_ids[:, 0]; inactive lanes (`active` [B] False) write the guard
    slot. Returns logits [B, T, V] float32: row t is the distribution for
    position start_pos + t + 1, the verdict on draft t + 1 (row T - 1
    gives the bonus token).

    KV of every fed token is appended at its position (in place); rows
    past the accepted prefix are never covered by the sequence length and
    the next round overwrites them: speculative KV needs no rollback."""
    B, T = token_ids.shape
    write = active.bool()[:, None].expand(B, T)
    x = _chunk_forward(params, config, kv_dtype, token_ids.long(),
                       start_pos.int(), pools, block_tables, write)
    return _final_logits(_norm(x, params["final_norm"], config), params,
                         config)


# ---------------------------------------------------------------------------
# host-streamed lanes: sequences whose KV lives in the host tier
# ---------------------------------------------------------------------------

def stream_decode_nblk(horizon: int, bs: int) -> int:
    """Touched-block count of `horizon` tokens starting at any in-block
    offset (worst case offset bs - 1): a fused streamed-decode span, and a
    streamed chunk's append run. For a chunk that is a multiple of bs, or
    of one token, it is the JAX packing's T // bs + 1; for another chunk
    that one can fall short of the chunk's last positions (their KV would
    be dropped), so the port packs this count instead."""
    return (horizon + bs - 2) // bs + 1


def _solve_chunk_len(rest: int, bs: int) -> int:
    """Invert rest = T + stream_decode_nblk(T, bs) for T."""
    for t in range(rest - 1, 0, -1):
        if t + stream_decode_nblk(t, bs) == rest:
            return t
    raise ValueError(f"no chunk length solves rest={rest} bs={bs}")


def _stream_append_rmw(fetched, chunks, offs_in: int, valid: int, *,
                       kv_dtype, nblk: int, bs: int, skip: int = 0):
    """Insert a lane's fresh chunk KV into its fetched touched-block slabs,
    in place (the read-modify-write half of the streamed append).
    `fetched` is (fk, fv, fks, fvs) [nblk, L, Hkv, bs, *]; `chunks` is the
    per-layer quantized chunk KV (kq, vq, ks, vs) [L, T, Hkv, *], chunk row
    t at position offs_in + t of the touched run. Rows skip <= t < valid
    that fall inside the run are written: an explicit mask where the JAX
    scatter drops out-of-range rows (`index_put_` raises on them). Returns
    `fetched` for `stash_blocks`."""
    t = np.arange(skip, valid)
    pos = offs_in + t
    keep = pos < nblk * bs
    t, pos = t[keep], pos[keep]
    if not len(t):
        return fetched
    dev = fetched[0].device
    rows_t = torch.from_numpy(t).to(dev)
    blk = torch.from_numpy(pos // bs).to(dev)
    off = torch.from_numpy(pos % bs).to(dev)
    for f, ch in zip(fetched, chunks):
        rows = ch[:, rows_t]                                  # [L, n, Hkv, *]
        if ch.dtype != torch.float32:         # KV values, not the scales
            rows = encode_for_pool(rows, kv_dtype)
        f[blk, :, :, off] = rows.transpose(0, 1).to(f.dtype)  # [n, L, Hkv, *]
    return fetched


def _consolidated_append(payloads, store, kv_dtype) -> None:
    """One fetch and one stash inserting EVERY lane's fresh KV:
    payloads[b] = (touched slots [nblk], chunks (kq, vq, ks, vs) [L, T,
    ...], offs_in, valid, skip). Lanes own disjoint slots; only the guard
    slot may repeat, and no insert lands in it, so its rows go back as they
    came."""
    if not payloads:
        return
    touched = np.concatenate([p[0] for p in payloads])
    fetched = fetch_blocks(store, touched, payloads[0][1][0].device)
    bs, at = store.k.shape[2], 0
    for slots, chunks, offs_in, valid, skip in payloads:
        n = len(slots)
        _stream_append_rmw(tuple(a[at:at + n] for a in fetched), chunks,
                           offs_in, valid, kv_dtype=kv_dtype, nblk=n, bs=bs,
                           skip=skip)
        at += n
    stash_blocks(store, fetched, touched)


def _stream_layer(x, lp, config: LlamaConfig, kv_dtype, positions,
                  inv_freq, window, attend_context):
    """One layer of a streamed lane over T fresh tokens x [T, H]:
    `attend_context(q)` gives the context accumulators (a staged slab or
    the host store, wave by wave), the chunk's own quantize -> dequantized
    K / V merge in causally. Returns (x, (kq, vq, ks, vs)), the chunk's
    quantized KV for the append."""
    c = config
    T = x.shape[0]
    h = _norm(x, lp["attn_norm"], c)
    q, k, v = _qkv(h, lp, c)
    q = apply_rope(q.reshape(T, c.num_q_heads, c.head_dim), positions,
                   inv_freq)
    k = apply_rope(k.reshape(T, c.num_kv_heads, c.head_dim), positions,
                   inv_freq)
    v = v.reshape(T, c.num_kv_heads, c.head_dim)
    # store-consistent views of the fresh chunk KV
    kq, ksc = quantize_kv(k, kv_dtype)
    vq, vsc = quantize_kv(v, kv_dtype)
    o = merge_chunk_causal(q, dequantize_kv(kq, ksc, kv_dtype),
                           dequantize_kv(vq, vsc, kv_dtype),
                           attend_context(q), sm_scale=c.sm_scale,
                           window=window, softcap=c.attn_softcap,
                           sinks=lp.get("sinks"))
    x = _block_residuals(x, o.reshape(T, -1), lp, c)
    return x, (kq, vq, ksc[..., 0], vsc[..., 0])


def _lane_sampler(word: int, dev, rng_seed: int, counter: int):
    """sample(logits [1, V]) for one lane's sampling word, drawing (when
    it samples) from seeded_generator(rng_seed, counter)."""
    from cxl_speckv_tpu_torch.engine.sampling import (
        decode_sampling,
        sample_tokens,
    )

    temps, top_ps = decode_sampling(torch.tensor([word], dtype=torch.int32))
    sampled = bool(temps[0] > 0)
    nucleus = sampled and 0.0 < float(top_ps[0]) < 1.0
    gen = seeded_generator(dev, rng_seed, counter) if sampled else None
    temps, top_ps = temps.to(dev), top_ps.to(dev)
    return lambda lg: sample_tokens(lg, temps, gen,
                                    top_ps=top_ps if nucleus else None,
                                    sampled=sampled)


def _stream_lane(params: Params, config: LlamaConfig, kv_dtype,
                 packed: np.ndarray, store, *, max_blocks: int, wave: int,
                 rng_seed: int, logprobs_k: int = 0,
                 prompt_scores: bool = False, stage_mb: int = 0,
                 ctx_waves: int | None = None, pen_info=None,
                 pen_counts=None, mark_prompt: bool = False, skip: int = 0):
    """One host-streamed lane: a prefill chunk or one decode token over the
    context in the host store. The body of `stream_step_batched`.

    packed int32 [4 + table_width + T] (the JAX layout): 0 = start
    position, 1 = valid tokens, 2 = sampling word, 3 = rng counter, then
    the host-slot row (guard-padded; table_width = the context table's
    waves x wave + stream_decode_nblk(T, bs) append blocks), then T token
    ids. Only the
    valid tokens run. The first `skip` of them (a re-fed boundary token,
    whose KV the store already holds) are not written back.

    Staged mode (stage_mb > 0, uniform windows, `ctx_waves` given): each
    group of G layers' context is staged in one gather, G sized to the
    budget from the JAX rule's rows a layer (min(ctx_waves, n_waves) x
    wave); the port stages only the waves this lane attends, the rows
    beyond are never read. Otherwise each (layer, wave) is fetched as the
    wave loop reaches it (`stream_context_attention`), which also serves
    mixed windows (Gemma-2, GPT-OSS). Both run the same wave loop, so they
    agree bit for bit.

    Returns (token [1] int32, the logprob triple or None, prompt scores [T]
    or None, the append payload for `_consolidated_append`). With
    pen_info [1, 5] / pen_counts the penalty hooks run in place, as in
    `prefill_batch_packed`."""
    from cxl_speckv_tpu_torch.engine.sampling import (
        pen_mark_prompt,
        pen_reset_rows,
        penalize_and_count,
    )

    c = config
    dev = params["final_norm"].device
    L, bs = c.num_layers, store.k.shape[2]
    n_waves = -(-max_blocks // wave)
    tw_ctx = n_waves * wave
    nblk = stream_decode_nblk(_solve_chunk_len(len(packed) - 4 - tw_ctx, bs),
                              bs)
    tw = tw_ctx + nblk
    start, valid = int(packed[0]), int(packed[1])
    host_row = packed[4:4 + tw]
    token_ids = torch.from_numpy(
        packed[4 + tw:4 + tw + valid].astype(np.int64)).to(dev)
    positions = start + torch.arange(valid, device=dev)
    inv_freq = rope_frequencies(c).to(dev)
    x = _embed(params, c, token_ids)                          # [T, H]
    wins = c.layer_windows()
    kv_rows = []                               # per layer (kq, vq, ks, vs)
    if stage_mb > 0 and len(set(wins)) <= 1 and ctx_waves is not None:
        window = wins[0]
        rows_a_layer = min(ctx_waves, n_waves) * wave
        G = max(1, min(L, int(stage_mb * (1 << 20))
                       // max(rows_a_layer * store.bytes_per_row, 1)))
        wt = wave * bs
        slots_ctx = host_row[:min((start + wt - 1) // wt, n_waves) * wave]
        for l0 in range(0, L, G):
            g = min(G, L - l0)
            group = stage_layers(store, slots_ctx, l0, g, dev)
            for j in range(g):
                slab = tuple(a[:, j] for a in group)
                x, kv = _stream_layer(
                    x, layer_params(params, l0 + j), c, kv_dtype, positions,
                    inv_freq, window,
                    lambda q: stream_context_attention_slab(
                        q, slab, start, kv_dtype, bs, wave,
                        sm_scale=c.sm_scale, window=window,
                        softcap=c.attn_softcap))
                kv_rows.append(kv)
    else:
        for li, window in enumerate(wins):
            x, kv = _stream_layer(
                x, layer_params(params, li), c, kv_dtype, positions,
                inv_freq, window,
                lambda q: stream_context_attention(
                    q, store, host_row, start, li, kv_dtype, bs, tw_ctx,
                    wave, sm_scale=c.sm_scale, window=window,
                    softcap=c.attn_softcap))
            kv_rows.append(kv)
    chunks = tuple(torch.stack([kv[i] for kv in kv_rows]) for i in range(4))
    b0 = start // bs
    payload = (host_row[b0:b0 + nblk], chunks, start % bs, valid, skip)

    logits = _final_logits(_norm(x[valid - 1:valid], params["final_norm"], c),
                           params, c)                         # [1, V]
    sample = _lane_sampler(int(packed[2]), dev, rng_seed, int(packed[3]))
    if pen_counts is not None:
        pen_reset_rows(pen_info, pen_counts)
        if mark_prompt:
            pen_mark_prompt(pen_info, pen_counts, token_ids[None],
                            torch.tensor([valid], device=dev))
        tok, _ = penalize_and_count(logits, pen_info, pen_counts, sample)
    else:
        tok = sample(logits)
    tok = tok.to(torch.int32)
    lp = _token_logprobs(logits, tok, logprobs_k) if logprobs_k else None
    ps = (_prompt_scores(x[None], token_ids[None],
                         torch.tensor([valid], device=dev), [0], params, c)[0]
          if prompt_scores else None)
    return tok, lp, ps, payload


def stream_step_batched(params: Params, config: LlamaConfig, kv_dtype,
                        packed: np.ndarray, store, pen_info=None,
                        pen_counts: torch.Tensor | None = None, *,
                        max_blocks: int, wave: int = 4, rng_seed: int = 0,
                        logprobs_k: int = 0, prompt_scores: bool = False,
                        stage_mb: int = 0, ctx_waves: int | None = None,
                        mark_prompt: bool = False,
                        skip: np.ndarray | None = None):
    """B host-streamed lanes of one phase (a prefill chunk each, or one
    decode token each) in one call: packed int32 [B, 4 + table_width + T]
    (`_stream_lane`'s layout; lanes with valid 0 are padding: they compute
    and write nothing). The lanes run one after another, each over the
    store as it was before the call (lanes own disjoint slots), so a lane's
    arithmetic never depends on its neighbours; then ONE fetch and ONE
    stash append every lane's fresh KV (`_consolidated_append`). skip [B]:
    leading tokens of each lane not written back (a re-fed boundary token).

    Returns tokens [B] int32 on the device, or a tuple of it and, in this
    order: with `logprobs_k`, the chosen logprobs [B] and top-k ids /
    logprobs [B, k]; with `prompt_scores`, scores [B, T] (`_prompt_scores`'s
    surface; 0 past a lane's valid - 1). The store updates in place;
    pen_info [B, 5] / pen_counts as in `prefill_batch_packed`."""
    packed = np.asarray(packed, np.int32)
    dev = params["final_norm"].device
    B = packed.shape[0]
    bs = store.k.shape[2]
    tw_ctx = -(-max_blocks // wave) * wave
    T = _solve_chunk_len(packed.shape[1] - 4 - tw_ctx, bs)
    pi = (torch.from_numpy(np.asarray(pen_info, np.int32)).to(dev)
          if pen_counts is not None else None)
    toks = torch.zeros(B, dtype=torch.int32, device=dev)
    lps = ((torch.zeros(B, device=dev),
            torch.zeros((B, logprobs_k), dtype=torch.int32, device=dev),
            torch.zeros((B, logprobs_k), device=dev)) if logprobs_k else ())
    scores = torch.zeros((B, T), device=dev) if prompt_scores else None
    payloads = []
    for b in range(B):
        if packed[b, 1] <= 0:
            continue
        tok, lp, ps, payload = _stream_lane(
            params, config, kv_dtype, packed[b], store,
            max_blocks=max_blocks, wave=wave, rng_seed=rng_seed,
            logprobs_k=logprobs_k, prompt_scores=prompt_scores,
            stage_mb=stage_mb, ctx_waves=ctx_waves,
            pen_info=pi[b:b + 1] if pi is not None else None,
            pen_counts=pen_counts, mark_prompt=mark_prompt,
            skip=int(skip[b]) if skip is not None else 0)
        toks[b] = tok[0]
        for dst, src in zip(lps, lp or ()):
            dst[b] = src[0]
        if ps is not None:
            scores[b, :len(ps)] = ps
        payloads.append(payload)
    _consolidated_append(payloads, store, kv_dtype)
    extra = [*lps] + ([scores] if prompt_scores else [])
    return (toks, *extra) if extra else toks


def stream_step(params: Params, config: LlamaConfig, kv_dtype,
                packed: np.ndarray, store, *, max_blocks: int, wave: int = 4,
                rng_seed: int = 0, logprobs_k: int = 0,
                prompt_scores: bool = False):
    """T tokens of ONE host-resident sequence (a prefill chunk, or T = 1 for
    a decode token), context read wave by wave from the store, the chunk's
    KV appended back to it. packed [4 + table_width + T] as in
    `_stream_lane`. Returns what `stream_step_batched` returns for a batch
    of one, each tensor without its batch axis."""
    out = stream_step_batched(params, config, kv_dtype,
                              np.asarray(packed)[None], store,
                              max_blocks=max_blocks, wave=wave,
                              rng_seed=rng_seed, logprobs_k=logprobs_k,
                              prompt_scores=prompt_scores)
    return tuple(a[0] for a in out) if isinstance(out, tuple) else out[0]


def stream_decode_multi_batched(params: Params, config: LlamaConfig,
                                kv_dtype, packed: np.ndarray, store,
                                pen_info=None,
                                pen_counts: torch.Tensor | None = None, *,
                                max_blocks: int, wave: int, horizon: int,
                                rng_seed: int = 0, logprobs_k: int = 0):
    """Up to `horizon` streamed decode steps for B host-resident lanes in
    one call, the streamed counterpart of `decode_multi`.

        packed int32 [B, 4 + table_width + nblk + 1]: 0 = start (the seed
        token's position), 1 = valid steps, 2 = sampling word, 3 = rng
        counter, then the host-slot row (guard-padded) with
        nblk = stream_decode_nblk(horizon, bs) append blocks, last = the
        seed token.

    Each lane's context, all layers of the waves its steps attend, is
    staged ONCE (one copy per run of consecutive slots); each step writes
    its freshly quantized KV into the slab at its position, so step j + 1
    reads exactly the bytes a fresh fetch would (same wave order, same
    values, same merges: bit-equal to `valid` calls of
    `stream_step_batched` at T = 1), and every lane's appends consolidate
    into one fetch and one stash at the end. A lane runs its `valid` steps
    only (the JAX program runs `horizon` and the engine drops the rest).

    Greedy lanes are token-identical to the per-token path. A sampled lane
    draws step j from seeded_generator(rng_seed + j, its counter), the JAX
    key layout: the same distribution along another draw sequence than
    the per-token path's. Needs uniform windows. Returns tokens
    [B, horizon] int32 and, with `logprobs_k`, the chosen logprobs
    [B, horizon] and top-k ids / logprobs [B, horizon, k]."""
    from cxl_speckv_tpu_torch.engine.sampling import penalize_and_count

    c = config
    wins = c.layer_windows()
    if len(set(wins)) > 1:
        raise ValueError("fused streamed decode needs uniform attention "
                         "windows (same precondition as staged gathers)")
    window = wins[0]
    packed = np.asarray(packed, np.int32)
    dev = params["final_norm"].device
    L, bs = c.num_layers, store.k.shape[2]
    n_waves = -(-max_blocks // wave)
    tw_ctx = n_waves * wave
    nblk = stream_decode_nblk(horizon, bs)
    B = packed.shape[0]
    expect = 4 + tw_ctx + nblk + 1
    if packed.shape[1] != expect:
        raise ValueError(
            f"stream_decode_multi_batched packed width {packed.shape[1]} != "
            f"4 + {tw_ctx} (table) + {nblk} (touched) + 1 (seed) = {expect}")
    pi = (torch.from_numpy(np.asarray(pen_info, np.int32)).to(dev)
          if pen_counts is not None else None)
    inv_freq = rope_frequencies(c).to(dev)
    toks = torch.zeros((B, horizon), dtype=torch.int32, device=dev)
    lps = ((torch.zeros((B, horizon), device=dev),
            torch.zeros((B, horizon, logprobs_k), dtype=torch.int32,
                        device=dev),
            torch.zeros((B, horizon, logprobs_k), device=dev))
           if logprobs_k else ())
    wt = wave * bs
    payloads = []
    for b in range(B):
        lane = packed[b]
        start, valid, ctr = int(lane[0]), int(lane[1]), int(lane[3])
        if valid <= 0:
            continue
        host_row = lane[4:4 + tw_ctx + nblk]
        # the waves the last step attends: every step's context is in here
        n_ctx = min((start + valid - 1 + wt - 1) // wt, n_waves) * wave
        slab = stage_layers(store, host_row[:n_ctx], 0, L, dev)
        tok = torch.from_numpy(lane[-1:].astype(np.int64)).to(dev)
        steps = []                   # per step: per layer (kq, vq, ks, vs)
        for j in range(valid):
            pos = start + j
            brow, offs = pos // bs, pos % bs
            x = _embed(params, c, tok)                        # [1, H]
            kv_rows = []
            for li in range(L):
                ctx = tuple(a[:, li] for a in slab)
                x, kv = _stream_layer(
                    x, layer_params(params, li), c, kv_dtype,
                    pos + torch.arange(1, device=dev), inv_freq, window,
                    lambda q: stream_context_attention_slab(
                        q, ctx, pos, kv_dtype, bs, wave, sm_scale=c.sm_scale,
                        window=window, softcap=c.attn_softcap))
                kv_rows.append(kv)
                if brow < n_ctx:
                    # the bytes the append will store (the last step's
                    # position may lie past the staged waves: no later
                    # step reads it)
                    kq, vq, ks, vs = kv
                    for dst, val in ((ctx[0], encode_for_pool(kq, kv_dtype)),
                                     (ctx[1], encode_for_pool(vq, kv_dtype)),
                                     (ctx[2], ks), (ctx[3], vs)):
                        dst[brow, :, offs] = val[0].to(dst.dtype)
            steps.append(kv_rows)
            logits = _final_logits(_norm(x, params["final_norm"], c), params,
                                   c)
            sample = _lane_sampler(int(lane[2]), dev, rng_seed + j, ctr)
            if pen_counts is not None:
                tok, _ = penalize_and_count(logits, pi[b:b + 1], pen_counts,
                                            sample)
            else:
                tok = sample(logits)
            toks[b, j] = tok[0].to(torch.int32)
            if logprobs_k:
                for dst, src in zip(lps, _token_logprobs(logits, tok,
                                                         logprobs_k)):
                    dst[b, j] = src[0]
        # [L, valid, Hkv, *]: step j's one token at chunk row j
        chunks = tuple(torch.stack([torch.cat([s[li][i] for s in steps])
                                    for li in range(L)]) for i in range(4))
        b0 = start // bs
        payloads.append((host_row[b0:b0 + nblk], chunks, start % bs, valid,
                         0))
    _consolidated_append(payloads, store, kv_dtype)
    return (toks, *lps) if logprobs_k else toks


# ---------------------------------------------------------------------------
# plain forward (no cache) — for parity tests
# ---------------------------------------------------------------------------

def forward_dense(params: Params, config: LlamaConfig,
                  token_ids: torch.Tensor) -> torch.Tensor:
    """Full causal forward, no KV cache: token_ids [B, T] -> logits
    [B, T, V] float32."""
    c = config
    check_supported(c)
    B, T = token_ids.shape
    dev = token_ids.device
    positions = torch.arange(T, device=dev)
    inv_freq = rope_frequencies(c).to(dev)
    causal = positions[:, None] >= positions[None, :]
    x = _embed(params, c, token_ids)
    G = c.q_group
    for li, window in enumerate(c.layer_windows()):
        mask = causal
        if window is not None:
            mask = causal & (positions[:, None] - positions[None, :] < window)
        lp = layer_params(params, li)
        h = _norm(x, lp["attn_norm"], c)
        q, k, v = _qkv(h, lp, c)
        q = apply_rope(q.reshape(B, T, c.num_q_heads, c.head_dim),
                       positions[None], inv_freq)
        k = apply_rope(k.reshape(B, T, c.num_kv_heads, c.head_dim),
                       positions[None], inv_freq)
        v = v.reshape(B, T, c.num_kv_heads, c.head_dim)
        qg = q.reshape(B, T, c.num_kv_heads, G, c.head_dim).float()
        s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * c.sm_scale
        s = soft_cap(s, c.attn_softcap).masked_fill(~mask, -1e30)
        sk = (lp["sinks"].reshape(c.num_kv_heads, G).float()[None, :, :,
                                                             None, None]
              if "sinks" in lp else None)
        w = sink_softmax(s, sk)
        o = torch.einsum("bhgts,bshd->bthgd", w, v.float())
        x = _block_residuals(x, o.reshape(B, T, -1), lp, c)
    x = _norm(x, params["final_norm"], c)
    return _final_logits(x, params, c)
