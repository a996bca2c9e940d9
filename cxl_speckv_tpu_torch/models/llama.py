"""Llama-family model in PyTorch over the paged quantized KV cache.

Counterpart of `cxl_speckv_tpu/models/llama.py`, main-path subset: the
parameter tree and its random init (plain and quantize-at-init), the
building blocks, `decode_step` / `decode_multi` / `decode_multi_packed`
(fused multi-step decode with sampling on the device, optionally returning
each step's logits), the batched chunked prefill `prefill_batch_packed`,
the single-sequence `prefill_chunk`, the speculative verify pass
`verify_step`, and `forward_dense`. Families: Llama,
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
from cxl_speckv_tpu_torch.ops.wquant import (
    QuantizedTensor,
    mm,
    quantize_tensor,
    take_rows,
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
    alternatives (ids, logprobs)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(lp, -1, toks[..., None].long())[..., 0]
    tv, ti = torch.topk(lp, k, dim=-1)
    return chosen, ti.to(torch.int32), tv


def decode_multi(params: Params, config: LlamaConfig, kv_dtype,
                 first_tokens: torch.Tensor, start_positions: torch.Tensor,
                 pools: Pools, block_table: torch.Tensor,
                 generator: torch.Generator | None,
                 temperatures: torch.Tensor, top_ps: torch.Tensor | None,
                 *, horizon: int, sampled: bool = False,
                 nucleus: bool = False, return_logits: bool = False):
    """`horizon` decode steps with sampling on the device: step j feeds the
    token sampled at step j - 1. Callers pre-extend sequences so the table
    covers start .. start + horizon - 1. `sampled` / `nucleus` say whether
    any lane samples (temperature > 0) or uses top-p; when neither, the
    steps are pure argmax and never synchronize with the host. Returns
    tokens [B, horizon] int32 on the device; the pools update in place.
    With `return_logits`, (tokens, logits [B, horizon, V] float32): each
    step's logits, the proposal distributions that speculative sampling's
    acceptance rule needs (`engine/spec.py`)."""
    from cxl_speckv_tpu_torch.engine.sampling import sample_tokens

    schemes = layer_kv_schemes(kv_dtype, config.num_layers)
    toks = first_tokens
    out, step_logits = [], []
    for j in range(horizon):
        positions = start_positions + j
        logits = _decode_core(params, config, schemes, toks, positions,
                              pools, block_table, positions + 1)
        toks = sample_tokens(logits, temperatures, generator,
                             top_ps=top_ps if nucleus else None,
                             sampled=sampled).to(torch.int32)
        out.append(toks)
        if return_logits:
            step_logits.append(logits)
    toks = torch.stack(out, dim=1)
    return (toks, torch.stack(step_logits, dim=1)) if return_logits else toks


def seeded_generator(device, rng_seed: int, counter: int) -> torch.Generator:
    """The generator of one dispatch's draws, seeded from (rng_seed,
    counter) as the JAX package derives its key."""
    g = torch.Generator(device=device)
    g.manual_seed((rng_seed << 32) + counter)
    return g


def decode_multi_packed(params: Params, config: LlamaConfig,
                        kv_dtype, packed: np.ndarray, pools: Pools,
                        *, horizon: int, rng_seed: int = 0,
                        return_logits: bool = False):
    """`decode_multi` with every per-round host input in ONE int32 array
    (one host->device copy per round):

        packed [B, max_blocks + 4]: col 0 = first token, 1 = its position,
        2 = sampling word (`engine.sampling.encode_sampling`), 3 = rng
        counter, 4: = block-table row (guard-filled).

    Returns tokens [B, horizon] int32 on the pools' device, and with
    `return_logits` the per-step logits beside them (`decode_multi`)."""
    from cxl_speckv_tpu_torch.engine.sampling import decode_sampling

    packed = np.asarray(packed, np.int32)
    dev = pools[0].device
    temps_h, top_ps_h = decode_sampling(torch.from_numpy(packed[:, 2]))
    sampled = bool((temps_h > 0).any())
    nucleus = sampled and bool(((top_ps_h > 0) & (top_ps_h < 1)
                                & (temps_h > 0)).any())
    p = torch.from_numpy(packed).to(dev)
    gen = (seeded_generator(dev, rng_seed, int(packed[0, 3])) if sampled
           else None)
    return decode_multi(params, config, kv_dtype, p[:, 0], p[:, 1], pools,
                        p[:, 4:], gen, temps_h.to(dev), top_ps_h.to(dev),
                        horizon=horizon, sampled=sampled, nucleus=nucleus,
                        return_logits=return_logits)


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


def prefill_batch_packed(params: Params, config: LlamaConfig,
                         kv_dtype, packed: np.ndarray, pools: Pools,
                         *, max_blocks: int, rng_seed: int = 0) -> torch.Tensor:
    """Batched chunked prefill: every prefilling lane's chunk in one pass
    (`_chunk_forward`), each lane's next token sampled on the device.

        packed [B, 4 + max_blocks + T]: col 0 = start position, 1 = valid
        length (0 = inactive lane), 2 = sampling word, 3 = rng counter,
        4:4+max_blocks = table row (guard-filled), the rest = tokens.

    Positions past a lane's valid length write the guard slot. Returns
    tokens [B] int32 on the pools' device."""
    from cxl_speckv_tpu_torch.engine.sampling import (
        decode_sampling,
        sample_tokens,
    )

    c = config
    packed = np.asarray(packed, np.int32)
    dev = pools[0].device
    B = packed.shape[0]
    T = packed.shape[1] - 4 - max_blocks
    temps_h, top_ps_h = decode_sampling(torch.from_numpy(packed[:, 2]))
    sampled = bool((temps_h > 0).any())
    nucleus = sampled and bool(((top_ps_h > 0) & (top_ps_h < 1)
                                & (temps_h > 0)).any())
    p = torch.from_numpy(packed).to(dev)
    valid = p[:, 1]
    write = torch.arange(T, device=dev)[None, :] < valid[:, None]
    x = _chunk_forward(params, c, kv_dtype, p[:, 4 + max_blocks:].long(),
                       p[:, 0], pools, p[:, 4:4 + max_blocks], write)
    # last valid hidden state per lane -> logits -> sampled token
    last = torch.clamp(valid - 1, 0, T - 1).long()
    x_last = x[torch.arange(B, device=dev), last]
    logits = _final_logits(_norm(x_last, params["final_norm"], c), params, c)
    gen = (seeded_generator(dev, rng_seed, int(packed[0, 3])) if sampled
           else None)
    return sample_tokens(logits, temps_h.to(dev), gen,
                         top_ps=top_ps_h.to(dev) if nucleus else None,
                         sampled=sampled).to(torch.int32)


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
