"""Llama-family model in PyTorch over the paged quantized KV cache.

Counterpart of `cxl_speckv_tpu/models/llama.py`, main-path subset: the
parameter tree and its random init (plain and quantize-at-init), the
building blocks, `decode_step` / `decode_multi` / `decode_multi_packed`
(fused multi-step decode with sampling on the device), the batched chunked
prefill `prefill_batch_packed`, and `forward_dense`. Families: Llama,
Mistral (uniform sliding window) and Gemma-2 (alternating sliding / global
layers, tanh softcaps, GeGLU, sandwich norms, 1 + w RMSNorm, scaled
embeddings, tied head).

Parameters are a plain dict with the JAX package's tree layout (layer
weights stacked on a leading [L] axis). PyTorch runs eagerly, so the layer
scan and the horizon loop are Python loops, and the pools are updated IN
PLACE (the JAX functions return new pools). Numerics follow the HF
conventions as the JAX package does: rotate-half RoPE, Llama-3 banded rope
scaling, RMSNorm in float32. Each layer passes its own window
(`config.layer_windows()[li]`) and the attention softcap to the kernels:
the layer loop is Python, so the JAX package's period-grouped scan has no
counterpart here.

Attention goes through the kernel wrappers `ops.paged_attention.
paged_attention` (K1, decode) and `ops.chunk_attention_cuda.
paged_chunk_attention_cuda` (K2, prefill): the CUDA kernels for tensors on
the card, their plain versions for tensors on the CPU.

`kv_dtype` is one scheme for every layer, or a tuple of per-layer schemes
(INT8 / FP8, `CacheConfig.layer_kv_dtypes`): layer li then quantizes with
its own scheme and attends as MIXED8 with its scheme id
(`layer_kv_schemes`).

Model features outside this slice (attention bias, qk-norm, MoE, sinks,
YaRN / linear / per-layer rope) raise NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.models.configs import LlamaConfig
from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
    paged_chunk_attention_cuda,
)
from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention
from cxl_speckv_tpu_torch.ops.paged_attention_ref import soft_cap
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
        "attn_bias": c.attn_bias,
        "o_bias": c.o_bias,
        "qk_norm": c.qk_norm,
        "num_experts": c.num_experts > 0,
        "attn_sinks": c.attn_sinks,
        "act_fn": c.act_fn not in ("silu", "gelu_tanh"),
        "rope_yarn": c.rope_yarn is not None,
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
    `post_norms` (Gemma-2) also post_attn_norm / post_mlp_norm [L, H].
    Weights are N(0, 1/fan_in) draws from `generator` (a different stream
    from JAX's: carry JAX weights with `convert.params_from_jax`)."""
    c = config
    check_supported(c)
    dtype = dtype or torch_dtype(c.dtype)
    L, H, I, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size
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
            "gate": w((L, H, I), H), "up": w((L, H, I), H),
            "down": w((L, I, H), I),
        },
        "final_norm": torch.ones((H,), dtype=dtype, device=device),
    }
    params["layers"].update(_post_norms(c, generator, device, dtype))
    if not c.tie_embeddings:
        params["lm_head"] = w((H, V), H)
    return params


def _post_norms(config: LlamaConfig, generator, device, dtype) -> dict:
    """Gemma-2 sandwich-norm weights [L, H] (HF post_attention_layernorm /
    post_feedforward_layernorm), N(0, 0.05^2) as the JAX init draws them so
    the path is exercised; {} without `post_norms`."""
    if not config.post_norms:
        return {}
    shape = (config.num_layers, config.hidden_size)
    return {name: (torch.randn(shape, generator=generator, device=device)
                   * 0.05).to(dtype)
            for name in ("post_attn_norm", "post_mlp_norm")}


def init_params_quantized(config: LlamaConfig, generator: torch.Generator,
                          device="cpu") -> Params:
    """Random-init straight into W8A16 storage, one layer at a time: each
    layer's weights are drawn in float32 and quantized before the next is
    drawn, so the full-precision tree never exists (Llama-3-8B: ~8 GB of
    int8 instead of 16 GB of bf16 plus a quantized copy). Same tree layout
    as `init_params` followed by `quantize_weights`."""
    c = config
    check_supported(c)
    dtype = torch_dtype(c.dtype)
    L, H, I, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size
    qd, kvd = c.num_q_heads * c.head_dim, c.num_kv_heads * c.head_dim
    shapes = {"q": ((H, qd), H), "k": ((H, kvd), H), "v": ((H, kvd), H),
              "o": ((qd, H), qd), "gate": ((H, I), H), "up": ((H, I), H),
              "down": ((I, H), I)}
    layers = {}
    for name, (shape, fan_in) in shapes.items():
        q = torch.empty((L, *shape), dtype=torch.int8, device=device)
        s = torch.empty((L, 1, shape[1]), dtype=torch.float32, device=device)
        for li in range(L):
            qt = quantize_tensor(_normal(shape, fan_in, generator, device))
            q[li], s[li] = qt.q, qt.s
        layers[name] = QuantizedTensor(q, s, -2)
    layers["attn_norm"] = torch.ones((L, H), dtype=dtype, device=device)
    layers["mlp_norm"] = torch.ones((L, H), dtype=dtype, device=device)
    layers.update(_post_norms(c, generator, device, dtype))
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
    """Inverse frequencies [D/2] float32, with Llama-3 banded scaling
    (HF-compatible)."""
    c = config
    inv = 1.0 / (c.rope_theta ** (torch.arange(0, c.head_dim, 2,
                                               dtype=torch.float32)
                                  / c.head_dim))
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
    return _mlp(x, lp["gate"], lp["up"], lp["down"], _act(config))


def _qkv(h, lp, config: LlamaConfig = None):
    return mm(h, lp["q"]), mm(h, lp["k"]), mm(h, lp["v"])


def _block_residuals(x, o_flat, lp, config):
    """o-projection (+ Gemma-2 post-attention norm) + residual, then the
    MLP block (+ post-MLP norm) + residual."""
    att = mm(o_flat.to(x.dtype), lp["o"])
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
                   window=windows[li], scheme_id=sid)
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
                 nucleus: bool = False) -> torch.Tensor:
    """`horizon` decode steps with sampling on the device: step j feeds the
    token sampled at step j - 1. Callers pre-extend sequences so the table
    covers start .. start + horizon - 1. `sampled` / `nucleus` say whether
    any lane samples (temperature > 0) or uses top-p; when neither, the
    steps are pure argmax and never synchronize with the host. Returns
    tokens [B, horizon] int32 on the device; the pools update in place."""
    from cxl_speckv_tpu_torch.engine.sampling import sample_tokens

    schemes = layer_kv_schemes(kv_dtype, config.num_layers)
    toks = first_tokens
    out = []
    for j in range(horizon):
        positions = start_positions + j
        logits = _decode_core(params, config, schemes, toks, positions,
                              pools, block_table, positions + 1)
        toks = sample_tokens(logits, temperatures, generator,
                             top_ps=top_ps if nucleus else None,
                             sampled=sampled).to(torch.int32)
        out.append(toks)
    return torch.stack(out, dim=1)


def _generator(device, rng_seed: int, counter: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((rng_seed << 32) + counter)
    return g


def decode_multi_packed(params: Params, config: LlamaConfig,
                        kv_dtype, packed: np.ndarray, pools: Pools,
                        *, horizon: int, rng_seed: int = 0) -> torch.Tensor:
    """`decode_multi` with every per-round host input in ONE int32 array
    (one host->device copy per round):

        packed [B, max_blocks + 4]: col 0 = first token, 1 = its position,
        2 = sampling word (`engine.sampling.encode_sampling`), 3 = rng
        counter, 4: = block-table row (guard-filled).

    Returns tokens [B, horizon] int32 on the pools' device."""
    from cxl_speckv_tpu_torch.engine.sampling import decode_sampling

    packed = np.asarray(packed, np.int32)
    dev = pools[0].device
    temps_h, top_ps_h = decode_sampling(torch.from_numpy(packed[:, 2]))
    sampled = bool((temps_h > 0).any())
    nucleus = sampled and bool(((top_ps_h > 0) & (top_ps_h < 1)
                                & (temps_h > 0)).any())
    p = torch.from_numpy(packed).to(dev)
    gen = (_generator(dev, rng_seed, int(packed[0, 3])) if sampled else None)
    return decode_multi(params, config, kv_dtype, p[:, 0], p[:, 1], pools,
                        p[:, 4:], gen, temps_h.to(dev), top_ps_h.to(dev),
                        horizon=horizon, sampled=sampled, nucleus=nucleus)


# ---------------------------------------------------------------------------
# batched chunked prefill
# ---------------------------------------------------------------------------

def prefill_batch_packed(params: Params, config: LlamaConfig,
                         kv_dtype, packed: np.ndarray, pools: Pools,
                         *, max_blocks: int, rng_seed: int = 0) -> torch.Tensor:
    """Batched chunked prefill: every prefilling lane's chunk in one pass
    (causal within the chunk + that lane's quantized pool context), each
    lane's next token sampled on the device.

        packed [B, 4 + max_blocks + T]: col 0 = start position, 1 = valid
        length (0 = inactive lane), 2 = sampling word, 3 = rng counter,
        4:4+max_blocks = table row (guard-filled), the rest = tokens.

    The chunk's K/V enter attention as quantize->dequantized values (what
    decode will later read from the pool) and are appended to the pools in
    place after attention; inactive positions write the guard slot.
    Returns tokens [B] int32 on the pools' device."""
    from cxl_speckv_tpu_torch.engine.sampling import (
        decode_sampling,
        sample_tokens,
    )

    c = config
    schemes = layer_kv_schemes(kv_dtype, c.num_layers)
    packed = np.asarray(packed, np.int32)
    dev = pools[0].device
    B = packed.shape[0]
    T = packed.shape[1] - 4 - max_blocks
    bs = pools[1].shape[3]
    guard_slot = pools[0].shape[1] - 1
    temps_h, top_ps_h = decode_sampling(torch.from_numpy(packed[:, 2]))
    sampled = bool((temps_h > 0).any())
    nucleus = sampled and bool(((top_ps_h > 0) & (top_ps_h < 1)
                                & (temps_h > 0)).any())
    p = torch.from_numpy(packed).to(dev)
    start, valid = p[:, 0], p[:, 1]
    tables = p[:, 4:4 + max_blocks]
    token_ids = p[:, 4 + max_blocks:].long()

    t_idx = torch.arange(T, device=dev)
    positions = start[:, None] + t_idx[None, :]              # [B, T]
    blk = torch.clamp(positions // bs, 0, max_blocks - 1)
    slots = torch.gather(tables, 1, blk.long()).long()
    slots = torch.where(t_idx[None, :] < valid[:, None], slots,
                        torch.full_like(slots, guard_slot))
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
                         window=windows[li], scheme_id=sid)
        x = _block_residuals(x, o.reshape(B, T, -1), lp, c)
        _append_kv(pools, li, encode_for_pool(kq, scheme),
                   encode_for_pool(vq, scheme), ks, vs, slots, offs)
    # last valid hidden state per lane -> logits -> sampled token
    last = torch.clamp(valid - 1, 0, T - 1).long()
    x_last = x[torch.arange(B, device=dev), last]
    logits = _final_logits(_norm(x_last, params["final_norm"], c), params, c)
    gen = (_generator(dev, rng_seed, int(packed[0, 3])) if sampled else None)
    return sample_tokens(logits, temps_h.to(dev), gen,
                         top_ps=top_ps_h.to(dev) if nucleus else None,
                         sampled=sampled).to(torch.int32)


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
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgts,bshd->bthgd", w, v.float())
        x = _block_residuals(x, o.reshape(B, T, -1), lp, c)
    x = _norm(x, params["final_norm"], c)
    return _final_logits(x, params, c)
