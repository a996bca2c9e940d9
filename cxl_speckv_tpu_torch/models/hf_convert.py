"""HuggingFace checkpoint conversion into the port's parameter tree.

Counterpart of `cxl_speckv_tpu/models/hf_convert.py`, every family it
reads: Llama / Mistral / Qwen2 (q/k/v biases), Qwen3 and Gemma-3 (per-head
q/k norms; Gemma-3's `layer_types` reduced to their period, its local RoPE
base, linear `rope_scaling` and `query_pre_attn_scalar`), Gemma-2 sandwich
norms, Phi-3's fused `qkv_proj` / `gate_up_proj` (split here; longrope
raises), Mixtral `w1` / `w3` / `w2` experts, Qwen2 / Qwen3-MoE (`mlp.gate`
router, per-expert projections, Qwen2-MoE's shared expert) and GPT-OSS
(interleaved `gate_up_proj` with biases, router bias, sinks).

Nothing here imports `transformers` or reads a file: `hf_config` is any
object with HF's config attributes (a `transformers` config, or a
`types.SimpleNamespace` holding the same fields), and the state dict maps
HF's parameter names to torch tensors or numpy arrays. Linear weights are
[out, in] in HF and [in, out] here, so a forward is `x @ W`.

`weight_dtype="int8"` quantizes at conversion (W8A16, `ops/wquant.py`),
and "int4" to W4A16 (the embedding int8 per row either way), one layer's
matrix or expert stack at a time on the target device, so the
full-precision tree never exists there: the device holds the quantized
tree plus one float32 matrix or stack. The result is bit for bit the JAX
converter's (`params_from_hf_state_dict` followed by its
`quantize_weights`): each matrix is rounded to the activation dtype first,
then quantized per output channel.
"""

from __future__ import annotations

import torch

from cxl_speckv_tpu_torch.engine.engine import resolve_device
from cxl_speckv_tpu_torch.models.configs import LlamaConfig, RopeScaling, YarnRope
from cxl_speckv_tpu_torch.models.convert import tensor_from_numpy
from cxl_speckv_tpu_torch.models.llama import torch_dtype
from cxl_speckv_tpu_torch.ops.wquant import (
    LAYER_MM_KEYS,
    QuantizedTensor,
    quantize_tensor,
)


def _pattern_from_layer_types(hf_config) -> tuple:
    """Reduce HF layer_types to the smallest repeating (is_sliding, ...)
    period (HF stores the full per-layer list)."""
    types = list(hf_config.layer_types)
    pattern = tuple(t == "sliding_attention" for t in types)
    for p in range(1, len(pattern) + 1):
        if len(pattern) % p == 0 and all(
                pattern[i] == pattern[i % p] for i in range(len(pattern))):
            return pattern[:p]
    return pattern


def config_from_hf(hf_config) -> LlamaConfig:
    """The port's `LlamaConfig` of an HF config: field for field what the
    JAX package's `config_from_hf` gives."""
    rs = None
    linear_factor = None
    yarn = None
    raw = getattr(hf_config, "rope_scaling", None)
    kind = raw.get("rope_type", raw.get("type")) if raw else None
    if kind == "linear":
        linear_factor = float(raw["factor"])
    elif kind == "yarn":
        yarn = YarnRope(
            factor=float(raw["factor"]),
            original_max_position=int(
                raw.get("original_max_position_embeddings")
                or hf_config.max_position_embeddings),
            beta_fast=float(raw.get("beta_fast") or 32),
            beta_slow=float(raw.get("beta_slow") or 1),
            attention_factor=raw.get("attention_factor"),
            truncate=bool(raw.get("truncate", True)),
        )
    elif kind == "llama3":
        rs = RopeScaling(
            factor=raw["factor"],
            low_freq_factor=raw["low_freq_factor"],
            high_freq_factor=raw["high_freq_factor"],
            original_max_position=raw["original_max_position_embeddings"],
        )
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads)
    eos = hf_config.eos_token_id
    if isinstance(eos, (list, tuple)):
        eos = eos[0]
    # Mistral's sliding window; Qwen2 carries the field but turns it off
    # with use_sliding_window=False
    window = getattr(hf_config, "sliding_window", None)
    if window is not None and not getattr(hf_config, "use_sliding_window",
                                          True):
        window = None
    model_type = getattr(hf_config, "model_type", "")
    attn_bias = bool(getattr(hf_config, "attention_bias", False)) or (
        model_type in ("qwen2", "qwen2_moe"))
    qk_norm = model_type in ("qwen3", "qwen3_moe", "gemma3_text", "gemma3")
    if model_type == "phi3" and raw:
        raise NotImplementedError("phi3 longrope scaling not supported; "
                                  "use a config with rope_scaling=None")
    family_kw = {}
    if model_type == "gemma2":
        family_kw = dict(
            attn_pattern=_pattern_from_layer_types(hf_config),
            attn_softcap=hf_config.attn_logit_softcapping,
            final_softcap=hf_config.final_logit_softcapping,
            norm_offset=True, post_norms=True, act_fn="gelu_tanh",
            embed_scale=True,
            query_scale=float(hf_config.query_pre_attn_scalar) ** -0.5,
        )
    elif model_type == "gpt_oss":
        family_kw = dict(
            attn_pattern=_pattern_from_layer_types(hf_config),
            attn_sinks=True, o_bias=True, moe_style="gpt_oss",
        )
    elif model_type in ("gemma3_text", "gemma3"):
        # no softcaps (the q/k norm replaces them); sliding layers rotate
        # with their own base
        family_kw = dict(
            attn_pattern=_pattern_from_layer_types(hf_config),
            norm_offset=True, post_norms=True, act_fn="gelu_tanh",
            embed_scale=True,
            query_scale=float(hf_config.query_pre_attn_scalar) ** -0.5,
            rope_local_theta=float(hf_config.rope_local_base_freq),
        )
    # Qwen2 / Qwen3-MoE: an expert's width is moe_intermediate_size;
    # Qwen2-MoE adds the shared expert and keeps raw top-k probabilities
    moe_kw = {}
    if model_type in ("qwen2_moe", "qwen3_moe"):
        if (getattr(hf_config, "decoder_sparse_step", 1) != 1
                or getattr(hf_config, "mlp_only_layers", [])):
            raise NotImplementedError(
                "mixed dense/sparse Qwen-MoE layer layouts not supported")
        moe_kw = dict(
            num_experts=hf_config.num_experts,
            intermediate_size=hf_config.moe_intermediate_size,
            moe_norm_topk=bool(hf_config.norm_topk_prob),
            moe_shared_expert=getattr(
                hf_config, "shared_expert_intermediate_size", 0) or 0,
        )
    kw = dict(
        **family_kw,
        sliding_window=window,
        attn_bias=attn_bias or model_type == "gpt_oss",
        qk_norm=qk_norm,
        rope_linear_factor=linear_factor,
        rope_yarn=yarn,
        num_experts=getattr(hf_config, "num_local_experts", 0) or 0,
        num_experts_per_tok=getattr(hf_config, "num_experts_per_tok", 2) or 2,
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_q_heads=hf_config.num_attention_heads,
        num_kv_heads=hf_config.num_key_value_heads,
        head_dim=head_dim,
        rope_theta=hf_config.rope_theta,
        rope_scaling=rs,
        rms_eps=hf_config.rms_norm_eps,
        tie_embeddings=hf_config.tie_word_embeddings,
        max_seq_len=hf_config.max_position_embeddings,
        eos_token_id=eos if eos is not None else -1,
    )
    kw.update(moe_kw)
    return LlamaConfig(**kw)


def _layer_sources(sd_has, config: LlamaConfig, get) -> dict:
    """{leaf name: fn(i) -> layer i's float32 weight in the tree's layout}.
    `get(name)` reads one HF tensor as float32 on the target device;
    `sd_has(name)` says whether the state dict holds it."""
    c = config
    qd, kvd = c.num_q_heads * c.head_dim, c.num_kv_heads * c.head_dim
    E, I = c.num_experts, c.intermediate_size
    lay = "model.layers.{}."

    def lin(fmt, rows=slice(None)):          # HF [out, in] rows -> [in, out]
        return lambda i: get((lay + fmt).format(i))[rows].T

    def raw(fmt):                            # stored as the tree keeps it
        return lambda i: get((lay + fmt).format(i))

    def experts(fmt):                        # [E, in, out]
        return lambda i: torch.stack([get((lay + fmt).format(i, e)).T
                                      for e in range(E)])

    fused = sd_has("model.layers.0.self_attn.qkv_proj.weight")
    src = {"attn_norm": raw("input_layernorm.weight")}
    if fused:
        # Phi-3: qkv_proj fuses [q; k; v] rows, gate_up_proj [gate; up]
        qkv = "self_attn.qkv_proj.weight"
        src.update(q=lin(qkv, slice(0, qd)), k=lin(qkv, slice(qd, qd + kvd)),
                   v=lin(qkv, slice(qd + kvd, None)))
    else:
        src.update(q=lin("self_attn.q_proj.weight"),
                   k=lin("self_attn.k_proj.weight"),
                   v=lin("self_attn.v_proj.weight"))
    src["o"] = lin("self_attn.o_proj.weight")
    if c.post_norms:
        # Gemma-2 / -3 sandwich norms: post_attention_layernorm is the
        # post-attention norm, pre_feedforward_layernorm the MLP pre-norm
        src.update(post_attn_norm=raw("post_attention_layernorm.weight"),
                   mlp_norm=raw("pre_feedforward_layernorm.weight"),
                   post_mlp_norm=raw("post_feedforward_layernorm.weight"))
    else:
        src["mlp_norm"] = raw("post_attention_layernorm.weight")
    if E > 0 and c.moe_style == "gpt_oss":
        # gate_up_proj [E, H, 2I] input-major with INTERLEAVED gate / up
        # columns, every projection biased
        gu, gub = "mlp.experts.gate_up_proj", "mlp.experts.gate_up_proj_bias"
        src.update(
            router=lin("mlp.router.weight"),
            router_bias=raw("mlp.router.bias"),
            gate=lambda i: get((lay + gu).format(i))[..., ::2],
            up=lambda i: get((lay + gu).format(i))[..., 1::2],
            gate_bias=lambda i: get((lay + gub).format(i))[..., ::2],
            up_bias=lambda i: get((lay + gub).format(i))[..., 1::2],
            down=raw("mlp.experts.down_proj"),
            down_bias=raw("mlp.experts.down_proj_bias"))
    elif E > 0 and sd_has("model.layers.0.mlp.gate.weight"):
        # Qwen2 / Qwen3-MoE: mlp.gate is the router
        src.update(router=lin("mlp.gate.weight"),
                   gate=experts("mlp.experts.{}.gate_proj.weight"),
                   up=experts("mlp.experts.{}.up_proj.weight"),
                   down=experts("mlp.experts.{}.down_proj.weight"))
        if c.moe_shared_expert > 0:
            seg = raw("mlp.shared_expert_gate.weight")
            src.update(shared_gate=lin("mlp.shared_expert.gate_proj.weight"),
                       shared_up=lin("mlp.shared_expert.up_proj.weight"),
                       shared_down=lin("mlp.shared_expert.down_proj.weight"),
                       shared_expert_gate=lambda i: seg(i)[0])   # [1, H]
    elif E > 0:
        # Mixtral: block_sparse_moe.gate is the router, w1 / w3 / w2 the
        # experts' gate / up / down
        src.update(router=lin("block_sparse_moe.gate.weight"),
                   gate=experts("block_sparse_moe.experts.{}.w1.weight"),
                   up=experts("block_sparse_moe.experts.{}.w3.weight"),
                   down=experts("block_sparse_moe.experts.{}.w2.weight"))
    elif fused:
        gu = "mlp.gate_up_proj.weight"
        src.update(gate=lin(gu, slice(0, I)), up=lin(gu, slice(I, None)),
                   down=lin("mlp.down_proj.weight"))
    else:
        src.update(gate=lin("mlp.gate_proj.weight"),
                   up=lin("mlp.up_proj.weight"),
                   down=lin("mlp.down_proj.weight"))
    if c.attn_bias:
        src.update(q_bias=raw("self_attn.q_proj.bias"),
                   k_bias=raw("self_attn.k_proj.bias"),
                   v_bias=raw("self_attn.v_proj.bias"))
    if c.attn_sinks:
        src["sinks"] = raw("self_attn.sinks")
    if c.o_bias:
        src["o_bias"] = raw("self_attn.o_proj.bias")
    if c.qk_norm:
        src.update(q_norm=raw("self_attn.q_norm.weight"),
                   k_norm=raw("self_attn.k_norm.weight"))
    return src


def _stack(layer_fn, num_layers: int, dtype, bits: int | None, device):
    """[L, ...] of `layer_fn(i)` rounded to `dtype`, built one layer at a
    time into its preallocated stack; quantized per output channel at
    `bits` (`QuantizedTensor`, axis -2) unless `bits` is None."""
    out = None
    for i in range(num_layers):
        w = layer_fn(i).to(dtype)
        if out is None:
            shape = (num_layers, *w.shape)
            if bits:
                pack = 2 if bits == 4 else 1
                out = QuantizedTensor(
                    torch.empty((*shape[:-1], shape[-1] // pack),
                                dtype=torch.int8, device=device),
                    torch.empty((*shape[:-2], 1, shape[-1]),
                                dtype=torch.float32, device=device), -2, bits)
            else:
                out = torch.empty(shape, dtype=dtype, device=device)
        if bits:
            qt = quantize_tensor(w, bits=bits)
            out.q[i], out.s[i] = qt.q, qt.s
        else:
            out[i] = w
    return out


def params_from_hf_state_dict(state_dict, config: LlamaConfig, dtype=None,
                              weight_dtype: str = "native", device=None):
    """HF tensors (torch or numpy) -> the port's tree on `device` (None ->
    the card, which raises without CUDA; "cpu" for the CPU), in the
    activation dtype `dtype` (default `config.dtype`; a torch dtype or its
    name). `weight_dtype` "native" keeps every leaf in `dtype`; "int8"
    (W8A16) or "int4" (W4A16) quantizes the matmul weights at conversion
    (`ops/wquant.quantize_weights`' classes), a layer's matrix or expert
    stack at a time, and the embedding per row at int8."""
    if weight_dtype not in ("native", "int8", "int4"):
        raise ValueError(f"weight_dtype must be native/int8/int4, got "
                         f"{weight_dtype!r}")
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    dtype = torch_dtype(dtype) if isinstance(dtype, str) else dtype
    bits = {"int8": 8, "int4": 4}.get(weight_dtype)

    def get(name):
        t = state_dict[name]
        if not isinstance(t, torch.Tensor):
            t = tensor_from_numpy(t)
        return t.detach().to(dev).float()

    layers = {}
    for name, fn in _layer_sources(lambda n: n in state_dict, config,
                                   get).items():
        layers[name] = _stack(fn, config.num_layers, dtype,
                              bits if name in LAYER_MM_KEYS else None, dev)
    embed = get("model.embed_tokens.weight").to(dtype)
    params = {
        "embed": quantize_tensor(embed, axis=-1) if bits else embed,
        "layers": layers,
        "final_norm": get("model.norm.weight").to(dtype),
    }
    if not config.tie_embeddings:
        head = get("lm_head.weight").to(dtype).T.contiguous()
        params["lm_head"] = (quantize_tensor(head, bits=bits) if bits
                             else head)
    return params
