"""`cxl_speckv_tpu_torch.models.hf_convert` against the JAX package's
converter and against HF's own models, on random-weight HF models built on
the CPU from tiny configs (nothing is downloaded):

- `config_from_hf` gives the JAX package's `LlamaConfig`, field for field,
  for every family the converter reads, from the HF config object and from
  a `types.SimpleNamespace` holding its fields (what a machine without
  `transformers` passes);
- `params_from_hf_state_dict` gives, bit for bit, the JAX converter's tree
  carried over by `params_from_jax`: at float32, and at `weight_dtype=
  "int8"` (q bytes and scales) with float32 and bfloat16 activations;
- the port's `forward_dense` on the converted tree gives HF's logits within
  3e-4 (the JAX tests' bound) for Qwen3, Gemma-3 (5:1 pattern, local base,
  linear scaling), Phi-3 (fused projections) and Qwen3-MoE;
- an unknown `weight_dtype` and Phi-3 longrope raise ("int4" converts).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import transformers as tf

from cxl_speckv_tpu.models import hf_convert as jhf
from cxl_speckv_tpu_torch.models import hf_convert as thf
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.models.llama import forward_dense
from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

HF_TOL = 3e-4
TOKENS = np.array([3, 17, 9, 25, 1, 4, 4, 7, 19, 2, 11, 30, 5, 8, 21, 13],
                  dtype=np.int64)   # 16 > every window below: windows bind
BASE = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
            max_position_embeddings=64, attn_implementation="eager")
MOE = dict(intermediate_size=48, moe_intermediate_size=24, num_experts=4,
           num_experts_per_tok=2, decoder_sparse_step=1, mlp_only_layers=[],
           use_sliding_window=False)
# family -> (config class, model class, config fields beyond BASE)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(
        head_dim=8, rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 32})),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(head_dim=8, sliding_window=6)),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM",
              dict(use_sliding_window=False)),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM",
              dict(head_dim=8, rms_norm_eps=1e-6, use_sliding_window=False)),
    "phi3": ("Phi3Config", "Phi3ForCausalLM",
             dict(sliding_window=None, pad_token_id=0)),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM", dict(
        num_hidden_layers=4, head_dim=8, tie_word_embeddings=True,
        sliding_window=6, query_pre_attn_scalar=16.0,
        attn_logit_softcapping=30.0, final_logit_softcapping=10.0)),
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM", dict(
        num_hidden_layers=6, head_dim=8, rope_theta=50000.0,
        rope_local_base_freq=10000.0,
        rope_scaling={"rope_type": "linear", "factor": 2.0},
        tie_word_embeddings=True, sliding_window=6,
        sliding_window_pattern=6, query_pre_attn_scalar=16.0)),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(num_local_experts=4, num_experts_per_tok=2)),
    "qwen2_moe": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM", dict(
        MOE, shared_expert_intermediate_size=40, norm_topk_prob=False)),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM", dict(
        MOE, head_dim=8, rms_norm_eps=1e-6, norm_topk_prob=True)),
    "gpt_oss": ("GptOssConfig", "GptOssForCausalLM", dict(
        intermediate_size=32, head_dim=8, sliding_window=6,
        num_local_experts=4, num_experts_per_tok=2, pad_token_id=0,
        rope_scaling={"rope_type": "yarn", "factor": 2.0,
                      "original_max_position_embeddings": 32,
                      "beta_fast": 32, "beta_slow": 1})),
}
HF_PARITY = ("qwen3", "gemma3", "phi3", "qwen3_moe")


def hf_config(family, **kw):
    cls, _, extra = FAMILIES[family]
    return getattr(tf, cls)(**dict(BASE, **extra, **kw))


_MODELS = {}


def hf_model(family):
    """The family's HF model with seeded random weights (built once)."""
    if family not in _MODELS:
        torch.manual_seed(0)
        model = getattr(tf, FAMILIES[family][1])(hf_config(family)).eval()
        # Gemma / Qwen3 norms initialise to 0 / 1: draw them so the 1 + w
        # and the q/k norm weights bind
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "norm" in name:
                    p.add_(torch.randn_like(p) * 0.1)
        _MODELS[family] = model
    return _MODELS[family]


def as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_from_hf_matches_jax(family):
    """The port's config equals the JAX package's, also from a plain
    namespace of the HF config's fields."""
    hc = hf_config(family)
    want = as_dict(jhf.config_from_hf(hc))
    assert as_dict(thf.config_from_hf(hc)) == want
    ns = types.SimpleNamespace(**hc.to_dict())
    assert as_dict(thf.config_from_hf(ns)) == want


def test_config_from_hf_family_fields():
    """The fields each family turns on, and Gemma-3's 5:1 period."""
    g3 = thf.config_from_hf(hf_config("gemma3"))
    assert g3.attn_pattern == (True,) * 5 + (False,)
    assert g3.qk_norm and g3.norm_offset and g3.rope_local_theta == 10000.0
    assert g3.rope_linear_factor == 2.0 and g3.attn_softcap is None
    assert g3.query_scale == 16.0 ** -0.5
    q3 = thf.config_from_hf(hf_config("qwen3_moe"))
    assert q3.qk_norm and q3.moe_norm_topk and q3.num_experts == 4
    assert q3.intermediate_size == 24 and not q3.attn_bias
    q2 = thf.config_from_hf(hf_config("qwen2_moe"))
    assert q2.moe_shared_expert == 40 and not q2.moe_norm_topk
    assert q2.attn_bias
    assert thf.config_from_hf(hf_config("phi3")).num_kv_heads == 2


def _assert_trees_equal(got: dict, want: dict):
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    leaves = [(k, got[k], want[k]) for k in got if k != "layers"]
    leaves += [(k, got["layers"][k], want["layers"][k])
               for k in got["layers"]]
    for name, g, w in leaves:
        assert isinstance(g, QuantizedTensor) == isinstance(w, QuantizedTensor)
        pairs = ([(g.q, w.q), (g.s, w.s)] if isinstance(g, QuantizedTensor)
                 else [(g, w)])
        if isinstance(g, QuantizedTensor):
            assert g.axis == w.axis, name
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), name


@pytest.mark.parametrize("weights", ["float32", "int8", "int8-bf16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_match_jax_bit_for_bit(family, weights):
    model = hf_model(family)
    cfg_j = jhf.config_from_hf(model.config)
    cfg_t = thf.config_from_hf(model.config)
    wd = "int8" if weights.startswith("int8") else "native"
    dt = "bfloat16" if weights.endswith("bf16") else "float32"
    sd = model.state_dict()
    want = jhf.params_from_hf_state_dict(sd, cfg_j, dtype=jax.numpy.dtype(dt),
                                         weight_dtype=wd)
    want = params_from_jax(jax.tree.map(np.asarray, want))
    got = thf.params_from_hf_state_dict(sd, cfg_t, dtype=dt, weight_dtype=wd,
                                        device="cpu")
    _assert_trees_equal(got, want)


def test_numpy_state_dict_converts_alike():
    """A state dict of numpy arrays gives the tree torch tensors give."""
    model = hf_model("qwen3_moe")
    cfg = thf.config_from_hf(model.config)
    sd = model.state_dict()
    npsd = {k: v.numpy() for k, v in sd.items()}
    for wd in ("native", "int8"):
        _assert_trees_equal(
            thf.params_from_hf_state_dict(npsd, cfg, weight_dtype=wd,
                                          dtype=torch.float32, device="cpu"),
            thf.params_from_hf_state_dict(sd, cfg, weight_dtype=wd,
                                          dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("family", HF_PARITY)
def test_logits_match_hf(family):
    model = hf_model(family)
    cfg = thf.config_from_hf(model.config)
    params = thf.params_from_hf_state_dict(model.state_dict(), cfg,
                                           dtype=torch.float32, device="cpu")
    with torch.no_grad():
        want = model(torch.tensor(TOKENS[None])).logits[0].float()
    got = forward_dense(params, cfg, torch.tensor(TOKENS[None]))[0]
    torch.testing.assert_close(got, want, rtol=HF_TOL, atol=HF_TOL)


def test_refusals():
    model = hf_model("qwen3")
    cfg = thf.config_from_hf(model.config)
    # "int4" converts to W4A16 (bit-exact with the JAX converter in
    # test_torch_w4a16.py); only unknown widths refuse
    four = thf.params_from_hf_state_dict(model.state_dict(), cfg,
                                         weight_dtype="int4", device="cpu")
    assert four["layers"]["q"].bits == 4 and four["embed"].bits == 8
    with pytest.raises(ValueError, match="weight_dtype"):
        thf.params_from_hf_state_dict(model.state_dict(), cfg,
                                      weight_dtype="fp8", device="cpu")
    longrope = hf_config("phi3", rope_scaling={
        "type": "longrope", "long_factor": [1.0] * 4,
        "short_factor": [1.0] * 4}, original_max_position_embeddings=32)
    with pytest.raises(NotImplementedError, match="longrope"):
        thf.config_from_hf(longrope)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            thf.params_from_hf_state_dict(model.state_dict(), cfg)
