"""The port's offline batch scoring (`engine/scoring.py`) against the JAX
package's, on tiny configs with the JAX weights carried over by
`params_from_jax`:

- LLAMA: the tiny config;
- GEMMA2: alternating window 6 / global layers, softcaps, GeGLU, sandwich
  norms, a tied head;
- GPT_OSS: sinks, q/k/v + o biases, a 4-expert top-2 MoE MLP, window 6;
- QWEN2_MOE: Qwen2-57B-A14B's features: q/k/v bias, G 7 (7 query heads on
  one KV head), a 4-expert top-2 MoE without top-k renormalisation and the
  sigmoid-gated shared expert.

Held: `score_prompts(mode="dense")` within 2e-4 of the JAX package's at
float32 (the two forwards sum in other orders), on the prompt-length mix of
`tests/test_pipeline_sp.py:test_score_prompts_dense_pp_sp_agree`, past the
window of 6; `Engine.score_prompts` == `score_prompts`; the refusals (pp /
sp themselves: `tests/test_torch_pipeline_ring.py`,
`tests/test_torch_line_spawn.py`).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.engine.scoring import score_prompts as j_score_prompts
from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.engine.scoring import score_prompts
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.parallel.mesh import LineMesh
from cxl_speckv_tpu_torch.parallel.pipeline import pipeline_forward

GEMMA2 = dict(sliding_window=6, attn_pattern=(True, False), attn_softcap=30.0,
              final_softcap=10.0, norm_offset=True, post_norms=True,
              act_fn="gelu_tanh", embed_scale=True, query_scale=10.0**-0.5,
              tie_embeddings=True)
GPT_OSS = dict(attn_sinks=True, o_bias=True, attn_bias=True, num_experts=4,
               num_experts_per_tok=2, moe_style="gpt_oss", sliding_window=6,
               attn_pattern=(True, False))
QWEN2_MOE = dict(attn_bias=True, num_q_heads=7, num_kv_heads=1,
                 num_experts=4, num_experts_per_tok=2, moe_norm_topk=False,
                 moe_shared_expert=40, rms_eps=1e-6)
FAMILIES = {"llama": {}, "gemma2": GEMMA2, "gpt_oss": GPT_OSS,
            "qwen2_moe": QWEN2_MOE}
LENGTHS = (9, 14, 6, 11)
TOL = 2e-4


def configs(family):
    kw = FAMILIES[family]
    return (dataclasses.replace(j_tiny(), **kw),
            dataclasses.replace(tiny_test_config(), **kw))


def jax_params(family, seed=8):
    return jl.init_params(configs(family)[0], jax.random.PRNGKey(seed))


def carried(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def prompts(vocab, lengths=LENGTHS, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, n).tolist() for n in lengths]


def assert_scores_close(got, want, tol=TOL):
    assert [len(s) for s in got] == [len(s) for s in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def test_qwen2_moe_config_has_seven_query_heads_a_kv_head():
    assert configs("qwen2_moe")[1].q_group == 7


@pytest.mark.parametrize("family", list(FAMILIES))
def test_score_prompts_matches_jax(family):
    jc, tc = configs(family)
    jp = jax_params(family)
    ps = prompts(tc.vocab_size)
    want = j_score_prompts(jp, jc, ps, mode="dense")
    got = score_prompts(carried(jp), tc, ps, mode="dense")
    assert [len(s) for s in got] == [n - 1 for n in LENGTHS]
    assert all(isinstance(x, float) for s in got for x in s)
    assert_scores_close(got, want)


def engine(family="llama", params=None, weight_dtype="native"):
    _, tc = configs(family)
    sc = SystemConfig(
        cache=CacheConfig(block_size=8, num_hbm_blocks=16, num_host_blocks=32,
                          kv_dtype=KVDtype.INT8),
        prefetch=PrefetchConfig(enabled=False),
        engine=EngineConfig(max_batch_size=2, max_seq_len=64,
                            prefill_chunk=16, decode_horizon=1,
                            weight_dtype=weight_dtype))
    return Engine(tc, sc, params=params, device="cpu", enable_lstm=False)


@pytest.mark.parametrize("family", ["llama", "qwen2_moe"])
def test_engine_score_prompts_equals_score_prompts(family):
    _, tc = configs(family)
    eng = engine(family, carried(jax_params(family)))
    ps = prompts(tc.vocab_size)
    assert eng.score_prompts(ps) == score_prompts(eng.params, tc, ps)


def test_score_prompts_on_w8a16_engine_matches_jax():
    """An engine that quantizes the weights at construction
    (`weight_dtype="int8"`) scores with its W8A16 tree, as JAX's scorer
    does on the JAX package's quantized tree."""
    from cxl_speckv_tpu.ops.wquant import quantize_weights as j_quantize

    jc, tc = configs("qwen2_moe")
    jp = jax_params("qwen2_moe")
    eng = engine("qwen2_moe", carried(jp), weight_dtype="int8")
    ps = prompts(tc.vocab_size)
    want = j_score_prompts(j_quantize(jp), jc, ps, mode="dense")
    assert_scores_close(eng.score_prompts(ps), want)


def test_score_prompts_refusals():
    eng = engine()
    with pytest.raises(ValueError, match="2 tokens"):
        eng.score_prompts([[1]])
    with pytest.raises(ValueError, match="2 tokens"):
        eng.score_prompts([])
    for mode in ("pp", "sp"):
        # a line longer than the world (one process here), the JAX
        # package's layer split refusal, JAX's device list
        with pytest.raises(ValueError, match=f"{mode}=2 needs 2 ranks"):
            eng.score_prompts([[1, 2, 3]], mode=mode, parallel_size=2)
        with pytest.raises(ValueError, match="devices has no counterpart"):
            score_prompts(eng.params, eng.model_config, [[1, 2, 3]],
                          mode=mode, devices=[0])
    with pytest.raises(ValueError, match="num_layers=2 not divisible by "
                                         "pp=3"):
        eng.score_prompts([[1, 2, 3]], mode="pp", parallel_size=3)
    with pytest.raises(ValueError, match="batch 3 not divisible by "
                                         "microbatches 2"):
        pipeline_forward(eng.params, eng.model_config,
                         torch.ones((3, 4), dtype=torch.long),
                         mesh=LineMesh("pp"), num_microbatches=2)
    with pytest.raises(ValueError, match="unknown scoring mode"):
        eng.score_prompts([[1, 2, 3]], mode="ring")


def test_score_prompts_runs_on_the_params_device():
    """The forward runs where the embedding lives, plain or quantized, and
    the scores come back as host floats."""
    from cxl_speckv_tpu_torch.engine.scoring import params_device

    for wd in ("native", "int8"):
        eng = engine(weight_dtype=wd)
        assert params_device(eng.params) == torch.device("cpu")
        (s,) = eng.score_prompts([[3, 4, 5]])
        assert len(s) == 2 and all(np.isfinite(s))
