"""The port's parameter checkpoints (`models/checkpoint.py`): a directory of
one `torch.save` of the flat tensors and a JSON index of the tree.

Held: a bit-exact round trip of the W8A16 tree (and of a bf16 tree) for
every family the port serves, on tiny configs: Llama, Gemma-2 (tied head,
per-row embedding), GPT-OSS (sinks, router and its bias, biases, expert
stacks), Qwen2-MoE (G 7, q/k/v bias, shared expert) and Qwen3 (q/k norm);
a layer slice saves only its own values; `like=` refuses a checkpoint
that differs from a tree in a shape, a dtype, a missing or an extra leaf,
naming the leaf; a tree saved and restored by the JAX package's orbax
checkpointer, carried across with `params_from_jax`, then saved and loaded
by the port, gives `forward_dense` within 2e-4 of the JAX package's (as
`tests/test_wquant.py:test_checkpoint_roundtrip_quantized`); and
`load_params(device=None)` needs a card.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scoring import FAMILIES, carried, configs, jax_params

from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.models.checkpoint import load_params as j_load_params
from cxl_speckv_tpu.models.checkpoint import save_params as j_save_params
from cxl_speckv_tpu.ops.wquant import quantize_weights as j_quantize
from cxl_speckv_tpu_torch.models import load_params, save_params
from cxl_speckv_tpu_torch.models.checkpoint import INDEX, TENSORS, read_index
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.llama import (
    forward_dense,
    init_params,
    init_params_quantized,
)
from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

TREE_FAMILIES = {**FAMILIES, "qwen3": dict(qk_norm=True, rms_eps=1e-6)}
TOL = 2e-4


def port_config(family):
    return dataclasses.replace(tiny_test_config(), **TREE_FAMILIES[family])


def quantized_tree(family, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return init_params_quantized(port_config(family), gen)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def raw(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def assert_trees_equal(got, want):
    """Same paths, kinds, axes, dtypes, shapes and bytes."""
    g, w = dict(leaves(got)), dict(leaves(want))
    assert list(g) == list(w)
    for key, b in w.items():
        a = g[key]
        assert type(a) is type(b), key
        pairs = ([(a.q, b.q), (a.s, b.s)] if isinstance(b, QuantizedTensor)
                 else [(a, b)])
        if isinstance(b, QuantizedTensor):
            assert a.axis == b.axis, key
        for x, y in pairs:
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert torch.equal(raw(x), raw(y)), key


@pytest.mark.parametrize("family", list(TREE_FAMILIES))
def test_quantized_round_trip_is_bit_exact(family, tmp_path):
    tree = quantized_tree(family)
    save_params(tree, tmp_path / "ckpt")
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == sorted(
        [INDEX, TENSORS])
    back = load_params(tmp_path / "ckpt", like=tree, device="cpu")
    assert_trees_equal(back, tree)
    # the index names every quantized leaf with its scale axis
    idx = read_index(tmp_path / "ckpt")
    assert idx["embed"]["kind"] == "quantized" and idx["embed"]["axis"] == -1
    assert idx["layers/q"]["axis"] == -2
    if "attn_sinks" in TREE_FAMILIES[family]:
        assert idx["layers/sinks"]["kind"] == "tensor"
        assert idx["layers/router"]["kind"] == "tensor"


@pytest.mark.parametrize("family", ["llama", "gemma2"])
def test_bf16_round_trip_is_bit_exact(family, tmp_path):
    cfg = dataclasses.replace(port_config(family), dtype="bfloat16")
    tree = init_params(cfg, torch.Generator().manual_seed(4))
    assert tree["layers"]["q"].dtype == torch.bfloat16
    save_params(tree, tmp_path)
    assert_trees_equal(load_params(tmp_path, device="cpu"), tree)


def test_loaded_tree_serves_the_same_logits(tmp_path):
    """The loaded W8A16 tree is the saved one to the model: the same dense
    logits, bit for bit."""
    cfg = port_config("qwen2_moe")
    tree = quantized_tree("qwen2_moe")
    save_params(tree, tmp_path)
    back = load_params(tmp_path, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        1, cfg.vocab_size, (2, 11)))
    assert torch.equal(forward_dense(back, cfg, toks),
                       forward_dense(tree, cfg, toks))


def test_layer_slice_saves_only_its_values(tmp_path):
    """A tree cut to its first layer holds views of the full stacks; the
    file holds the slice, not the whole storage."""
    tree = quantized_tree("llama")
    cut = {**tree, "layers": {k: v[:1] for k, v in tree["layers"].items()}}
    save_params(tree, tmp_path / "full")
    save_params(cut, tmp_path / "cut")
    size = lambda d: (tmp_path / d / TENSORS).stat().st_size
    assert size("cut") < 0.75 * size("full")
    assert_trees_equal(load_params(tmp_path / "cut", device="cpu"), cut)


def test_like_mismatches_raise_naming_the_leaf(tmp_path):
    tree = quantized_tree("gpt_oss")
    save_params(tree, tmp_path)
    # a shape
    other = {**tree, "final_norm": torch.zeros(3)}
    with pytest.raises(ValueError, match="'final_norm'.*shape"):
        load_params(tmp_path, like=other, device="cpu")
    # a dtype
    lay = dict(tree["layers"])
    lay["sinks"] = lay["sinks"].double()
    with pytest.raises(ValueError, match="'layers/sinks'.*float64"):
        load_params(tmp_path, like={**tree, "layers": lay}, device="cpu")
    # a leaf of the like tree that the checkpoint lacks
    lay = dict(tree["layers"], extra_bias=torch.zeros(2))
    with pytest.raises(ValueError, match="'layers/extra_bias'.*missing"):
        load_params(tmp_path, like={**tree, "layers": lay}, device="cpu")
    # a leaf of the checkpoint that the like tree lacks
    lay = {k: v for k, v in tree["layers"].items() if k != "router_bias"}
    with pytest.raises(ValueError, match="'layers/router_bias'.*not in"):
        load_params(tmp_path, like={**tree, "layers": lay}, device="cpu")
    # a quantized leaf against a plain one
    lay = dict(tree["layers"], q=tree["layers"]["q"].dequantize())
    with pytest.raises(ValueError, match="'layers/q'"):
        load_params(tmp_path, like={**tree, "layers": lay}, device="cpu")


def test_save_refuses_what_is_not_a_tree_of_tensors(tmp_path):
    with pytest.raises(TypeError, match="'meta'"):
        save_params({"embed": torch.zeros(2), "meta": "x"}, tmp_path)
    with pytest.raises(ValueError, match="reserved"):
        save_params({"a/b": torch.zeros(2)}, tmp_path)


def test_index_is_json_of_paths_shapes_dtypes(tmp_path):
    tree = quantized_tree("qwen3")
    save_params(tree, tmp_path)
    meta = json.loads((tmp_path / INDEX).read_text())
    assert meta["leaves"]["layers/q_norm"] == {
        "kind": "tensor", "dtype": "float32",
        "shape": list(tree["layers"]["q_norm"].shape)}
    q = tree["layers"]["q"]
    assert meta["leaves"]["layers/q"]["q"] == {"dtype": "int8",
                                               "shape": list(q.q.shape)}
    meta["version"] = 99
    (tmp_path / INDEX).write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="not a checkpoint"):
        load_params(tmp_path, device="cpu")


@pytest.mark.parametrize("family", ["llama", "qwen2_moe"])
def test_orbax_tree_carried_across_scores_as_jax(family, tmp_path):
    """JAX saves and restores its W8A16 tree with orbax; the restored tree
    crosses with `params_from_jax`, goes through the port's checkpoint, and
    the port's dense logits match the JAX package's."""
    jc, tc = configs(family)
    jq = j_quantize(jax_params(family))
    j_save_params(jq, str(tmp_path / "orbax"))
    jback = j_load_params(str(tmp_path / "orbax"), like=jq)
    tree = carried(jback)
    save_params(tree, tmp_path / "port")
    back = load_params(tmp_path / "port", like=tree, device="cpu")
    toks = np.random.RandomState(6).randint(1, tc.vocab_size, (2, 13))
    want = np.asarray(jl.forward_dense(jq, jc, jnp.asarray(toks)))
    got = forward_dense(back, tc, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_load_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None loads onto it")
    save_params({"embed": torch.zeros(2)}, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_params(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_params(tmp_path, device="cuda")
