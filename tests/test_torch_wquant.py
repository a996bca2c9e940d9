"""W8A16 weights: the port's `quantize_tensor` q and s are bit-exact with the
JAX package's `ops/wquant.py`; `mm` and `take_rows` agree within float32
rounding (rtol 1e-5, atol 1e-5: the two matmuls sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.ops import wquant as jw
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.models.llama import init_params as j_init_params
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.ops import wquant as tw

TOL = 1e-5


def _w(shape, seed):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    w[0, 0] = 0.0
    return w


@pytest.mark.parametrize("axis", [-2, -1, 0])
def test_quantize_tensor_bit_exact(axis):
    w = _w((24, 40), seed=axis + 3)
    w[:, 1] = 0.0                                 # an all-zero channel: 1e-8 floor
    jq = jw.quantize_tensor(jnp.asarray(w), axis=axis)
    tq = tw.quantize_tensor(torch.from_numpy(w), axis=axis)
    assert tq.axis == jq.axis
    assert tq.q.dtype == torch.int8
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.s.numpy().view(np.uint32),
                                  np.asarray(jq.s).view(np.uint32))


def test_quantize_tensor_stacked_layers():
    w = np.random.RandomState(1).randn(3, 16, 8).astype(np.float32)
    jq = jw.quantize_tensor(jnp.asarray(w))
    tq = tw.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))
    # layer slicing keeps the scale axis
    one = tq[1]
    assert one.shape == (16, 8) and one.s.shape == (1, 8) and one.axis == -2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mm_matches_jax(dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(5, 24).astype(np.float32)
    w = _w((24, 40), seed=4)
    jq = jw.quantize_tensor(jnp.asarray(w))
    tq = tw.quantize_tensor(torch.from_numpy(w))
    want = np.asarray(jw.mm(jnp.asarray(x, dtype=dtype), jq)
                      .astype(jnp.float32))
    got = tw.mm(torch.from_numpy(x).to(getattr(torch, dtype)), tq).float()
    tol = TOL if dtype == "float32" else 2e-2     # one bfloat16 rounding
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # the plain-tensor branch is a plain matmul
    np.testing.assert_allclose(
        tw.mm(torch.from_numpy(x), torch.from_numpy(w)).numpy(), x @ w,
        rtol=TOL, atol=TOL)


def test_embedding_rows_and_tied_head():
    """Per-row embedding: the gather dequantizes rows, and `.T` serves a
    tied lm_head as a per-out-column weight."""
    emb = _w((32, 16), seed=5)
    jq = jw.quantize_tensor(jnp.asarray(emb), axis=-1)
    tq = tw.quantize_tensor(torch.from_numpy(emb), axis=-1)
    ids = np.array([[0, 3, 31], [7, 7, 1]], np.int32)
    want = np.asarray(jw.take_rows(jq, jnp.asarray(ids), dtype=jnp.float32))
    got = tw.take_rows(tq, torch.from_numpy(ids).long(), dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    x = np.random.RandomState(6).randn(3, 16).astype(np.float32)
    want = np.asarray(jw.mm(jnp.asarray(x), jq.T))
    got = tw.mm(torch.from_numpy(x), tq.T)
    assert tq.T.axis == -2
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        tw.mm(torch.from_numpy(x), tq.T.T)        # per-row weights can't mm


def test_quantize_weights_tree_matches_jax():
    """The whole W8A16 tree, carried from JAX with `params_from_jax`, equals
    the port's own quantization of the carried float weights."""
    import jax

    cfg = j_tiny()
    jp = j_init_params(cfg, jax.random.PRNGKey(3))
    jqp = jw.quantize_weights(jp)
    carried = params_from_jax(jax.tree.map(np.asarray, jqp))
    mine = tw.quantize_weights(params_from_jax(jax.tree.map(np.asarray, jp)))
    assert tw.is_quantized(mine) and tw.is_quantized(carried)
    assert set(mine["layers"]) == set(carried["layers"])
    for k in ("embed", "lm_head"):
        np.testing.assert_array_equal(mine[k].q.numpy(), carried[k].q.numpy())
        np.testing.assert_array_equal(mine[k].s.numpy(), carried[k].s.numpy())
        assert mine[k].axis == carried[k].axis
    for k, w in mine["layers"].items():
        c = carried["layers"][k]
        if isinstance(w, tw.QuantizedTensor):
            np.testing.assert_array_equal(w.q.numpy(), c.q.numpy())
            np.testing.assert_array_equal(w.s.numpy(), c.s.numpy())
        else:
            np.testing.assert_array_equal(w.numpy(), c.numpy())
    # W4A16 is served: bits 4 packs two nibbles a byte along the last
    # axis (values bit-exact with the JAX package in test_torch_w4a16.py);
    # other widths refuse, as in the JAX package
    four = tw.quantize_tensor(torch.zeros(4, 4), bits=4)
    assert four.bits == 4 and four.shape == (4, 4) and four.q.shape == (4, 2)
    with pytest.raises(ValueError, match="bits"):
        tw.quantize_tensor(torch.zeros(4, 4), bits=3)
