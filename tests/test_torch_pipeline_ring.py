"""The port's pipeline (`parallel/pipeline.py`) and ring attention
(`parallel/ring.py`) in one process, against the JAX package's.

At world 1 the line has one rank: pp with S = 1 (M 1, 2, 4) and sp with
S = 1 must give `forward_dense`'s logits, and the JAX package's. The ring's
per-chunk update (`ring_update`), driven here over all S chunks of every
line index in turn, must give the whole sequence's masked attention and
the JAX package's `_ring_attention_local` over S virtual devices, with
softcap, window and sinks. `stage_params` must equal JAX's
`_stage_params`, slice by slice. The refusals keep the JAX messages and
come before any communication, so one process reaches them. The spawned
gloo worlds are `tests/test_torch_line_spawn.py`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from torch_line_scenarios import MODELS

from cxl_speckv_tpu.engine.scoring import score_prompts as j_score_prompts
from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.ops.wquant import quantize_weights as j_quantize
from cxl_speckv_tpu.parallel.pipeline import _stage_params as j_stage_params
from cxl_speckv_tpu.parallel.pipeline import pipeline_forward as j_pipeline
from cxl_speckv_tpu.parallel.ring import _ring_attention_local as j_ring
from cxl_speckv_tpu.parallel.ring import sp_forward_dense as j_sp
from cxl_speckv_tpu_torch.engine.scoring import score_prompts
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.llama import (
    attention_mask,
    forward_dense,
    init_params,
    masked_attention,
)
from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor, quantize_weights
from cxl_speckv_tpu_torch.parallel import pipeline, ring
from cxl_speckv_tpu_torch.parallel.mesh import LineMesh, single_device_mesh
from cxl_speckv_tpu_torch.parallel.sharding import shard_params

PP_TOL, SP_TOL, RING_TOL = 2e-5, 1e-4, 1e-5


def configs(model="llama", **kw):
    base = dict(num_layers=4, **MODELS[model], **kw)
    return (dataclasses.replace(j_tiny(), **base),
            dataclasses.replace(tiny_test_config(), **base))


def tree(cfg, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return init_params(cfg, gen)


def jax_tree(t):
    return {k: (jax_tree(v) if isinstance(v, dict)
                else jnp.asarray(v.numpy())) for k, v in t.items()}


def tokens(b, t, seed, vocab=256):
    return np.random.RandomState(seed).randint(1, vocab, (b, t))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def gemma():
    jc, tc = configs("gemma3")
    t = tree(tc, 11)
    return jc, tc, t


def test_world_one_forwards_equal_dense_and_jax(gemma):
    """pp at S = 1 (M 1, 2, 4) and sp at S = 1 on a Gemma-3 tree (dual
    RoPE, q/k norm, alternating windows): `forward_dense`'s logits, and
    the JAX package's pipeline / ring forward on one device."""
    jc, tc, t = gemma
    toks = tokens(4, 16, 12)
    ids = torch.from_numpy(toks)
    dense = forward_dense(t, tc, ids)
    jt, jtoks = jax_tree(t), jnp.asarray(toks, jnp.int32)
    one = Mesh(np.asarray(jax.devices()[:1]), ("pp",))
    want = np.asarray(j_pipeline(jt, jc, jtoks, mesh=one,
                                 num_microbatches=2))
    close(dense.numpy(), want, PP_TOL)
    with LineMesh("pp") as mesh:
        assert (mesh.size, mesh.index, mesh.world) == (1, 0, 1)
        for m in (1, 2, 4):
            got = pipeline.pipeline_forward(t, tc, ids, mesh=mesh,
                                            num_microbatches=m)
            close(got.numpy(), dense.numpy(), PP_TOL)
        assert mesh.stats() == {}
    with LineMesh("sp") as mesh:
        got = ring.sp_forward_dense(t, tc, ids, mesh=mesh)
    close(got.numpy(), dense.numpy(), SP_TOL)
    sp_one = Mesh(np.asarray(jax.devices()[:1]), ("sp",))
    close(got.numpy(), np.asarray(j_sp(jt, jc, jtoks, mesh=sp_one)), SP_TOL)


def jax_ring(q, k, v, sinks, cfg, window, S):
    """JAX `_ring_attention_local` over S virtual devices, [B, T, Hq * D]."""
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("sp",))
    Tl = q.shape[1] // S

    def fn(q, k, v):
        idx = jax.lax.axis_index("sp")
        q_pos = idx * Tl + jnp.arange(Tl)
        return j_ring(q, k, v, q_pos, idx * Tl, Tl, cfg, sinks=sinks,
                      window=window)

    return jax.shard_map(fn, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                         out_specs=P(None, "sp"), check_vma=False)(q, k, v)


@pytest.mark.parametrize("S,window,sinks,cap", [
    (2, None, False, None), (4, 5, False, None), (4, None, True, None),
    (4, 3, True, 20.0)])
def test_ring_update_over_all_chunks_equals_dense_attention(S, window, sinks,
                                                            cap):
    """Each line index folds the chunks in ring order (its own, then
    i - 1, i - 2, ...) with `ring_update`, the sinks join in
    `ring_finish`: the whole sequence's masked attention, and JAX's ring."""
    jc, tc = configs(attn_softcap=cap)
    B, T, D, hq, hkv = 2, 16, tc.head_dim, tc.num_q_heads, tc.num_kv_heads
    rng = np.random.RandomState(S + (window or 0))
    q, k, v = (rng.randn(B, T, h, D).astype(np.float32)
               for h in (hq, hkv, hkv))
    sk = rng.randn(hq).astype(np.float32) if sinks else None
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tsk = None if sk is None else torch.from_numpy(sk)
    pos = torch.arange(T)
    want = masked_attention(tq, tk, tv, tsk,
                            mask=attention_mask(pos, pos, window), config=tc)
    Tl = T // S
    outs = []
    for i in range(S):
        q_pos = pos[i * Tl:(i + 1) * Tl]
        qg = (tq[:, i * Tl:(i + 1) * Tl].reshape(B, Tl, hkv, -1, D)
              .permute(0, 2, 3, 1, 4))
        m = torch.full((B, hkv, hq // hkv, Tl, 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, hkv, hq // hkv, Tl, D))
        for j in range(S):
            c = (i - j) % S
            m, l, acc = ring.ring_update(
                qg, tk[:, c * Tl:(c + 1) * Tl], tv[:, c * Tl:(c + 1) * Tl],
                q_pos, c * Tl, m, l, acc, config=tc, window=window)
        outs.append(ring.ring_finish(m, l, acc, tsk))
    got = torch.cat(outs, dim=1)
    close(got.numpy(), want.numpy(), RING_TOL)
    jwant = jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     None if sk is None else jnp.asarray(sk), jc, window, S)
    close(got.numpy(), np.asarray(jwant), RING_TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_stage_params_equals_jax_slice_by_slice(int8):
    """Stage s's leaves are slice s of JAX's [S, L/S, ...] regrouping (the
    quantized q and scale of a W8A16 tree too); the rest of the tree is
    shared."""
    jc, tc = configs("gpt_oss")
    t = tree(tc, 12)
    jt = jax_tree(t)
    if int8:
        t, jt = quantize_weights(t), j_quantize(jt)
    for S in (1, 2, 4):
        jst = jax.jit(j_stage_params, static_argnums=1)(jt, S)["layers"]
        for s in range(S):
            st = pipeline.stage_params(t, s, S)
            assert st["embed"] is t["embed"]
            for k, leaf in st["layers"].items():
                if isinstance(leaf, QuantizedTensor):
                    assert leaf.shape[0] == 4 // S
                    np.testing.assert_array_equal(
                        leaf.q.numpy(), np.asarray(jst[k].q)[s])
                    np.testing.assert_array_equal(
                        leaf.s.numpy(), np.asarray(jst[k].s)[s])
                else:
                    np.testing.assert_array_equal(leaf.numpy(),
                                                  np.asarray(jst[k])[s])


def test_score_prompts_world_one_equals_dense_and_jax():
    jc, tc = configs()
    t = tree(tc)
    rng = np.random.RandomState(5)
    ps = [rng.randint(1, 256, n).tolist() for n in (9, 14, 6, 11)]
    dense = score_prompts(t, tc, ps)
    want = j_score_prompts(jax_tree(t), jc, ps, mode="dense")
    for mode in ("pp", "sp"):
        got = score_prompts(t, tc, ps, mode=mode, num_microbatches=3)
        assert [len(s) for s in got] == [n - 1 for n in (9, 14, 6, 11)]
        for a, b, c in zip(got, dense, want):
            close(a, b, 2e-4)
            close(a, c, 2e-4)


def test_refusals_before_any_communication():
    """The JAX package's refusals ("not divisible"), reached in one
    process: each is checked before a line is laid."""
    jc, tc = configs()
    t = tree(tc)
    ids = torch.from_numpy(tokens(3, 8, 1))
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        pipeline.stage_params(t, 0, 3)
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        score_prompts(t, tc, [[1, 2, 3]], mode="pp", parallel_size=3)
    with LineMesh("pp") as mesh:
        with pytest.raises(ValueError, match="batch 3 not divisible by "
                                             "microbatches 2"):
            pipeline.pipeline_forward(t, tc, ids, mesh=mesh,
                                      num_microbatches=2)
    with pytest.raises(ValueError, match="seq len 30 not divisible by sp=4"):
        ring.check_split(tc, 30, 4)
    # an alternating pattern split across stages, or across a layer count
    _, gc = configs("gemma2")
    g = tree(gc, 9)
    with pytest.raises(ValueError, match="attn_pattern period 2"):
        score_prompts(g, gc, [[1, 2, 3]], mode="pp", parallel_size=4)
    g3 = dataclasses.replace(gc, num_layers=3)
    with LineMesh("sp") as mesh, pytest.raises(
            ValueError, match="num_layers not divisible by attn_pattern"):
        ring.sp_forward_dense(tree(g3, 9), g3, ids, mesh=mesh)


def test_score_prompts_refuses_what_the_port_cannot_hold():
    _, tc = configs()
    t = tree(tc)
    for mode in ("pp", "sp"):
        with pytest.raises(ValueError, match=f"{mode}=2 needs 2 ranks"):
            score_prompts(t, tc, [[1, 2, 3]], mode=mode, parallel_size=2)
        with pytest.raises(ValueError, match="devices has no counterpart"):
            score_prompts(t, tc, [[1, 2, 3]], mode=mode, devices=["cpu"])
        with pytest.raises(ValueError, match="not one cut for a"):
            score_prompts(shard_params(t, tc, single_device_mesh()), tc,
                          [[1, 2, 3]], mode=mode)
    with pytest.raises(ValueError, match="pp=2 needs 2 ranks"):
        LineMesh("pp", 2)


def test_line_of_one_issues_nothing():
    with LineMesh("sp") as mesh:
        mesh.timing = True
        x = torch.ones(3)
        assert mesh.shift(x, None) is None
        r = torch.zeros(3)
        assert mesh.shift(x, r) is r and torch.equal(r, torch.zeros(3))
        assert mesh.broadcast(x, 0) is x and mesh.all_gather(x, 0) is x
        assert mesh.stats() == {} and mesh.route == "cpu"
        with pytest.raises(ValueError, match="a meta tensor on a line built "
                                             "for cpu"):
            mesh.shift(torch.empty(3, device="meta"), None)
