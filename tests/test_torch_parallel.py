"""The port's parallel package in one process, against the JAX package's.

- `param_specs` / `param_shardings` / `pool_specs`: the port's tables
  {tensor axis: mesh axis} equal JAX's `PartitionSpec`s leaf for leaf, for
  every preset of `models/configs.py` and, with native / int8 / int4
  weights, for tiny dense, tied-head, GPT-OSS and shared-expert MoE trees;
- `validate_tp` / `tp_compatible` decide as JAX's over a grid;
- `shard_params` cuts every leaf so that the rank pieces put back together
  give the whole tree, including W4A16's packed columns (repacked in each
  shard's own half-split order; an odd shard width raises);
- the lockstep frontend (`parallel/lockstep.py`, copied from JAX's) on port
  engines through `LocalFabric`: the cases of `tests/test_lockstep.py`,
  each run on both packages' frontends and engines with the same
  submissions; the engines' command streams are equal and so are the
  tokens (the port at float32 attention compute, the JAX engine on its
  reference attention);
- the one-rank mesh issues no collective, and an engine asked for a mesh
  outside a world refuses with the reason.

The multi-rank paths run in `tests/test_torch_parallel_spawn.py`.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import jax
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import CacheConfig as JCacheConfig
from cxl_speckv_tpu.config import EngineConfig as JEngineConfig
from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.config import PrefetchConfig as JPrefetchConfig
from cxl_speckv_tpu.config import SystemConfig as JSystemConfig
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.models.configs import PRESETS as J_PRESETS
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.ops.wquant import QuantizedTensor as JQT
from cxl_speckv_tpu.ops.wquant import quantize_specs as j_quantize_specs
from cxl_speckv_tpu.ops.wquant import quantize_weights as j_quantize_weights
from cxl_speckv_tpu.parallel import lockstep as jlock
from cxl_speckv_tpu.parallel import sharding as jsh
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    ParallelConfig,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models.configs import PRESETS
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.models.llama import forward_dense
from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor, quantize_weights
from cxl_speckv_tpu_torch.parallel import lockstep as tlock
from cxl_speckv_tpu_torch.parallel import sharding as tsh
from cxl_speckv_tpu_torch.parallel.mesh import (
    Mesh,
    coords_of,
    make_mesh,
    single_device_mesh,
)
from cxl_speckv_tpu_torch.parallel.shard_kernels import (
    lane_slice,
    shard_heads,
    sharded_chunk_attention,
    sharded_paged_attention,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the suite runs six xdist
    workers on a few cores, and many small ops slow down many times over
    when each process's thread pool contends for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FAMILIES = {
    "dense": {},
    "tied_post_norms": dict(tie_embeddings=True, post_norms=True,
                            norm_offset=True),
    "gpt_oss": dict(attn_sinks=True, o_bias=True, attn_bias=True,
                    num_experts=4, num_experts_per_tok=2,
                    moe_style="gpt_oss", sliding_window=6,
                    attn_pattern=(True, False)),
    "shared_moe": dict(num_experts=4, num_experts_per_tok=2,
                       moe_shared_expert=32, qk_norm=True),
}
BITS = {"native": None, "int8": 8, "int4": 4}


def jax_spec(p) -> dict:
    """A JAX PartitionSpec as the port's table."""
    return {d: a for d, a in enumerate(tuple(p)) if a is not None}


def jax_table(tree):
    """JAX spec tree -> the port's: tables, and (q, s) pairs for quantized
    leaves."""
    if isinstance(tree, JQT):
        return (jax_spec(tree.q), jax_spec(tree.s))
    if isinstance(tree, dict):
        return {k: jax_table(v) for k, v in tree.items()}
    return jax_spec(tree)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_param_specs_match_jax(preset):
    assert preset in J_PRESETS
    assert tsh.param_specs(PRESETS[preset]()) == jax_table(
        jsh.param_specs(J_PRESETS[preset]()))


def test_pool_specs_cover_the_kv_head_axis():
    """JAX shards the kT pool's head-major columns and V's head axis; the
    port's token-major pools and scales put the heads on axis 2."""
    jk, jv, jks, jvs = (jax_spec(p) for p in jsh.pool_specs())
    assert jk == {3: "tp"} and jv == {2: "tp"} and jks == jvs == {3: "tp"}
    assert tsh.pool_specs() == ({2: "tp"},) * 4
    assert tsh.pool_shardings(None) == tsh.pool_specs()


@functools.lru_cache(maxsize=None)
def trees(family, bits):
    """(JAX tree, port tree) of a tiny `family` model at `bits`."""
    jc = dataclasses.replace(j_tiny(), **FAMILIES[family])
    jp = jl.init_params(jc, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    if bits:
        jp = j_quantize_weights(jp, bits=bits)
        tp = quantize_weights(tp, bits=bits)
    return jc, jp, tp


@pytest.mark.parametrize("family,width", itertools.product(FAMILIES, BITS))
def test_param_shardings_match_jax_quantize_specs(family, width):
    jc, jp, tp = trees(family, BITS[width])
    tc = dataclasses.replace(tiny_test_config(), **FAMILIES[family])
    want = jax_table(j_quantize_specs(jsh.param_specs(jc), jp))
    assert tsh.param_shardings(tc, None, tp) == want


CONFIGS = [dataclasses.replace(j_tiny(), **kw) for kw in (
    {}, dict(num_q_heads=6, num_kv_heads=3),
    dict(num_experts=4, num_experts_per_tok=2),
    dict(num_experts=6, num_experts_per_tok=2, vocab_size=250,
         intermediate_size=96))]


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_validate_tp_and_tp_compatible_match_jax(ci):
    jc = CONFIGS[ci]
    tc = dataclasses.replace(tiny_test_config(), **{
        f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
        if f.name in ("num_q_heads", "num_kv_heads", "num_experts",
                      "num_experts_per_tok", "vocab_size",
                      "intermediate_size")})
    for tp, ep in itertools.product((1, 2, 3, 4, 8), (1, 2, 3, 4)):
        assert tsh.tp_compatible(tc, tp) == jsh.tp_compatible(jc, tp)
        try:
            jsh.validate_tp(jc, tp, ep)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            tsh.validate_tp(tc, tp, ep)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want, (tp, ep)


class FakeMesh:
    """A rank's coordinates without a world: what `shard_params` reads."""

    def __init__(self, rank, dp=1, ep=1, tp=2):
        self.shape = {"dp": dp, "ep": ep, "tp": tp}
        self.coords = coords_of(rank, ep, tp)
        self.tp, self.dp, self.ep = tp, dp, ep

    size = Mesh.size
    index = Mesh.index


def _full(leaf):
    return (leaf.dequantize() if isinstance(leaf, QuantizedTensor)
            else leaf.float())


@pytest.mark.parametrize("family,width", [("dense", "int8"),
                                          ("gpt_oss", "int4"),
                                          ("shared_moe", "native"),
                                          ("tied_post_norms", "int4")])
def test_shard_params_pieces_rebuild_the_tree(family, width):
    """Every leaf's rank pieces, put back in mesh order along the axes its
    spec names, give the whole leaf (dequantized): the quantized q and s
    are cut together, and int4 columns are repacked a shard at a time."""
    _, _, tree = trees(family, BITS[width])
    tc = dataclasses.replace(tiny_test_config(), **FAMILIES[family])
    ep = 2 if tc.num_experts else 1
    ranks = [FakeMesh(r, ep=ep, tp=2) for r in range(2 * ep)]
    pieces = [tsh.shard_params(tree, tc, m) for m in ranks]
    assert all(p.mesh is m for p, m in zip(pieces, ranks))
    specs = tsh.param_specs(tc)
    leaves = [("embed", specs["embed"])] + [
        (("layers", k), specs["layers"][k]) for k in tree["layers"]]
    if "lm_head" in tree:
        leaves.append(("lm_head", specs["lm_head"]))
    for key, spec in leaves:
        def get(t):
            return t[key[0]][key[1]] if isinstance(key, tuple) else t[key]

        whole = _full(get(tree))
        got = [_full(get(p)) for p in pieces]
        # reassemble: tp innermost, then ep
        for ax in ("tp", "ep"):
            dims = [d for d, a in spec.items() if a == ax]
            if not dims:
                n = ranks[0].size(ax)
                got = got[::n]
                continue
            n = ranks[0].size(ax)
            got = [torch.cat(got[i:i + n], dim=dims[0])
                   for i in range(0, len(got), n)]
        assert len(got) == 1
        torch.testing.assert_close(got[0], whole, rtol=0, atol=0)


def test_w4a16_packed_column_split():
    """A W4A16 column shard is repacked in its own half-split order: its
    bytes are what quantizing the column slice would store; a shard of odd
    width cannot be packed and raises."""
    g = torch.Generator()
    g.manual_seed(0)
    from cxl_speckv_tpu_torch.ops.wquant import quantize_tensor
    w = torch.randn(16, 12, generator=g)
    qt = quantize_tensor(w, bits=4)
    for tp in (2, 3):
        for r in range(tp):
            sh = tsh.shard_tensor(qt, {1: "tp"}, FakeMesh(r, tp=tp), "w")
            lo, hi = r * 12 // tp, (r + 1) * 12 // tp
            direct = quantize_tensor(w[:, lo:hi], bits=4)
            assert sh.shape == direct.shape == (16, hi - lo)
            assert torch.equal(sh.q, direct.q) and torch.equal(sh.s, direct.s)
    with pytest.raises(ValueError, match="odd width"):
        tsh.shard_tensor(qt, {1: "tp"}, FakeMesh(0, tp=4), "w")
    # rows of an int4 weight cut without repacking; the scale stays whole
    sh = tsh.shard_tensor(qt, {0: "tp"}, FakeMesh(1, tp=2), "w")
    assert torch.equal(sh.q, qt.q[8:]) and torch.equal(sh.s, qt.s)


def test_shard_pools_keep_each_ranks_kv_heads():
    g = torch.Generator()
    g.manual_seed(1)
    kv = torch.randint(-127, 128, (2, 5, 4, 8, 16), generator=g,
                       dtype=torch.int8)
    sc = torch.rand((2, 5, 4, 8), generator=g)
    for r in range(2):
        got = tsh.shard_pools((kv, kv, sc, sc), FakeMesh(r, tp=2))
        assert [tuple(t.shape) for t in got] == [(2, 5, 2, 8, 16)] * 2 + [
            (2, 5, 2, 8)] * 2
        assert torch.equal(got[0], kv[:, :, 2 * r:2 * r + 2])
        assert torch.equal(got[3], sc[:, :, 2 * r:2 * r + 2])


def test_shard_params_refuses_an_unknown_leaf_and_a_ragged_axis():
    _, _, tree = trees("dense", None)
    bad = dict(tree, layers=dict(tree["layers"], extra=torch.zeros(2, 4)))
    with pytest.raises(ValueError, match="no sharding rule"):
        tsh.shard_params(bad, tiny_test_config(), FakeMesh(0))
    with pytest.raises(ValueError, match="does not divide"):
        tsh.shard_params(tree, tiny_test_config(), FakeMesh(0, tp=3))


def test_a_shard_without_its_mesh_raises():
    """A tp shard that lost its mesh (a tree rebuilt through dict()) does not
    serve as a narrower model: the first layer's head reshape raises, and
    K1 / K2's wrappers refuse a pool that is not this rank's shard."""
    _, _, tree = trees("dense", None)
    tc = tiny_test_config()
    mesh = FakeMesh(0, tp=2)
    piece = tsh.shard_params(tree, tc, mesh)
    assert shard_heads(tc, mesh) == (tc.num_q_heads // 2,
                                     tc.num_kv_heads // 2)
    assert shard_heads(tc, None) == (tc.num_q_heads, tc.num_kv_heads)
    ids = torch.tensor([[1, 2, 3]])
    with pytest.raises(RuntimeError, match="invalid for input"):
        forward_dense(dict(piece), tc, ids)
    D, bs = tc.head_dim, 4
    pool = torch.zeros(3, tc.num_kv_heads, bs, D, dtype=torch.int8)
    scale = torch.ones(3, tc.num_kv_heads, bs)
    table, lens = torch.zeros(1, 2, dtype=torch.int32), torch.ones(
        1, dtype=torch.int32)
    q = torch.zeros(1, tc.num_q_heads // 2, D)
    attend = sharded_paged_attention(mesh, tc, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="not this rank's shard"):
        attend(q, pool, pool, scale, scale, table, lens, KVDtype.INT8)
    chunk = sharded_chunk_attention(mesh, tc, compute_dtype=torch.float32)
    kn = torch.zeros(1, 1, tc.num_kv_heads // 2, D)
    with pytest.raises(ValueError, match="not this rank's shard"):
        chunk(q[:, None], kn, kn, pool, pool, scale, scale, table,
              torch.zeros(1, dtype=torch.int32), KVDtype.INT8)


def test_lane_slice_and_the_one_rank_mesh():
    m = FakeMesh(3, dp=2, tp=2)          # dp index 1
    assert lane_slice(m, 8) == slice(4, 8)
    assert lane_slice(m, 3) is None and lane_slice(None, 8) is None
    one = single_device_mesh()
    x = torch.arange(6.0)
    assert one.world == 1 and one.all_reduce(x, ("ep", "tp")) is x
    assert one.all_gather(x, "dp", 0) is x and one.agree(5) == 5
    assert one.stats() == {}
    assert make_mesh().shape == {"dp": 1, "ep": 1, "tp": 1}
    with pytest.raises(ValueError, match="world size 1"):
        Mesh(tp=2)


def test_engine_mesh_needs_a_world_and_divisible_lanes():
    sc = SystemConfig(parallel=ParallelConfig(dp=2, tp=2),
                      engine=EngineConfig(max_batch_size=3))
    with pytest.raises(ValueError, match="max_batch_size"):
        Engine(tiny_test_config(), sc, device="cpu")
    sc = SystemConfig(parallel=ParallelConfig(tp=2))
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        Engine(tiny_test_config(), sc, device="cpu")
    sc = SystemConfig(parallel=ParallelConfig(tp=3))
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        Engine(tiny_test_config(), sc, device="cpu")


# -- lockstep, on both packages ------------------------------------------------

F32 = dataclasses.replace(tiny_test_config(), attn_compute_dtype="float32")
JF32 = dataclasses.replace(j_tiny(), attn_compute_dtype="float32")


@functools.lru_cache(maxsize=1)
def lock_params():
    jp = jl.init_params(j_tiny(), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


class Recorder:
    """An engine proxy logging every command the frontend applies."""

    def __init__(self, eng, log):
        self._eng, self._log = eng, log

    def __getattr__(self, name):
        attr = getattr(self._eng, name)
        if name in ("add_request", "continue_session", "cancel",
                    "set_prefetch_depth", "set_kv_dtype"):
            def call(*a, **kw):
                self._log.append((name, a, tuple(sorted(kw.items()))))
                return attr(*a, **kw)
            return call
        return attr


def make_pair(pkg):
    """(engines, frontends, logs) of two lockstep processes of `pkg`."""
    jp, tp = lock_params()
    if pkg == "jax":
        mods = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig,
                JSystemConfig)
        lock = jlock
    else:
        mods = (CacheConfig, EngineConfig, KVDtype, PrefetchConfig,
                SystemConfig)
        lock = tlock
    cc, ec, kvd, pc, sc = mods
    system = sc(cache=cc(block_size=8, num_hbm_blocks=24, num_host_blocks=64,
                         kv_dtype=kvd.INT8),
                prefetch=pc(enabled=False),
                engine=ec(max_batch_size=2, max_seq_len=64,
                          prefill_chunk=16))
    fabric = lock.LocalFabric(2)
    engs, fronts, logs = [], [], []
    for r in range(2):
        if pkg == "jax":
            e = JEngine(JF32, system, params=jp, use_pallas=False,
                        enable_lstm=False, seed=0)
        else:
            e = Engine(F32, system, params=tp, device="cpu",
                       enable_lstm=False, seed=0)
        log: list = []
        engs.append(e)
        logs.append(log)
        fronts.append(lock.LockstepFrontend(Recorder(e, log), r, fabric))
    return engs, fronts, logs


def _commit(*fronts):
    for f in fronts:
        f.stage_round()
    return [f.apply_round() for f in fronts]


def _outs(front):
    """Comparable serving results (latency fields left out)."""
    return {o.req_id: (list(map(int, o.tokens)), o.finish_reason,
                       o.logprobs is not None, o.prompt_logprobs is not None)
            for o in front.run()}


def case_interleavings(engs, f0, f1):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 256, rng.randint(4, 10)).tolist()
               for _ in range(6)]
    h0 = [f0.submit(p, max_new_tokens=6) for p in prompts[:3]]
    h1 = [f1.submit(p, max_new_tokens=6) for p in prompts[3:]]
    m0, m1 = _commit(f0, f1)
    assert len(engs[0]._requests) == len(engs[1]._requests) == 6
    assert set(m0) == set(h0) and set(m1) == set(h1)
    return [_outs(f0), _outs(f1)]


def case_control_knobs(engs, f0, f1):
    f0.submit([5, 6, 7], max_new_tokens=4)
    f1.set_prefetch_depth(2)
    _commit(f0, f1)
    f1.submit([9, 9], max_new_tokens=4)
    _commit(f0, f1)
    return [_outs(f0), _outs(f1)]


def case_full_surface(engs, f0, f1):
    f0.submit([3, 4, 5, 6, 7, 8], max_new_tokens=8, temperature=0.9,
              top_p=0.8, logprobs=2)
    f0.submit([9, 10, 11, 12], max_new_tokens=8, stop_token_ids=[17],
              ignore_eos=True)
    f1.submit([20, 21, 22, 23, 24], max_new_tokens=8,
              stop_sequences=[[40, 41]], prompt_logprobs=True)
    _commit(f0, f1)
    out = [_outs(f0), _outs(f1)]
    assert out[0][0][2] and out[0][2][3]
    return out


def case_sessions(engs, f0, f1):
    h = f0.submit([5, 6, 7, 8, 9], max_new_tokens=4, session=True)
    _commit(f0, f1)
    out = [_outs(f0), _outs(f1)]
    sid = next(o.session_id for o in engs[0]._requests.values()
               if o.req_id == f0.req_id(h))
    f1.continue_session(sid, [30, 31, 32], max_new_tokens=4)
    _commit(f0, f1)
    return out + [_outs(f0), _outs(f1)]


def case_cancel(engs, f0, f1):
    h_long = f0.submit([2, 3, 4, 5], max_new_tokens=40, ignore_eos=True)
    _commit(f0, f1)
    for _ in range(3):
        f0.step()
        f1.step()
    assert f0.cancel(h_long) is not None
    _commit(f0, f1)
    out = [_outs(f0), _outs(f1)]
    rid = f0.req_id(h_long)
    assert all(e._requests[rid].finish_reason == "cancelled" for e in engs)
    h_buf = f1.submit([7, 7, 7], max_new_tokens=4)
    assert f1.cancel(h_buf) is None
    _commit(f0, f1)
    assert len(engs[0]._requests) == len(engs[1]._requests) == 1
    with pytest.raises(KeyError):
        f1.cancel((1, 999))
    return out + [[len(engs[0]._requests[rid].output)]]


LOCK_CASES = {"interleavings": case_interleavings,
              "control_knobs": case_control_knobs,
              "full_surface": case_full_surface,
              "sessions": case_sessions, "cancel": case_cancel}


@pytest.mark.parametrize("case", list(LOCK_CASES))
def test_lockstep_matches_jax_frontend(case):
    """Both processes of each package apply one command stream, the same in
    both packages, and serve the same tokens."""
    got = {}
    for pkg in ("jax", "torch"):
        engs, (f0, f1), logs = make_pair(pkg)
        out = LOCK_CASES[case](engs, f0, f1)
        assert logs[0] == logs[1] and out[0] == out[1]
        if case == "full_surface":
            # request 0 samples: the packages draw different random bits
            for o in out:
                o.pop(0)
        got[pkg] = (logs[0], out)
    assert repr(got["torch"][0]) == repr(got["jax"][0])
    assert got["torch"][1] == got["jax"][1]


def test_merge_and_fabric_protocol_match_jax():
    entries = [[(0, 0, "request", ((1,), 4, 0.0, None)), (0, 1, "depth", (3,))],
               [(1, 0, "request", ((2,), 4, 0.0, None))]]
    for shuffled in (entries, entries[::-1]):
        t = tlock.merge_rounds([[tlock.LogEntry(*e) for e in es]
                                for es in shuffled])
        j = jlock.merge_rounds([[jlock.LogEntry(*e) for e in es]
                                for es in shuffled])
        assert [(e.client_id, e.client_seq, e.kind, e.payload) for e in t] \
            == [(e.client_id, e.client_seq, e.kind, e.payload) for e in j]
    fabric = tlock.LocalFabric(2)
    fabric.stage(0, [])
    with pytest.raises(RuntimeError, match="not yet staged"):
        fabric.gather(0)
    with pytest.raises(RuntimeError, match="staged twice"):
        fabric.stage(0, [])
