"""Mesh serving across spawned ranks: the port's mesh engine on gloo on the
CPU against its single-process engine and the JAX single-device engine.

Two worlds are spawned once for the module, side by side: one of 2 ranks
(tp 2) and one of 4 (dp 2 x tp 2, then a fresh ep 2 x tp 2 mesh for the
tiny Qwen3-MoE and GPT-OSS; the tp 2 world also serves a tiny Gemma-2).
Each rank runs every scenario of
`torch_mesh_scenarios.py` (plain greedy and sampled, tiered
oversubscription, a streamed request, draft spec with a sharded and a
replicated draft, n-gram spec, prefix cache, scheme switch, sessions,
logprobs and penalties, W8A16, W4A16, dense scoring, `multiproc_serve`'s
`tpspan` / `dptp` script) with one intra-op thread, and writes JSON. The
worlds have a hard timeout of their own: a rank still running then is
killed with the others. Meanwhile this process computes the references
from the same weights (the port's seeded trees, carried over to JAX).

Held: every rank's results equal; they equal the port's single-process
engine's (tokens exactly, logprobs and scores within 1e-4: only the order
of the tp sums differs, at float32); greedy tokens equal the JAX engine's
(the near-tie rule never had to apply at float32 on these inputs: equality
is asserted) and its logprobs within `torch_surface.LP_TOL`; the pools,
host stores and draft pools of ranks with the same tp index (dp and ep
replicas) are bitwise equal at every round boundary (`state_hash`).
"""

from __future__ import annotations

import json
import os
import threading

import jax.numpy as jnp
import pytest
import torch
import torch_mesh_scenarios as S
from torch_surface import LP_TOL

from cxl_speckv_tpu.config import CacheConfig as JCacheConfig
from cxl_speckv_tpu.config import EngineConfig as JEngineConfig
from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.config import PrefetchConfig as JPrefetchConfig
from cxl_speckv_tpu.config import SystemConfig as JSystemConfig
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu_torch.models import save_params
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.llama import init_params
from cxl_speckv_tpu_torch.parallel import distributed
from cxl_speckv_tpu_torch.scripts import multiproc_serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
WORLD_TIMEOUT_S = 300.0
MESH_TOL = 1e-4        # logprobs / scores, mesh against single-process
SEEDS = {"main": 42, "draft_sharded": 7, "draft_replicated": 8,
         "qwen3_moe": 9, "gpt_oss": 10, "gemma2": 11}
WORLDS = (2, 4)
CASES = [(w, name) for w in WORLDS
         for scen, _ in S.meshes(w) for name in scen]
JAX_CASES = [(w, name) for w, name in CASES if name in S.JAX_SCENARIOS]
SCENARIOS = {**S.DENSE, **S.MOE, **S.FAMILY}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: the suite runs six xdist
    workers on a few cores, and many small ops slow down many times over
    when each process's thread pool contends for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tree(tree):
    """The port's tree as the JAX package's (the same layout)."""
    return {k: (jax_tree(v) if isinstance(v, dict)
                else jnp.asarray(v.numpy())) for k, v in tree.items()}


def jax_maker(jparams):
    def make(model="main", spec=None, **kw):
        s = S.system_kwargs(**kw)
        cc = dict(s["cache"], kv_dtype=JKV(s["cache"]["kv_dtype"]))
        sc = JSystemConfig(cache=JCacheConfig(**cc),
                           prefetch=JPrefetchConfig(**s["prefetch"]),
                           engine=JEngineConfig(**s["engine"]))
        assert not spec, "the JAX references serve no spec"
        return JEngine(S.config(j_tiny(), model), sc, params=jparams[model],
                       use_pallas=False, enable_lstm=False, seed=0)

    return make


def jax_serve(eng):
    return {o.req_id: o for o in eng.run()}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both worlds' rank records and every reference, computed once."""
    tmp = tmp_path_factory.mktemp("mesh")
    weights = str(tmp / "weights")
    jparams = {}
    for name, seed in SEEDS.items():
        gen = torch.Generator()
        gen.manual_seed(seed)
        tree = init_params(S.config(tiny_test_config(), name), gen)
        save_params(tree, f"{weights}/{name}")
        jparams[name] = jax_tree(tree)
    env = dict(os.environ, PYTHONPATH=REPO)
    rcs: dict = {}

    def run(world):
        logs = tmp / f"logs{world}"
        logs.mkdir()
        rcs[world] = distributed.launch(
            "torch_mesh_scenarios", world,
            ["--weights", weights, "--out", str(tmp / f"world{world}")],
            timeout_s=WORLD_TIMEOUT_S, env=env, cwd=TESTS,
            log_dir=str(logs))

    threads = [threading.Thread(target=run, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    try:
        port = {}
        for w, name in CASES:
            if name not in port:
                port[name] = SCENARIOS[name](S.port_maker(weights),
                                             S.port_serve(None))
        jx = {name: SCENARIOS[name](jax_maker(jparams), jax_serve)
              for name in S.JAX_SCENARIOS}
        mp = {m: multiproc_serve.reference(m, "tiny", "cpu")
              for m in ("tpspan", "dptp")}
    finally:
        for t in threads:
            t.join(WORLD_TIMEOUT_S + 30)
    logs = {(w, r): open(tmp / f"logs{w}" / f"rank{r}.log").read()[-3000:]
            for w in WORLDS for r in range(w)
            if os.path.exists(tmp / f"logs{w}" / f"rank{r}.log")}
    ranks = {}
    for w in WORLDS:
        assert rcs.get(w) == [0] * w, (w, rcs.get(w), logs)
        ranks[w] = []
        for r in range(w):
            with open(tmp / f"world{w}.rank{r}.json") as f:
                ranks[w].append(json.load(f))
    return {"ranks": ranks, "port": port, "jax": jx, "multiproc": mp}


def _close(a, b, tol):
    """Nested lists / dicts of numbers equal within tol (ints and strings
    exactly)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert a is not None and b is not None
        assert abs(a - b) <= tol, (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("world,name", CASES)
def test_mesh_scenario_matches_single_process(served, world, name):
    """Every rank serves what the single-process engine serves; the dp and
    ep replicas' pools and host stores are bitwise equal at every round
    boundary."""
    recs = [r[name] for r in served["ranks"][world]]
    for rec in recs[1:]:
        assert rec["result"] == recs[0]["result"]
    _close(recs[0]["result"], json.loads(json.dumps(served["port"][name])),
           MESH_TOL)
    tp = recs[0]["parallel"][2]
    for r, rec in enumerate(recs):
        assert rec["hashes"] == recs[r % tp]["hashes"]
    if name != "scoring":
        assert recs[0]["hashes"]


@pytest.mark.parametrize("world,name", JAX_CASES)
def test_mesh_scenario_matches_jax(served, world, name):
    got = served["ranks"][world][0][name]["result"]
    want = served["jax"][name]
    greedy = got.get("greedy", [True] * len(got["tokens"]))
    for g, w, keep in zip(got["tokens"], want["tokens"], greedy):
        if keep:
            assert g == [int(t) for t in w]
    if name == "surface":
        assert got["reasons"] == want["reasons"]
        for g, w in zip(got["logprobs"], want["logprobs"]):
            _close(g, json.loads(json.dumps(w)) if w else w, LP_TOL)


def test_mesh_features_ran(served):
    """The scenarios exercised what they name, on every world."""
    for world in WORLDS:
        r = served["ranks"][world][0]
        assert min(r["tiered"]["result"]["migrations"]) > 0
        assert r["stream"]["result"]["streamed"]
        assert r["prefix"]["result"]["prefix_hit_blocks"] > 0
        assert r["ngram"]["result"]["accepted"] > 0
        for spec in ("spec_sharded", "spec_replicated", "ngram"):
            # greedy speculative decoding emits the target's greedy tokens
            assert (r[spec]["result"]["tokens"]
                    == r["spec_plain"]["result"]["tokens"])
    assert served["ranks"][4][0]["qwen3_moe"]["parallel"] == [1, 2, 2]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_derived_horizon_is_rank_zeros(served, world):
    """Ranks that measured different dispatch costs still serve one
    decode horizon, rank 0's (each deriving its own would run different
    programs, whose collectives then mismatch)."""
    recs = [r["horizon"]["result"] for r in served["ranks"][world]]
    assert recs[0]["own"] == 1 and all(r["own"] > 1 for r in recs[1:])
    assert all(r["decode_horizon"] == recs[0]["own"] for r in recs)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_rounds_are_eager(served, world):
    """A mesh rank's decode rounds run eagerly (no graph cache: its gloo
    collectives run on the host), and its statistics say so."""
    for rec in served["ranks"][world]:
        got = rec["round_route"]["result"]
        assert got["route"] == "eager: mesh" and got["cache"]
        assert got["graph_rounds"] == 0
        assert got["eager_rounds"] == got["decode_batches"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_host_fetch_gathers_what_a_rank_does_not_hold(served, world):
    for r, rec in enumerate(served["ranks"][world]):
        got = rec["host_fetch"]["result"]
        assert got["own"] == [r]
        assert got["tp"] == [r - r % 2, r - r % 2 + 1]
        assert got["all"] == list(range(world))


@pytest.mark.parametrize("world,mode", [(2, "tpspan"), (4, "dptp")])
def test_multiproc_serve_identity(served, world, mode):
    """`multiproc_serve`'s script across the ranks: one digest on every
    rank, and the single-process reference's outputs."""
    recs = [r["multiproc"]["result"] for r in served["ranks"][world]]
    assert len({r["digest"] for r in recs}) == 1
    assert all(r["world"] == world and r["backend"] == "gloo" for r in recs)
    cmp = multiproc_serve.compare(
        {int(k): v for k, v in recs[0]["outputs"].items()},
        {int(k): v for k, v in served["multiproc"][mode]["outputs"].items()})
    assert cmp["ok"] and not cmp["near_ties"], cmp
