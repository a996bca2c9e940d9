"""Offline scoring over pp and sp across spawned ranks: the port's
`parallel/pipeline.py` and `parallel/ring.py` on gloo on the CPU against
the JAX package's `pipeline_forward`, `sp_forward_dense`, `forward_dense`
and `score_prompts` on the same trees and tokens.

Two worlds, of 2 and 4 ranks, are spawned once for the module, side by
side. Each rank runs the cases of `torch_line_scenarios.py` for its world
with one intra-op thread and writes them out; the worlds have a hard
timeout of their own. Meanwhile this process computes the JAX references:
the port's seeded 4-layer trees carried over to JAX (and quantized by each
package for W8A16), with JAX's 8 virtual CPU devices
(`tests/conftest.py`) for its pipeline and ring forwards.

Held, with the JAX package's own tolerances (`tests/test_pipeline_sp.py`,
`tests/test_gpt_oss.py:235`, `tests/test_wquant.py:263`): pp logits within
2e-5, sp within 1e-4, W8A16 within 2e-4; scores dense == pp == sp within
2e-4; every rank's logits and scores bit-equal; each line's shift,
broadcast and gather counts as its schedule says; the engine's pp / sp
entry, its mesh guard ("mesh-sharded engine") and the refusals ("not
divisible", a line past the world).
"""

from __future__ import annotations

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_line_scenarios as S
from jax.sharding import Mesh

from cxl_speckv_tpu.engine.scoring import score_prompts as j_score_prompts
from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.ops.wquant import quantize_weights as j_quantize
from cxl_speckv_tpu.parallel.pipeline import pipeline_forward as j_pipeline
from cxl_speckv_tpu.parallel.ring import sp_forward_dense as j_sp
from cxl_speckv_tpu_torch.models import save_params
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.llama import init_params
from cxl_speckv_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
WORLD_TIMEOUT_S = 240.0
WORLDS = (2, 4)
PP_TOL, SP_TOL, W8_TOL, SCORE_TOL = 2e-5, 1e-4, 2e-4, 2e-4
# the cases held against the JAX forward they port (the rest against JAX
# `forward_dense`, as the JAX package's own tests hold its forwards)
AGAINST_PARALLEL = ("pp2_m2", "gemma3_pp2", "sp4", "gpt_oss_sp4")


def tolerance(case: S.Forward) -> float:
    return W8_TOL if case.int8 else (PP_TOL if case.mode == "pp"
                                     else SP_TOL)


def jax_tree(tree):
    """The port's tree as the JAX package's (the same layout)."""
    return {k: (jax_tree(v) if isinstance(v, dict)
                else jnp.asarray(v.numpy())) for k, v in tree.items()}


def jax_reference(name: str, case: S.Forward, jparams: dict) -> np.ndarray:
    cfg = S.config(j_tiny(), case.model)
    params = jparams[case.model]
    if case.int8:
        params = j_quantize(params)
    toks = jnp.asarray(S.tokens(cfg.vocab_size, *case.tokens), jnp.int32)
    if name not in AGAINST_PARALLEL:
        return np.asarray(jl.forward_dense(params, cfg, toks))
    mesh = Mesh(np.asarray(jax.devices()[:case.size]), (case.mode,))
    if case.mode == "pp":
        return np.asarray(j_pipeline(params, cfg, toks, mesh=mesh,
                                     num_microbatches=case.microbatches))
    return np.asarray(j_sp(params, cfg, toks, mesh=mesh))


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    """Both worlds' rank records and the JAX references, computed once."""
    tmp = tmp_path_factory.mktemp("line")
    weights = str(tmp / "weights")
    jparams = {}
    for model, seed in S.SEEDS.items():
        gen = torch.Generator()
        gen.manual_seed(seed)
        tree = init_params(S.config(tiny_test_config(), model), gen)
        save_params(tree, f"{weights}/{model}")
        jparams[model] = jax_tree(tree)
    env = dict(os.environ, PYTHONPATH=REPO)
    rcs: dict = {}

    def run(world):
        logs = tmp / f"logs{world}"
        logs.mkdir()
        rcs[world] = distributed.launch(
            "torch_line_scenarios", world,
            ["--weights", weights, "--out", str(tmp / f"world{world}")],
            timeout_s=WORLD_TIMEOUT_S, env=env, cwd=TESTS,
            log_dir=str(logs))

    threads = [threading.Thread(target=run, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    try:
        want = {name: jax_reference(name, case, jparams)
                for name, case in S.FORWARDS.items()}
        cfg = S.config(j_tiny(), "llama")
        ps = S.score_prompts_of(cfg.vocab_size)
        jscores = {m: j_score_prompts(jparams["llama"], cfg, ps, mode=m,
                                      parallel_size=4, num_microbatches=2)
                   for m in ("dense", "pp", "sp")}
        jengine = j_score_prompts(jparams["llama"], cfg, S.ENGINE_PROMPTS)
    finally:
        for t in threads:
            t.join(WORLD_TIMEOUT_S + 30)
    logs = {(w, r): open(tmp / f"logs{w}" / f"rank{r}.log").read()[-3000:]
            for w in WORLDS for r in range(w)
            if os.path.exists(tmp / f"logs{w}" / f"rank{r}.log")}
    ranks = {}
    for w in WORLDS:
        assert rcs.get(w) == [0] * w, (w, rcs.get(w), logs)
        ranks[w] = [torch.load(tmp / f"world{w}.rank{r}.pt")
                    for r in range(w)]
    return {"ranks": ranks, "want": want, "jscores": jscores,
            "jengine": jengine}


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", list(S.FORWARDS))
def test_forward_matches_jax(lines, name):
    """Every rank returns the same [B, T, V] logits, within the JAX test's
    tolerance of the JAX forward on the same tree and tokens."""
    case = S.FORWARDS[name]
    recs = [r["forwards"][name] for r in lines["ranks"][case.world]]
    for got in recs[1:]:
        assert torch.equal(got, recs[0])
    b, t, _ = case.tokens
    assert recs[0].shape == (b, t, 256) and recs[0].dtype == torch.float32
    close(recs[0].numpy(), lines["want"][name], tolerance(case))


@pytest.mark.parametrize("name", list(S.FORWARDS))
def test_line_operations_follow_the_schedule(lines, name):
    """The pipeline's open line: stage 0 sends M microbatches, the last
    stage receives M and broadcasts once; the ring: S - 1 hops a layer on
    every member, one gather. Ranks past the line issue one broadcast."""
    case = S.FORWARDS[name]
    S_, M, L = case.size, case.microbatches, 4
    for st in (r["stats"][name] for r in lines["ranks"][case.world]):
        calls = {k.split("/")[0]: v["calls"] for k, v in st.items()
                 if k != "index"}
        i = st["index"]
        assert all(k.endswith("/gloo-cpu") for k in st if k != "index")
        if i is None:
            assert calls == {"broadcast": 1}
        elif case.mode == "pp":
            shifts = M if i in (0, S_ - 1) else M + 1
            assert calls == {"shift": shifts, "broadcast": 1}
        else:
            want = {"shift": (S_ - 1) * L, "all_gather": 1}
            if S_ < case.world:
                want["broadcast"] = 1
            assert calls == want


@pytest.mark.parametrize("name", [n for n in S.SCORES if n != "dense"])
def test_scores_dense_pp_sp_agree(lines, name):
    """`score_prompts` in pp / sp equals dense within 2e-4 (the JAX test's
    limit) on every rank, and the JAX package's scores in the same
    mode."""
    world, mode, _, _ = S.SCORES[name]
    recs = [r["scores"] for r in lines["ranks"][world]]
    for rec in recs[1:]:
        assert rec[name] == recs[0][name]
    got = recs[0][name]
    assert [len(s) for s in got] == [n - 1 for n in S.SCORE_LENGTHS]
    for a, b, c in zip(got, recs[0]["dense"], lines["jscores"][mode]):
        close(a, b, SCORE_TOL)
        close(a, c, SCORE_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_engine_score_prompts_pp_sp(lines, world):
    """`Engine.score_prompts` reaches both parallel modes over the world's
    ranks, equal to its dense scores and the JAX engine's."""
    recs = [r["engine"] for r in lines["ranks"][world]]
    dense = recs[0]["dense"]
    assert [len(s) for s in dense] == [4, 2]
    for rec in recs:
        for mode in ("pp", "sp"):
            assert rec[mode] == recs[0][mode]
            for a, b, c in zip(rec[mode], dense, lines["jengine"]):
                close(a, b, SCORE_TOL)
                close(a, c, SCORE_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_engine_mesh_guard(lines, world):
    """On a (dp, ep, tp) mesh engine dense scoring runs and matches the
    unsharded engine's, pp / sp raise "mesh-sharded engine", and serving
    goes on around the calls."""
    for rec in lines["ranks"][world]:
        g = rec["guard"]
        for mode in ("pp", "sp"):
            assert "mesh-sharded engine" in g[mode], g[mode]
        assert g["served"]
        for a, b in zip(g["dense"], rec["engine"]["dense"]):
            close(a, b, SCORE_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_in_a_world(lines, world):
    for rec in lines["ranks"][world]:
        r = rec["refusals"]
        assert "not divisible by pp=3" in r["pp3"], r
        assert f"sp={world + 1} needs" in r["past_world"], r
        assert f"not divisible by sp={world}" in r["seq"], r
