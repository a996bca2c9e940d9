"""The pipeline (pp) and ring-attention (sp) cases of the spawned gloo
worlds (`tests/test_torch_line_spawn.py`), mirroring the JAX package's
`tests/test_pipeline_sp.py`, `tests/test_gpt_oss.py`'s sinks case and
`tests/test_wquant.py`'s W8A16 case on the port's seeded 4-layer trees.

Run as a rank: `python -m torch_line_scenarios --rank r --world n --port p
--weights DIR --out PREFIX` from this directory with the repository on
PYTHONPATH. It imports no JAX. Each rank runs its world's forwards
(`FORWARDS`), scoring calls (`SCORES`), the engine's entry and mesh guard
and the refusals, and writes `{PREFIX}.rank{r}.pt`.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

GEMMA = dict(sliding_window=5, attn_pattern=(True, False), norm_offset=True,
             post_norms=True, act_fn="gelu_tanh", embed_scale=True,
             query_scale=10.0**-0.5)
MODELS = {
    "llama": {},
    "moe_window": dict(num_experts=4, num_experts_per_tok=2,
                       sliding_window=6),
    "gemma2": dict(GEMMA, attn_softcap=25.0, final_softcap=8.0),
    "gemma3": dict(GEMMA, qk_norm=True, rope_local_theta=10000.0,
                   rope_theta=50000.0, rope_linear_factor=2.0),
    "window": dict(sliding_window=5),
    "gpt_oss": dict(attn_sinks=True, o_bias=True, attn_bias=True,
                    num_experts=4, num_experts_per_tok=2,
                    moe_style="gpt_oss", sliding_window=6,
                    attn_pattern=(True, False)),
}
SEEDS = {"llama": 0, "moe_window": 3, "gemma2": 9, "gemma3": 11,
         "window": 5, "gpt_oss": 12}


@dataclasses.dataclass(frozen=True)
class Forward:
    world: int
    mode: str                 # "pp" | "sp"
    size: int                 # the line's length
    model: str
    tokens: tuple             # (B, T, seed)
    microbatches: int = 1
    int8: bool = False        # W8A16 (`ops.wquant.quantize_weights`)


FORWARDS = {
    "pp2_m2": Forward(2, "pp", 2, "llama", (4, 16, 1), 2),
    "pp4_m4": Forward(4, "pp", 4, "llama", (4, 16, 1), 4),
    "pp4_m1": Forward(4, "pp", 4, "llama", (4, 16, 1), 1),
    "moe_window_pp2": Forward(2, "pp", 2, "moe_window", (2, 16, 2), 2),
    "gemma2_pp2": Forward(2, "pp", 2, "gemma2", (2, 16, 8), 2),
    "gemma2_sp4": Forward(4, "sp", 4, "gemma2", (2, 16, 8)),
    "gemma3_pp2": Forward(2, "pp", 2, "gemma3", (2, 16, 12), 2),
    "gemma3_sp4": Forward(4, "sp", 4, "gemma3", (2, 16, 12)),
    "sp2": Forward(2, "sp", 2, "llama", (2, 32, 4)),
    "sp4": Forward(4, "sp", 4, "llama", (2, 32, 4)),
    "window_sp4": Forward(4, "sp", 4, "window", (2, 32, 6)),
    "gpt_oss_pp2": Forward(2, "pp", 2, "gpt_oss", (2, 16, 13), 2),
    "gpt_oss_sp4": Forward(4, "sp", 4, "gpt_oss", (2, 16, 13)),
    "w8a16_pp2": Forward(2, "pp", 2, "llama", (4, 32, 5), 2, int8=True),
    "w8a16_sp4": Forward(4, "sp", 4, "llama", (4, 32, 5), int8=True),
    # lines shorter than the world: ranks 2 and 3 get the logits by
    # broadcast
    "pp2_of4": Forward(4, "pp", 2, "llama", (4, 16, 1), 2),
    "sp2_of4": Forward(4, "sp", 2, "llama", (2, 32, 4)),
}
# score_prompts over the llama tree: (world, mode, parallel_size, M)
SCORES = {
    "dense": (None, "dense", None, 4),
    "pp4_m2": (4, "pp", 4, 2),
    "sp4": (4, "sp", 4, 4),
    "pp2_of4": (4, "pp", 2, 4),
    "sp2_of4": (4, "sp", 2, 4),
    "pp2": (2, "pp", None, 4),
    "sp2": (2, "sp", None, 4),
}
SCORE_LENGTHS = (9, 14, 6, 11)
ENGINE_PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6]]


def config(base, model: str):
    """`model`'s 4-layer config over a package's `tiny_test_config()`."""
    return dataclasses.replace(base, num_layers=4, **MODELS[model])


def tokens(vocab: int, b: int, t: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(1, vocab, (b, t))


def score_prompts_of(vocab: int) -> list:
    rng = np.random.RandomState(5)
    return [rng.randint(1, vocab, n).tolist() for n in SCORE_LENGTHS]


# -- the port's side -----------------------------------------------------------

def run_forward(case: Forward, tree: dict) -> tuple:
    """(logits, the line's statistics) of one case on this rank."""
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config
    from cxl_speckv_tpu_torch.parallel.mesh import LineMesh
    from cxl_speckv_tpu_torch.parallel.pipeline import pipeline_forward
    from cxl_speckv_tpu_torch.parallel.ring import sp_forward_dense

    cfg = config(tiny_test_config(), case.model)
    ids = torch.from_numpy(tokens(cfg.vocab_size, *case.tokens))
    with LineMesh(case.mode, case.size) as mesh, torch.no_grad():
        if case.mode == "pp":
            out = pipeline_forward(tree, cfg, ids, mesh=mesh,
                                   num_microbatches=case.microbatches)
        else:
            out = sp_forward_dense(tree, cfg, ids, mesh=mesh)
        return out, {"index": mesh.index, **mesh.stats()}


def engine(tree: dict, parallel=(1, 1, 1)):
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        KVDtype,
        ParallelConfig,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config

    dp, ep, tp = parallel
    sc = SystemConfig(
        cache=CacheConfig(block_size=8, num_hbm_blocks=16,
                          num_host_blocks=32, kv_dtype=KVDtype.INT8),
        prefetch=PrefetchConfig(enabled=False),
        engine=EngineConfig(max_batch_size=2, max_seq_len=64,
                            prefill_chunk=16, decode_horizon=1),
        parallel=ParallelConfig(dp=dp, ep=ep, tp=tp))
    return Engine(config(tiny_test_config(), "llama"), sc, params=tree,
                  device="cpu", enable_lstm=False, seed=0)


def refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def run_rank(weights: str, world: int) -> dict:
    """Every case of this world on this rank (the world is up)."""
    from cxl_speckv_tpu_torch.engine.scoring import score_prompts
    from cxl_speckv_tpu_torch.models import load_params
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config
    from cxl_speckv_tpu_torch.ops.wquant import quantize_weights
    from cxl_speckv_tpu_torch.parallel.mesh import LineMesh
    from cxl_speckv_tpu_torch.parallel.ring import sp_forward_dense

    trees = {m: load_params(f"{weights}/{m}", device="cpu") for m in MODELS}
    out: dict = {"forwards": {}, "stats": {}, "scores": {}}
    for name, case in FORWARDS.items():
        if case.world != world:
            continue
        tree = trees[case.model]
        out["forwards"][name], out["stats"][name] = run_forward(
            case, quantize_weights(tree) if case.int8 else tree)
    cfg = config(tiny_test_config(), "llama")
    ps = score_prompts_of(cfg.vocab_size)
    for name, (w, mode, size, mbs) in SCORES.items():
        if w in (None, world):
            out["scores"][name] = score_prompts(
                trees["llama"], cfg, ps, mode=mode, parallel_size=size,
                num_microbatches=mbs)
    eng = engine(trees["llama"])
    out["engine"] = {m: eng.score_prompts(ENGINE_PROMPTS, mode=m,
                                          parallel_size=world)
                     for m in ("dense", "pp", "sp")}
    # the guard: a (dp, ep, tp) mesh engine scores dense and refuses pp /
    # sp, serving on around the calls
    meng = engine(trees["llama"], (world // 2, 1, 2))
    rid = meng.add_request([1, 2, 3, 4], max_new_tokens=4)
    out["guard"] = {m: refusal(lambda m=m: meng.score_prompts(
        ENGINE_PROMPTS, mode=m, parallel_size=2)) for m in ("pp", "sp")}
    out["guard"]["dense"] = meng.score_prompts(ENGINE_PROMPTS)
    out["guard"]["served"] = [o.req_id for o in meng.run()] == [rid]
    # the refusals, raised before any communication
    out["refusals"] = {
        "pp3": refusal(lambda: score_prompts(trees["llama"], cfg, ps,
                                             mode="pp", parallel_size=3)),
        "past_world": refusal(lambda: score_prompts(
            trees["llama"], cfg, ps, mode="sp", parallel_size=world + 1)),
    }
    with LineMesh("sp") as mesh:
        odd = torch.from_numpy(tokens(cfg.vocab_size, 2, 4 * world - 1, 3))
        out["refusals"]["seq"] = refusal(
            lambda: sp_forward_dense(trees["llama"], cfg, odd, mesh=mesh))
    return out


def main(argv=None) -> None:
    from cxl_speckv_tpu_torch.parallel import distributed

    ap = argparse.ArgumentParser()
    distributed.add_rank_args(ap)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    distributed.initialize(args.rank, args.world, args.port, device="cpu")
    try:
        rec = run_rank(args.weights, args.world)
    finally:
        distributed.shutdown()
    torch.save(rec, f"{args.out}.rank{args.rank}.pt")


if __name__ == "__main__":
    main()
