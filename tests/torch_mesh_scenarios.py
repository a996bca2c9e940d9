"""Serving scenarios of the spawned mesh worlds
(`tests/test_torch_parallel_spawn.py`), written once for three engines:
the port's mesh engine on every rank of a gloo world on the CPU, the
port's single-process engine and the JAX single-device engine
(`use_pallas=False`), both in the test process. A scenario is a function
of `make(**system kwargs) -> engine` and `serve(engine) -> {req_id:
output}`; both packages' engines take the same calls.

Run as a rank: `python -m torch_mesh_scenarios --rank r --world n --port p
--weights DIR --out PREFIX` from this directory with the repository on
PYTHONPATH. It imports no JAX. Each rank serves every scenario of its
world, records each engine's pool / host-store / draft-pool checksum at
every round boundary (`state_hash`) and writes `{PREFIX}.rank{r}.json`.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json

import numpy as np
import torch

# float32 activations and attention: the mesh and the single-process
# engine then differ only in the order of the tp sums, and greedy tokens
# agree with the JAX engine's reference attention bit for bit
TINY = dict(attn_compute_dtype="float32")
DRAFT_SHARDED = dict(hidden_size=32, intermediate_size=64, num_layers=1,
                     num_q_heads=2, num_kv_heads=2)
DRAFT_REPLICATED = dict(hidden_size=48, intermediate_size=64, num_layers=1,
                        num_q_heads=3, num_kv_heads=1)
QWEN3_MOE = dict(TINY, qk_norm=True, rms_eps=1e-6, num_experts=8,
                 num_experts_per_tok=2, moe_norm_topk=True,
                 intermediate_size=32)
GPT_OSS = dict(TINY, attn_sinks=True, o_bias=True, attn_bias=True,
               num_experts=4, num_experts_per_tok=2, moe_style="gpt_oss",
               sliding_window=6, attn_pattern=(True, False))
# Gemma-2's conventions: softcaps, the tied head (vocabulary-sharded rows
# read transposed), sandwich norms, scaled embeddings, alternating windows
GEMMA2 = dict(TINY, sliding_window=6, attn_pattern=(True, False),
              attn_softcap=30.0, final_softcap=10.0, norm_offset=True,
              post_norms=True, act_fn="gelu_tanh", embed_scale=True,
              query_scale=10.0**-0.5, tie_embeddings=True)
MODELS = {"main": TINY, "draft_sharded": DRAFT_SHARDED,
          "draft_replicated": DRAFT_REPLICATED, "qwen3_moe": QWEN3_MOE,
          "gpt_oss": GPT_OSS, "gemma2": GEMMA2}
V = 256


def config(base, name):
    """`name`'s config over a package's `tiny_test_config()` (`base`)."""
    return dataclasses.replace(base, **MODELS[name])


def prompts(n, seed, lo=6, hi=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, V, rng.randint(lo, hi)).tolist() for _ in range(n)]


def submit_all(eng, ps, **kw):
    return [eng.add_request(p, **kw) for p in ps]


def toks(outs, ids):
    return [[int(t) for t in outs[i].tokens] for i in ids]


def reasons(outs, ids):
    return [outs[i].finish_reason for i in ids]


# -- the scenarios: fn(make, serve) -> JSON-able result ------------------------

def sc_plain(make, serve):
    eng = make()
    ps = prompts(6, 1)
    ids = [eng.add_request(p, max_new_tokens=10,
                           temperature=0.7 if i % 2 else 0.0)
           for i, p in enumerate(ps)]
    outs = serve(eng)
    return {"tokens": toks(outs, ids), "greedy": [i % 2 == 0
                                                  for i in range(6)]}


def sc_tiered(make, serve):
    eng = make(hbm=10, host=64)
    ids = submit_all(eng, prompts(6, 3), max_new_tokens=10)
    outs = serve(eng)
    st = eng.get_statistics()["transfer"]
    return {"tokens": toks(outs, ids),
            "migrations": [st["up_transfers"], st["down_transfers"]]}


def sc_stream(make, serve):
    eng = make(hbm=6, host=64)
    long = np.random.RandomState(5).randint(1, V, 40).tolist()
    ids = [eng.add_request(long, max_new_tokens=8)]
    streamed = bool(eng._stream_queue)
    ids += submit_all(eng, prompts(2, 6), max_new_tokens=6)
    outs = serve(eng)
    return {"tokens": toks(outs, ids), "streamed": streamed}


def _spec(make, serve, **spec):
    eng = make(spec=spec)
    ids = submit_all(eng, prompts(4, 11), max_new_tokens=10)
    outs = serve(eng)
    return {"tokens": toks(outs, ids),
            "accepted": eng.get_statistics()["spec"]["accepted"]}


def sc_spec_sharded(make, serve):
    return _spec(make, serve, draft="draft_sharded", spec_gamma=3)


def sc_spec_replicated(make, serve):
    return _spec(make, serve, draft="draft_replicated", spec_gamma=3)


def sc_ngram(make, serve):
    return _spec(make, serve, spec_ngram=True, spec_gamma=3)


def sc_spec_plain(make, serve):
    """The spec scenarios' prompts without spec: their greedy reference."""
    eng = make()
    ids = submit_all(eng, prompts(4, 11), max_new_tokens=10)
    return {"tokens": toks(serve(eng), ids)}


def sc_prefix(make, serve):
    eng = make()
    shared = np.random.RandomState(21).randint(1, V, 24).tolist()
    ps = [shared + p for p in prompts(4, 22, 3, 9)]
    ids = submit_all(eng, ps[:1], max_new_tokens=12)
    eng.step()                   # the first prompt's blocks are live now
    ids += submit_all(eng, ps[1:], max_new_tokens=6)
    outs = serve(eng)
    return {"tokens": toks(outs, ids),
            "prefix_hit_blocks":
                eng.get_statistics()["runtime"]["prefix_hit_blocks"]}


def sc_switch(make, serve):
    eng = make()
    ids = submit_all(eng, prompts(2, 31), max_new_tokens=8)
    eng.step()
    eng.set_kv_dtype("fp8")                   # live: INT8 and FP8 share bytes
    ids += submit_all(eng, prompts(2, 32), max_new_tokens=8)
    outs = serve(eng)
    eng.set_kv_dtype("int4")                  # idle: the pools are rebuilt
    ids += submit_all(eng, prompts(2, 33), max_new_tokens=8)
    outs.update(serve(eng))
    return {"tokens": toks(outs, ids)}


def sc_sessions(make, serve):
    eng = make(hbm=16, host=64)
    ps = prompts(2, 41)
    rids = submit_all(eng, ps, max_new_tokens=6, session=True)
    outs = serve(eng)
    sids = [outs[r].session_id for r in rids]
    # other traffic demotes the idle sessions' KV before their next turns
    ids = submit_all(eng, prompts(3, 42), max_new_tokens=6)
    outs.update(serve(eng))
    for k, sid in enumerate(sids):
        ids.append(eng.continue_session(sid, [5 + k, 9, 13],
                                        max_new_tokens=6))
    outs.update(serve(eng))
    return {"tokens": toks(outs, rids + ids)}


def sc_surface(make, serve):
    eng = make()
    ps = prompts(4, 51)
    ids = [eng.add_request(ps[0], max_new_tokens=8, logprobs=3),
           eng.add_request(ps[1], max_new_tokens=8, frequency_penalty=0.8,
                           presence_penalty=0.5, logprobs=2),
           eng.add_request(ps[2], max_new_tokens=8, repetition_penalty=1.4),
           eng.add_request(ps[3], max_new_tokens=8, prompt_logprobs=True,
                           stop_token_ids=[17])]
    outs = serve(eng)
    return {"tokens": toks(outs, ids), "reasons": reasons(outs, ids),
            "logprobs": [outs[i].logprobs for i in ids],
            "prompt_logprobs": outs[ids[3]].prompt_logprobs}


def sc_w8a16(make, serve):
    eng = make(weight_dtype="int8")
    ids = submit_all(eng, prompts(4, 61), max_new_tokens=8)
    return {"tokens": toks(serve(eng), ids)}


def sc_w4a16(make, serve):
    eng = make(weight_dtype="int4")
    ids = submit_all(eng, prompts(4, 62), max_new_tokens=8)
    return {"tokens": toks(serve(eng), ids)}


def sc_scoring(make, serve):
    eng = make()
    return {"scores": eng.score_prompts(prompts(3, 71))}


def sc_gemma2(make, serve):
    eng = make(model="gemma2", hbm=10, host=64)
    ids = submit_all(eng, prompts(4, 83), max_new_tokens=8)
    return {"tokens": toks(serve(eng), ids)}


def sc_qwen3_moe(make, serve):
    eng = make(model="qwen3_moe")
    ids = submit_all(eng, prompts(4, 81), max_new_tokens=8)
    return {"tokens": toks(serve(eng), ids)}


def sc_gpt_oss(make, serve):
    eng = make(model="gpt_oss", hbm=10, host=64)
    ids = submit_all(eng, prompts(4, 82), max_new_tokens=8)
    return {"tokens": toks(serve(eng), ids)}


# the dense scenarios, served on (dp, ep, tp) = (1, 1, 2) and (2, 1, 2);
# the MoE ones on (1, 2, 2) in the world of 4, Gemma-2 on tp 2
DENSE = {"plain": sc_plain, "tiered": sc_tiered, "stream": sc_stream,
         "spec_plain": sc_spec_plain, "spec_sharded": sc_spec_sharded,
         "spec_replicated": sc_spec_replicated, "ngram": sc_ngram,
         "prefix": sc_prefix, "switch": sc_switch, "sessions": sc_sessions,
         "surface": sc_surface, "w8a16": sc_w8a16, "w4a16": sc_w4a16,
         "scoring": sc_scoring}
MOE = {"qwen3_moe": sc_qwen3_moe, "gpt_oss": sc_gpt_oss}
FAMILY = {"gemma2": sc_gemma2}
# the scenarios the JAX engine serves too (the others: sampled lanes, the
# port's own features, or the plain reference of spec = greedy decoding)
JAX_SCENARIOS = ("plain", "tiered", "stream", "spec_plain", "prefix",
                 "sessions", "surface", "w8a16", "qwen3_moe", "gpt_oss",
                 "gemma2")


def meshes(world: int) -> list[tuple[dict, tuple[int, int, int]]]:
    """[(scenarios, (dp, ep, tp))] a world of `world` ranks serves."""
    if world == 2:
        return [(DENSE, (1, 1, 2)), (FAMILY, (1, 1, 2))]
    return [(DENSE, (2, 1, 2)), (MOE, (1, 2, 2))]


def system_kwargs(hbm=64, host=128, batch=4, horizon=2, weight_dtype="native",
                  seq=96):
    return dict(cache=dict(block_size=8, num_hbm_blocks=hbm,
                           num_host_blocks=host, kv_dtype="int8"),
                prefetch=dict(enabled=True, depth=2),
                engine=dict(max_batch_size=batch, max_seq_len=seq,
                            prefill_chunk=32, decode_horizon=horizon,
                            weight_dtype=weight_dtype))


# -- the port's side -----------------------------------------------------------

def state_hash(eng) -> str:
    """Checksum of the engine's pools, host store and draft pools, guard
    slots left out (nothing reads them)."""
    h = hashlib.sha256()

    def add(t):
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())

    for p in eng.kvc.pools:
        add(p[:, :-1])
    st = eng.kvc.store
    if st is not None:
        for a in st.arrays:
            add(a[:st.host_slots * st.num_layers])
    spec_pools = getattr(eng.spec, "pools", None)
    if spec_pools is not None:
        for p in spec_pools:
            add(p[:, :-1])
    return h.hexdigest()[:16]


def port_maker(weights: str, parallel=(1, 1, 1)):
    """make(**kw) for the port's engines, weights from `weights`/<model>."""
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        KVDtype,
        ParallelConfig,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine
    from cxl_speckv_tpu_torch.models import load_params
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config

    def make(model="main", spec=None, **kw):
        s = system_kwargs(**kw)
        cc = dict(s["cache"], kv_dtype=KVDtype(s["cache"]["kv_dtype"]))
        dp, ep, tp = parallel
        sc = SystemConfig(cache=CacheConfig(**cc),
                          prefetch=PrefetchConfig(**s["prefetch"]),
                          engine=EngineConfig(**s["engine"]),
                          parallel=ParallelConfig(dp=dp, ep=ep, tp=tp))
        spec = dict(spec or {})
        draft = spec.pop("draft", None)
        if draft is not None:
            spec.update(draft_config=config(tiny_test_config(), draft),
                        draft_params=load_params(f"{weights}/{draft}",
                                                 device="cpu"))
        return Engine(config(tiny_test_config(), model), sc,
                      params=load_params(f"{weights}/{model}", device="cpu"),
                      device="cpu", enable_lstm=False, seed=0, **spec)

    return make


def port_serve(hashes: list | None):
    """serve(eng) stepping the port's engine to the end, appending
    `state_hash` after every step to `hashes` when given."""
    def serve(eng):
        outs = {}
        while eng.has_work:
            for o in eng.step():
                outs[o.req_id] = o
            if hashes is not None:
                hashes.append(state_hash(eng))
        eng.prefetcher.drain_training()
        return outs

    return serve


def derived_horizon(weights: str, world: int) -> dict:
    """An engine with the derived decode horizon (`decode_horizon` 0) on a
    dp x tp 2 mesh whose ranks measured different dispatch costs (rank 0 a
    realistic one, the others a hundred times its): the horizon it serves
    with, and the one this rank would derive alone."""
    import torch.distributed as dist

    from cxl_speckv_tpu_torch.utils import dispatch

    own_ms = 0.05 if dist.get_rank() == 0 else 50.0
    saved = dict(dispatch._dispatch_ms_cache)
    dispatch._dispatch_ms_cache["cpu"] = own_ms
    try:
        eng = port_maker(weights, (world // 2, 1, 2))(horizon=0)
        own = dispatch.derive_decode_horizon(
            dispatch.params_byte_size(eng.params) * 2, device="cpu")
    finally:
        dispatch._dispatch_ms_cache.clear()
        dispatch._dispatch_ms_cache.update(saved)
    return {"decode_horizon": eng.config.engine.decode_horizon, "own": own}


def fetched_ranks(world: int) -> dict:
    """`host_fetch` of each rank's own rank number: gathered over tp, and
    over the whole (dp, tp) mesh."""
    import torch.distributed as dist

    from cxl_speckv_tpu_torch.parallel.mesh import Mesh
    from cxl_speckv_tpu_torch.parallel.sharding import host_fetch

    mesh = Mesh(dp=world // 2, tp=2)
    mine = torch.full((1,), dist.get_rank())
    return {"tp": host_fetch(mine, mesh, "tp").tolist(),
            "all": host_fetch(mine, mesh, ("dp", "tp")).tolist(),
            "own": host_fetch(mine).tolist()}


def round_route(weights: str, world: int) -> dict:
    """How a mesh engine dispatched its decode rounds: eager, its gloo
    collectives on the host (`Engine._round_statistics`)."""
    eng = port_maker(weights, meshes(world)[0][1])()
    submit_all(eng, prompts(2, 9), max_new_tokens=6)
    port_serve(None)(eng)
    st = eng.get_statistics()
    e = st["engine"]
    return {"route": e["round_route"], "graph_rounds": e["graph_rounds"],
            "eager_rounds": e["eager_rounds"],
            "decode_batches": st["scheduler"]["decode_batches"],
            "cache": eng.round_graphs is None}


def run_rank(weights: str, world: int) -> dict:
    """Every scenario of this world on this rank (the world is up)."""
    from cxl_speckv_tpu_torch.scripts import multiproc_serve

    out = {}
    for scenarios, parallel in meshes(world):
        for name, fn in scenarios.items():
            hashes: list = []
            res = fn(port_maker(weights, parallel), port_serve(hashes))
            out[name] = {"result": res, "hashes": hashes,
                         "parallel": parallel}
    out["horizon"] = {"result": derived_horizon(weights, world),
                      "hashes": [], "parallel": None}
    out["host_fetch"] = {"result": fetched_ranks(world), "hashes": [],
                         "parallel": None}
    out["round_route"] = {"result": round_route(weights, world),
                          "hashes": [], "parallel": None}
    mode = "tpspan" if world == 2 else "dptp"
    rec = multiproc_serve.serve_rank(mode, "tiny", torch.device("cpu"))
    out["multiproc"] = {"result": rec, "hashes": [], "parallel": None}
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
    with open(f"{args.out}.rank{args.rank}.json", "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    main()
