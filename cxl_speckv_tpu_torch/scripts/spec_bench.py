"""Speculative-decoding serving throughput on the tiered engine, on the
card.

    python -m cxl_speckv_tpu_torch.scripts.spec_bench [--model 1b|8b|tiny] \\
        [--arms plain,ngram,self,draft] [--gamma 4] [--n 32] [--prompt 64] \\
        [--gen 64] [--reps 1] [--device cpu]

Counterpart of the JAX package's TPU script `scripts/spec_bench.py`
(`build` at `:62`, `run` at `:106`, `main` at `:118`). The arms serve one
tiered workload (`--n` requests of `--prompt` + `--gen` tokens, INT8 KV in
32-token blocks, an HBM pool of two batches' blocks plus a few, the rest
in the host tier, prefetch off):

  plain   no speculation, fused decode at `--horizon` (0: the engine's
          derived horizon)
  ngram   prompt lookup proposes (`engine/spec.py:NgramProposer`)
  self    the target drafts for itself (the acceptance ceiling; it pays
          gamma full-size draft steps a round)
  draft   a separate draft: Llama-3.2-1B with other weights (seed 7; for
          the tiny model, the tiny config), INT8 draft KV

Each arm serves the workload once to warm (the JAX script's compile pass;
here the kernels build at first use, and `--no-warm` skips it), then
`--reps` times on a fresh engine; the best rep is kept. Times are the host clock around
`Engine.run` after `torch.cuda.synchronize()`. A row holds tok/s, wall
seconds, tokens, hit rate, migrations, decode seconds and the engine's
phase timers (the spec arms' `decode.spec_resident` / `_propose` /
`_verify` among them), and for a spec arm acceptance, tokens a round,
rounds and ms a round (for plain: ms a decode batch). The JSON at the end
has the JAX script's keys (`:246-265`): model, gamma, batch, workload,
quantum, oversubscription, arms, and with plain and ngram both run
`ngram_speedup_vs_plain_at_acceptance` and the machine constants
`measured` {t_tok_ms, t_round_ms}. Random weights make acceptance
meaningless as a speed claim; the constants are what carries over. Weights
are random from seed 0 on the device (1B: bf16 quantized to W8A16 by the
engine; 8B: W8A16 at init; tiny: float32). The JAX model default (8b on a
TPU, tiny elsewhere) becomes 8b on the card and tiny on `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys

import numpy as np

from cxl_speckv_tpu_torch.scripts import common

JSON_KEYS = ("model", "gamma", "batch", "workload", "quantum",
             "oversubscription", "arms")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=None, choices=["1b", "8b", "tiny"])
    ap.add_argument("--arms", default="plain,ngram,self,draft")
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=0,
                    help="plain arm's fused horizon (0 = auto)")
    ap.add_argument("--quantum", type=int, default=4,
                    help="scheduler stint length in ticks (a spec round is "
                         "one tick)")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--no-warm", dest="warm", action="store_false",
                    help="skip each arm's warm-up serve")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def tiny_config():
    """The JAX script's CPU model (`:147-152`)."""
    from cxl_speckv_tpu_torch.models.configs import llama_3_2_1b

    return dataclasses.replace(
        llama_3_2_1b(), num_layers=2, hidden_size=256, intermediate_size=512,
        vocab_size=1024, num_q_heads=8, num_kv_heads=4, head_dim=32,
        dtype="float32")


def build(model_config, params, *, batch, n_requests, prompt_len, gen,
          horizon, weight_dtype, device, spec=None, gamma=4,
          draft_config=None, draft_params=None, bs=32, prefill_chunk=None,
          quantum=4):
    """The arm's engine (`:62-103`); returns (engine, demand / HBM
    blocks)."""
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        KVDtype,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine

    max_seq = prompt_len + gen + gamma + bs
    blocks_per_seq = -(-max_seq // bs)
    hbm_blocks = 2 * batch * blocks_per_seq + max(3, blocks_per_seq // 2)
    host_blocks = n_requests * blocks_per_seq + 8
    sc = SystemConfig(
        cache=CacheConfig(block_size=bs, num_hbm_blocks=hbm_blocks,
                          num_host_blocks=host_blocks,
                          kv_dtype=KVDtype("int8"),
                          prefetch_reserve_frac=0.25),
        prefetch=PrefetchConfig(enabled=False, train_online=False),
        engine=EngineConfig(max_batch_size=batch, max_seq_len=max_seq,
                            prefill_chunk=prefill_chunk
                            or min(128, max(32, prompt_len)),
                            decode_horizon=horizon, sched_quantum=quantum,
                            weight_dtype=weight_dtype))
    kw = {}
    if spec == "ngram":
        kw = dict(spec_ngram=True, spec_gamma=gamma)
    elif spec in ("self", "draft"):
        kw = dict(draft_config=draft_config, draft_params=draft_params,
                  spec_gamma=gamma, spec_draft_kv="int8")
    eng = Engine(model_config, sc, params=params, device=device,
                 enable_lstm=False, seed=0, **kw)
    return eng, n_requests * blocks_per_seq / hbm_blocks


def serve(eng, *, n_requests, prompt_len, gen, seed=0):
    """The workload (`:106-115`); returns (tokens emitted, seconds, each
    request's output in submission order)."""
    rng = np.random.RandomState(seed)
    vocab = eng.model_config.vocab_size
    ids = [eng.add_request(rng.randint(1, vocab, prompt_len).tolist(),
                           max_new_tokens=gen) for _ in range(n_requests)]
    outs, dt = common.wall(eng.run, eng.device.type)
    by_id = {o.req_id: o for o in outs}
    return (sum(len(o.tokens) for o in outs), dt,
            [by_id.get(i) for i in ids])


def row_of(eng, toks, dt, spec, gamma) -> dict:
    st = eng.get_statistics()
    row = {"tok_s": toks / dt, "wall_s": dt, "tokens": toks,
           "hit_rate": st["directory"]["hit_rate"],
           "migrations": (st["transfer"]["up_transfers"]
                          + st["transfer"]["down_transfers"]),
           "decode_s": st["engine"]["decode_time_s"],
           "phases": {k: {"total_s": round(v.get("total_s", 0.0), 2),
                          "p50_ms": round(v.get("p50_ms", 0.0), 1),
                          "p95_ms": round(v.get("p95_ms", 0.0), 1)}
                      for k, v in sorted(st["phases"].items())
                      if v.get("total_s", 0.0) > 0.01}}
    if spec:
        sp = st["spec"]
        row.update(acceptance=sp["acceptance_rate"],
                   tokens_per_round=sp["tokens_per_round"],
                   rounds=sp["rounds"], gamma=gamma)
        row["round_ms"] = (row["decode_s"] / sp["rounds"] * 1e3
                           if sp["rounds"] else 0.0)
    else:
        dbatches = st["scheduler"]["decode_batches"]
        row["step_ms"] = (row["decode_s"] / dbatches * 1e3
                          if dbatches else 0.0)
    return row


def derived(out: dict, results: dict, gamma: int, batch: int) -> None:
    """The machine constants and the speedup curve (`:236-253`)."""
    plain, ng = results["plain"], results["ngram"]
    t_tok = plain["decode_s"] / plain["tokens"]
    t_round = ng["decode_s"] / ng["rounds"]
    out["ngram_speedup_vs_plain_at_acceptance"] = {
        f"{a:.1f}": round(t_tok / (t_round / (batch * (1 + gamma * a))), 2)
        for a in (0.0, 0.3, 0.5, 0.7, 0.9, 1.0)}
    out["measured"] = {"t_tok_ms": round(t_tok * 1e3, 2),
                       "t_round_ms": round(t_round * 1e3, 2)}


def run(args: argparse.Namespace) -> dict:
    """Returns {"json": the printed object, "tokens": {arm: each request's
    tokens of the kept rep}, "finished": {arm: every request emitted
    --gen tokens or stopped}}."""
    from cxl_speckv_tpu_torch.models.configs import llama_3_2_1b, llama_3_8b
    from cxl_speckv_tpu_torch.models.llama import (
        init_params,
        init_params_quantized,
    )

    dev = common.resolve(args.device, "spec_bench")
    prefix = common.label(dev)
    model = args.model or ("8b" if dev == "cuda" else "tiny")
    gen = common.seeded(dev, 0)
    if model == "tiny":
        config = tiny_config()
        params = init_params(config, gen, device=dev)
        weight_dtype = "native"
        args.batch, args.n = min(args.batch, 2), min(args.n, 8)
        args.prompt, args.gen = min(args.prompt, 32), min(args.gen, 24)
    elif model == "8b":
        config = llama_3_8b()
        params = init_params_quantized(config, gen, device=dev)
        weight_dtype = "int8"
    else:
        config = llama_3_2_1b()
        params = init_params(config, gen, device=dev)
        weight_dtype = "int8"
    arms = [a.strip() for a in args.arms.split(",") if a.strip()]
    draft_cfg = draft_params = None
    if "draft" in arms:
        draft_cfg = config if model == "tiny" else llama_3_2_1b()
        draft_params = init_params(draft_cfg, common.seeded(dev, 7),
                                   device=dev)
    wl = dict(n_requests=args.n, prompt_len=args.prompt, gen=args.gen)
    results, tokens, finished, oversub = {}, {}, {}, 0.0
    for arm in arms:
        spec = None if arm == "plain" else arm
        dc, dp = {"self": (config, params),
                  "draft": (draft_cfg, draft_params)}.get(arm, (None, None))
        horizon = args.horizon if arm == "plain" else 1
        kw = dict(batch=args.batch, horizon=horizon, weight_dtype=weight_dtype,
                  device=dev, spec=spec, gamma=args.gamma, draft_config=dc,
                  draft_params=dp, quantum=args.quantum, **wl)
        eng, oversub = build(config, params, **kw)
        if args.warm:
            _, dt, _ = serve(eng, seed=99, **wl)
            print(f"{prefix} | # {arm}: warm done in {dt:.1f} s", flush=True)
        best = None
        for rep in range(args.reps):
            del eng
            gc.collect()
            eng, oversub = build(config, params, **kw)
            toks, dt, per_req = serve(eng, seed=0, **wl)
            row = row_of(eng, toks, dt, spec, args.gamma)
            if best is None or row["tok_s"] > best["tok_s"]:
                best = row
                tokens[arm] = [o.tokens if o else None for o in per_req]
                finished[arm] = common.all_finished(per_req)
            print(f"{prefix} | # {arm} rep{rep}: {row['tok_s']:.1f} tok/s "
                  + (f"acc={row.get('acceptance', 0):.3f} "
                     f"tok/round={row.get('tokens_per_round', 0):.2f}"
                     if spec else ""), flush=True)
        results[arm] = best
        del eng
        gc.collect()
    out = {"model": model, "gamma": args.gamma, "batch": args.batch,
           "workload": f"{args.n}x{args.prompt}+{args.gen}",
           "quantum": args.quantum, "oversubscription": round(oversub, 2),
           "arms": results}
    if "plain" in results and "ngram" in results:
        derived(out, results, args.gamma, args.batch)
    print(f"{prefix} | spec_bench result:")
    print(json.dumps(out, indent=1), flush=True)
    return {"json": out, "tokens": tokens, "finished": finished}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
