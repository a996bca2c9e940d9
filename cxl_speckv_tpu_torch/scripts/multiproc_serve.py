"""Serving across real OS processes: a lockstep command log over a mesh
engine, one process a rank.

Counterpart of `scripts/multiproc_serve.py`. Each rank joins a
`torch.distributed` world (`parallel/distributed.py`: gloo on the CPU and
for ranks that share one card, NCCL for one card a rank), builds the same
mesh engine and serves lockstep rounds through `TorchProcessTransport`.
Two modes, both recorded in the record this returns and writes:

- `tpspan`: a world of 2, tp = 2. The model's collectives (the o / down
  all-reduces, the vocabulary gathers) cross the processes at every layer.
- `dptp`: a world of 4, dp = 2 x tp = 2. One process a rank, so both axes
  cross processes: the dp lanes' hidden states and appended KV rows as
  well as the tp collectives.

Each rank submits a different set of client requests in a different local
order (sampling knobs, stops, logprobs, penalties, a session and its next
turn, a cancel); the merge makes every engine's command stream, and so its
tokens, identical. The checks: every rank's outputs are byte-identical
(one digest), and equal to a single-process reference that merges the
same client streams through a `LocalFabric` into one-rank engines: tokens
and finish reasons equal (a divergence must be a top-2 swap of the
reference's logprobs under 0.06, where the request carries them), logprobs
within `LP_TOL` (see there). The record also holds what explains a logprob
gap: K1's split counts in both runs, and the INT8 KV codes of every rank's
pools against the reference's same heads (how many differ, by how many
quantization steps).

Usage:
  python -m cxl_speckv_tpu_torch.scripts.multiproc_serve [--device cpu]
      [--mode tpspan|dptp|all] [--model tiny|tiny-f32|1b] [--out PATH]

`--model 1b` serves Llama-3.2-1B's widths (random weights from the seed,
float32 activations and attention), `tiny-f32` the tiny model with its
attention in float32 (its own is bf16). The launcher writes its record to `--out` (a path
in the system's temporary directory by default); the ranks write theirs
beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import threading
from collections import Counter

import numpy as np
import torch

MODES = {
    # mode: (world, dp, tp)
    "tpspan": (2, 1, 2),
    "dptp": (4, 2, 2),
}
# logprobs, mesh against the single-process engine (float32 activations).
# The mesh sums the row-parallel o / down partials, and the card's matmuls
# over the shards' shapes, in another order: K / V scales ~5e-7 apart. On
# the card that moves values across rounding boundaries, and a value that
# crosses one moves by a whole step: an INT8 KV code (1/127 of its row's
# max; the 1B's pools held 29k of 1.57M codes one step apart, its logprobs
# 4.6e-3 apart) or, where attention computes in bf16 (the tiny model), a
# bf16 step of q or of p * vs inside K1 / K2 (every code equal, logprobs
# 5.4e-4 apart). H100 readings, `chip_smoke.py`'s [parallel] phase, which
# also serves the tiny model at float32 attention to show that without
# either the card stays within "exact". The CPU is held to "exact" always
# (<= 1.5e-6 measured there, at either attention dtype)
LP_TOL = {"exact": 1e-4, "rounded": 2e-2}
NEAR_TIE = 0.06        # a top-2 swap closer than this is a near tie


def model_config(name: str):
    from cxl_speckv_tpu_torch.models.configs import (
        llama_3_2_1b,
        tiny_test_config,
    )

    if name == "tiny":
        return tiny_test_config()
    if name == "tiny-f32":
        # attention in float32 too: nothing rounds at bf16 grade
        return dataclasses.replace(tiny_test_config(),
                                   attn_compute_dtype="float32")
    if name == "1b":
        return dataclasses.replace(llama_3_2_1b(), dtype="float32",
                                   attn_compute_dtype="float32")
    raise ValueError(f"unknown model {name!r}")


def build_engine(cfg, dp: int, tp: int, device):
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        KVDtype,
        ParallelConfig,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine
    from cxl_speckv_tpu_torch.models.llama import init_params

    # the same seed on every rank: the same full tree, cut per rank
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    params = init_params(cfg, gen, device)
    sc = SystemConfig(
        cache=CacheConfig(block_size=8, num_hbm_blocks=24, num_host_blocks=64,
                          kv_dtype=KVDtype.INT8),
        prefetch=PrefetchConfig(depth=2),
        engine=EngineConfig(max_batch_size=4, max_seq_len=96,
                            prefill_chunk=32, decode_horizon=2),
        parallel=ParallelConfig(dp=dp, tp=tp),
    )
    return Engine(cfg, sc, params=params, device=device, enable_lstm=False,
                  seed=0)


def drive(front, eng, cfg, rank: int, result: dict):
    """The serving script, as a generator that yields at every lockstep
    round barrier (the caller commits the round as its transport needs:
    `commit_round` for real processes, staged then applied on every
    frontend for the in-process reference). Fills `result` with the
    comparable outputs. The JAX script's command surface: sampling knobs,
    stops, logprobs, penalties, sessions and cancellation."""
    rng = np.random.RandomState(100 + rank)
    for i in range(3):
        prompt = rng.randint(1, cfg.vocab_size, 6 + 3 * rank + i).tolist()
        front.submit(prompt, max_new_tokens=8,
                     temperature=0.0 if i % 2 == 0 else 0.8,
                     top_p=1.0 if i % 2 == 0 else 0.9,
                     logprobs=2 if i == 0 else 0)
    front.submit(rng.randint(1, cfg.vocab_size, 7).tolist(),
                 max_new_tokens=6, frequency_penalty=1.0,
                 repetition_penalty=1.3)
    if rank == 0:
        front.submit(rng.randint(1, cfg.vocab_size, 8).tolist(),
                     max_new_tokens=4, session=True)
    h_dead = front.submit([7, 7, 7], max_new_tokens=40, ignore_eos=True)
    front.set_prefetch_depth(3)
    yield                     # round 1

    # cancel a committed request mid-serve (replicates the engine req_id)
    for _ in range(2):
        front.step()
    front.cancel(h_dead)
    yield                     # round 2
    res = {o.req_id: (o.tokens, o.finish_reason, o.logprobs)
           for o in front.run()}

    # round 3: the session's next turn (its client lives on rank 0; every
    # rank's engine knows the session) and fresh submissions
    sid = next((r.session_id for r in eng._requests.values()
                if r.session and r.session_id >= 0), None)
    if rank == 0 and sid is not None:
        front.continue_session(sid, [30, 31, 32], max_new_tokens=4)
    rng2 = np.random.RandomState(200 + rank)
    front.submit(rng2.randint(1, cfg.vocab_size, 10).tolist(),
                 max_new_tokens=6)
    yield                     # round 3
    res.update({o.req_id: (o.tokens, o.finish_reason, o.logprobs)
                for o in front.run()})
    # every rank cancelled its own request; both cancels reach every engine
    assert front.req_id(h_dead) in eng._requests
    for r in eng._requests.values():
        if r.finish_reason == "cancelled":
            res[r.req_id] = (list(r.output), r.finish_reason, None)
    result.update(res)


def digest(outs: dict) -> str:
    return hashlib.sha256(repr(sorted(outs.items())).encode()).hexdigest()


def host_pools(eng) -> list:
    """The engine's KV pools (codes and scales) on the host, without the
    guard slot (which nothing reads)."""
    return [p[:, :-1].cpu() for p in eng.kvc.pools]


def k1_splits(since: Counter) -> dict:
    """K1's launches by split count since the `since` snapshot."""
    from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention

    return {str(k): v for k, v in
            sorted((paged_attention.split_launches - since).items())}


def split_snapshot() -> Counter:
    from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention

    return Counter(paged_attention.split_launches)


def serve_rank(mode: str, model: str, device,
               pools_out: str | None = None) -> dict:
    """This rank's part of `mode` in an initialized world of its size; its
    pools go to `pools_out` when given."""
    import torch.distributed as dist

    from cxl_speckv_tpu_torch.parallel.lockstep import (
        LockstepFrontend,
        TorchProcessTransport,
    )

    world, dp, tp = MODES[mode]
    rank = dist.get_rank()
    if dist.get_world_size() != world:
        raise RuntimeError(f"{mode} needs a world of {world}, got "
                           f"{dist.get_world_size()}")
    cfg = model_config(model)
    eng = build_engine(cfg, dp, tp, device)
    if mode == "tpspan":
        # the point of the mode: the tp axis spans the processes
        assert eng.mesh.size("tp") == world
    front = LockstepFrontend(eng, rank, TorchProcessTransport())
    outs: dict = {}
    since = split_snapshot()
    for _ in drive(front, eng, cfg, rank, outs):
        front.commit_round()
    if pools_out:
        torch.save(host_pools(eng), pools_out)
    return {"rank": rank, "world": world, "backend": eng.mesh.backend,
            "mesh": {"dp": dp, "tp": tp},
            "tp_index": eng.mesh.coords["tp"],
            "k1_splits": k1_splits(since),
            "collectives": eng.mesh.stats(),
            "outputs": {str(k): v for k, v in sorted(outs.items())},
            "digest": digest(outs)}


# one reference at a time in a process, so that K1's split counts of a
# reference are its own when several modes are served from threads
_REFERENCE = threading.Lock()


def reference(mode: str, model: str, device) -> dict:
    """The same client streams merged through a `LocalFabric` into one-rank
    engines in this process (no collective): what every rank must serve.
    Also K1's split counts (of all `world` engines) and engine 0's pools."""
    from cxl_speckv_tpu_torch.parallel.lockstep import (
        LocalFabric,
        LockstepFrontend,
    )

    world = MODES[mode][0]
    cfg = model_config(model)
    fabric = LocalFabric(world)
    with _REFERENCE:
        since = split_snapshot()
        engs = [build_engine(cfg, 1, 1, device) for _ in range(world)]
        fronts = [LockstepFrontend(engs[r], r, fabric) for r in range(world)]
        results: list[dict] = [{} for _ in range(world)]
        gens = [drive(fronts[r], engs[r], cfg, r, results[r])
                for r in range(world)]
        for _ in range(3):                 # the script's three round barriers
            for g in gens:
                next(g)
            for f in fronts:
                f.stage_round()
            for f in fronts:
                f.apply_round()
        for g in gens:                     # each script's tail
            for _ in g:
                pass
        splits = k1_splits(since)
    if len({digest(r) for r in results}) != 1:
        raise RuntimeError("single-process reference engines diverged")
    outs = results[0]
    return {"digest": digest(outs),
            "outputs": {str(k): v for k, v in sorted(outs.items())},
            "k1_splits": splits, "pools": host_pools(engs[0])}


def code_flips(rank_pools: list, ref_pools: list, tp_index: int) -> dict:
    """A rank's pools against the reference's same kv heads (the rank's tp
    index picks them): the K / V codes that differ, the most quantization
    steps by which one does, and the scales' largest relative difference.
    Codes only where the pools hold INT8 (the script's KV dtype)."""
    hkv = rank_pools[0].shape[2]
    heads = slice(tp_index * hkv, (tp_index + 1) * hkv)
    codes = [(a.to(torch.int16), b[:, :, heads].to(torch.int16))
             for a, b in zip(rank_pools[:2], ref_pools[:2])]
    steps = [(a - b).abs() for a, b in codes]
    scales = [(a - b[:, :, heads]).abs() / b[:, :, heads].abs().clamp_min(
        1e-30) for a, b in zip(rank_pools[2:], ref_pools[2:])]
    return {"differ": int(sum(int((d > 0).sum()) for d in steps)),
            "of": int(sum(d.numel() for d in steps)),
            "max_steps": int(max(int(d.max()) for d in steps)),
            "scales_max_rel": float(max(float(d.max()) for d in scales))}


def compare(got: dict, want: dict,
            lp_tol: float = LP_TOL["exact"]) -> dict:
    """Tokens and finish reasons of `got` (a rank's outputs) against the
    reference's, with the near-tie rule where the reference has logprobs;
    logprobs within `lp_tol` where both agree on the tokens (also reported:
    the gap at the first generated token, which only the prefill feeds)."""
    if sorted(got) != sorted(want):
        return {"ok": False, "why": "different request ids"}
    ties, worst, first = [], 0.0, 0.0
    for rid, (toks, reason, lps) in want.items():
        gtoks, greason, glps = got[rid]
        n = next((i for i, (a, b) in enumerate(zip(gtoks, toks)) if a != b),
                 None)
        if n is None:
            if len(gtoks) != len(toks) or greason != reason:
                return {"ok": False, "why": f"request {rid}: length or "
                        f"finish reason differs"}
            for i, (g, w) in enumerate(zip(glps or [], lps or [])):
                gap = max(abs(g["logprob"] - w["logprob"]),
                          *(abs(a - b) for a, b in
                            zip(g["top_logprobs"], w["top_logprobs"])))
                worst = max(worst, gap)
                first = max(first, gap) if i == 0 else first
            continue
        rec = lps[n] if lps else None
        if (rec is None or gtoks[n] not in rec["top_ids"][:2]
                or len(rec["top_logprobs"]) < 2
                or rec["top_logprobs"][0] - rec["top_logprobs"][1]
                >= NEAR_TIE):
            return {"ok": False, "why": f"request {rid}: token {n} differs "
                    f"({gtoks[n]} vs {toks[n]}) and is no near tie"}
        ties.append((rid, n))
    if worst > lp_tol:
        return {"ok": False, "why": f"logprobs differ by {worst} (limit "
                f"{lp_tol})"}
    return {"ok": True, "near_ties": ties, "max_logprob_diff": worst,
            "first_token_logprob_diff": first}


def worker(args) -> None:
    from cxl_speckv_tpu_torch.parallel import distributed

    torch.set_num_threads(args.threads)
    device = distributed.initialize(args.rank, args.world, args.port,
                                    device=args.device)
    try:
        rec = serve_rank(args.mode, args.model, device,
                         pools_out=f"{args.out}.rank{args.rank}.pools.pt")
    finally:
        distributed.shutdown()
    with open(f"{args.out}.rank{args.rank}.json", "w") as f:
        json.dump(rec, f)
    print(f"rank {args.rank}: {len(rec['outputs'])} requests served, "
          f"digest {rec['digest'][:16]}", flush=True)


def launch_mode(mode: str, args) -> dict:
    from cxl_speckv_tpu_torch.parallel import distributed

    world, dp, tp = MODES[mode]
    out = f"{args.out}.{mode}"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rcs = distributed.launch(
        "cxl_speckv_tpu_torch.scripts.multiproc_serve", world,
        ["--mode", mode, "--model", args.model, "--device", args.device,
         "--threads", str(args.threads), "--out", out],
        timeout_s=args.timeout, cwd=repo)
    if any(rcs):
        raise RuntimeError(f"{mode}: rank return codes {rcs}")
    ranks = []
    for r in range(world):
        with open(f"{out}.rank{r}.json") as f:
            ranks.append(json.load(f))
    ref = reference(mode, args.model, rank_device(args.device))
    flips = [code_flips(torch.load(f"{out}.rank{r}.pools.pt"), ref["pools"],
                        ranks[r]["tp_index"]) for r in range(world)]
    # the looser limit only where the card's run has a cause for it
    rounded = (model_config(args.model).attn_compute_dtype != "float32"
               or any(f["differ"] for f in flips))
    tol = LP_TOL["rounded" if args.device != "cpu" and rounded else "exact"]
    cmp = compare({int(k): v for k, v in ranks[0]["outputs"].items()},
                  {int(k): v for k, v in ref["outputs"].items()}, tol)
    return {
        "process_count": world,
        "mesh": f"dp={dp} x tp={tp}, one process a rank",
        "backend": ranks[0]["backend"],
        "transport": "TorchProcessTransport (gloo all-gather)",
        "model": args.model,
        "requests_served": len(ranks[0]["outputs"]),
        "outputs_identical_across_processes":
            len({r["digest"] for r in ranks}) == 1,
        "digest": ranks[0]["digest"],
        "single_process_reference_digest": ref["digest"],
        "matches_single_process_reference": cmp["ok"],
        "reference_comparison": cmp,
        "logprob_limit": tol,
        "kv_codes_vs_reference": flips,
        "k1_splits": {"rank0": ranks[0]["k1_splits"],
                      f"reference ({world} engines)": ref["k1_splits"]},
        "collectives_rank0": ranks[0]["collectives"],
    }


def rank_device(device: str):
    return torch.device("cpu") if device == "cpu" else torch.device("cuda", 0)


def parse_args(argv=None) -> argparse.Namespace:
    from cxl_speckv_tpu_torch.parallel.distributed import add_rank_args
    from cxl_speckv_tpu_torch.scripts.common import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    add_rank_args(ap)
    ap.add_argument("--mode", choices=[*MODES, "all"], default="all")
    ap.add_argument("--model", choices=("tiny", "tiny-f32", "1b"),
                    default="tiny")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "speckv_multiproc.json"))
    ap.add_argument("--threads", type=int, default=1,
                    help="intra-op threads a rank")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the ranks are killed")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Serve every mode asked for; returns the record ({mode: ...}, "ok").
    Raises SystemExit without CUDA unless `--device cpu`."""
    from cxl_speckv_tpu_torch.scripts.common import resolve

    args = parse_args(argv)
    resolve(args.device, "multiproc_serve")
    if args.rank is not None:
        worker(args)
        return {}
    modes = list(MODES) if args.mode == "all" else [args.mode]
    record = {m: launch_mode(m, args) for m in modes}
    record["ok"] = all(record[m]["outputs_identical_across_processes"]
                       and record[m]["matches_single_process_reference"]
                       for m in modes)
    print(json.dumps(record, indent=1), flush=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    rec = main()
    sys.exit(0 if rec.get("ok", True) else 1)
