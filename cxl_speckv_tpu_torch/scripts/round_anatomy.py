"""Decode-round anatomy on the card: split a fused decode round's time into
dispatch, weight-stream, KV-stream and compute terms.

    python -m cxl_speckv_tpu_torch.scripts.round_anatomy [--reps 5] \\
        [--smoke] [--device cpu]

Counterpart of the JAX package's TPU script `scripts/round_anatomy.py`
(`main` at `:37`, `run` at `:131`, the decomposition at `:157-200`). It
sweeps the port's production decode program, `models/llama.py`
`decode_multi_packed` (the function the engine dispatches; K1 in every
layer of every step), at the script's geometry: Llama-3.2-1B, B 8 lanes,
32-token blocks, INT8 KV, 16-block tables (`--smoke`: the tiny config, B 2,
bs 8, horizons 1 / 2, context 1 / 2 blocks), along three axes:

  horizon 1 / 4 / 16     per-dispatch against per-step cost
  weights bf16 / int8    the weight-stream term (W8A16,
                         `ops/wquant.quantize_weights`): weight-byte delta
                         over the per-step time delta
  context 2 / 8 blocks   the KV term (the same program; lens are data)

Each point prints three times for one call of `horizon` steps:

- host: the host clock around the call and the copy of its tokens to the
  host, after `torch.cuda.synchronize()` (the JAX column; the TPU's
  "value fetch because block_until_ready lies" has no place here: the
  synchronize is exact);
- window: two CUDA events around the same (a window that holds the host's
  dispatch gaps too, since the device waits for the eager launches);
- busy: the device's own time, the sum of every kernel's and copy's time
  that `torch.profiler` records in one more call (`common.device_busy_s`),
  at the points the decomposition reads (`profiled_points`),

and the K1 / K2 launches of the point's calls. On the card every point
runs twice: eagerly (`graphs=None`, the launches dispatched from the host)
and as the engine runs it, replayed from a CUDA graph
(`models/round_graph.RoundGraphs`: the key's eager round and its capture
are the two warm calls). Then `decompose` runs the JAX script's arithmetic
on the eager host times, the eager busy times and the graph host times:
dispatch a call, the weight stream's rate from the bf16 / int8 slope delta,
the KV stream's rate from the context slope, and the compute floor. Eager
host minus busy a step is the per-step host dispatch; the graph's host
time a step shows what of it the captured round leaves. On
`--device cpu` the plain versions run eagerly, every time is the host's
and busy is "not measured".

The port's W8A16 matmul reads each int8 weight once and converts it in
registers (`ops/wquant.mm`, `ops/w8a16_mm.py`), as XLA's fusion does for
the JAX script; where the int8 arm's slope is not below the bf16 arm's,
the weight stream's rate (and with it the compute floor) prints nan, as
the JAX arithmetic gives it.

Weight bytes count a quantized leaf as its q bytes plus float32 scale
bytes (`:112-121`); an int4 tree's q holds two nibbles a byte, so its
packed bytes are counted. The script's `--slots` stays (a pool of that
many slots; on the card a pool small enough for the 50 MB L2 reads faster,
as one in VMEM did on the TPU).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cxl_speckv_tpu_torch.scripts import common

ARMS = ("bf16", "int8")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config (mechanics only)")
    ap.add_argument("--slots", type=int, default=0,
                    help="pool slot count override (the pool-size effect)")
    ap.add_argument("--horizons", default="",
                    help="comma-separated horizon override, e.g. 16,32,64")
    ap.add_argument("--arms", default="bf16,int8",
                    help="weight arms to run (comma-separated)")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def geometry(smoke: bool, slots: int = 0, horizons: str = "") -> dict:
    """The sweep's shapes (`scripts/round_anatomy.py:70-80`)."""
    B, bs = (2, 8) if smoke else (8, 32)
    max_blocks = 16
    num_slots = slots or B * max_blocks + 1
    if num_slots <= B * max_blocks:
        raise ValueError("slots must cover B * max_blocks + a guard")
    hs = (1, 2) if smoke else (1, 4, 16)
    if horizons:
        hs = tuple(int(h) for h in horizons.split(","))
    return {"B": B, "bs": bs, "max_blocks": max_blocks,
            "num_slots": num_slots, "horizons": hs,
            "ctxs": (1, 2) if smoke else (2, 8)}


def fresh_pools(config, num_slots: int, bs: int, device) -> tuple:
    """Zero INT8 K / V and unit scales in the port's token-major layout
    ([L, S, Hkv, bs, D] and [L, S, Hkv, bs]): the JAX script's
    `fresh_pools` (`:92-95`) content."""
    c = config
    shape = (c.num_layers, num_slots, c.num_kv_heads, bs, c.head_dim)
    return (torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.ones(shape[:-1], device=device),
            torch.ones(shape[:-1], device=device))


def packed_for(B: int, bs: int, max_blocks: int, num_slots: int,
               ctx_blocks: int) -> np.ndarray:
    """The packed decode input the engine builds (`:97-110`): first token
    7 at position ctx_blocks * bs - 2, greedy, rng counter 1, lane b's
    table the slots b * max_blocks .. (b + 1) * max_blocks - 1."""
    packed = np.zeros((B, 4 + max_blocks), np.int32)
    packed[:, 0] = 7
    packed[:, 1] = ctx_blocks * bs - 2
    packed[:, 2] = 0
    packed[:, 3] = 1
    packed[:, 4:] = num_slots - 1
    for b in range(B):
        packed[b, 4:4 + max_blocks] = np.arange(b * max_blocks,
                                                (b + 1) * max_blocks)
    return packed


def weight_gb(params) -> float:
    """GB of the weight tree (`:112-121`): a quantized leaf is its q bytes
    (an int4 q: packed, two nibbles a byte) plus 4 bytes a scale."""
    from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

    leaves = [v for k, v in params.items() if k != "layers"]
    leaves += list(params["layers"].values())
    tot = 0
    for x in leaves:
        if isinstance(x, QuantizedTensor):
            tot += x.q.numel() * x.q.element_size() + x.s.numel() * 4
        else:
            tot += x.numel() * x.element_size()
    return tot / 1e9


def kv_gb_per_step(config, B: int, bs: int, ctx_blocks: int) -> float:
    """INT8 KV bytes a decode step reads (`:123-125`)."""
    c = config
    return (B * ctx_blocks * bs * c.num_layers * 2 * c.num_kv_heads
            * c.head_dim) / 1e9


def decompose(results: dict, weight_gb: dict, kv_gb_per_step, horizons,
              ctxs) -> dict:
    """The JAX script's decomposition (`:157-200`) of `results`
    {(arm, horizon, ctx_blocks): seconds a call}; `weight_gb` {arm: GB},
    `kv_gb_per_step(ctx_blocks)` -> GB. Returns seconds and GB/s: dispatch
    and slope by arm, the weight stream's rate and per-step time at int8,
    the KV stream's rate and its per-step time at the small context, the
    compute floor, the int8 per-step total and a 16-step round."""
    hi, lo = max(horizons), min(horizons)
    cb_hi, cb_lo = max(ctxs), min(ctxs)
    slope = {wq: (results[(wq, hi, cb_lo)] - results[(wq, lo, cb_lo)])
             / (hi - lo) for wq in ARMS}
    dispatch = {wq: results[(wq, lo, cb_lo)] - lo * slope[wq] for wq in ARMS}
    wdelta_gb = weight_gb["bf16"] - weight_gb["int8"]
    wstep = slope["bf16"] - slope["int8"]
    rate = wdelta_gb / wstep if wstep > 0 else float("nan")
    kvstep = (results[("int8", hi, cb_hi)] - results[("int8", hi, cb_lo)]) / (
        hi - lo)
    kv_gb = kv_gb_per_step(cb_hi) - kv_gb_per_step(cb_lo)
    kv_rate = kv_gb / kvstep if kvstep > 0 else float("nan")
    w_int8_s = weight_gb["int8"] / rate if rate == rate else float("nan")
    kv_lo_s = kv_gb_per_step(cb_lo) / kv_rate if kv_rate == kv_rate else 0.0
    return {"slope": slope, "dispatch": dispatch, "rate_gbs": rate,
            "w_int8_s": w_int8_s, "kv_rate_gbs": kv_rate, "kv_lo_s": kv_lo_s,
            "resid": slope["int8"] - w_int8_s - kv_lo_s,
            "step_s": slope["int8"],
            "round16_s": dispatch["int8"] + 16 * slope["int8"]}


def launches() -> tuple[int, int]:
    from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
        paged_chunk_attention_cuda,
    )
    from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention

    return (sum(paged_attention.launches.values()),
            sum(paged_chunk_attention_cuda.launches.values()))


def profiled_points(g: dict) -> set:
    """The points `decompose` reads (both arms at the lowest and highest
    horizon at the smallest context, int8 at the highest horizon at the
    largest): the ones whose busy time is profiled."""
    hi, lo = max(g["horizons"]), min(g["horizons"])
    cb_hi, cb_lo = max(g["ctxs"]), min(g["ctxs"])
    return ({(wq, h, cb_lo) for wq in ARMS for h in (lo, hi)}
            | {("int8", hi, cb_hi)})


def run_point(params, config, g: dict, horizon: int, ctx_blocks: int,
              reps: int, device: str, profile: bool = True,
              graphed: bool = False) -> dict:
    """One point: a warm call, then `reps` calls timed on the host clock
    and in a CUDA-event window (medians), then on the card with `profile`
    one profiled call for the device's busy time. `graphed`: through a
    `RoundGraphs` cache, with one more warm call (the key's eager round,
    then the capture). Returns seconds a call, the calls made, the K1 / K2
    launches they made and the tokens of the last call."""
    from cxl_speckv_tpu_torch.config import KVDtype
    from cxl_speckv_tpu_torch.models.llama import decode_multi_packed
    from cxl_speckv_tpu_torch.models.round_graph import RoundGraphs

    pk = packed_for(g["B"], g["bs"], g["max_blocks"], g["num_slots"],
                    ctx_blocks)
    pools = fresh_pools(config, g["num_slots"], g["bs"], device)
    graphs = RoundGraphs(device) if graphed else None
    call = lambda: decode_multi_packed(
        params, config, KVDtype.INT8, pk, pools, horizon=horizon,
        graphs=graphs).cpu().numpy()
    k1, k2 = launches()
    if graphed:
        call()
    toks, host, window = common.timed_calls(call, device, reps)
    calls = reps + 1 + graphed
    busy = None
    if device == "cuda" and profile:
        toks, busy = common.device_busy_s(call)
        calls += 1
    k1b, k2b = launches()
    return {"host": host, "window": window, "busy": busy, "calls": calls,
            "k1": k1b - k1, "k2": k2b - k2, "tokens": toks}


def print_decomposition(tag: str, d: dict, wgb: dict, kvgb, B: int, bs: int,
                        cb_lo: int, config, prefix: str) -> None:
    print(f"{prefix} | # decomposition on {tag} (per decode STEP, int8-weight "
          f"arm, ctx={cb_lo * bs} tok):")
    print(f"{prefix} | #   dispatch overhead  {d['dispatch']['int8'] * 1e3:7.2f}"
          f" ms/dispatch (bf16 arm {d['dispatch']['bf16'] * 1e3:.2f})")
    print(f"{prefix} | #   weight stream      {d['w_int8_s'] * 1e3:7.2f} ms/step"
          f"  ({wgb['int8']:.2f} GB at {d['rate_gbs']:.0f} GB/s, from the "
          f"bf16/int8 slope delta)")
    print(f"{prefix} | #   kv stream          {d['kv_lo_s'] * 1e3:7.2f} ms/step"
          f"  ({kvgb(cb_lo) * 1e3:.1f} MB at {d['kv_rate_gbs']:.0f} GB/s, "
          f"from the context slope)")
    print(f"{prefix} | #   compute/seq floor  {d['resid'] * 1e3:7.2f} ms/step"
          f"  (projections+RoPE+norms on [B={B}, {config.hidden_size}], K1, "
          f"argmax over [{B}, {config.vocab_size}], the step's launches)")
    print(f"{prefix} | #   per-step total     {d['step_s'] * 1e3:7.2f} ms/step;"
          f" 16-step round = {d['round16_s'] * 1e3:.1f} ms", flush=True)


def run(args: argparse.Namespace) -> dict:
    """The sweep and its decompositions; returns {"points": {(arm,
    horizon, ctx_blocks): run_point's dict}, "weight_gb", "host" and
    "busy" decompositions (None where not computed), "host_dispatch_step_s"
    (host minus busy a step), "layers"}."""
    from cxl_speckv_tpu_torch.models.configs import (
        llama_3_2_1b,
        tiny_test_config,
    )
    from cxl_speckv_tpu_torch.models.llama import init_params
    from cxl_speckv_tpu_torch.ops.wquant import quantize_weights

    dev = common.resolve(args.device, "round_anatomy")
    prefix = common.label(dev)
    config = tiny_test_config() if args.smoke else llama_3_2_1b()
    g = geometry(args.smoke, args.slots, args.horizons)
    params = init_params(config, common.seeded(dev, 0), device=dev)
    wanted = args.arms.split(",")
    arms = {}
    if "bf16" in wanted:
        arms["bf16"] = params
    if "int8" in wanted:
        arms["int8"] = quantize_weights(params)
    wgb = {k: weight_gb(p) for k, p in arms.items()}
    kvgb = lambda cb: kv_gb_per_step(config, g["B"], g["bs"], cb)
    print(f"{prefix} | # B={g['B']} lanes, {config.num_layers} layers, "
          f"bs={g['bs']}, INT8 KV, K1 {'kernel' if dev == 'cuda' else 'plain'}"
          f"; times are medians of {args.reps} (first call dropped); weights "
          + ", ".join(f"{k} {v:.3f} GB" for k, v in wgb.items()), flush=True)
    points = {}
    profiled = profiled_points(g)
    routes = ("eager", "graph") if dev == "cuda" else ("eager",)
    for wq, p in arms.items():
        for h in g["horizons"]:
            for cb in g["ctxs"]:
                for route in routes:
                    r = run_point(p, config, g, h, cb, args.reps, dev,
                                  profile=(wq, h, cb) in profiled,
                                  graphed=route == "graph")
                    if route == "eager":
                        points[(wq, h, cb)] = r
                    else:
                        points[(wq, h, cb)]["graph"] = r
                    busy = ("busy not measured (cpu)" if dev == "cpu" else
                            f"window {r['window'] * 1e3:8.1f} ms  busy "
                            + ("not profiled (unused)" if r["busy"] is None
                               else f"{r['busy'] * 1e3:8.2f} ms"))
                    print(f"{prefix} | {wq:5s} {route:5s} horizon={h:3d} "
                          f"ctx={cb * g['bs']:4d}tok  host "
                          f"{r['host'] * 1e3:8.1f} ms  {busy}  K1 {r['k1']} "
                          f"K2 {r['k2']} launches in {r['calls']} calls",
                          flush=True)
    out = {"points": points, "weight_gb": wgb, "host": None, "busy": None,
           "graph_host": None, "host_dispatch_step_s": None,
           "layers": config.num_layers}
    if len(g["horizons"]) < 2 or set(arms) != set(ARMS):
        return out
    for tag in ("host", "busy", "graph_host"):
        if tag == "graph_host" and "graph" not in routes:
            continue
        res = {k: (v["graph"]["host"] if tag == "graph_host" else v[tag])
               for k, v in points.items()}
        if any(res[k] is None for k in profiled):
            continue
        out[tag] = decompose(res, wgb, kvgb, g["horizons"], g["ctxs"])
        label = ("graph host time (replayed rounds)" if tag == "graph_host"
                 else f"eager {tag} time")
        print_decomposition(label, out[tag], wgb, kvgb, g["B"],
                            g["bs"], min(g["ctxs"]), config, prefix)
    if out["busy"] is not None:
        h, b = out["host"], out["busy"]
        out["host_dispatch_step_s"] = h["step_s"] - b["step_s"]
        print(f"{prefix} | # eager host minus busy: "
              f"{out['host_dispatch_step_s'] * 1e3:.2f} ms a step of host "
              f"dispatch (the eager launches); a dispatch "
              f"{(h['dispatch']['int8'] - b['dispatch']['int8']) * 1e3:.2f}"
              f" ms", flush=True)
    if out["graph_host"] is not None:
        gh = out["graph_host"]
        print(f"{prefix} | # graph rounds: {gh['step_s'] * 1e3:.2f} ms a "
              f"step on the host clock against eager "
              f"{out['host']['step_s'] * 1e3:.2f} (busy "
              + (f"{out['busy']['step_s'] * 1e3:.2f}" if out["busy"]
                 else "not measured") + "); a dispatch "
              f"{gh['dispatch']['int8'] * 1e3:.2f} ms", flush=True)
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
