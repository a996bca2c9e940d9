"""Host-streamed serving on the card against an ample pooled engine.

    python -m cxl_speckv_tpu_torch.scripts.stream_bench [--model 1b|8b] \\
        [--prompt 2048] [--gen 32] [--lanes 2] [--horizon 1] [--chunk 128] \\
        [--device cpu]

Counterpart of the JAX package's TPU script `scripts/stream_bench.py`
(`:25-132`). Prompts longer than the HBM pool are served through the
host-streamed path (their KV lives in the pinned host tier and attention
reads it wave by wave, `ops/stream_attention.py`; no K1 / K2 launch), and
the same prompts on an ample pooled engine: Llama-3.2-1B (bf16 weights)
or Llama-3-8B (`--model 8b`, W8A16), `--lanes` prompts of `--prompt`
tokens and `--gen` new ones, INT8 KV in 32-token blocks, the streamed
engine's pool max(4, blocks // 8) blocks and its max_seq_len 128 (so every
prompt streams), waves of 128 blocks. Each engine is warmed once on the
same prompts (2 new tokens), as the JAX script warms its programs.

It prints, for each engine, the host clock of the run (after
`torch.cuda.synchronize()`), generated and total tok/s and the stream
counters; whether the streamed tokens equal the pooled ones; and their
throughput ratio (`:96-128`). The port adds, for the streamed run, the
bytes its decode steps staged from the host tier a step
(`DeviceHostStore.staged_bytes`) and the host-to-device rate of those
staging copies (their bytes over their CUDA-event time,
`DeviceHostStore.copy_events`). On `--device cpu` (the JAX script's
non-TPU branch) the model is cut to 2 layers of width 256 at float32
(attention compute float32 too), 96 + 8 tokens, and times are the host's.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from cxl_speckv_tpu_torch.scripts import common

BS = 32


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--horizon", type=int, default=1,
                    help="fused decode steps per dispatch")
    ap.add_argument("--chunk", type=int, default=128,
                    help="prefill chunk width")
    ap.add_argument("--model", choices=("1b", "8b"), default="1b")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def build(config, params, args, hbm_blocks, host_blocks, max_seq, device):
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        KVDtype,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine

    sc = SystemConfig(
        cache=CacheConfig(block_size=BS, num_hbm_blocks=hbm_blocks,
                          num_host_blocks=host_blocks,
                          kv_dtype=KVDtype.INT8),
        prefetch=PrefetchConfig(enabled=False),
        engine=EngineConfig(max_batch_size=args.lanes, max_seq_len=max_seq,
                            prefill_chunk=args.chunk, stream_wave=128,
                            decode_horizon=args.horizon,
                            weight_dtype=("int8" if args.model == "8b"
                                          and device == "cuda" else "native")))
    return Engine(config, sc, params=params, device=device,
                  enable_lstm=False, seed=0)


def serve(eng, prompts, gen, device, staged: bool = False):
    """Serve to the end; returns (each prompt's output, seconds, and with
    `staged` the decode steps' (staged bytes, staging copy seconds,
    steps))."""
    import time

    rids = [eng.add_request(p, max_new_tokens=gen) for p in prompts]
    reqs = [eng._requests[r] for r in rids]
    outs = {}
    common.sync(device)
    t0 = time.perf_counter()
    if staged:
        while eng.has_work and not all(r.output for r in reqs):
            outs.update({o.req_id: o for o in eng.step()})
        store = eng.kvc.store
        store.staged_bytes = 0
        store.copy_events = [] if device == "cuda" else None
        first = sum(len(r.output) for r in reqs)
    while eng.has_work:
        outs.update({o.req_id: o for o in eng.step()})
    common.sync(device)
    dt = time.perf_counter() - t0
    done = [outs.get(r) for r in rids]
    if not staged:
        return done, dt, None
    copy_s = sum(a.elapsed_time(b) for a, b in store.copy_events or []) / 1e3
    steps = sum(len(r.output) for r in reqs) - first
    return done, dt, (store.staged_bytes, copy_s, steps)


def run(args: argparse.Namespace) -> dict:
    """Returns {"streamed", "pooled": each lane's tokens, "tok_s":
    {streamed, pooled}, "same", "ratio", "staged_gb_step", "h2d_gb_s",
    "stream_tokens", "finished"}."""
    from cxl_speckv_tpu_torch.models.configs import llama_3_2_1b, llama_3_8b
    from cxl_speckv_tpu_torch.models.llama import (
        init_params,
        init_params_quantized,
    )

    dev = common.resolve(args.device, "stream_bench")
    prefix = common.label(dev)
    config = llama_3_2_1b() if args.model == "1b" else llama_3_8b()
    if dev == "cpu":
        config = dataclasses.replace(
            config, num_layers=2, hidden_size=256, intermediate_size=512,
            vocab_size=1024, num_q_heads=8, num_kv_heads=4, head_dim=32,
            dtype="float32", attn_compute_dtype="float32")
        args.prompt, args.gen = 96, 8
    gen = common.seeded(dev, 0)
    if args.model == "8b" and dev == "cuda":
        params = init_params_quantized(config, gen, device=dev)
    else:
        params = init_params(config, gen, device=dev)
    total = args.prompt + args.gen
    blocks = -(-total // BS)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, config.vocab_size, args.prompt).tolist()
               for _ in range(args.lanes)]
    hbm_small = max(4, blocks // 8)
    if (hbm_small - 2) * BS >= total:
        raise ValueError("geometry would not stream")
    tight = (hbm_small, args.lanes * blocks + 8, BS * 4)
    ample = (args.lanes * blocks + 2 * blocks, 0, total + BS)
    res = {}
    for tag, geo in (("streamed", tight), ("pooled", ample)):
        serve(build(config, params, args, *geo, dev),
              [p[:args.prompt] for p in prompts], 2, dev)       # warm
        eng = build(config, params, args, *geo, dev)
        done, dt, st = serve(eng, prompts, args.gen, dev,
                             staged=tag == "streamed")
        e = eng.get_statistics()["engine"]
        res[tag] = [o.tokens if o else None for o in done]
        ntok = sum(len(t) for t in res[tag] if t is not None)
        res.setdefault("tok_s", {})[tag] = ntok / dt
        res.setdefault("finished", {})[tag] = common.all_finished(done)
        label = (f"streamed (hbm={hbm_small} blocks)" if tag == "streamed"
                 else "pooled ample-HBM")
        print(f"{prefix} | {label}: {args.lanes} x {args.prompt}+{args.gen} "
              f"tok in {dt:.2f}s -> {ntok / dt:.2f} gen tok/s, "
              f"{(args.prompt * args.lanes + ntok) / dt:.0f} total tok/s | "
              f"stream_chunks={e['stream_chunks']} "
              f"stream_tokens={e['stream_tokens']}", flush=True)
        if tag == "streamed":
            res["stream_tokens"] = e["stream_tokens"]
            staged, copy_s, steps = st
            res["staged_gb_step"] = staged / max(steps, 1) / 1e9
            res["h2d_gb_s"] = (staged / copy_s / 1e9 if copy_s else None)
            rate = (f"{res['h2d_gb_s']:.2f} GB/s by CUDA events"
                    if res["h2d_gb_s"] else "not measured (cpu)")
            print(f"{prefix} | streamed decode: staged "
                  f"{res['staged_gb_step']:.4f} GB a step over {steps} "
                  f"steps; staging copies host -> device {rate}", flush=True)
        del eng
    res["same"] = res["streamed"] == res["pooled"]
    res["ratio"] = res["tok_s"]["streamed"] / res["tok_s"]["pooled"]
    print(f"token-identical streamed vs pooled: {res['same']}")
    print(f"{prefix} | streamed/pooled gen-throughput ratio: "
          f"{res['ratio']:.3f}", flush=True)
    return res


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
