"""What the prefetcher and its LSTM buy on a tiered serve, on the card,
with every run's phase timers.

    python -m cxl_speckv_tpu_torch.scripts.bench_ablate [--reps 3] \\
        [--regime smooth|thrash] [--modes lstm,lstm-host,nolstm,noprefetch] \\
        [--device cpu]

Counterpart of the JAX package's TPU script `scripts/bench_ablate.py`
(`:44-143`). One tiered workload (Llama-3.2-1B at bf16, INT8 KV, an HBM
pool of two batches' blocks plus a few, the rest in the host tier) is
served in each mode:

  lstm        prefetch on, gated and ranked by the LSTM, online training,
              the continue probability computed inside the decode round
  lstm-host   the same with the continue probability on the host
              (`PrefetchConfig.ingraph_pcont=False`)
  nolstm      schedule-lookahead prefetch, no predictor
  noprefetch  demand fetches only

`--regime smooth` is `bench.py`'s geometry (32 x (64 + 64), batch 4,
horizon 16, quantum 4); `--regime thrash` rotates the decode set every
round (16 x (224 + 32), batch 4, horizon 8, quantum 1). Every mode is
warmed once on the workload (seed 99), then `--reps` rounds of all modes
print, per run: tok/s (host clock around `Engine.run` after
`torch.cuda.synchronize()`), hit rate, prefetch accuracy, demand misses,
migrations each way, and the phase timers (p50 / p95 ms and total s);
then a summary of tok/s per mode. `--modes` narrows the modes (the JAX
script always runs all four), `--layers` serves the model's first N
layers and `--no-warm` skips the warm-up (the JAX script's warm-up
compiles the programs; here nothing compiles, and the kernels build at
first use). The JAX script builds its engines with `bench.build_engine`
and `bench.run_workload` (`bench.py:35`, `:77`); this module keeps its
own copies of the two (`build_engine`, `run_workload`) and ports no
`bench.py`. On `--device cpu` the JAX
script's CPU geometry runs (a 2-layer, width-256 model at float32) and
the times are the host's.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from cxl_speckv_tpu_torch.scripts import common

MODES = {
    "lstm": dict(prefetch=True, lstm=True),
    "lstm-host": dict(prefetch=True, lstm=True, ingraph_pcont=False),
    "nolstm": dict(prefetch=True, lstm=False),
    "noprefetch": dict(prefetch=False, lstm=False),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--regime", choices=("smooth", "thrash"),
                    default="smooth")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the model's first N layers (0: all)")
    ap.add_argument("--no-warm", dest="warm", action="store_false",
                    help="skip the warm-up serve of every mode")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def build_engine(model_config, params, *, hbm_blocks, host_blocks, batch,
                 max_seq_len, horizon, quantum, prefetch, device, lstm=None,
                 block_size=32, weight_dtype="native", prefill_lanes=0,
                 prefill_chunk=128, ingraph_pcont=True, kv_dtype="int8"):
    """`bench.py:35-74`'s engine (prefetch depth 4, min 3, online training
    with prefetch; the LSTM with prefetch unless `lstm` says otherwise)."""
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        KVDtype,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine

    sc = SystemConfig(
        cache=CacheConfig(block_size=block_size, num_hbm_blocks=hbm_blocks,
                          num_host_blocks=host_blocks,
                          kv_dtype=KVDtype(kv_dtype),
                          prefetch_reserve_frac=0.25),
        prefetch=PrefetchConfig(depth=4, min_depth=3, enabled=prefetch,
                                train_online=prefetch,
                                ingraph_pcont=ingraph_pcont),
        engine=EngineConfig(max_batch_size=batch, max_seq_len=max_seq_len,
                            prefill_chunk=prefill_chunk,
                            decode_horizon=horizon, sched_quantum=quantum,
                            weight_dtype=weight_dtype,
                            prefill_lanes=prefill_lanes))
    return Engine(model_config, sc, params=params, device=device,
                  enable_lstm=prefetch if lstm is None else lstm, seed=0)


def run_workload(eng, *, n_requests, prompt_len, gen, seed=0):
    """`bench.py:77-86`: (tokens emitted, host seconds of `Engine.run`),
    and here also each request's output in submission order."""
    rng = np.random.RandomState(seed)
    vocab = eng.model_config.vocab_size
    ids = [eng.add_request(rng.randint(1, vocab, prompt_len).tolist(),
                           max_new_tokens=gen) for _ in range(n_requests)]
    outs, dt = common.wall(eng.run, eng.device.type)
    by_id = {o.req_id: o for o in outs}
    return (sum(len(o.tokens) for o in outs), dt,
            [by_id.get(i) for i in ids])


def geometry(regime: str, on_card: bool) -> tuple[dict, dict]:
    """(workload, engine geometry) of `:65-87`."""
    if regime == "thrash":
        n, p, g = (16, 224, 32) if on_card else (8, 56, 16)
        batch, horizon, quantum, bs = (4, 8, 1, 32) if on_card else (2, 4, 1, 8)
    elif on_card:
        n, p, g = 32, 64, 64
        batch, horizon, quantum, bs = 4, 16, 4, 32
    else:
        n, p, g = 6, 24, 12
        batch, horizon, quantum, bs = 2, 4, 3, 32
    max_seq = p + g + bs
    per_seq = -(-max_seq // bs)
    hbm = 2 * batch * per_seq + max(3, per_seq // 2)
    wl = dict(n_requests=n, prompt_len=p, gen=g)
    geo = dict(hbm_blocks=hbm, host_blocks=n * per_seq + 8, batch=batch,
               max_seq_len=max_seq, horizon=horizon, quantum=quantum,
               block_size=bs)
    return wl, geo


def run(args: argparse.Namespace) -> dict:
    """Returns {"tok_s": {mode: [per rep]}, "tokens": {mode: each
    request's tokens of the last rep}, "finished": {mode: bool}}."""
    from cxl_speckv_tpu_torch.models.configs import llama_3_2_1b
    from cxl_speckv_tpu_torch.models.llama import init_params

    dev = common.resolve(args.device, "bench_ablate")
    prefix = common.label(dev)
    config = llama_3_2_1b()
    if dev == "cpu":
        config = dataclasses.replace(
            config, num_layers=2, hidden_size=256, intermediate_size=512,
            vocab_size=1024, num_q_heads=8, num_kv_heads=4, head_dim=32,
            dtype="float32")
    if args.layers:
        config = dataclasses.replace(config, num_layers=args.layers)
    params = init_params(config, common.seeded(dev, 0), device=dev)
    wl, geo = geometry(args.regime, dev == "cuda")
    modes = {m: MODES[m] for m in args.modes.split(",")}
    print(f"{prefix} | # regime={args.regime}: {wl['n_requests']} seqs x "
          f"{wl['prompt_len']}+{wl['gen']}, {config.num_layers} layers, "
          f"batch={geo['batch']} "
          f"horizon={geo['horizon']} quantum={geo['quantum']} "
          f"hbm={geo['hbm_blocks']} blocks", flush=True)
    for kw in modes.values() if args.warm else ():
        run_workload(build_engine(config, params, device=dev, **geo, **kw),
                     seed=99, **wl)
    res = {"tok_s": {m: [] for m in modes}, "tokens": {}, "finished": {}}
    for rep in range(args.reps):
        for mode, kw in modes.items():
            eng = build_engine(config, params, device=dev, **geo, **kw)
            tok, dt, per_req = run_workload(eng, **wl)
            st = eng.get_statistics()
            d = st["directory"]
            res["tok_s"][mode].append(tok / dt)
            res["tokens"][mode] = [o.tokens if o else None for o in per_req]
            res["finished"][mode] = common.all_finished(per_req)
            phase_str = " ".join(
                f"{k}:p50={v['p50_ms']:.0f} p95={v['p95_ms']:.0f} "
                f"tot={v['total_s']:.2f}" for k, v in sorted(st["phases"].items()))
            print(f"{prefix} | {mode:10s} rep{rep}: {tok / dt:7.1f} tok/s "
                  f"hit={d['hit_rate']:.3f} acc={d['prefetch_accuracy']:.2f} "
                  f"miss={d['demand_misses']} up/down="
                  f"{st['transfer']['up_transfers']}/"
                  f"{st['transfer']['down_transfers']}", flush=True)
            print(f"{prefix} |     phases: {phase_str}", flush=True)
            del eng
    print(f"\n{prefix} | # summary (tok/s per rep)")
    for mode, vals in res["tok_s"].items():
        print(f"{prefix} | {mode:10s}: {['%.1f' % v for v in vals]}  mean "
              f"{sum(vals) / len(vals):.1f}", flush=True)
    return res


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
