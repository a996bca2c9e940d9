"""One speculative round's verify-and-accept on the card, alone, across
gamma: its fixed cost apart from its per-position device time.

    python -m cxl_speckv_tpu_torch.scripts.verify_gamma_probe \\
        [--model 1b|8b] [--gammas 2,4,8,16] [--batch 8] [--ctx 128] \\
        [--reps 3] [--device cpu]

Counterpart of the JAX package's TPU script `scripts/verify_gamma_probe.py`
(`:27-111`), which times `_verify_accept_program` (`cxl_speckv_tpu/
engine/spec.py:138`). The port's round tail is `engine/spec.py`
`verify_accept`: the target's `verify_step` over the paged INT8 pool (K2
at T = gamma + 1 in every layer), the acceptance where the logits are, and
one host copy of the [2, B] verdict. Weights: Llama-3.2-1B at bf16
(`--model 1b`) or Llama-3-8B at W8A16 (`8b`), random from seed 0; random
drafts, greedy lanes at `--ctx` tokens of zero context.

For each gamma it prints the host clock of one round (best of `--reps`
after a warm call; each ends in the verdict's copy, so no value fetch is
needed) and the device's busy time in one more round (`common.
device_busy_s`). Their difference is the round's fixed cost: the host's
dispatch of the round's launches and the verdict's copy back. A line fit
of busy time against the positions T gives the per-position device time.
On `--device cpu` the plain versions run; every time is the host's and the
busy time is "not measured".

Unlike the JAX script, which fixes the table at 8 blocks and the pool at
100 slots (`:60-79`), so that `--ctx` >= 256 indexes past the table and
aliases slots across lanes, the port sizes both from `--ctx` and
`--batch` (`tables_for`): each lane owns ctx // 32 + 2 blocks of slots
that no other lane holds.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cxl_speckv_tpu_torch.scripts import common

BS = 32


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="1b", choices=["1b", "8b"])
    ap.add_argument("--gammas", default="2,4,8,16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ctx", type=int, default=128,
                    help="resident context tokens per lane")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def tables_for(batch: int, ctx: int, bs: int = BS) -> tuple[np.ndarray, int]:
    """(tables [batch, ctx // bs + 2] int32, pool slots): lane b owns slots
    b * w .. (b + 1) * w - 1 (w = ctx // bs + 2, enough for the context
    and a verify of up to bs positions past it); the last slot is the
    guard."""
    w = ctx // bs + 2
    tables = np.arange(batch * w, dtype=np.int32).reshape(batch, w)
    return tables, batch * w + 1


def fresh_pools(config, n_slots: int, device, bs: int = BS) -> tuple:
    c = config
    shape = (c.num_layers, n_slots, c.num_kv_heads, bs, c.head_dim)
    return (torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.ones(shape[:-1], device=device),
            torch.ones(shape[:-1], device=device))


def verifier(gamma: int):
    """The acceptance machinery without a proposer: greedy token match,
    no draft logits (as the n-gram arm's)."""
    from cxl_speckv_tpu_torch.engine.spec import SpecStatistics, _AcceptanceMixin

    v = _AcceptanceMixin()
    v.gamma, v.stats, v._draft_logits = gamma, SpecStatistics(), None
    return v


def round_inputs(config, batch: int, gamma: int, ctx: int, rng):
    """The JAX script's inputs for one gamma (`:80-89`): random tokens
    [B, gamma + 1] (the drafts are tokens 1..), every lane at `ctx`,
    active, greedy."""
    toks = rng.randint(1, config.vocab_size, (batch, gamma + 1)).astype(
        np.int32)
    return (toks, toks[:, 1:].copy(), np.full(batch, ctx, np.int32),
            np.ones(batch, bool), np.zeros(batch, np.float32))


def verify_call(params, config, gamma, toks, drafts, start, active, temps,
                pools, tables):
    """One `verify_accept` round -> (emitted tokens a lane, n_acc)."""
    from cxl_speckv_tpu_torch.config import KVDtype

    return verifier(gamma).verify_accept(
        params, config, KVDtype.INT8, toks, start, pools, tables, active,
        drafts, temps)[:2]


def run_config(config, params, gammas, batch: int, ctx: int, reps: int,
               device: str) -> dict:
    """The sweep on given weights; returns {gamma: {"warm", "rounds" (host
    seconds), "round" (best), "busy", "k2", "calls", "emitted",
    "n_acc"}}."""
    from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
        paged_chunk_attention_cuda as k2,
    )

    prefix = common.label(device)
    tables, n_slots = tables_for(batch, ctx)
    rng = np.random.RandomState(0)
    out = {}
    for g in gammas:
        toks, drafts, start, active, temps = round_inputs(
            config, batch, g, ctx, rng)
        pools = fresh_pools(config, n_slots, device)
        call = lambda: verify_call(params, config, g, toks, drafts, start,
                                   active, temps, pools, tables)
        n0 = sum(k2.launches.values())
        (emitted, n_acc), warm = common.wall(call, device)
        times = [common.wall(call, device)[1] for _ in range(reps)]
        calls, busy = reps + 1, None
        if device == "cuda":
            _, busy = common.device_busy_s(call)
            calls += 1
        out[g] = {"warm": warm, "rounds": times, "round": min(times),
                  "busy": busy, "calls": calls,
                  "k2": sum(k2.launches.values()) - n0,
                  "emitted": emitted, "n_acc": n_acc}
        dev_s = ("busy not measured (cpu)" if busy is None else
                 f"busy={busy * 1e3:7.2f} ms "
                 f"fixed={(min(times) - busy) * 1e3:7.2f} ms")
        print(f"{prefix} | gamma={g:3d} T={g + 1:3d} warm={warm:6.2f}s "
              f"round={min(times) * 1e3:7.1f} ms (best of {reps}: "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times)}) {dev_s}",
              flush=True)
    busy = {g: r["busy"] for g, r in out.items() if r["busy"] is not None}
    if len(busy) >= 2:
        T = np.array([g + 1 for g in busy], float)
        slope, icpt = np.polyfit(T, np.array(list(busy.values())), 1)
        fixed = np.mean([out[g]["round"] - b for g, b in busy.items()])
        out["fit"] = {"per_position_s": float(slope),
                      "busy_intercept_s": float(icpt),
                      "fixed_s": float(fixed)}
        print(f"{prefix} | # per-position device time {slope * 1e3:.3f} ms "
              f"(busy = {icpt * 1e3:.2f} ms + T x {slope * 1e3:.3f} ms); "
              f"fixed cost a round (host dispatch + verdict copy) "
              f"{fixed * 1e3:.2f} ms on average", flush=True)
    return out


def run(args: argparse.Namespace) -> dict:
    from cxl_speckv_tpu_torch.models.configs import llama_3_2_1b, llama_3_8b
    from cxl_speckv_tpu_torch.models.llama import (
        init_params,
        init_params_quantized,
    )

    dev = common.resolve(args.device, "verify_gamma_probe")
    gen = common.seeded(dev, 0)
    if args.model == "8b":
        config = llama_3_8b()
        params = init_params_quantized(config, gen, device=dev)
    else:
        config = llama_3_2_1b()
        params = init_params(config, gen, device=dev)
    gammas = [int(x) for x in args.gammas.split(",")]
    print(f"{common.label(dev)} | model={args.model} B={args.batch} "
          f"ctx={args.ctx} INT8 KV, {config.num_layers} layers, table "
          f"{args.ctx // BS + 2} blocks a lane", flush=True)
    res = run_config(config, params, gammas, args.batch, args.ctx, args.reps,
                     dev)
    res["layers"] = config.num_layers
    return res


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
