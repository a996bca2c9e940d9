"""K1's HBM bandwidth on the card at the Llama-3-8B decode geometry.

    python -m cxl_speckv_tpu_torch.scripts.kernel_bench [--f32] \\
        [--schemes int8,int4,bf16] [--ctx 2048,8192] [--device cpu]

Counterpart of the JAX package's TPU script `scripts/kernel_bench.py`
(`:24-89`): K1 (`ops/paged_attention.py`) at B 8, Hq 32, Hkv 8, D 128,
32-token blocks, for INT8 / INT4 / BF16 pools at contexts 2048 and 8192,
bf16 compute (`--f32`: float32), at the split count the rule chooses.
Each point runs 50 dependent calls back to back (each call's output the
next q; `kernel_probe.dependent_loop`) between two CUDA events in place of
the JAX in-program loop and its value fetch, over pools of at least 512 MB
(past the 50 MB L2, where the JAX comment at `:71-72` sized them past
VMEM), and prints µs a call, the GB/s of the bytes K1 must read
(`kernel_probe.k1_bytes`) and their share of the card's HBM peak
(`utils/card.py:card_peaks`) in place of the v5e's 820 GB/s. `--schemes`
and `--ctx` narrow the sweep (the JAX script always runs all six points);
`--check` holds each point's first output to K1's plain version as
`kernel_probe` does. On `--device cpu` the plain version runs and the
times are the host's.
"""

from __future__ import annotations

import argparse
import sys

import torch

from cxl_speckv_tpu_torch.scripts import common, kernel_probe as kp

BATCH, BS = 8, 32
ITERS = 50
MINPOOL = 512 * 1024 * 1024


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--f32", action="store_true",
                    help="float32 compute in place of bf16")
    ap.add_argument("--schemes", default="int8,int4,bf16")
    ap.add_argument("--ctx", default="2048,8192")
    ap.add_argument("--check", action="store_true",
                    help="hold each point's first output to K1's plain "
                         "version on the same q (within 2e-4)")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Returns {(scheme, ctx): kernel_probe.time_point's dict with
    "splits" and "share" (on the card)}."""
    from cxl_speckv_tpu_torch.utils.card import card_peaks

    dev = common.resolve(args.device, "kernel_bench")
    prefix = common.label(dev)
    cdt = torch.float32 if args.f32 else torch.bfloat16
    peak = card_peaks(torch.cuda.get_device_name(0))["hbm"] \
        if dev == "cuda" else None
    print(f"{prefix} | compute_dtype={str(cdt).split('.')[-1]}", flush=True)
    rows = {}
    for name in args.schemes.split(","):
        for ctx in (int(x) for x in args.ctx.split(",")):
            p = kp.probe_pools(name, BS, ctx, BATCH, MINPOOL, 0, dev)
            s = kp.rule_splits(p, dev)
            r = kp.time_point(p, s, ITERS, dev, args.check, cdt)
            r["splits"] = s
            if dev == "cpu":
                print(f"{prefix} | {name:5s} ctx={ctx:5d}: {r['us']:7.0f} "
                      f"us/call on the host CPU (plain version, S={s})",
                      flush=True)
            else:
                r["share"] = r["gbps"] * 1e9 / peak
                chk = (f"; first output vs plain err {r['err']:.2e} "
                       f"{'ok' if r['ok'] else 'FAIL'}" if "err" in r else "")
                print(f"{prefix} | {name:5s} ctx={ctx:5d}: {r['us']:7.1f} "
                      f"us/call, {r['gbps']:6.1f} GB/s "
                      f"({100 * r['share']:.0f}% of HBM peak), S={s}{chk}",
                      flush=True)
            rows[(name, ctx)] = r
            del p
    return rows


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
