"""Decode-kernel anatomy on the card: K1 timed beside its pieces.

    python -m cxl_speckv_tpu_torch.scripts.kernel_anatomy --scheme int8 \\
        --bs 32 --ctx 8192 --iters 30 --minpool 536870912 [--device cpu]

Counterpart of the JAX package's TPU script `scripts/kernel_anatomy.py`, at
its geometry (B 8, Hq 32, Hkv 8, D 128: Llama-3-8B's widths) and with its
output: a header with the bytes of the block walk every variant makes
(`fetch`'s: each K and V tile and scale row of the lanes' blocks, the table
and lens) and their time at the card's HBM rate, then one line per variant
in the script's order -- `full` (K1, `ops/paged_attention.py`, bf16
compute), `fetch`, `matmul`, `matmulT` (P1),
`v2`, `v3fused` (P2), `v5ring4`, `v5ring8`, `v5ring16` (P3) -- and after
them the modes the script's loop skips: `fetchrow`, `fetchint`, `dequant`
(P1) and `w8a8` (P2). What each isolates is in `ops/decode_anatomy.py`.

Each line gives us a call and GB/s (the header's bytes over that time) from
`--iters` launches back to back between two CUDA events, divided by the
count; `full` also gives the median of single-launch event windows
(`utils.card.single_launch_ms`, as `chip_smoke.py` times a kernel), so
that the two can be told apart. A
variant the card cannot run at these shapes (a ring that does not fit in
shared memory, w8a8 on BF16 pools) prints FAIL and its reason, as the
script does. With `--device cpu` the plain PyTorch versions run and the
times are the host's, printed as such. Pools hold random values from
`--seed` (0 by default) over a contiguous table, or with `--constants` the
script's constants (zero K, V and q, unit scales). The script's `--ppb`
has no counterpart: it set the blocks a TPU grid step fetched, and here a
CTA walks its share of a lane's blocks in one loop (P1 and P3 split a
lane's walk over `decode_anatomy.probe_splits` CTAs).
"""

from __future__ import annotations

import argparse
import sys

import torch

from cxl_speckv_tpu_torch.ops import decode_anatomy as da
from cxl_speckv_tpu_torch.utils.card import (
    back_to_back_us,
    card_peaks,
    single_launch_ms,
)

# the script's order (`scripts/kernel_anatomy.py:495-528`), then the modes
# its loop skips
LABELS = ("full", "fetch", "matmul", "matmulT", "v2", "v3fused", "v5ring4",
          "v5ring8", "v5ring16", "fetchrow", "fetchint", "dequant", "w8a8")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The TPU script's --ppb (blocks a grid step fetched) has no "
               "counterpart: a CTA walks its share of a lane's blocks in one "
               "loop.")
    ap.add_argument("--scheme", default="int8", choices=sorted(da.SCHEMES))
    ap.add_argument("--bs", type=int, default=128, help="KV block size")
    ap.add_argument("--ctx", type=int, default=8192,
                    help="tokens of context a lane")
    ap.add_argument("--iters", type=int, default=30,
                    help="launches timed back to back")
    ap.add_argument("--minpool", type=int, default=512 * 1024 * 1024,
                    help="least pool bytes (K), so that a call reads device "
                         "memory and not the 50 MB L2")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the pools' random values")
    ap.add_argument("--constants", action="store_true",
                    help="fill the pools with the TPU script's constants "
                         "(zero K, V and q, unit scales) instead")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> tuple[dict, da.ProbePools]:
    """Print the header and one line per variant; returns ({label: {"us",
    "gbps", "single_us" (full, on the card)} or {"fail": reason}}, pools)."""
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        raise SystemExit("kernel_anatomy: CUDA is not available; --device cpu "
                         "runs the plain versions")
    p = da.build_pools(args.scheme, args.bs, args.ctx, minpool=args.minpool,
                       seed=None if args.constants else args.seed,
                       device=dev)
    B, mb = p.table.shape
    tot = da.probe_work("fetch", p)[0]
    if dev == "cuda":
        hbm = card_peaks(torch.cuda.get_device_name(0))["hbm"]
        ideal = f"ideal={tot / hbm * 1e6:.0f}us at {hbm / 1e12:g} TB/s"
    else:
        ideal = "ideal=not measured (cpu)"
    print(f"scheme={args.scheme} bs={args.bs} ctx={args.ctx} steps={B * mb} bytes/call={tot / 1e6:.0f}MB "
          f"{ideal}", flush=True)
    fns = da.probe_calls(p)
    rows = {}
    for label in LABELS:
        try:
            us = back_to_back_us(fns[label], args.iters, dev)
        except ValueError as e:        # refused at these shapes by the wrapper
            rows[label] = {"fail": str(e)}
            print(f"{label:8s}: FAIL {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
            continue
        rows[label] = {"us": us, "gbps": tot / us / 1e3}
        if dev == "cpu":
            print(f"{label:8s}: {us:8.0f} us/call on the host CPU (plain "
                  f"version; no device time)", flush=True)
            continue
        extra = ""
        if label == "full":
            rows[label]["single_us"] = single_launch_ms(fns[label]) * 1e3
            extra = (f" back to back; {rows[label]['single_us']:.1f} us in a "
                     f"single-launch event window")
        print(f"{label:8s}: {us:8.1f} us/call {tot / us / 1e3:7.1f} GB/s"
              f"{extra}", flush=True)
    return rows, p


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
