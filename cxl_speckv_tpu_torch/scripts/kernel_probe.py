"""K1's bandwidth on the card, swept over scheme, block size and split
count.

    python -m cxl_speckv_tpu_torch.scripts.kernel_probe [--ctx 8192] \\
        [--iters 30] [--schemes int8,int4,bf16] [--bs 32,128] \\
        [--splits 1,S,2S,4S] [--device cpu]

Counterpart of the JAX package's TPU script `scripts/kernel_probe.py`
(`:28-114`). It times K1 (`ops/paged_attention.py`, `csrc/
paged_attention.cu`) at bf16 compute with B lanes (8) of `--ctx` tokens
(8192) and Llama-3-8B's heads (Hq 32, Hkv 8, D 128), for each scheme
(INT8 / INT4 / BF16), block size (32 / 128) and split count. The split
counts are 1, the rule's `decode_splits` S for the shape and 2S and 4S,
clamped to 1..64 (`--splits` takes a list in which S stands for the
rule's count). The TPU script's `--ppb` (the blocks one grid step
fetched) has no counterpart: a CTA walks its share of a lane's blocks in
one loop, and the split count is the card's axis of the same question
(fewer, fatter units of work or more, thinner ones).

Pools hold at least `--minpool` bytes of K (512 MB): the JAX comment at
`:36` sized them past the TPU's VMEM; here the reason is the H100's 50 MB
L2, in which a smaller pool would read faster than HBM. They hold random
values from seed 0 (`ops/decode_anatomy.build_pools`) in place of the JAX
script's zeros, so that the check below compares outputs that are not
zero.

The JAX in-program loop of `--iters` dependent calls (q <- attention(q),
`:56-62`) becomes `--iters` launches back to back between two CUDA events,
each call's bf16 output the next call's q (`dependent_loop`); no value
fetch is needed, the events are exact. Each point prints ms a call, the
GB/s of the bytes K1 must read (`k1_bytes`: the lanes' K and V tiles and
their scales, as `:304-306` counts them, plus the table and lens) and that
rate's share of the card's HBM peak (`utils/card.py:card_peaks`). On
`--device cpu` the plain version runs (its split form at S > 1) and the
times are the host's.

`kernel_bench.py` shares `probe_pools`, `dependent_loop`, `k1_bytes` and
`time_point` from here.
"""

from __future__ import annotations

import argparse
import sys

import torch

from cxl_speckv_tpu_torch.scripts import common

HEADS = (32, 8, 128)            # Hq, Hkv, D: Llama-3-8B's
H100_SMS = 132                  # the split rule's SM count on the CPU
TOL = 2e-4                      # kernel vs plain, float32 output


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The TPU script's --ppb (blocks a grid step fetched) has no "
               "counterpart: a CTA walks its share of a lane's blocks in one "
               "loop; --splits is the card's axis in its place.")
    ap.add_argument("--ctx", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--schemes", default="int8,int4,bf16")
    ap.add_argument("--bs", default="32,128")
    ap.add_argument("--splits", default="1,S,2S,4S",
                    help="split counts; S is the rule's decode_splits")
    ap.add_argument("--minpool", type=int, default=512 * 1024 * 1024,
                    help="least pool bytes (K), past the 50 MB L2")
    ap.add_argument("--check", action="store_true",
                    help="hold each point's first output to K1's plain "
                         "version on the same q (within 2e-4)")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def probe_pools(scheme: str, bs: int, ctx: int, batch: int, minpool: int,
                seed, device, heads=HEADS):
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    return da.build_pools(scheme, bs, ctx, batch=batch, heads=heads,
                          minpool=minpool, seed=seed, device=device)


def rule_splits(p, device: str) -> int:
    """`decode_splits` of the point's shapes: the card's SM count, the
    H100's 132 on the CPU."""
    from cxl_speckv_tpu_torch.ops.paged_attention import decode_splits, sm_count

    sms = sm_count(torch.cuda.current_device()) if device == "cuda" \
        else H100_SMS
    B, mb = p.table.shape
    return decode_splits(B, p.k.shape[1], mb, None, p.k.shape[2], sms)


def split_counts(spec: str, s: int) -> list[int]:
    """The counts of `spec` ("1,S,2S,4S"), S the rule's, clamped to 1..64,
    in order, each once."""
    from cxl_speckv_tpu_torch.ops.paged_attention import MAX_SPLITS

    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        n = (int(tok[:-1] or 1) * s) if tok.endswith("S") else int(tok)
        n = min(max(n, 1), MAX_SPLITS)
        if n not in out:
            out.append(n)
    return out


def k1_call(p, q, splits, compute_dtype=torch.bfloat16):
    from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention

    return paged_attention(q, p.k, p.v, p.ks, p.vs, p.table, p.lens, p.kv,
                           compute_dtype=compute_dtype, num_splits=splits)


def dependent_loop(p, splits, compute_dtype=torch.bfloat16):
    """A step function: each call attends with the last call's output as q
    (bf16, as the JAX loop's `.astype(q.dtype)`); `state["q"]` holds it."""
    state = {"q": p.q.to(torch.bfloat16)}

    def step():
        state["q"] = k1_call(p, state["q"], splits, compute_dtype)
    return step, state


def k1_bytes(p) -> int:
    """Bytes K1 must read a call: each lane's attended K and V tiles and
    their float32 scales (`:304-306`, which counts the scales for every
    scheme; the kernel reads them for BF16 too), the table and the lens."""
    B, mb = p.table.shape
    hkv, bs, dp = p.k.shape[1:]
    toks = sum(-(-int(n) // bs) * bs for n in p.lens.tolist())
    elem = p.k.element_size()
    return (toks * hkv * dp * elem * 2 + toks * hkv * 4 * 2 + B * mb * 4
            + B * 4)


def bound(p, peaks) -> tuple[float, str]:
    """The least ms a call could take on the card: `k1_bytes` plus q read
    and the float32 output written, at the HBM rate, or the products'
    operations (2 * 2 * B * Hq * tokens * D, bf16), whichever is larger."""
    from cxl_speckv_tpu_torch.utils.card import bound_ms

    B, hq, d = p.q.shape
    toks = int(p.lens.sum())
    return bound_ms(peaks, k1_bytes(p) + 2 * B * hq * d * 4,
                    {"bf16": 4 * B * hq * toks * d})


def time_point(p, splits, iters: int, device: str, check: bool,
               compute_dtype=torch.bfloat16) -> dict:
    """One point: µs a call of `iters` dependent launches back to back; on
    the card with `check` also the first output (float32 q holding bf16
    values, float32 out) against the plain version at the same split count
    (its split form), the plain version's ms and K1's single-launch ms.
    Returns {"us", "gbps", "out": the loop's last q} and with `check`
    {"err", "ok", "plain_ms", "single_ms"}."""
    from cxl_speckv_tpu_torch.ops.paged_attention_ref import (
        paged_attention_ref,
    )
    from cxl_speckv_tpu_torch.utils.card import back_to_back_us, single_launch_ms

    row = {}
    if check and device == "cuda":
        got = k1_call(p, p.q, splits, compute_dtype)
        plain = lambda: paged_attention_ref(
            p.q, p.k, p.v, p.ks, p.vs, p.table, p.lens, p.kv,
            compute_dtype=compute_dtype, num_splits=splits)
        want = plain()
        err = (got - want).abs()
        row.update(err=float(err.max()),
                   ok=bool((err <= TOL + TOL * want.abs()).all()),
                   plain_ms=single_launch_ms(plain, iters=3, warmup=1),
                   single_ms=single_launch_ms(
                       lambda: k1_call(p, p.q, splits, compute_dtype)))
    step, state = dependent_loop(p, splits, compute_dtype)
    us = back_to_back_us(step, iters, device)
    row.update(us=us, gbps=k1_bytes(p) / us / 1e3, out=state["q"])
    return row


def point_label(scheme: str, bs: int, splits: int) -> str:
    return f"{scheme:5s} bs={bs:4d} splits={splits:3d}"


def run(args: argparse.Namespace) -> dict:
    """The sweep; returns {(scheme, bs, splits): time_point's dict with
    "rule_splits" and "share" (of the HBM peak, on the card)}."""
    from cxl_speckv_tpu_torch.utils.card import card_peaks

    dev = common.resolve(args.device, "kernel_probe")
    prefix = common.label(dev)
    peak = card_peaks(torch.cuda.get_device_name(0))["hbm"] \
        if dev == "cuda" else None
    print(f"{prefix} | B={args.batch} ctx={args.ctx} iters={args.iters} "
          f"heads={HEADS} bf16 compute", flush=True)
    rows = {}
    for scheme in args.schemes.split(","):
        for bs in (int(x) for x in args.bs.split(",")):
            p = probe_pools(scheme, bs, args.ctx, args.batch, args.minpool,
                            0, dev)
            s = rule_splits(p, dev)
            for n in split_counts(args.splits, s):
                r = time_point(p, n, args.iters, dev, args.check)
                r["rule_splits"] = s
                lab = point_label(scheme, bs, n)
                if dev == "cpu":
                    print(f"{prefix} | {lab} (S={s}): {r['us']:10.0f} us/call "
                          f"on the host CPU (plain version)", flush=True)
                else:
                    r["share"] = r["gbps"] * 1e9 / peak
                    chk = (f"; first output vs plain err {r['err']:.2e} "
                           f"{'ok' if r['ok'] else 'FAIL'}"
                           if "err" in r else "")
                    print(f"{prefix} | {lab} (S={s}): {r['us']:8.1f} us/call "
                          f"{r['gbps']:7.1f} GB/s {100 * r['share']:5.1f}% of "
                          f"HBM peak{chk}", flush=True)
                rows[(scheme, bs, n)] = r
            del p
    return rows


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
