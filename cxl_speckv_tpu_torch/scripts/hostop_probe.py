"""Host-tier gathers on the card: is their cost per copy or per byte, and
does it hide behind device work?

    python -m cxl_speckv_tpu_torch.scripts.hostop_probe [--reps 5] \\
        [--device cpu]

Counterpart of the JAX package's TPU script `scripts/hostop_probe.py`
(`:29-117`, programs A-D at `:65-95`). The TPU script gathers rows of a
pinned-host store with `compute_on("device_host")`; the port's counterpart
is `runtime/hoststore.py`: a `DeviceHostStore` in pinned memory and
`gather_units` (one non-blocking copy of a slot's run of rows a slot and
array), the streamed path's staging. The JAX geometry: 16 layers, waves of
128 slots, Hkv 8, 8-token blocks, D 64, 4096 rows (256 slots x 16
layers), INT8 K / V with float32 scales, here filled with random bytes
from seed 0.

  A  16 sequential layer gathers of the 4 arrays (`fetch_layer`)
  B  16 gathers of K alone
  C  one gather of 16x the rows (`gather_units(l0=0, n=16)`)
  D  A issued on a side stream (`runtime/hoststore.py` `CopyStream`),
     layer by layer between the segments of a dependent chain of 200
     [256, 256] float32 matmuls (the JAX program's) on the compute stream

For each program: the host clock of one run after `torch.cuda.
synchronize()` (median of `--reps`; the JAX script's value fetch, its
sync on a remote runtime, has no place here), the CUDA-event window,
the copies issued, and GB/s of the bytes gathered over the host time. For
D, the chain alone and the share of the smaller of A and the chain that
hid behind the other ((A + chain - D) / min(A, chain)). Every program's
gathered bytes are held to `index_select` of the store's rows. On
`--device cpu` the store is not pinned, the copies are host copies, D has
no side stream, and the times are the host's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cxl_speckv_tpu_torch.scripts import common

L, W, HKV, BS, D = 16, 128, 8, 8, 64
ROWS = 4096
CHAIN = 200


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def make_store(device: str, seed: int = 0):
    from cxl_speckv_tpu_torch.runtime.hoststore import DeviceHostStore

    store = DeviceHostStore(ROWS // L - 1, L, BS, HKV, D, torch.int8,
                            pin=device == "cuda")
    gen = torch.Generator()
    gen.manual_seed(seed)
    for a in (store.k, store.v):
        a.copy_(torch.randint(-128, 128, a.shape, generator=gen,
                              dtype=torch.int8))
    for a in (store.ks, store.vs):
        a.copy_(torch.rand(a.shape, generator=gen))
    return store


SLOTS = np.arange(W)


def prog_a(store, device):
    from cxl_speckv_tpu_torch.runtime.hoststore import fetch_layer

    return [fetch_layer(store, SLOTS, li, device) for li in range(L)]


def gather_k(store, li: int, device):
    """Layer li's K rows of the wave's slots alone: one copy a slot."""
    views = store.units(li, 1)[0]
    dst = torch.empty((W, 1, *store.k.shape[1:]), dtype=store.k.dtype,
                      device=device)
    torch._foreach_copy_(list(dst.unbind(0)), [views[s] for s in SLOTS],
                         non_blocking=True)
    return dst[:, 0]


def prog_b(store, device):
    return [(gather_k(store, li, device),) for li in range(L)]


def prog_c(store, device):
    from cxl_speckv_tpu_torch.runtime.hoststore import gather_units

    return gather_units(store, SLOTS, 0, L, device)


COPIES = {"A": L * 4 * W, "B": L * W, "C": 4 * W, "D": L * 4 * W}


def gathered_bytes(name: str, store) -> int:
    row = store.bytes_per_row
    return {"A": L * W * row, "B": L * W * store.k[0].numel(),
            "C": L * W * row, "D": L * W * row}[name]


def chain_fn(device):
    """A dependent matmul chain of CHAIN steps (`:86-90`) in L parts:
    returns (part(i) running part i, the state holding its value)."""
    x = torch.zeros((256, 256), device=device)
    w = torch.ones((256, 256), device=device)
    state = {"y": x}

    def part(i):
        y = state["y"]
        for _ in range(CHAIN // L + (i < CHAIN % L)):
            y = torch.tanh(y @ w * 1e-3)
        state["y"] = y
    return part, state


def prog_d(store, device, copy_stream):
    """A's gathers on the side stream, layer by layer between the chain's
    segments on the compute stream."""
    from cxl_speckv_tpu_torch.runtime.hoststore import fetch_layer

    part, _ = chain_fn(device)
    out = []
    for li in range(L):
        if copy_stream is None:
            out.append(fetch_layer(store, SLOTS, li, device))
        else:
            out.append(copy_stream.run(
                lambda mark, li=li: fetch_layer(store, SLOTS, li, device))[1])
        part(li)
    if copy_stream is not None:
        torch.cuda.current_stream().wait_stream(copy_stream.stream)
    return out


def check(name: str, store, out) -> None:
    """The gathered bytes == index_select of the store's rows."""
    rows = lambda li: torch.as_tensor(SLOTS * L + li)
    arrays = store.arrays if name != "B" else store.arrays[:1]
    if name == "C":
        for a, got in zip(store.arrays, out):
            r = torch.as_tensor((SLOTS[:, None] * L + np.arange(L)).reshape(-1))
            want = a.index_select(0, r).reshape(W, L, *a.shape[1:])
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"hostop_probe: program C gathered "
                                     f"other bytes than index_select")
        return
    for li, per_layer in enumerate(out):
        for a, got in zip(arrays, per_layer):
            if not torch.equal(got.cpu(), a.index_select(0, rows(li))):
                raise AssertionError(f"hostop_probe: program {name} layer "
                                     f"{li} gathered other bytes than "
                                     f"index_select")


def run(args: argparse.Namespace) -> dict:
    """Returns {program: {"host_s", "window_s", "copies", "gbps"}} and
    "chain_s", "hidden" (D's overlap share)."""
    from cxl_speckv_tpu_torch.runtime.hoststore import CopyStream

    dev = common.resolve(args.device, "hostop_probe")
    prefix = common.label(dev)
    store = make_store(dev)
    cs = CopyStream(dev) if dev == "cuda" else None
    print(f"{prefix} | store {ROWS} rows x {store.bytes_per_row} B "
          f"({'pinned' if dev == 'cuda' else 'pageable'}), {L} layers, waves "
          f"of {W} slots", flush=True)
    progs = {"A": ("16x(4-array gather)", lambda: prog_a(store, dev)),
             "B": ("16x(1-array gather)", lambda: prog_b(store, dev)),
             "C": ("1x(4-array gather, 16x rows)", lambda: prog_c(store, dev)),
             "D": ("A on a side stream + compute chain",
                   lambda: prog_d(store, dev, cs))}
    res = {}
    for name, (what, fn) in progs.items():
        out, host, window = common.timed_calls(fn, dev, args.reps)
        check(name, store, out)
        nb = gathered_bytes(name, store)
        res[name] = {"host_s": host, "window_s": window,
                     "copies": COPIES[name], "gbps": nb / host / 1e9}
        win = (f", event window {window * 1e3:.2f} ms" if window is not None
               else "")
        print(f"{prefix} | {name} {what}: median {host * 1e3:.2f} ms{win}, "
              f"{COPIES[name]} copies, {nb / 1e6:.2f} MB, "
              f"{nb / host / 1e9:.2f} GB/s; bytes == index_select", flush=True)
    part, _ = chain_fn(dev)
    _, chain, _ = common.timed_calls(lambda: [part(i) for i in range(L)],
                                     dev, args.reps)
    a, d = res["A"]["host_s"], res["D"]["host_s"]
    res["chain_s"] = chain
    res["hidden"] = (a + chain - d) / min(a, chain)
    print(f"{prefix} | chain alone ({CHAIN} dependent [256, 256] matmuls): "
          f"{chain * 1e3:.2f} ms; D hid {100 * res['hidden']:.1f}% of the "
          f"smaller of A and the chain"
          + ("" if dev == "cuda" else " (no side stream on the CPU)"),
          flush=True)
    return res


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
