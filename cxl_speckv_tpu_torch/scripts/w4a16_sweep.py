"""Time the W4A16 fused matmul (`csrc/w4a16_mm.cu`) on the card against its
yardsticks, over split-K counts and ring variants: the sweep behind the
split rule of `ops/w4a16_mm.py:plan` and the kernel's ring depth and stage
rows.

    python -m cxl_speckv_tpu_torch.scripts.w4a16_sweep [--shapes up,down]
        [--rows 8,40] [--splits 1,2,4,8,16] [--variants 4x64,3x128]

Shapes are Llama-3-8B's matrices ([K, N]: q [4096, 4096], k [4096, 1024],
down [14336, 4096], up [4096, 14336], lm_head [4096, 128256]) with random
packed weights, 32 of each (one lm_head, 262.7 MB packed), so that calls in
turn find no matrix in the 50 MB L2; x is random bf16. A time is the median
of 5 replays of a CUDA graph of 32 calls over the matrices in turn, divided
by 32: the device's time without host dispatch. Beside the wrapper as it
plans each call: the composition the fused kernel replaced (`x @
w4_unpack(q) * s`), cuBLAS on the weight in bf16 (two copies in turn), and
the planned configuration at each split count ("split/<splits>"). A
variant "SxB" rebuilds the source with NSTAGE S and BK B into the build
directory and runs the planned configuration at each split count. Each run
is checked against the plain version first. Returns a dict; raises
SystemExit without CUDA (nothing here has a CPU form).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import itertools
import statistics
import subprocess

import torch

from cxl_speckv_tpu_torch.ops import cuda_build
from cxl_speckv_tpu_torch.ops import w4a16_mm as wm
from cxl_speckv_tpu_torch.ops.w4_unpack import w4_unpack
from cxl_speckv_tpu_torch.scripts import common
from cxl_speckv_tpu_torch.utils.card import bound_ms, card_peaks

SHAPES = {"q": (4096, 4096), "k": (4096, 1024), "down": (14336, 4096),
          "up": (4096, 14336), "lm_head": (4096, 128256)}
CALLS = 32                  # calls a graph, and matrices in turn


def variant_source(src: str, nstage: int, bk: int) -> str:
    """`csrc/w4a16_mm.cu` with ring depth `nstage` and stage rows `bk`."""
    out = src.replace("constexpr int BK = 64;", f"constexpr int BK = {bk};")
    out = out.replace("constexpr int NSTAGE = 4;",
                      f"constexpr int NSTAGE = {nstage};")
    if out.count(f"BK = {bk};") != 1 or out.count(
            f"NSTAGE = {nstage};") != 1:
        raise ValueError("w4a16_sweep: the source's BK / NSTAGE lines moved")
    return out


def build_variants(names: list[str]) -> dict:
    """{"SxB": launch function} built in parallel (one nvcc each)."""
    src = (cuda_build.CSRC / "w4a16_mm.cu").read_text()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        nstage, bk = (int(v) for v in name.split("x"))
        text = variant_source(src, nstage, bk)
        digest = hashlib.sha256(text.encode()).hexdigest()[:12]
        cu = cuda_build.BUILD_DIR / f"w4a16_mm-{name}-{digest}.cu"
        lib = cu.with_suffix(".so")
        cu.write_text(text)
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
               str(cuda_build.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    fns = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).w4a16_mm_launch
        fn.argtypes = cuda_build.SIGNATURES["w4a16_mm"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def graph_ms(call) -> float:
    """Median ms a call of 5 replays of a CUDA graph of CALLS calls."""
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            call()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / CALLS)
    return statistics.median(times)


def launch(fn, x, q, s, cfg: int, splits: int, cnt) -> torch.Tensor:
    """One call of a variant's kernel (16-byte rows) at `splits`."""
    M, K = x.shape
    half = q.shape[1]
    y = torch.empty(M, 2 * half, dtype=x.dtype, device=x.device)
    ws = (torch.empty(splits * M * 2 * half, dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
             ws.data_ptr() if ws is not None else None, cnt.data_ptr(), 1,
             M, K, half, wm.KINDS[x.dtype], cfg, splits, 1,
             torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch("w4a16_mm variant", err)
    return y


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="up,down,q,k,lm_head")
    ap.add_argument("--rows", default="8,40,512")
    ap.add_argument("--splits", default="1,2,4,8,16,32")
    ap.add_argument("--variants", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    common.resolve("cuda", "w4a16_sweep")
    dev = torch.device("cuda")
    bf = torch.bfloat16
    variants = build_variants([v for v in args.variants.split(",") if v])
    main_fn = cuda_build.kernel("w4a16_mm")
    splits = [int(v) for v in args.splits.split(",")]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cnt = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    peaks = card_peaks(torch.cuda.get_device_name(dev))
    out = {"card": common.card_label(), "rows": []}
    for name in args.shapes.split(","):
        K, N = SHAPES[name]
        mats = [(torch.randint(-128, 128, (K, N // 2), generator=gen,
                               device=dev, dtype=torch.int8),
                 torch.rand((1, N), generator=gen, device=dev) * 0.02 + 1e-3)
                for _ in range(1 if name == "lm_head" else CALLS)]
        wb = [(torch.cat([q, q], 1).to(bf), None) for q, _ in mats[:2]]
        for M in (int(v) for v in args.rows.split(",")):
            x = torch.randn(M, K, generator=gen, device=dev).to(bf)

            def turns(fn, ws):
                it = itertools.cycle(ws)
                return lambda: fn(*next(it))

            cfg, _, planned = wm.plan(M, K, N // 2, 1, bf, sms)
            row = {"shape": name, "K": K, "N": N, "M": M, "splits": planned,
                   "bound_ms": bound_ms(
                       peaks, K * N // 2 + 4 * N + 2 * M * K + 2 * M * N,
                       {"bf16": 2 * M * K * N})[0],
                   "ms": graph_ms(turns(lambda q, s: wm.w4a16_mm(x, q, s),
                                        mats)),
                   "composition_ms": graph_ms(turns(
                       lambda q, s: (x @ w4_unpack(q, bf)) * s.to(bf),
                       mats)),
                   "library_ms": graph_ms(turns(lambda w, _: x @ w, wb)),
                   "variants": {}}
            runs = [("split", main_fn, wm.BK)]
            runs += [(v, fn, int(v.split("x")[1]))
                     for v, fn in variants.items()]
            want = wm.w4a16_mm_plain(x, *mats[0]).float()
            for tag, fn, bk in runs:
                for sp in splits:
                    if sp > -(-K // bk):
                        continue
                    got = launch(fn, x, *mats[0], cfg, sp, cnt).float()
                    if not ((got - want).abs() <= 2.0 ** -6 * want.abs()
                            + 1e-3 * want.abs().max()).all():
                        raise RuntimeError(f"w4a16_sweep: {name} M={M} "
                                           f"{tag}/{sp} disagrees with the "
                                           f"plain version")
                    row["variants"][f"{tag}/{sp}"] = graph_ms(turns(
                        lambda q, s, fn=fn, sp=sp: launch(
                            fn, x, q, s, cfg, sp, cnt), mats))
            out["rows"].append(row)
            print(f"[w4a16_sweep] {out['card']} | {name} [{K}, {N}] M={M}: "
                  f"bound {row['bound_ms']:.4f} ms, planned ({planned} "
                  f"splits) {row['ms']:.4f}, composition "
                  f"{row['composition_ms']:.4f}, cuBLAS bf16 "
                  f"{row['library_ms']:.4f}" + "".join(
                      f", {k} {v:.4f}" for k, v in row["variants"].items()),
                  flush=True)
        del mats, wb
    return out


if __name__ == "__main__":
    main()
