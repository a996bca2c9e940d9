"""Time the fused quantized-weight matmuls on the card against their
yardsticks, over split-K counts and ring variants: the sweep behind the
split rule of `ops/w4a16_mm.py:plan` (which `ops/w8a16_mm.py:plan` shares)
and the kernels' ring depth and stage rows.

    python -m cxl_speckv_tpu_torch.scripts.w4a16_sweep [--bits 4|8]
        [--shapes up,down] [--rows 8,40] [--splits 1,2,4,8,16]
        [--variants 4x64,3x128] [--blocks 64,128]

`--bits 4` (the default) times the W4A16 kernel (`csrc/w4a16_mm.cu`),
`--bits 8` the W8A16 one (`csrc/w8a16_mm.cu`). Shapes are Llama-3-8B's
matrices ([K, N]: q [4096, 4096], k [4096, 1024], down [14336, 4096], up
[4096, 14336], lm_head [4096, 128256]) and, at bits 8, Qwen3-30B-A3B's
gate / up expert stack (`experts`: 128 x [2048, 768], x [128, rows,
2048]) and Gemma-2-9B's tied head (`tied`: the [256000, 3584] table read as
[3584, 256000]). Weights are random, 32 of each matrix (one of a weight
past 200 MB), so that calls in turn find no matrix in the 50 MB L2; x is
random bf16. A time is the median of 5 replays of a CUDA graph of 32 calls
over the matrices in turn, divided by 32: the device's time without host
dispatch. Beside the wrapper as it plans each call: the composition the
fused kernel replaced (int4: `x @ w4_unpack(q) * s`; int8: `x @ q.to(bf16)
* s`), cuBLAS on the weight in bf16 (two copies in turn), and the planned
configuration at each split count ("split/<splits>"). A variant "SxB"
rebuilds the source with NSTAGE S and BK B into the build directory and
runs the planned configuration at each split count; `--blocks` runs the
source's configuration of each listed row block at each split count
("mb<rows>/<splits>"). Each run is checked against the plain version
first. Returns a dict; raises SystemExit without CUDA (nothing here has a
CPU form).
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
from cxl_speckv_tpu_torch.ops import w8a16_mm as w8
from cxl_speckv_tpu_torch.ops.w4_unpack import w4_unpack
from cxl_speckv_tpu_torch.scripts import common
from cxl_speckv_tpu_torch.utils.card import bound_ms, card_peaks

SHAPES = {"q": (4096, 4096), "k": (4096, 1024), "down": (14336, 4096),
          "up": (4096, 14336), "lm_head": (4096, 128256)}
# bits 8 only: (batch, K, N, tied)
SHAPES_8 = {"experts": (128, 2048, 768, False),
            "tied": (1, 3584, 256000, True)}
CALLS = 32                  # calls a graph, and matrices in turn
ONE_COPY_BYTES = 200e6      # a weight past this many bytes: one copy
SOURCES = {4: "w4a16_mm", 8: "w8a16_mm"}


def variant_source(src: str, nstage: int, bk: int) -> str:
    """A kernel source (`csrc/w4a16_mm.cu` or `csrc/w8a16_mm.cu`) with ring
    depth `nstage` and stage rows `bk`."""
    out = src.replace("constexpr int BK = 64;", f"constexpr int BK = {bk};")
    out = out.replace("constexpr int NSTAGE = 4;",
                      f"constexpr int NSTAGE = {nstage};")
    if out.count(f"BK = {bk};") != 1 or out.count(
            f"NSTAGE = {nstage};") != 1:
        raise ValueError("w4a16_sweep: the source's BK / NSTAGE lines moved")
    return out


def build_variants(names: list[str], source: str = "w4a16_mm") -> dict:
    """{"SxB": launch function of `source`} built in parallel (one nvcc
    each)."""
    src = (cuda_build.CSRC / f"{source}.cu").read_text()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        nstage, bk = (int(v) for v in name.split("x"))
        text = variant_source(src, nstage, bk)
        digest = hashlib.sha256(text.encode()).hexdigest()[:12]
        cu = cuda_build.BUILD_DIR / f"{source}-{name}-{digest}.cu"
        lib = cu.with_suffix(".so")
        cu.write_text(text)
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
               str(cuda_build.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    fns = {}
    symbol, argtypes = cuda_build.SIGNATURES[source]
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = argtypes
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


def launch(fn, x, q, s, cfg: int, splits: int, cnt,
           bits: int = 4) -> torch.Tensor:
    """One call of a variant's kernel (16-byte rows) at `splits`: the int4
    kernel's x [M, K], q [K, N/2]; the int8 kernel's dense, batched or
    tied (q the transposed view) forms."""
    stream = torch.cuda.current_stream().cuda_stream
    M, K = x.shape[-2:]
    B = x.shape[0] if x.ndim == 3 else 1
    N = q.shape[-1] * (2 if bits == 4 else 1)
    y = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    ws = (torch.empty(B * splits * M * N, dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    args = (x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None, cnt.data_ptr(), B,
            M, K, q.shape[-1], wm.KINDS[x.dtype], cfg, splits, 1)
    if bits == 4:
        err = fn(*args, stream)
    else:
        err = fn(*args, int(w8.is_tied(q)), M * K, stream)
    cuda_build.check_launch(f"{SOURCES[bits]} variant", err)
    return y


def weights(name: str, bits: int, gen, dev) -> tuple[list, int, int, int]:
    """([(q, s)] random copies of weight `name`, batch, K, N)."""
    B, K, N, tied = (1, *SHAPES[name], False) if name in SHAPES else \
        SHAPES_8[name]
    lead = (B,) if B > 1 else ()
    cols = N // 2 if bits == 4 else N
    copies = 1 if B * K * cols > ONE_COPY_BYTES else CALLS
    mats = []
    for _ in range(copies):
        shape = (N, K) if tied else (*lead, K, cols)
        q = torch.randint(-128, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        mats.append((q.t() if tied else q,
                     torch.rand((*lead, 1, N), generator=gen, device=dev)
                     * 0.02 + 1e-3))
    return mats, B, K, N


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bits", type=int, choices=(4, 8), default=4)
    ap.add_argument("--shapes", default=None,
                    help="default: up,down,q,k,lm_head (bits 8: and "
                         "experts,tied)")
    ap.add_argument("--rows", default="8,40,512")
    ap.add_argument("--splits", default="1,2,4,8,16,32")
    ap.add_argument("--variants", default="")
    ap.add_argument("--blocks", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    common.resolve("cuda", "w4a16_sweep")
    dev = torch.device("cuda")
    bf = torch.bfloat16
    bits = args.bits
    source = SOURCES[bits]
    mod = w8 if bits == 8 else wm
    fused = w8.w8a16_mm if bits == 8 else wm.w4a16_mm
    plain = w8.w8a16_mm_plain if bits == 8 else wm.w4a16_mm_plain
    shapes = args.shapes or ("up,down,q,k,lm_head"
                             + (",experts,tied" if bits == 8 else ""))
    variants = build_variants([v for v in args.variants.split(",") if v],
                              source)
    main_fn = cuda_build.kernel(source)
    splits = [int(v) for v in args.splits.split(",")]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cnt = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    peaks = card_peaks(torch.cuda.get_device_name(dev))
    out = {"card": common.card_label(), "bits": bits, "rows": []}
    for name in shapes.split(","):
        mats, B, K, N = weights(name, bits, gen, dev)
        lead = (B,) if B > 1 else ()
        wb = [((torch.cat([q, q], -1) if bits == 4 else q).to(bf), None)
              for q, _ in mats[:2]]
        for M in (int(v) for v in args.rows.split(",")):
            x = torch.randn(*lead, M, K, generator=gen, device=dev).to(bf)

            def turns(fn, ws):
                it = itertools.cycle(ws)
                return lambda: fn(*next(it))

            width = N // 2 if bits == 4 else N
            cfg, _, planned = mod.plan(M, K, width, B, bf, sms)
            if bits == 4:
                comp = lambda q, s: (x @ w4_unpack(q, bf)) * s.to(bf)
            else:
                comp = lambda q, s: (x @ q.to(bf)) * s.to(bf)
            row = {"shape": name, "B": B, "K": K, "N": N, "M": M,
                   "splits": planned,
                   "bound_ms": bound_ms(
                       peaks, B * (K * N * bits // 8 + 4 * N + 2 * M * K
                                   + 2 * M * N),
                       {"bf16": 2 * B * M * K * N})[0],
                   "ms": graph_ms(turns(lambda q, s: fused(x, q, s), mats)),
                   "composition_ms": graph_ms(turns(comp, mats)),
                   "library_ms": graph_ms(turns(lambda w, _: x @ w, wb)),
                   "variants": {}}
            runs = [("split", main_fn, mod.BK, cfg)]
            runs += [(v, fn, int(v.split("x")[1]), cfg)
                     for v, fn in variants.items()]
            runs += [(f"mb{mb}", main_fn, mod.BK, c)
                     for mb, c in mod.MMA_BLOCKS
                     if str(mb) in args.blocks.split(",")]
            want = plain(x, *mats[0]).float()
            for tag, fn, bk, cfg in runs:
                for sp in splits:
                    if sp > -(-K // bk) or B * sp > wm.MAX_GRID_Z:
                        continue
                    got = launch(fn, x, *mats[0], cfg, sp, cnt, bits).float()
                    if not ((got - want).abs() <= 2.0 ** -6 * want.abs()
                            + 1e-3 * want.abs().max()).all():
                        raise RuntimeError(f"w4a16_sweep: {name} M={M} "
                                           f"{tag}/{sp} disagrees with the "
                                           f"plain version")
                    row["variants"][f"{tag}/{sp}"] = graph_ms(turns(
                        lambda q, s, fn=fn, sp=sp: launch(
                            fn, x, q, s, cfg, sp, cnt, bits), mats))
            out["rows"].append(row)
            print(f"[w4a16_sweep] {out['card']} | int{bits} {name} "
                  f"{B} x [{K}, {N}] M={M}: bound {row['bound_ms']:.4f} ms, "
                  f"planned ({planned} splits) {row['ms']:.4f}, composition "
                  f"{row['composition_ms']:.4f}, cuBLAS bf16 "
                  f"{row['library_ms']:.4f}" + "".join(
                      f", {k} {v:.4f}" for k, v in row["variants"].items()),
                  flush=True)
        del mats, wb
    return out


if __name__ == "__main__":
    main()
