"""Build and load the port's CUDA kernels.

Each source `cxl_speckv_tpu_torch/csrc/<name>.cu` exports one function with a
plain C interface. `nvcc` compiles it for `sm_90a` into a shared library in
`cxl_speckv_tpu_torch/_build/` (listed in .gitignore), named by a digest of
the source, the shared headers `csrc/*.cuh` and the flags, so an edit to
any of them rebuilds; ctypes loads it. Nothing
here runs at import: the first kernel call builds what it needs, and
`build()` builds several sources at once, one nvcc process each.

A failed build raises: no caller falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# exported symbol and argument types of each source (a null pointer for
# the optional sinks, and for K1's three split-state workspace pointers at
# one split)
SIGNATURES = {
    "paged_attention": ("paged_attention_launch",
                        [_P] * 12 + [_I] * 10 + [_F, _F, _P]),
    "chunk_attention": ("chunk_attention_launch",
                        [_P] * 11 + [_I] * 11 + [_F, _F, _P]),
    # the decode-anatomy probes P1, P2, P3 (ops/decode_anatomy.py)
    "anatomy_variants": ("anatomy_variants_launch", [_P] * 9 + [_I] * 11 + [_P]),
    "anatomy_kt": ("anatomy_kt_launch", [_P] * 12 + [_I] * 12 + [_F, _P]),
    "anatomy_ring": ("anatomy_ring_launch", [_P] * 8 + [_I] * 8 + [_P]),
    # W4A16 weights: packed int4 -> the activation dtype (ops/w4_unpack.py)
    "w4_unpack": ("w4_unpack_launch",
                  [_P, _P, ctypes.c_longlong, _I, _I, _I, _P]),
    # W4A16 weights: the fused int4 matmul (ops/w4a16_mm.py)
    "w4a16_mm": ("w4a16_mm_launch", [_P] * 6 + [_I] * 8 + [_P]),
    # W8A16 weights: the fused int8 matmul (ops/w8a16_mm.py)
    "w8a16_mm": ("w8a16_mm_launch",
                 [_P] * 6 + [_I] * 9 + [ctypes.c_longlong, _P]),
    # the card tests' hold on a stream (utils/card.py:StreamHold)
    "stream_hold": ("stream_hold_launch", [_P, ctypes.c_longlong, _P]),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}
_sass: dict[Path, str] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) count as part of every source
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc process each, all started together. Returns {name: compiler log}
    for what was compiled; raises RuntimeError if any compile fails."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode:
            failed.append(n)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def kernel(name: str):
    """The launch function of source `name` (built on first use)."""
    fn = _loaded.get(name)
    if fn is None:
        build([name])
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def sass_counts(name: str, opcode: str) -> dict[str, int]:
    """{kernel (mangled name): how many of its SASS instructions start
    with `opcode`} in source `name`'s built library (e.g. "HMMA", the
    tensor-core products), by `cuobjdump -sass` from the toolkit beside
    nvcc."""
    path = library_path(name)
    sass = _sass.get(path)
    if sass is None:                  # one dump a library, however many opcodes
        tool = Path(nvcc_path()).with_name("cuobjdump")
        sass = _sass[path] = subprocess.run(
            [str(tool), "-sass", str(path)], capture_output=True, text=True,
            check=True).stdout
    counts: dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
            continue
        # an instruction: "/*0a70*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"
        # (predicated: "/*0a70*/  @P0 HMMA...")
        if fn is None or "*/" not in line:
            continue
        words = line.split("*/", 1)[1].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        counts[fn] += bool(words) and words[0].startswith(opcode)
    return counts


def check_launch(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
