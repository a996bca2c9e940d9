"""K1 and K2 with a binding sliding window and / or the tanh score softcap,
on the card, against their plain versions.

    python -m cxl_speckv_tpu_torch.scripts.tpu_window_check [--device cpu]

Counterpart of the JAX package's TPU script `scripts/tpu_window_check.py`
(`:19-99`), at its shapes: B 4, Hq 32, Hkv 8, D 128, 16-token blocks, 32
blocks a lane (lanes of 512, 301, 97 and 480 tokens at permuted slots),
window 200, softcap 30, chunks of T 8 fresh tokens at the lanes' ends;
random data from RandomState(0), quantized by `ops/quant.py`, for INT8,
INT4 and BF16 pools. The cases (`CASES`), in the script's order: for each
scheme, (window, softcap) = (200, none), (200, 30), (none, 30), each for
K1 (`ops/paged_attention.py`, decode) and K2 (`ops/chunk_attention_cuda.py`,
chunk). On the card each kernel runs at bf16 compute and is held to its
plain version (float32 compute) with the script's own rule: the largest
absolute difference over the largest |plain| under 2e-2 (`:83`, `:94`).

With `--device cpu` there is no kernel: each case runs the plain version
at float32 compute against `numpy_case`, the case written out in numpy
(float64) on the dequantized pools: the window as a mask of the positions
a query may see (decode: the last `window` of the lane's; chunk: query t
at position start + t sees positions start + t - window + 1 .. start + t,
pool and fresh alike) and the softcap as cap * tanh(s / cap) of the
scaled scores. No time is printed.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cxl_speckv_tpu_torch.scripts import common

B, HQ, HKV, D, BS = 4, 32, 8, 128, 16
MB, WINDOW, CAP, T = 32, 200, 30.0, 8
LENS = (512, 301, 97, 480)
SCHEMES = ("int8", "int4", "bf16")
VARIANTS = ((WINDOW, None), (WINDOW, CAP), (None, CAP))
CASES = [(s, kind, w, c) for s in SCHEMES for w, c in VARIANTS
         for kind in ("decode", "chunk")]
TOL = 2e-2


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def scheme_data(scheme: str, rng, device) -> dict:
    """The script's pools and inputs for one scheme (`:31-63`), in the
    port's token-major layout, and the dequantized K / V of each lane
    (float32 [mb * bs, Hkv, D]) for the numpy statement."""
    from cxl_speckv_tpu_torch.config import KVDtype
    from cxl_speckv_tpu_torch.ops.quant import (
        dequantize_kv,
        encode_for_pool,
        kv_pack,
        kv_storage_dtype,
        quantize_kv,
    )

    kv = KVDtype(scheme)
    S = B * MB + 1
    dp = D // kv_pack(kv)
    k_pool = torch.zeros((S, HKV, BS, dp), dtype=kv_storage_dtype(kv))
    v_pool = torch.zeros_like(k_pool)
    k_scale = torch.ones((S, HKV, BS))
    v_scale = torch.ones_like(k_scale)
    table = rng.permutation(S - 1).astype(np.int32)[:B * MB].reshape(B, MB)
    deq = []
    for b in range(B):
        x = torch.from_numpy(rng.randn(2, MB * BS, HKV, D).astype(np.float32))
        kq, ks = quantize_kv(x[0], kv)
        vq, vs = quantize_kv(x[1], kv)
        deq.append((dequantize_kv(kq, ks, kv).numpy(),
                    dequantize_kv(vq, vs, kv).numpy()))
        kenc, venc = encode_for_pool(kq, kv), encode_for_pool(vq, kv)
        for i in range(MB):
            sl = slice(i * BS, (i + 1) * BS)
            k_pool[table[b, i]] = kenc[sl].transpose(0, 1)
            v_pool[table[b, i]] = venc[sl].transpose(0, 1)
            k_scale[table[b, i]] = ks[sl, :, 0].T
            v_scale[table[b, i]] = vs[sl, :, 0].T
    f = lambda a: torch.from_numpy(rng.randn(*a).astype(np.float32))
    q, qc, kn, vn = f((B, HQ, D)), f((B, T, HQ, D)), f((B, T, HKV, D)), \
        f((B, T, HKV, D))
    to = lambda t: t.to(device)
    return {"kv": kv, "pools": tuple(map(to, (k_pool, v_pool, k_scale,
                                              v_scale))),
            "table": to(torch.from_numpy(table)),
            "lens": to(torch.tensor(LENS, dtype=torch.int32)),
            "q": to(q), "qc": to(qc), "kn": to(kn), "vn": to(vn), "deq": deq}


def _attend(q, k, v, ok, cap):
    """softmax over the seen positions of cap-tanh'ed scaled scores, float64:
    q [Hq, D], k / v [P, Hkv, D], ok [P] (or [Hq, P])."""
    G = HQ // HKV
    kk = np.repeat(k.transpose(1, 0, 2), G, axis=0)          # [Hq, P, D]
    vv = np.repeat(v.transpose(1, 0, 2), G, axis=0)
    s = np.einsum("hd,hpd->hp", q, kk) * D ** -0.5
    if cap is not None:
        s = cap * np.tanh(s / cap)
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("hp,hpd->hd", p, vv)


def numpy_case(data: dict, kind: str, window, cap) -> np.ndarray:
    """The case written out in numpy (see the module docstring)."""
    out = []
    for b, n in enumerate(LENS):
        k, v = (a.astype(np.float64) for a in data["deq"][b])
        if kind == "decode":
            pos = np.arange(n)
            ok = pos >= n - window if window is not None else pos >= 0
            out.append(_attend(data["q"][b].double().cpu().numpy(), k[:n],
                               v[:n], ok, cap))
            continue
        kk = np.concatenate([k[:n], data["kn"][b].double().cpu().numpy()])
        vv = np.concatenate([v[:n], data["vn"][b].double().cpu().numpy()])
        pos = np.arange(n + T)
        rows = []
        for t in range(T):
            a = n + t
            ok = pos <= a
            if window is not None:
                ok &= pos > a - window
            rows.append(_attend(data["qc"][b, t].double().cpu().numpy(), kk,
                                vv, ok, cap))
        out.append(np.stack(rows))
    return np.stack(out)


def case_pair(data: dict, kind: str, window, cap, device):
    """(got, want) numpy float32/float64: on the card the kernel at bf16
    compute and the plain version at float32; on the CPU the plain
    version at float32 and `numpy_case`."""
    from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
        paged_chunk_attention_cuda,
    )
    from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention

    d = data
    if kind == "decode":
        fn = lambda cd: paged_attention(
            d["q"], *d["pools"], d["table"], d["lens"], d["kv"],
            compute_dtype=cd, window=window, softcap=cap)
    else:
        fn = lambda cd: paged_chunk_attention_cuda(
            d["qc"], d["kn"], d["vn"], *d["pools"], d["table"], d["lens"],
            d["kv"], compute_dtype=cd, window=window, softcap=cap)
    if device == "cpu":
        return fn(torch.float32).numpy(), numpy_case(d, kind, window, cap)
    plain = _plain(kind, d, window, cap)
    return fn(torch.bfloat16).float().cpu().numpy(), plain


def _plain(kind, d, window, cap) -> np.ndarray:
    from cxl_speckv_tpu_torch.ops.chunk_attention import paged_chunk_attention
    from cxl_speckv_tpu_torch.ops.paged_attention_ref import (
        paged_attention_ref,
    )

    if kind == "decode":
        out = paged_attention_ref(d["q"], *d["pools"], d["table"], d["lens"],
                                  d["kv"], window=window, softcap=cap)
    else:
        out = paged_chunk_attention(d["qc"], d["kn"], d["vn"], *d["pools"],
                                    d["table"], d["lens"], d["kv"],
                                    window=window, softcap=cap)
    return out.float().cpu().numpy()


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def run(args: argparse.Namespace) -> dict:
    """Returns {(scheme, kind, window, cap): relative error}; raises
    AssertionError at the first case over 2e-2, as the script does."""
    dev = common.resolve(args.device, "tpu_window_check")
    what = ("kernels (bf16 compute) vs plain (float32)" if dev == "cuda"
            else "plain versions (float32) vs the numpy statement")
    print(f"device={common.label(dev)}: {what}", flush=True)
    rng = np.random.RandomState(0)
    errs = {}
    for scheme in SCHEMES:
        data = scheme_data(scheme, rng, dev)
        for window, cap in VARIANTS:
            tag = f"win={window} cap={cap}"
            for kind in ("decode", "chunk"):
                err = rel_err(*case_pair(data, kind, window, cap, dev))
                errs[(scheme, kind, window, cap)] = err
                print(f"{kind:6s} {scheme} {tag}: rel_err={err:.2e}",
                      flush=True)
                assert err < TOL, f"{kind} mismatch ({scheme}, {tag})"
    print(f"window/softcap {'kernels' if dev == 'cuda' else 'plain versions'}"
          f" OK on {dev}", flush=True)
    return errs


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
