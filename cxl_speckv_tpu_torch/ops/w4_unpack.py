"""W4A16 weight unpack, a CUDA kernel for Hopper (`csrc/w4_unpack.cu`).

A W4A16 weight (`ops/wquant.QuantizedTensor` at bits 4) stores two signed
nibbles a byte along its last (output) axis, half-split: the low nibble of
byte j is column j, the high nibble column j + out/2, as the INT4 KV pack
(`ops/quant.unpack_int4`). `w4_unpack(q, dtype)` turns a packed
[..., out/2] int8 tensor into [..., out] in `dtype` in one launch; any
leading dims (a layer's matrix, an expert stack [E, in, out/2]) flatten
into rows.

It replaces no TPU kernel: the JAX package's int4 weights convert inside
XLA's matmul fusion. Its plain version `w4_unpack_plain` is
`unpack_int4(q).to(dtype)`; the wrapper runs it for a tensor on the CPU
only, and on a CUDA tensor launches the kernel or raises.

Off the matmul path: an int4 matmul runs the fused kernel of
`ops/w4a16_mm.py`, which never writes the unpacked weight. This kernel
serves `ops/wquant.take_rows` on an int4 table, which no served tree holds
(the embedding stays int8).
"""

from __future__ import annotations

from collections import Counter

import torch

from cxl_speckv_tpu_torch.ops import cuda_build
from cxl_speckv_tpu_torch.ops.quant import unpack_int4

# the kernel's output kinds (csrc/w4_unpack.cu)
OUT_KINDS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def w4_unpack_plain(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[..., out/2] half-split nibbles -> [..., out] values in `dtype`."""
    return unpack_int4(q).to(dtype)


def w4_unpack(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[..., out/2] int8 half-split nibbles -> [..., out] in `dtype`
    (float32, float16 or bfloat16)."""
    if q.device.type == "cpu":
        return w4_unpack_plain(q, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"w4_unpack: unsupported device {q.device}")
    if q.dtype != torch.int8 or not q.is_contiguous() or q.ndim < 1:
        raise ValueError(f"w4_unpack: needs a contiguous int8 tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if dtype not in OUT_KINDS:
        raise ValueError(f"w4_unpack: unsupported output dtype {dtype}")
    half = q.shape[-1]
    rows = q.numel() // half if half else 0
    out = torch.empty((*q.shape[:-1], 2 * half), dtype=dtype, device=q.device)
    if out.numel() == 0:
        return out
    wide = (half % 16 == 0 and q.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
    fn = cuda_build.kernel("w4_unpack")
    err = fn(q.data_ptr(), out.data_ptr(), rows, half, OUT_KINDS[dtype],
             int(wide), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("w4_unpack", err)
    w4_unpack.launches[str(dtype).removeprefix("torch.")] += 1
    return out


# kernel launches by output dtype ("bfloat16"); CPU calls are not counted
w4_unpack.launches = Counter()
