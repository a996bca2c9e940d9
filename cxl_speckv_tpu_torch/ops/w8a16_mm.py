"""W8A16 fused matmul, a CUDA kernel for Hopper (`csrc/w8a16_mm.cu`).

`w8a16_mm(x, q, s)` returns `(x @ q.to(dt)) * s.to(dt)`, `dt = x.dtype`, in
one launch that reads the int8 weight once and converts its bytes to the
activation type in registers (no converted copy of the weight in device
memory):

- dense: x [M, K] with q [K, N] and s [1, N] (a matmul weight, or its tp
  shard);
- tied head: x [M, K] with q the [K, N] transposed view of a row-major
  [N, K] int8 table and s [1, N] (`QuantizedTensor.T` of an embedding:
  `mm(x, embed.T)`); the kernel reads the table's rows K-contiguous, as
  they lie, and copies nothing;
- batched: x [B, M, K], q [B, K, N], s [B, 1, N] (an MoE expert stack, both
  specs of `ops/wquant.EXPERT_SPECS`). An x that is one [M, K] matrix
  expanded over B (stride 0 on its first axis: the dense MoE mode's
  `x2d[None].expand(E, N, H)`) is read in place; any other x of other
  strides is made contiguous first (a copy of the activations, a few MB at
  most, never of the weight).

bf16 and f16 activations run on the tensor cores, float32 activations in
IEEE float32 FMA on CUDA cores. The sum is float32 in every case; the result
rounds as the composition does (the sum rounded to `dt`, times the scale
rounded to `dt`, rounded again), so the kernel differs from the plain
version only in the order of the sum.

It replaces no TPU kernel: the JAX package's int8 weights convert inside
XLA's matmul fusion (`cxl_speckv_tpu/ops/wquant.py`, `mm` / `qeinsum`). The
plain version `w8a16_mm_plain` is that composition in PyTorch (a full-width
copy of the weight, then the matmul); the wrapper runs it for a tensor on
the CPU only, and on a CUDA tensor launches the kernel or raises. `plan`
(the int4 kernel's rule, `ops/w4a16_mm.plan`, with this kernel's row
blocks) chooses the row block and split-K count from the shape
(deterministic: two calls on the same inputs give the same bits).
"""

from __future__ import annotations

from collections import Counter

import torch

from cxl_speckv_tpu_torch.ops import cuda_build
from cxl_speckv_tpu_torch.ops import w4a16_mm as w4

KINDS = w4.KINDS                 # activation kinds (csrc/wq_mm.cuh)
BK = w4.BK                       # k values of a ring stage
BN = w4.BP                       # output columns of a CTA's strip
# the kernel's configurations (csrc/w8a16_mm.cu: with_cfg): (rows MB,
# config id); the tensor-core ones in order of MB, up to 128 rows for a
# prefill's 512, and the float32 one
MMA_BLOCKS = ((8, 0), (16, 1), (32, 2), (48, 3), (64, 4), (128, 5))
FMA_BLOCK = (16, 6)


def w8a16_mm_plain(x: torch.Tensor, q: torch.Tensor,
                   s: torch.Tensor) -> torch.Tensor:
    """(x @ q.to(dt)) * s.to(dt), dt = x.dtype."""
    dt = x.dtype
    return (x @ q.to(dt)) * s.to(dt)


def plan(M: int, K: int, N: int, batch: int, dtype: torch.dtype,
         sms: int) -> tuple[int, int, int]:
    """(config id, rows a CTA, split-K count) for x [batch, M, K] against an
    int8 weight of N output columns on a card of `sms` SMs: the int4
    kernel's rule (`ops/w4a16_mm.plan`: split K while the tiles are fewer
    than its SPLIT_CTAS_PER_SM CTAs an SM) over this kernel's blocks."""
    return w4.plan(M, K, N, batch, dtype, sms, MMA_BLOCKS, FMA_BLOCK)


def is_tied(q: torch.Tensor) -> bool:
    """q is the transposed view of a contiguous [N, K] table (the tied
    head's layout) and not itself contiguous."""
    return q.ndim == 2 and not q.is_contiguous() and q.t().is_contiguous()


def check_args(x: torch.Tensor, q: torch.Tensor,
               s: torch.Tensor) -> tuple[int, int, int, int, bool]:
    """(batch, M, K, N, tied) of a call the kernel takes; raises ValueError
    on anything else: an activation dtype other than float32, float16 or
    bfloat16, a weight that is not int8 in one of the two layouts (a batch
    only contiguous), scales that are not contiguous float32, shapes that
    do not match, tensors on two devices."""
    if x.dtype not in KINDS:
        raise ValueError(f"w8a16_mm: unsupported activation dtype {x.dtype}")
    tied = is_tied(q)
    if q.dtype != torch.int8 or not (q.is_contiguous() or tied):
        raise ValueError(f"w8a16_mm: needs an int8 weight, contiguous or the "
                         f"transpose of a contiguous [N, K] table, got "
                         f"{q.dtype} {tuple(q.shape)} strides {q.stride()}")
    if s.dtype != torch.float32 or not s.is_contiguous():
        raise ValueError(f"w8a16_mm: needs contiguous float32 scales, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if q.ndim not in (2, 3) or x.ndim != q.ndim:
        raise ValueError(f"w8a16_mm: x {tuple(x.shape)} against q "
                         f"{tuple(q.shape)}: needs [M, K] @ [K, N] or "
                         f"[B, M, K] @ [B, K, N]")
    batch = q.shape[0] if q.ndim == 3 else 1
    K, N = q.shape[-2], q.shape[-1]
    if (x.shape[-1] != K or (q.ndim == 3 and x.shape[0] != batch)
            or s.shape != (*q.shape[:-2], 1, N)):
        raise ValueError(f"w8a16_mm: shapes x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, s {tuple(s.shape)} do not match")
    if q.device != x.device or s.device != x.device:
        raise ValueError("w8a16_mm: x, q and s must lie on one device")
    return batch, x.shape[-2], K, N, tied


def w8a16_mm(x: torch.Tensor, q: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ W8A16 weight (q [K, N] int8, dense or the tied head's
    transposed table; s [1, N] float32) -> [M, N] in x.dtype, or batched
    over a leading axis B of all three. A CUDA call takes what
    `check_args` allows (x of any strides and alignment); anything else
    raises."""
    if x.device.type == "cpu":
        return w8a16_mm_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_mm: unsupported device {x.device}")
    batch, M, K, N, tied = check_args(x, q, s)
    y = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if K == 0:
        return y.zero_()
    if x.ndim == 3 and x.stride(0) == 0 and x[0].is_contiguous():
        xbs = 0                          # one x for every batch, in place
    else:
        x = x.contiguous()
        xbs = M * K
    dev = x.device
    cfg, mb, splits = plan(M, K, N, batch, x.dtype, w4.sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = cnt = None
    if splits > 1:
        ws = torch.empty(batch * splits * M * N, dtype=torch.float32,
                         device=dev)
        cnt = w4.tile_counters(batch * w4.cdiv(N, BN) * w4.cdiv(M, mb), dev,
                               stream)
    vec = ((K if tied else N) % 16 == 0
           and (K * x.element_size()) % 16 == 0
           and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    fn = cuda_build.kernel("w8a16_mm")
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
             ws.data_ptr() if ws is not None else None,
             cnt.data_ptr() if cnt is not None else None,
             batch, M, K, N, KINDS[x.dtype], cfg, splits, int(vec),
             int(tied), xbs, stream)
    cuda_build.check_launch("w8a16_mm", err)
    w8a16_mm.launches[str(x.dtype).removeprefix("torch.")] += 1
    w8a16_mm.tied_launches += tied
    return y


# kernel launches by activation dtype ("bfloat16"), and those of the tied
# head's layout among them; CPU calls are not counted
w8a16_mm.launches = Counter()
w8a16_mm.tied_launches = 0
