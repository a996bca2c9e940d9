"""W4A16 fused matmul, a CUDA kernel for Hopper (`csrc/w4a16_mm.cu`).

`w4a16_mm(x, q, s)` returns `(x @ unpack(q).to(dt)) * s.to(dt)`, `dt =
x.dtype`, in one launch that reads the packed int4 weight once and keeps
its values in registers (no bf16 copy of the weight in device memory):

- x [M, K] with q [K, N/2] and s [1, N], or batched: x [B, M, K], q [B, K,
  N/2], s [B, 1, N] (an MoE expert stack);
- q int8 in the half-split nibble layout of `ops/wquant.py` (byte j of a
  row holds column j in its low nibble, column j + N/2 in its high one), s
  float32 (a per-output-column scale).

bf16 and f16 activations run on the tensor cores, float32 activations in
IEEE float32 FMA on CUDA cores. The sum is float32 in every case; the result
rounds as the composition does (the sum rounded to `dt`, times the scale
rounded to `dt`, rounded again), so the kernel differs from the plain
version only in the order of the sum.

It replaces no TPU kernel: the JAX package's int4 weights convert inside
XLA's matmul fusion (`cxl_speckv_tpu/ops/wquant.py`, `mm`). The plain
version `w4a16_mm_plain` is that composition in PyTorch; the wrapper runs it
for a tensor on the CPU only, and on a CUDA tensor launches the kernel or
raises. `plan` chooses the kernel's row block and split-K count from the
shape (deterministic: two calls on the same inputs give the same bits).
"""

from __future__ import annotations

from collections import Counter

import torch

from cxl_speckv_tpu_torch.ops import cuda_build
from cxl_speckv_tpu_torch.ops.quant import unpack_int4

# activation kinds (csrc/w4a16_mm.cu)
KINDS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
BK = 64                   # k rows of a ring stage
BP = 128                  # packed columns of a CTA's strip
# the kernel's configurations (csrc/w4a16_mm.cu: with_cfg): (rows MB,
# config id); the tensor-core ones in order of MB, and the float32 one
MMA_BLOCKS = ((8, 0), (16, 1), (32, 2), (48, 3), (64, 4))
FMA_BLOCK = (16, 5)
# split-K fills the card to SPLIT_CTAS_PER_SM CTAs an SM, each split
# keeping MIN_SPLIT_STAGES stages of BK rows (the split counts that timed
# best at 8 rows: `scripts/w4a16_sweep.py`)
SPLIT_CTAS_PER_SM = 2
MIN_SPLIT_STAGES = 4
MAX_GRID_Z = 65535


def w4a16_mm_plain(x: torch.Tensor, q: torch.Tensor,
                   s: torch.Tensor) -> torch.Tensor:
    """(x @ unpack_int4(q).to(dt)) * s.to(dt), dt = x.dtype."""
    dt = x.dtype
    return (x @ unpack_int4(q).to(dt)) * s.to(dt)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block(M: int, dtype: torch.dtype, blocks=MMA_BLOCKS,
          fma=FMA_BLOCK) -> tuple[int, int]:
    """(rows MB, config id) for x's row count and dtype: the smallest
    tensor-core block of `blocks` that holds M (the largest beyond them);
    float32 takes the CUDA-core kernel's `fma`. The defaults are this
    kernel's; `ops/w8a16_mm.py` passes its own."""
    if dtype == torch.float32:
        return fma
    return next((b for b in blocks if M <= b[0]), blocks[-1])


def plan(M: int, K: int, width: int, batch: int, dtype: torch.dtype,
         sms: int, blocks=MMA_BLOCKS,
         fma=FMA_BLOCK) -> tuple[int, int, int]:
    """(config id, rows a CTA, split-K count) for x [batch, M, K] against a
    weight of `width` bytes a row (the packed width here; the int8
    kernel's output width, whose strips are BP columns too) on a card of
    `sms` SMs. When the tiles (BP columns by MB rows) are fewer than
    SPLIT_CTAS_PER_SM CTAs an SM, K splits to make up that many, each
    split keeping MIN_SPLIT_STAGES stages of BK rows."""
    mb, cfg = block(M, dtype, blocks, fma)
    tiles = batch * cdiv(width, BP) * cdiv(M, mb)
    target = SPLIT_CTAS_PER_SM * sms
    splits = 1
    if tiles < target:
        splits = max(1, min(target // tiles,
                            cdiv(K, BK) // MIN_SPLIT_STAGES,
                            MAX_GRID_Z // batch))
    return cfg, mb, splits


_sms: dict[int, int] = {}
# per (device, stream): the split tiles' arrival counters, zero between
# calls (the last CTA of a tile resets its counter); the int4 and int8
# kernels share them, as calls on one stream run one after the other
_counters: dict[tuple[int, int], torch.Tensor] = {}
_outgrown: list[torch.Tensor] = []


def sm_count(device: torch.device) -> int:
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


def tile_counters(n: int, device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            # a captured decode round (models/round_graph.py) may hold the
            # smaller buffer's address: it must never be freed and reused
            _outgrown.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def check_args(x: torch.Tensor, q: torch.Tensor,
               s: torch.Tensor) -> tuple[int, int, int, int]:
    """(batch, M, K, packed width) of a call the kernel takes; raises
    ValueError on anything else: an activation dtype other than float32,
    float16 or bfloat16, a packed weight that is not contiguous int8, scales
    that are not contiguous float32, shapes that do not match, tensors on
    two devices."""
    if x.dtype not in KINDS:
        raise ValueError(f"w4a16_mm: unsupported activation dtype {x.dtype}")
    if q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"w4a16_mm: needs a contiguous int8 packed weight, "
                         f"got {q.dtype} {tuple(q.shape)} strides "
                         f"{q.stride()}")
    if s.dtype != torch.float32 or not s.is_contiguous():
        raise ValueError(f"w4a16_mm: needs contiguous float32 scales, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if q.ndim not in (2, 3) or x.ndim != q.ndim:
        raise ValueError(f"w4a16_mm: x {tuple(x.shape)} against q "
                         f"{tuple(q.shape)}: needs [M, K] @ [K, N/2] or "
                         f"[B, M, K] @ [B, K, N/2]")
    batch = q.shape[0] if q.ndim == 3 else 1
    K, half = q.shape[-2], q.shape[-1]
    if (x.shape[-1] != K or (q.ndim == 3 and x.shape[0] != batch)
            or s.shape != (*q.shape[:-2], 1, 2 * half)):
        raise ValueError(f"w4a16_mm: shapes x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, s {tuple(s.shape)} do not match")
    if q.device != x.device or s.device != x.device:
        raise ValueError("w4a16_mm: x, q and s must lie on one device")
    return batch, x.shape[-2], K, half


def w4a16_mm(x: torch.Tensor, q: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ W4A16 weight (q [K, N/2] int8, s [1, N] float32) ->
    [M, N] in x.dtype, or batched over a leading axis B of all three.
    A CUDA call takes what `check_args` allows (x of any strides and
    alignment); anything else raises."""
    if x.device.type == "cpu":
        return w4a16_mm_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"w4a16_mm: unsupported device {x.device}")
    batch, M, K, half = check_args(x, q, s)
    y = torch.empty((*x.shape[:-1], 2 * half), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if K == 0:
        return y.zero_()
    x = x.contiguous()
    dev = x.device
    cfg, mb, splits = plan(M, K, half, batch, x.dtype, sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = cnt = None
    if splits > 1:
        ws = torch.empty(batch * splits * M * 2 * half, dtype=torch.float32,
                         device=dev)
        cnt = tile_counters(batch * cdiv(half, BP) * cdiv(M, mb), dev,
                             stream)
    vec = (half % 16 == 0 and (K * x.element_size()) % 16 == 0
           and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    fn = cuda_build.kernel("w4a16_mm")
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
             ws.data_ptr() if ws is not None else None,
             cnt.data_ptr() if cnt is not None else None,
             batch, M, K, half, KINDS[x.dtype], cfg, splits, int(vec),
             stream)
    cuda_build.check_launch("w4a16_mm", err)
    w4a16_mm.launches[str(x.dtype).removeprefix("torch.")] += 1
    return y


# kernel launches by activation dtype ("bfloat16"); CPU calls are not counted
w4a16_mm.launches = Counter()
