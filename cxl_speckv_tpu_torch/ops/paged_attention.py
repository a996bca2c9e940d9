"""K1: paged decode attention, a CUDA kernel for Hopper.

Counterpart of `cxl_speckv_tpu/ops/paged_attention.py` (the Pallas TPU
kernel `paged_attention`); the kernel source is `csrc/paged_attention.cu`,
whose header gives its design and what bounds it. `paged_attention` takes
the port's token-major pools and computes what the TPU kernel computes:
one query token per lane over its quantized pool context, reached through
the block table, with dequantization fused into the attention.

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version `ops/paged_attention_ref.paged_attention_ref`. The kernel takes the
storage kind (INT8, BF16, FP8, INT4; MIXED8 with its `scheme_id` launches as
INT8 or FP8), the sliding window, the tanh softcap and the GPT-OSS sink
logits (a float32 pointer, null for none) as launch arguments.

The kernel's grid is split-context: each lane's attended blocks are divided
among `num_splits` CTAs a kv head, and a merge kernel combines their partial
softmax states. `decode_splits` chooses the count from the call's static
shapes and the card's SM count, never from `seq_lens`, so that two engines
of the same batch and table geometry run the same arithmetic.
"""

from __future__ import annotations

import functools
from collections import Counter

import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops import cuda_build
from cxl_speckv_tpu_torch.ops.paged_attention_ref import paged_attention_ref
from cxl_speckv_tpu_torch.ops.quant import decoded_scheme, kv_pack

# the kernels' storage kinds (csrc/kv_tile.cuh)
KV_KINDS = {KVDtype.INT8: 0, KVDtype.BF16: 1, KVDtype.FP8: 2, KVDtype.INT4: 3}

MAX_SPLITS = 64           # csrc/paged_attention.cu
SPLIT_WAVES = 2           # CTAs the split grid aims at, per SM
MIN_SPLIT_BLOCKS = 6      # least attended blocks a split, at most splits


def decode_splits(B: int, Hkv: int, max_blocks: int, window: int | None,
                  bs: int, sm_count: int) -> int:
    """Context splits a lane for K1 at these static shapes: about
    SPLIT_WAVES CTAs an SM (B * Hkv * S ~ SPLIT_WAVES * sm_count), at
    least MIN_SPLIT_BLOCKS of the most blocks a lane can attend a split
    (the table width, or under a window ceil(window / bs) + 1 of it), and
    1 where B * Hkv CTAs already fill the card. Reads no sequence lengths."""
    ctas = B * Hkv
    if ctas == 0 or ctas >= sm_count:
        return 1
    attended = max_blocks if not window else min(max_blocks,
                                                 -(-window // bs) + 1)
    s = min(-(-SPLIT_WAVES * sm_count // ctas), attended // MIN_SPLIT_BLOCKS,
            MAX_SPLITS)
    return max(s, 1)


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA card `device_index`."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def default_splits(q: torch.Tensor, k_pool: torch.Tensor,
                   block_table: torch.Tensor, window: int | None) -> int:
    """The splits `paged_attention(..., num_splits=None)` launches for these
    arguments: `decode_splits` of their shapes on a CUDA tensor, 1 (the
    unsplit plain version) on the CPU."""
    if q.device.type != "cuda":
        return 1
    return decode_splits(q.shape[0], k_pool.shape[1], block_table.shape[1],
                         window, k_pool.shape[2],
                         sm_count(torch.cuda.current_device()
                                  if q.device.index is None
                                  else q.device.index))


def check_cuda_call(name: str, kv_dtype: KVDtype, scheme_id, compute_dtype,
                    pools, tensors) -> KVDtype:
    """Shared argument checks of the CUDA attention wrappers. Returns the
    scheme the kernel decodes (MIXED8 resolved by `scheme_id`)."""
    kind = decoded_scheme(kv_dtype, scheme_id)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{name}: compute dtype {compute_dtype}")
    want = torch.bfloat16 if kind == KVDtype.BF16 else torch.int8
    k_pool, v_pool, k_scale, v_scale = pools
    if k_pool.dtype != want or v_pool.dtype != want:
        raise ValueError(f"{name}: pools must be {want} for {kv_dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError(f"{name}: scales must be float32")
    if k_pool.shape != v_pool.shape or k_scale.shape != k_pool.shape[:3] \
            or v_scale.shape != k_scale.shape:
        raise ValueError(f"{name}: pool/scale shapes disagree")
    dev = k_pool.device
    for t in (*pools, *tensors):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
    for t in pools:
        if not t.is_contiguous():
            raise ValueError(f"{name}: pools must be contiguous")
    return kind


def check_head_dim(name: str, kind: KVDtype, D: int, k_pool) -> None:
    """A pool row holds D / pack stored elements; the tile loader reads four
    at a time (INT4: four bytes, so D % 8 == 0)."""
    pack = kv_pack(kind)
    if k_pool.shape[-1] * pack != D or D % (4 * pack):
        raise ValueError(f"{name}: head_dim {D} does not fit pool rows of "
                         f"{k_pool.shape[-1]} for {kind}")


def sink_logits(name: str, sinks, num_q_heads: int, device):
    """The sinks as the kernels read them: float32 [Hq] on the card (the
    tree stores them in the activation dtype), or None."""
    if sinks is None:
        return None
    if sinks.shape != (num_q_heads,) or sinks.device != device:
        raise ValueError(f"{name}: sinks must be [{num_q_heads}] on {device},"
                         f" got {tuple(sinks.shape)} on {sinks.device}")
    return sinks.float().contiguous()


def count_launch(fn, kind: KVDtype, window: int, sinks) -> None:
    """One launch of `fn`'s kernel, by (scheme decoded, window); launches
    with sinks also count in `fn.sink_launches`."""
    fn.launches[kind.value, window] += 1
    if sinks is not None:
        fn.sink_launches[kind.value, window] += 1


def launch_variant(window: int | None, softcap: float | None) -> tuple:
    """(window, softcap) as the kernels take them: 0 = none."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return int(window or 0), float(softcap or 0.0)


def paged_attention(
    q: torch.Tensor,             # [B, Hq, D]
    k_pool: torch.Tensor,        # [S, Hkv, bs, D/pack] int8 bytes or bf16
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,       # [S, Hkv, bs] f32
    v_scale: torch.Tensor,
    block_table: torch.Tensor,   # [B, max_blocks] int32
    seq_lens: torch.Tensor,      # [B] int32
    kv_dtype: KVDtype,
    sm_scale: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
    window: int | None = None,
    softcap: float | None = None,
    sinks: torch.Tensor | None = None,
    scheme_id: int | None = None,  # MIXED8: 0 = INT8, 1 = FP8 bytes
    num_splits: int | None = None,  # context splits a lane; None: the rule
) -> torch.Tensor:
    """Decode attention -> [B, Hq, D] in q's dtype. `num_splits` forces the
    split count (tests, timing); None takes `default_splits`."""
    if num_splits is not None and not 1 <= num_splits <= MAX_SPLITS:
        raise ValueError(f"paged_attention: num_splits {num_splits} not in "
                         f"[1, {MAX_SPLITS}]")
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
            kv_dtype, sm_scale=sm_scale, compute_dtype=compute_dtype,
            window=window, softcap=softcap, sinks=sinks, scheme_id=scheme_id,
            num_splits=num_splits)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    kind = check_cuda_call("paged_attention", kv_dtype, scheme_id,
                           compute_dtype, (k_pool, v_pool, k_scale, v_scale),
                           (q, block_table, seq_lens))
    win, cap = launch_variant(window, softcap)
    B, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    check_head_dim("paged_attention", kind, D, k_pool)
    if Hq % Hkv or Hq // Hkv > 8 or D > 256:
        raise ValueError(f"paged_attention: unsupported shape q {tuple(q.shape)}"
                         f" pool {tuple(k_pool.shape)}")
    if block_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("paged_attention: block_table / seq_lens batch")
    if sm_scale is None:
        sm_scale = D ** -0.5
    sk = sink_logits("paged_attention", sinks, Hq, q.device)
    qf = q.float().contiguous()
    table = block_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    S = num_splits or default_splits(q, k_pool, table, window)
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    # the splits' partial (m, l, acc), float32 [B, Hq, S] x 2 and
    # [B, Hq, S, D], from the caching allocator (no host sync)
    parts = [None] * 3
    if S > 1:
        n = B * Hq * S
        ws = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
        base = ws.data_ptr()
        parts = [base, base + 4 * n, base + 8 * n]
    fn = cuda_build.kernel("paged_attention")
    err = fn(qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr(), v_scale.data_ptr(), table.data_ptr(),
             lens.data_ptr(), None if sk is None else sk.data_ptr(),
             out.data_ptr(), *parts, B, Hq, Hkv, D, bs,
             table.shape[1], KV_KINDS[kind],
             int(compute_dtype == torch.bfloat16), win, S, float(sm_scale),
             cap, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch("paged_attention", err)
    count_launch(paged_attention, kind, win, sk)
    paged_attention.split_launches[S] += 1
    return out.to(q.dtype)


# kernel launches by (the scheme decoded, e.g. "int8" also for a MIXED8
# layer of scheme id 0; the window, 0 = none) since the count was last
# cleared; CPU calls are not counted. The total is the sum of the values.
# `sink_launches`: the launches among them that carried sinks, same keys.
# `split_launches`: the same launches by their split count S (a call at
# S > 1 also launches the merge kernel; it counts once).
paged_attention.launches = Counter()
paged_attention.sink_launches = Counter()
paged_attention.split_launches = Counter()
