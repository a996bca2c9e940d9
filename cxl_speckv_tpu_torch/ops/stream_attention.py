"""Streamed attention over host-resident quantized KV context.

Counterpart of `cxl_speckv_tpu/ops/stream_attention.py`, the attention of
the host-streamed serving path: a sequence whose KV does not fit the HBM
pool keeps all of it in the pinned host tier (`runtime/hoststore.py`), and
each layer's context passes through the device wave by wave (`wave` blocks
at a time) in an online softmax, so HBM holds a wave's slab, not the
sequence. The JAX file is plain `jnp` with no Pallas kernel, and this one is
plain PyTorch with no CUDA kernel.

Two ways to get the waves, one wave loop (`_make_wave_attend`):

- `stream_context_attention_slab` attends over context rows already staged
  in a device slab (the engine stages a layer group, or a fused decode's
  whole context, in a few large copies);
- `stream_context_attention` copies each wave from the host store itself
  (`hoststore.fetch_layer`).

Both run the identical loop over the identical wave sequence, so on one
device they agree bit for bit, as the JAX pair does.

Numerics are float32 throughout, as in the reference: q, the dequantized
context and the fresh chunk's K / V are cast to float32, and every product
is a float32 einsum. On the card a float32 matmul runs in full float32 while
`torch.backends.cuda.matmul.allow_tf32` keeps PyTorch's default of False;
this module leaves it so (TF32 would keep about three decimal digits).

`start_pos` is a host integer: the engine knows every lane's position on
the host, so the trip count and the window's first wave need no device read.
"""

from __future__ import annotations

import numpy as np
import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops.quant import dequant_values
from cxl_speckv_tpu_torch.runtime.hoststore import DeviceHostStore, fetch_layer

NEG_INF = -1e30


def _make_wave_attend(qg, num_kv_heads, wave, block_size, head_dim,
                      kv_dtype, start_pos, sm_scale, window, softcap, T):
    """The online-softmax update of one wave, shared by the slab path and
    the host-fetching path: the same operations in the same order keep
    them bit-equal for the same wave sequence. qg [T, Hkv, G, D] float32.

    The products are the JAX einsums as batched matmuls over the kv head:
    q is arranged [Hkv, G * T, D] once, not per wave. A wave wholly below
    start_pos with no window is unmasked (every position attends), which
    `torch.where` over an all-true mask would leave unchanged."""
    W = wave * block_size
    dev = qg.device
    group = qg.shape[2]
    q_h = qg.permute(1, 2, 0, 3).reshape(num_kv_heads, group * T, head_dim)
    ar = torch.arange(W, device=dev)[None, :]
    t_idx = torch.arange(T, device=dev)[:, None]
    direct = kv_dtype in (KVDtype.INT8, KVDtype.BF16)

    def context(blk):
        """[wave, Hkv, bs, Dp] stored rows -> [Hkv, wave * bs, D] float32
        values, contiguous (INT8 / BF16 in one converting copy)."""
        if direct:
            out = torch.empty((num_kv_heads, wave, block_size, head_dim),
                              device=dev)
            return out.copy_(blk.transpose(0, 1)).view(num_kv_heads, W,
                                                       head_dim)
        return dequant_values(blk, kv_dtype).transpose(0, 1).reshape(
            num_kv_heads, W, head_dim)

    def attend(w, acc, slab):
        m_acc, l_acc, o_acc = acc
        kblk, vblk, ksb, vsb = slab        # [wave, Hkv, bs, Dp], [wave, Hkv, bs]
        kc, vc = context(kblk), context(vblk)
        ks = ksb.transpose(0, 1).reshape(num_kv_heads, W)
        vs = vsb.transpose(0, 1).reshape(num_kv_heads, W)

        s = (torch.bmm(q_h, kc.transpose(1, 2)).view(num_kv_heads, group, T, W)
             * ks[:, None, None, :] * sm_scale)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        # position w * W + i is context for query t when it lies below
        # start_pos and, with a window, above start_pos + t - window
        if window is not None or (w + 1) * W > start_pos:
            off = start_pos - w * W
            masked = ar >= off                                   # [1, W]
            if window is not None:
                masked = masked | (ar <= off + t_idx - window)   # [T, W]
            s = s.masked_fill(masked[None, None], NEG_INF)

        m_new = torch.maximum(m_acc, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_acc - m_new)
        l_acc = l_acc * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.bmm((p * vs[:, None, None, :]).view(
            num_kv_heads, group * T, W), vc)
        o_acc = o_acc * alpha + pv.view(num_kv_heads, group, T, head_dim)
        return m_new, l_acc, o_acc

    return attend


def _setup(q, num_kv_heads, sm_scale):
    """(qg [T, Hkv, G, D] float32, sm_scale, the initial (m, l, o))."""
    T, num_q_heads, head_dim = q.shape
    group = num_q_heads // num_kv_heads
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    qg = q.reshape(T, num_kv_heads, group, head_dim).float()
    shape = (num_kv_heads, group, T)
    init = (torch.full((*shape, 1), NEG_INF, device=q.device),
            torch.zeros((*shape, 1), device=q.device),
            torch.zeros((*shape, head_dim), device=q.device))
    return qg, sm_scale, init


def _wave_range(start_pos: int, n_waves: int, wave: int, block_size: int,
                window: int | None) -> range:
    """The waves that hold attended context: those below start_pos (only
    waves overlapping real context run, so a wide table costs nothing for a
    short sequence), from the first one the earliest query's window reaches
    (waves wholly below it are skipped)."""
    wt = wave * block_size
    n_used = min((start_pos + wt - 1) // wt, n_waves)
    w0 = 0
    if window is not None:
        w0 = min(max((start_pos - window) // wt, 0), n_used)
    return range(w0, n_used)


def stream_context_attention_slab(
    q: torch.Tensor,          # [T, Hq, D] fresh queries (rope applied)
    slab,                     # (k [Wb, Hkv, bs, Dp], v, ks [Wb, Hkv, bs], vs)
                              # device-resident staged context rows
    start_pos: int,           # pool tokens < start_pos are context
    kv_dtype: KVDtype,
    block_size: int,
    wave: int,
    sm_scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
):
    """Online-softmax context attention over a staged device slab. Returns
    the (m [Hkv, G, T, 1], l [Hkv, G, T, 1], o [Hkv, G, T, D]) accumulators
    for `merge_chunk_causal`."""
    num_kv_heads, head_dim = slab[0].shape[1], q.shape[2]
    qg, sm_scale, acc = _setup(q, num_kv_heads, sm_scale)
    attend = _make_wave_attend(qg, num_kv_heads, wave, block_size, head_dim,
                               kv_dtype, start_pos, sm_scale, window, softcap,
                               q.shape[0])
    for w in _wave_range(start_pos, slab[0].shape[0] // wave, wave,
                         block_size, window):
        acc = attend(w, acc, tuple(a[w * wave:(w + 1) * wave] for a in slab))
    return acc


def stream_context_attention(
    q: torch.Tensor,          # [T, Hq, D] fresh queries (rope applied)
    store: DeviceHostStore,   # the host tier (flat rows, slot-major)
    host_row: np.ndarray,     # [max_blocks_padded] store slots (guard-padded)
    start_pos: int,
    layer: int,
    kv_dtype: KVDtype,
    block_size: int,
    max_blocks: int,
    wave: int = 4,
    sm_scale: float | None = None,
    window: int | None = None,   # sliding window (Mistral family)
    softcap: float | None = None,  # tanh score cap (Gemma family)
):
    """Online-softmax partial attention over host-resident context: each
    wave's rows of `layer` are copied from the store as the loop reaches
    them. Returns the (m, l, o) accumulators for `merge_chunk_causal`.

    The JAX function's prefetch pipelining (`pre` / `next_layer`: the next
    wave's gather issued before this wave's matmuls) has no counterpart:
    it orders XLA's host ops, and changes no value. The store knows its
    layer count, which the JAX function takes as `num_layers`."""
    num_kv_heads, head_dim = store.k.shape[1], q.shape[2]
    qg, sm_scale, acc = _setup(q, num_kv_heads, sm_scale)
    attend = _make_wave_attend(qg, num_kv_heads, wave, block_size, head_dim,
                               kv_dtype, start_pos, sm_scale, window, softcap,
                               q.shape[0])
    for w in _wave_range(start_pos, -(-max_blocks // wave), wave, block_size,
                         window):
        slab = fetch_layer(store, host_row[w * wave:(w + 1) * wave], layer,
                           q.device)
        acc = attend(w, acc, slab)
    return acc


def merge_chunk_causal(
    q: torch.Tensor,          # [T, Hq, D]
    k_new: torch.Tensor,      # [T, Hkv, D] (already quantize -> dequantized)
    v_new: torch.Tensor,
    carry,                    # (m, l, o) from stream_context_attention(_slab)
    sm_scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
    sinks: torch.Tensor | None = None,    # [Hq] learned sink logits (GPT-OSS)
) -> torch.Tensor:
    """Merge in-chunk causal attention into the streamed accumulators, add
    the sinks at finalize, and normalize. Returns [T, Hq, D] in q's dtype."""
    T, num_q_heads, head_dim = q.shape
    num_kv_heads = k_new.shape[1]
    group = num_q_heads // num_kv_heads
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    m_acc, l_acc, o_acc = carry
    qg = q.reshape(T, num_kv_heads, group, head_dim).float()
    s = torch.einsum("thgd,shd->hgts", qg, k_new.float()) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    t_idx = torch.arange(T, device=q.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    if window is not None:
        causal = causal & (t_idx[:, None] - t_idx[None, :] < window)
    s = torch.where(causal[None, None], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m_acc, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m_acc - m_new)
    l_acc = l_acc * alpha + p.sum(dim=-1, keepdim=True)
    o_acc = o_acc * alpha + torch.einsum("hgts,shd->hgtd", p, v_new.float())
    if sinks is not None:
        sk = sinks.reshape(num_kv_heads, group).float()[:, :, None, None]
        m_fin = torch.maximum(m_new, sk)
        a2 = torch.exp(m_new - m_fin)
        l_acc = l_acc * a2 + torch.exp(sk - m_fin)
        o_acc = o_acc * a2
    out = o_acc / torch.clamp_min(l_acc, 1e-30)              # [Hkv, G, T, D]
    return out.permute(2, 0, 1, 3).reshape(T, num_q_heads, head_dim).to(q.dtype)
