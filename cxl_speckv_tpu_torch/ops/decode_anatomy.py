"""The decode-anatomy probes P1-P3: K1's walk taken apart, as CUDA kernels.

Counterparts of the three Pallas probes of `scripts/kernel_anatomy.py` (a
TPU script of the JAX package; nothing of it is imported here). They time
K1 (`ops/paged_attention.py`) beside its pieces, so that a K1 call's time
can be split into the load walk, the dequantize step, the products and
what keeping loads in flight buys. `scripts/kernel_anatomy.py` of this
package drives them.

- P1, `variant(mode, ...)`, `csrc/anatomy_variants.cu`, replaces
  `scripts/kernel_anatomy.py:204` (`run_variant.<locals>.loop`, call
  `:206`, body `:100-171`). Modes `fetchrow`, `fetchint`, `fetch`,
  `dequant`, `matmul`, `matmulT`; `variant_plain` states the function each
  computes, per (lane, kv head).
- P2, `kt_attention(...)`, `csrc/anatomy_kt.cu`, replaces
  `scripts/kernel_anatomy.py:360` (`run_v2.<locals>.loop`, call `:364`,
  body `:237-317`): decode attention on the JAX package's transposed-K
  ("kT") pool, variants `v2`, `v3fused` and `w8a8`; `kt_attention_plain`.
- P3, `ring(nbuf, ...)`, `csrc/anatomy_ring.cu`, replaces
  `scripts/kernel_anatomy.py:462` (`run_v5.<locals>.loop`, call `:464`): a
  ring of nbuf (4, 8, 16) `cp.async` stages in shared memory; the sum of
  token row 0 of every K and V tile, the function of P1's `fetchrow`.

What bounds them on the card: the bytes, at every mode. At the probe's
default geometry (B 8, Hq 32, Hkv 8, D 128, ctx 8192, INT8) a call reads
134 MB of K and V tiles (40 us at 3.35 TB/s); even the products of
`matmul` and `matmulT`, 1.07 GFLOP, take 16 us at the float32 rate the
kernels run them at (`probe_work` counts both). `fetchrow` and the rings
move whole tiles, as the TPU DMA did, but their function is the sum of
token row 0 of each tile: their bound counts those rows only (4.2 MB,
1.25 us), so their time against it is what moving the rest costs.

Where the designs depart from the TPU bodies, and why:
- P1 and P3 run on K1's grid, one CTA per (lane, kv head), over K1's
  token-major pools [S, Hkv, bs, D/pack], so that each mode is literally
  "K1 minus something". The TPU ring ran on a grid of (B,): on the card
  that is 8 CTAs at the probe's batch, 124 of 132 SMs idle.
- P1's products are taken within a head. The TPU tile spans all Hkv heads,
  so its body multiplied every query row by all Hkv * bs columns (and took
  matmulT's max over them); K1 on the card never does.
- P1's walk covers a lane's ceil(seq_len / bs) blocks; the TPU grid walked
  whole steps of `ppb` blocks with the index clamped to the last block.
  At the probe's full lanes the two are the same blocks.
- P2 keeps the TPU layout (its point is the layout) but, on K1's grid,
  needs no mask by head; it returns the whole [B, Hq, D] output, where the
  TPU probe returned column 0, so it can be held against K1.

Every wrapper takes a CUDA tensor to its kernel (or raises) and a CPU
tensor to the plain version; each counts its launches in a `Counter` keyed
by the probe's label (`variant.launches["fetch"]`, `kt_attention.launches
["v2"]`, `ring.launches["v5ring8"]`). What a kernel does not take raises
ValueError on either device: w8a8 on BF16 pools, a ring that does not fit
in the 227 KB of shared memory a block may have.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.models.convert import pools_from_jax
from cxl_speckv_tpu_torch.ops import cuda_build
from cxl_speckv_tpu_torch.ops.paged_attention import KV_KINDS, paged_attention
from cxl_speckv_tpu_torch.ops.paged_attention_ref import (
    NEG_INF,
    finalize,
    online_update,
    paged_attention_ref,
)
from cxl_speckv_tpu_torch.ops.quant import dequant_values, kv_pack

SCHEMES = {"int8": KVDtype.INT8, "int4": KVDtype.INT4, "bf16": KVDtype.BF16}
P1_MODES = ("fetchrow", "fetchint", "fetch", "dequant", "matmul", "matmulT")
SUM_MODES = P1_MODES[:4]
P2_VARIANTS = ("v2", "v3fused", "w8a8")
RING_DEPTHS = (4, 8, 16)
SMEM_LIMIT = 232448          # bytes of shared memory a block may have (H100)
PROBE_HEADS = (32, 8, 128)   # Hq, Hkv, D: the script's default, Llama-3-8B's
PROBE_BATCH = 8


@dataclass
class ProbePools:
    """One geometry's inputs, in both layouts: token-major K, V
    [S, Hkv, bs, D/pack] and scales [S, Hkv, bs] (K1, P1, P3); the kT pool
    [S, D/pack, Hkv * bs] and the fused scales [S, 2, Hkv, bs] (P2)."""
    kv: KVDtype
    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor
    kt: torch.Tensor
    scf: torch.Tensor
    table: torch.Tensor          # [B, max_blocks] int32
    lens: torch.Tensor           # [B] int32
    q: torch.Tensor              # [B, Hq, D] float32 holding bf16 values

    def token_major(self) -> tuple:
        return self.k, self.v, self.ks, self.vs


def kt_from_token_major(k: torch.Tensor) -> torch.Tensor:
    """K [S, Hkv, bs, D/pack] -> kT [S, D/pack, Hkv * bs] (the JAX
    `store_to_kt`; the INT4 half-split pairing carries over unchanged)."""
    S, hkv, bs, dp = k.shape
    return k.permute(0, 3, 1, 2).reshape(S, dp, hkv * bs).contiguous()


def token_major_from_kt(kt, v, ks, vs, num_kv_heads: int) -> tuple:
    """kT pools -> token-major (K, V, ks, vs) on kt's device, through
    `models.convert.pools_from_jax` (scales may be flat [S, 1, Hkv * bs]
    or [S, Hkv, bs]). bf16 pools cross as their int16 bits: numpy has no
    bfloat16 of its own."""
    bits = kt.dtype == torch.bfloat16
    as_np = lambda t: (t.view(torch.int16) if bits else t).cpu()
    k2, v2, ks2, vs2 = pools_from_jax(
        as_np(kt), as_np(v), ks.reshape(ks.shape[0], 1, -1).cpu(),
        vs.reshape(vs.shape[0], 1, -1).cpu(), num_kv_heads)
    if bits:
        k2, v2 = k2.view(torch.bfloat16), v2.view(torch.bfloat16)
    return tuple(t.to(kt.device) for t in (k2, v2, ks2, vs2))


def build_pools(scheme: str, bs: int, ctx: int, *, batch=PROBE_BATCH,
                heads=PROBE_HEADS, minpool: int = 0, seed=None, lens=None,
                shuffle: bool = False, device="cuda") -> ProbePools:
    """The probe's pools. Slots: max(B * max_blocks + 1, minpool // the
    bytes of one block's K), as the script sizes them, so a call reads from
    device memory and not from the L2. Without `seed` they hold the script's
    constants (`scripts/kernel_anatomy.py:71-84`: zero K, V and q, unit
    scales, the table arange(B * max_blocks)); with it, random values from a
    seeded `torch.Generator`: int8 bytes in [-127, 127] (INT4: any byte),
    bf16 N(0, 1) values, scales in [0.005, 0.025) (unit for BF16), q N(0, 1)
    rounded to bf16, and with `shuffle` the blocks at shuffled slots. `lens`
    (default ctx for every lane) may leave lanes shorter; max_blocks is
    ceil(max(lens, ctx) / bs)."""
    kv = SCHEMES[scheme]
    hq, hkv, d = heads
    dp = d // kv_pack(kv)
    dtype = torch.bfloat16 if kv == KVDtype.BF16 else torch.int8
    lens = [ctx] * batch if lens is None else list(lens)
    mb = -(-max(max(lens), ctx) // bs)
    block_bytes = hkv * bs * dp * (2 if kv == KVDtype.BF16 else 1)
    S = max(batch * mb + 1, minpool // block_bytes)
    shape = (S, hkv, bs, dp)
    if seed is None:
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        ks = torch.ones(shape[:3], device=device)
        vs = torch.ones(shape[:3], device=device)
        q = torch.zeros((batch, hq, d), device=device)
        order = torch.arange(S - 1)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        if kv == KVDtype.BF16:
            k, v = (torch.randn(shape, generator=gen, device=device)
                    .to(torch.bfloat16) for _ in range(2))
            ks = torch.ones(shape[:3], device=device)
            vs = torch.ones(shape[:3], device=device)
        else:
            low = -128 if kv == KVDtype.INT4 else -127
            k, v = (torch.randint(low, 128, shape, generator=gen,
                                  device=device, dtype=torch.int8)
                    for _ in range(2))
            ks, vs = (torch.rand(shape[:3], generator=gen, device=device)
                      * 0.02 + 0.005 for _ in range(2))
        q = torch.randn((batch, hq, d), generator=gen, device=device).to(
            torch.bfloat16).float()
        order = (torch.randperm(S - 1, generator=gen, device=device).cpu()
                 if shuffle else torch.arange(S - 1))
    table = order[:batch * mb].reshape(batch, mb).to(torch.int32)
    return ProbePools(kv=kv, k=k, v=v, ks=ks, vs=vs, kt=kt_from_token_major(k),
                      scf=torch.stack([ks, vs], 1).contiguous(),
                      table=table.to(device),
                      lens=torch.tensor(lens, dtype=torch.int32, device=device),
                      q=q)


# ---------------------------------------------------------------------------
# checks shared by the wrappers
# ---------------------------------------------------------------------------

def _check(name: str, kv: KVDtype, pools, tensors) -> torch.device:
    if kv not in SCHEMES.values():
        raise NotImplementedError(f"{name}: the probes take INT8, INT4 and "
                                  f"BF16 pools, not {kv}")
    want = torch.bfloat16 if kv == KVDtype.BF16 else torch.int8
    k, v = pools[:2]
    if k.dtype != want or v.dtype != want:
        raise ValueError(f"{name}: pools must be {want} for {kv}")
    for s in pools[2:]:
        if s is not None and s.dtype != torch.float32:
            raise ValueError(f"{name}: scales must be float32")
    dev = k.device
    for t in (*pools, *tensors):
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda":
        for t in (*pools, *tensors):
            if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(f"{name}: tensors must be contiguous and "
                                 f"16-byte aligned")
    return dev


def _walk(name, k, table, lens) -> None:
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError(f"{name}: block table and lens must be int32")
    if table.shape[0] != lens.shape[0]:
        raise ValueError(f"{name}: block table / lens batch")
    row_bytes = k.shape[-1] * k.element_size()
    if row_bytes % 16 or k.shape[2] % 4:
        raise ValueError(f"{name}: pool rows of {row_bytes} bytes (a multiple "
                         f"of 16 needed) or block size {k.shape[2]} (of 4)")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _lane_blocks(table, lens, b: int, bs: int) -> torch.Tensor:
    n = min(-(-int(lens[b]) // bs), table.shape[1])
    return table[b, :n].long()


# ---------------------------------------------------------------------------
# P1: K1's walk with parts stripped
# ---------------------------------------------------------------------------

def variant_plain(mode: str, q, k, v, ks, vs, table, lens, kv: KVDtype,
                  absolute: bool = False) -> torch.Tensor:
    """P1's function, per (lane b, kv head h), over the tiles of the lane's
    ceil(lens[b] / bs) blocks; raw = the stored elements as numbers (int8
    bytes, INT4 packed bytes read as int8, bf16 values):
      fetch     sum(raw K) + sum(raw V) + sum(ks) + sum(vs)   -> [B, Hkv] f32
      fetchint  sum(raw K) + sum(raw V) in int32, bf16 truncated toward 0
                                                              -> [B, Hkv] i32
      fetchrow  sum of token row 0 of each raw K and V tile    -> [B, Hkv] f32
      dequant   sum(bf16(deq(K) * bf16(ks))) + the same for V  -> [B, Hkv] f32
      matmul    sum over tokens t of bf16(q_g . K_t) V_t      -> [B, Hkv, G, D/pack]
      matmulT   sum over blocks of bf16(exp(s - max_block s)) V, s = q_g . K_t
    q_g: the kv head's G query rows, their first D/pack columns rounded to
    bf16; products on raw tiles. Sums accumulate in float64 (the kernel's
    float32 order differs). `absolute` sums |term| instead (the scale a
    sum's tolerance is stated against)."""
    B, hq, d = q.shape
    _, hkv, bs, dp = k.shape
    G = hq // hkv
    mag = torch.abs if absolute else (lambda x: x)
    if mode in SUM_MODES:
        acc = torch.zeros((B, hkv), dtype=torch.float64, device=k.device)
        for b in range(B):
            blk = _lane_blocks(table, lens, b, bs)
            kb, vb = k[blk], v[blk]
            if mode == "fetchint":
                tot = sum(mag(x.to(torch.int32)).sum((0, 2, 3), dtype=torch.int64)
                          for x in (kb, vb))
            elif mode == "fetchrow":
                tot = sum(mag(x[:, :, 0].double()).sum((0, 2)) for x in (kb, vb))
            elif mode == "fetch":
                tot = sum(mag(x.double()).sum((0, 2, 3)) for x in (kb, vb))
                tot = tot + sum(mag(s[blk].double()).sum((0, 2))
                                for s in (ks, vs))
            else:
                tot = sum(mag((dequant_values(x, kv) * s[blk].bfloat16().float()
                               [..., None]).bfloat16().double()).sum((0, 2, 3))
                          for x, s in ((kb, ks), (vb, vs)))
            acc[b] = tot
        return acc.to(torch.int32 if mode == "fetchint" else torch.float32)
    if mode not in ("matmul", "matmulT"):
        raise ValueError(f"unknown P1 mode {mode!r}")
    qh = q.reshape(B, hkv, G, d)[..., :dp].bfloat16().float()
    out = torch.zeros((B, hkv, G, dp), device=k.device)
    for b in range(B):
        blk = _lane_blocks(table, lens, b, bs)
        s = torch.einsum("hgd,nhtd->nhgt", qh[b], k[blk].float())
        if mode == "matmul":
            p = s.bfloat16().float()
        else:
            p = torch.exp(s - s.amax(-1, keepdim=True)).bfloat16().float()
        out[b] = torch.einsum("nhgt,nhtd->hgd", p, v[blk].float())
    return out


def variant(mode: str, q, k, v, ks, vs, table, lens,
            kv: KVDtype) -> torch.Tensor:
    """P1 mode `mode` (see `variant_plain`) on the card, or its plain
    version for CPU tensors."""
    dev = _check("anatomy variant", kv, (k, v, ks, vs), (q, table, lens))
    if mode not in P1_MODES:
        raise ValueError(f"unknown P1 mode {mode!r}")
    B, hq, d = q.shape
    S, hkv, bs, dp = k.shape
    _walk("anatomy variant", k, table, lens)
    if (hq % hkv or hq // hkv > 8 or dp > 256 or dp * kv_pack(kv) != d
            or ks.shape != k.shape[:3] or vs.shape != ks.shape):
        raise ValueError(f"anatomy variant: unsupported shape q "
                         f"{tuple(q.shape)} pool {tuple(k.shape)}")
    if dev.type == "cpu":
        return variant_plain(mode, q, k, v, ks, vs, table, lens, kv)
    if mode in SUM_MODES:
        out = torch.empty((B, hkv), device=dev, dtype=torch.int32
                          if mode == "fetchint" else torch.float32)
    else:
        out = torch.empty((B, hkv, hq // hkv, dp), device=dev)
    qf = q.float().contiguous()
    err = cuda_build.kernel("anatomy_variants")(
        qf.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), table.data_ptr(), lens.data_ptr(), out.data_ptr(), B,
        hq, hkv, d, dp, bs, table.shape[1], KV_KINDS[kv],
        P1_MODES.index(mode), _stream(dev))
    cuda_build.check_launch("anatomy_variants", err)
    variant.launches[mode] += 1
    return out


variant.launches = Counter()


# ---------------------------------------------------------------------------
# P2: decode attention on the transposed-K pool
# ---------------------------------------------------------------------------

def _q8(qg: torch.Tensor) -> torch.Tensor:
    """w8a8's int8 query, as `astype(int8)` gives it from the bf16 q:
    trunc(clip(bf16(q * 127), -127, 127)), held as float."""
    return torch.trunc(torch.clamp((qg * 127.0).bfloat16().float(), -127, 127))


def _kt_tiles(kt, slots, hkv: int, kv: KVDtype) -> torch.Tensor:
    """kT tiles of `slots` -> values [B, Hkv, bs, D] (INT4: row r's low
    nibble is element r, its high nibble element r + D/2)."""
    n, (_, dp, cols) = slots.shape[0], kt.shape
    raw = kt[slots].reshape(n, dp, hkv, cols // hkv).permute(0, 2, 3, 1)
    return dequant_values(raw, kv)


def w8a8_scores(q, kt, table, lens, num_kv_heads: int,
                kv: KVDtype) -> torch.Tensor:
    """w8a8's int32 scores q8 . k8 -> [B, Hkv, G, blocks * bs] over the
    longest lane's blocks (positions past a lane's length included). The
    products are exact in float64 (|sum| <= 127 * 127 * D < 2^53)."""
    B, hq, d = q.shape
    G = hq // num_kv_heads
    q8 = _q8(q.reshape(B, num_kv_heads, G, d).bfloat16().float()).double()
    bs = kt.shape[2] // num_kv_heads
    nblk = min(-(-int(lens.max()) // bs) if B else 0, table.shape[1])
    cols = [q8 @ _kt_tiles(kt, table[:, i].long(), num_kv_heads,
                           kv).double().transpose(-1, -2)
            for i in range(nblk)]
    if not cols:
        return torch.zeros((B, num_kv_heads, G, 0), dtype=torch.int32,
                           device=q.device)
    return torch.cat(cols, -1).to(torch.int32)


def kt_attention_plain(q, kt, v, k_scale, v_scale, table, lens, kv: KVDtype,
                       variant_name: str = "v2") -> torch.Tensor:
    """P2's function -> [B, Hq, D] float32: q rounded to bf16; per block,
    s = (q . k) * ks * D^-0.5 (w8a8: the int32 scores of `w8a8_scores`
    times float32(1/127) first); pos >= lens masked; an online softmax in
    float32; p * vs rounded to bf16 before PV (`paged_attention_ref`'s
    update). v3fused: `k_scale` is [S, 2, Hkv, bs] and `v_scale` None."""
    B, hq, d = q.shape
    hkv = v.shape[1]
    G = hq // hkv
    bs = kt.shape[2] // hkv
    if variant_name == "v3fused":
        k_scale, v_scale = k_scale[:, 0], k_scale[:, 1]
    ks = k_scale.reshape(k_scale.shape[0], hkv, bs)
    vs = v_scale.reshape(v_scale.shape[0], hkv, bs)
    qg = q.reshape(B, hkv, G, d).bfloat16().float()
    si = (w8a8_scores(q, kt, table, lens, hkv, kv)
          if variant_name == "w8a8" else None)
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    state = (torch.full((B, hkv, G, 1), NEG_INF, device=q.device),
             torch.zeros((B, hkv, G, 1), device=q.device),
             torch.zeros((B, hkv, G, d), device=q.device))
    nblk = min(-(-int(lens.max()) // bs) if B else 0, table.shape[1])
    for i in range(nblk):
        slots = table[:, i].long()
        if si is None:
            s = qg @ _kt_tiles(kt, slots, hkv, kv).transpose(-1, -2)
        else:
            s = (si[..., i * bs:(i + 1) * bs].float()
                 * torch.tensor(1.0 / 127.0, dtype=torch.float32))
        s = s * ks[slots][:, :, None, :] * scale
        pos = i * bs + torch.arange(bs, device=q.device)
        ok = (pos[None, :] < lens.long()[:, None])[:, None, None, :]
        state = online_update(state, s, ok, dequant_values(v[slots], kv),
                              vs[slots][:, :, None, :], torch.bfloat16)
    return finalize(state, None).reshape(B, hq, d)


def kt_attention(q, kt, v, k_scale, v_scale, table, lens, kv: KVDtype,
                 variant_name: str = "v2") -> torch.Tensor:
    """P2 variant `variant_name` ("v2", "v3fused", "w8a8") on the card, or
    its plain version for CPU tensors -> [B, Hq, D] float32. kt
    [S, D/pack, Hkv * bs], v [S, Hkv, bs, D/pack]; scales [S, Hkv, bs] (or
    flat [S, 1, Hkv * bs]); v3fused: k_scale [S, 2, Hkv, bs], v_scale None."""
    name = "anatomy kt"
    if variant_name not in P2_VARIANTS:
        raise ValueError(f"unknown P2 variant {variant_name!r}")
    fused = variant_name == "v3fused"
    if fused != (v_scale is None):
        raise ValueError(f"{name}: v3fused takes one scale array, v2 / w8a8 two")
    if variant_name == "w8a8" and kv == KVDtype.BF16:
        raise ValueError(f"{name}: w8a8 takes integer pools, not BF16")
    dev = _check(name, kv, (kt, v, k_scale, v_scale), (q, table, lens))
    B, hq, d = q.shape
    S, hkv, bs, dp = v.shape
    _walk(name, v, table, lens)
    want_sc = (S, 2, hkv, bs) if fused else None
    if (hq % hkv or hq // hkv > 8 or d > 256 or d % 8 or dp * kv_pack(kv) != d
            or kt.shape != (S, dp, hkv * bs)
            or (fused and k_scale.shape != want_sc)
            or (not fused and (k_scale.numel() != S * hkv * bs
                               or v_scale.shape != k_scale.shape))):
        raise ValueError(f"{name}: unsupported shape q {tuple(q.shape)} kT "
                         f"{tuple(kt.shape)} V {tuple(v.shape)}")
    if dev.type == "cpu":
        return kt_attention_plain(q, kt, v, k_scale, v_scale, table, lens, kv,
                                  variant_name)
    out = torch.empty((B, hq, d), device=dev)
    qf = q.float().contiguous()
    err = cuda_build.kernel("anatomy_kt")(
        qf.data_ptr(), kt.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        None if fused else v_scale.data_ptr(), table.data_ptr(),
        lens.data_ptr(), out.data_ptr(), B, hq, hkv, d, bs, table.shape[1],
        KV_KINDS[kv], int(fused), int(variant_name == "w8a8"),
        float(d ** -0.5), _stream(dev))
    cuda_build.check_launch("anatomy_kt", err)
    kt_attention.launches[variant_name] += 1
    return out


kt_attention.launches = Counter()


# ---------------------------------------------------------------------------
# P3: the ring of asynchronous copies
# ---------------------------------------------------------------------------

def ring_bytes(nbuf: int, bs: int, row_bytes: int) -> int:
    """Shared memory of a ring: nbuf stages of one block's K and V tiles and
    both scale rows."""
    return nbuf * (2 * bs * row_bytes + 8 * bs)


def ring(nbuf: int, k, v, ks, vs, table, lens, kv: KVDtype) -> torch.Tensor:
    """P3 at depth `nbuf` (4, 8, 16) -> [B, Hkv] float32, the function of
    `variant_plain("fetchrow", ...)`, which is its plain version for CPU
    tensors. Raises ValueError for a ring that does not fit in shared
    memory, on either device."""
    name = f"anatomy ring{nbuf}"
    if nbuf not in RING_DEPTHS:
        raise ValueError(f"{name}: depth must be one of {RING_DEPTHS}")
    dev = _check(name, kv, (k, v, ks, vs), (table, lens))
    B = lens.shape[0]
    S, hkv, bs, dp = k.shape
    _walk(name, k, table, lens)
    row_bytes = dp * k.element_size()
    need = ring_bytes(nbuf, bs, row_bytes)
    if need > SMEM_LIMIT:
        raise ValueError(f"{name}: a ring of {nbuf} stages needs {need} bytes "
                         f"of shared memory, more than the {SMEM_LIMIT} a "
                         f"block may have")
    if ks.shape != k.shape[:3] or vs.shape != ks.shape or v.shape != k.shape:
        raise ValueError(f"{name}: pool / scale shapes disagree")
    if dev.type == "cpu":
        q = torch.zeros((B, hkv, 1))
        return variant_plain("fetchrow", q, k, v, ks, vs, table, lens, kv)
    out = torch.empty((B, hkv), device=dev)
    err = cuda_build.kernel("anatomy_ring")(
        k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        table.data_ptr(), lens.data_ptr(), out.data_ptr(), B, hkv, bs,
        row_bytes, table.shape[1], k.element_size(), nbuf, _stream(dev))
    cuda_build.check_launch("anatomy_ring", err)
    ring.launches[f"v5ring{nbuf}"] += 1
    return out


ring.launches = Counter()


def probe_launches() -> dict:
    """{label: launches} of the three probe kernels since the last reset."""
    return {**variant.launches, **kt_attention.launches, **ring.launches}


def reset_probe_launches() -> None:
    for fn in (variant, kt_attention, ring):
        fn.launches.clear()


# ---------------------------------------------------------------------------
# every probe by its label: the call, its plain version, their agreement
# ---------------------------------------------------------------------------

def _scales(label: str, p: ProbePools) -> tuple:
    return (p.scf, None) if label == "v3fused" else (p.ks, p.vs)


def probe_calls(p: ProbePools) -> dict:
    """{label: a function of no arguments making one call on `p`}: "full"
    is K1 at bf16 compute, then every P1 mode, P2 variant and ring depth
    ("v5ring4", ...) under the TPU script's names."""
    tm = (*p.token_major(), p.table, p.lens, p.kv)
    fns = {"full": lambda: paged_attention(p.q, *tm,
                                           compute_dtype=torch.bfloat16)}
    for mode in P1_MODES:
        fns[mode] = lambda mode=mode: variant(mode, p.q, *tm)
    for name in P2_VARIANTS:
        fns[name] = lambda name=name: kt_attention(
            p.q, p.kt, p.v, *_scales(name, p), p.table, p.lens, p.kv, name)
    for nbuf in RING_DEPTHS:
        fns[f"v5ring{nbuf}"] = lambda nbuf=nbuf: ring(nbuf, *tm)
    return fns


def plain_calls(p: ProbePools) -> dict:
    """{label: its plain version on `p`}, the labels of `probe_calls`."""
    tm = (*p.token_major(), p.table, p.lens, p.kv)
    fns = {"full": lambda: paged_attention_ref(p.q, *tm,
                                               compute_dtype=torch.bfloat16)}
    for mode in P1_MODES:
        fns[mode] = lambda mode=mode: variant_plain(mode, p.q, *tm)
    for name in P2_VARIANTS:
        fns[name] = lambda name=name: kt_attention_plain(
            p.q, p.kt, p.v, *_scales(name, p), p.table, p.lens, p.kv, name)
    for nbuf in RING_DEPTHS:
        fns[f"v5ring{nbuf}"] = lambda: variant_plain("fetchrow", p.q, *tm)
    return fns


def agreement(label: str, got, want, p: ProbePools) -> tuple[float, bool, str]:
    """(max |got - want|, within tolerance, the tolerance stated) of a probe
    call against its plain version: fetchint exact; the float sums by
    `within_sum`; matmul / matmulT by `within_rows`; the attention outputs
    (full, v2, v3fused, w8a8, float32) within rtol = atol = 2e-4. Their
    p * vs rounds to bf16, and another float32 order can round a term to
    the neighbouring value; that moves an output by about 2^-8 of one
    token's share, ~1e-6 at the probe's geometry."""
    mode = "fetchrow" if label.startswith("v5ring") else label
    if mode == "fetchint":
        diff = (got.long() - want.long()).abs()
        return float(diff.max()) if diff.numel() else 0.0, bool(torch.equal(
            got, want)), "exact"
    if mode in SUM_MODES:
        mass = variant_plain(mode, p.q, *p.token_major(), p.table, p.lens,
                             p.kv, absolute=True)
        return (*within_sum(got, want, mass), "1e-5 of |plain| + sum |terms|")
    if mode in ("matmul", "matmulT"):
        return (*within_rows(got, want), "2e-3 of the (lane, head) max")
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= 2e-4 + 2e-4 * want.float().abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok, "rtol = atol = 2e-4"


# ---------------------------------------------------------------------------
# the work of a call, for its bound
# ---------------------------------------------------------------------------

def probe_work(label: str, p: ProbePools) -> tuple[int, dict]:
    """(bytes, {"bf16" | "int8" | "f32": operations}) of one call of probe
    `label` on `p` (their least time: `utils.card.bound_ms`): the inputs its
    function depends on, each read once -- the K / V tiles and scale rows
    of every block the lanes' walks cover (fetchrow and the rings: token
    row 0 of each head's K and V tile only, no scales, although they move
    whole tiles and the rings the scales too), q, the table entries and
    lens -- and its output written once; the operations on them (a product
    as 2, an add or a convert as 1). The probe's GB/s are taken against
    `fetch`'s bytes, the walk every variant makes."""
    B = p.lens.shape[0]
    hq, d = p.q.shape[1:]
    S, hkv, bs, dp = p.k.shape
    G = hq // hkv
    blocks = sum(min(-(-int(n) // bs), p.table.shape[1]) for n in p.lens.tolist())
    tile = hkv * bs * dp * p.k.element_size()
    scales = hkv * bs * 4
    walk = blocks * 4 + B * 4                          # table entries, lens
    tokens = blocks * bs * hkv                          # (token, head) pairs
    elems = tokens * dp                                  # stored K (or V)
    qb = p.q.numel() * 2                                 # bf16 values
    if label == "fetchrow" or label.startswith("v5ring"):
        row = hkv * dp * p.k.element_size()
        return (blocks * 2 * row + walk + B * hkv * 4,
                {"f32": 2 * blocks * hkv * dp})
    if label in ("fetch", "fetchint", "dequant"):
        with_sc = label != "fetchint"
        nb = blocks * 2 * (tile + (scales if with_sc else 0)) + walk + B * hkv * 4
        if label == "dequant":
            ops = {"f32": 2 * elems * kv_pack(p.kv) * 3}   # convert, scale, add
        else:
            ops = {"f32": 2 * elems + (2 * tokens if with_sc else 0)}
        return nb, ops
    if label in ("matmul", "matmulT"):
        nb = qb + blocks * 2 * tile + walk + B * hkv * G * dp * 4
        ops = {"bf16": 4 * G * dp * tokens}
        if label == "matmulT":
            ops["f32"] = 3 * G * tokens                 # max, subtract, exp
        return nb, ops
    # v2, v3fused, w8a8 and K1 ("full"): attention over the lanes' tokens
    nb = qb + blocks * 2 * (tile + scales) + walk + B * hq * d * 4
    ctx = int(p.lens.long().sum()) * hkv
    if label == "w8a8":
        return nb, {"int8": 2 * G * d * ctx, "bf16": 2 * G * d * ctx}
    return nb, {"bf16": 4 * G * d * ctx}


def contiguous_sums(label: str, p: ProbePools):
    """The PyTorch reductions that compute probe `label`'s sums where the
    table is the contiguous arange (the probe's timing pools), as a
    function of no arguments; None where no such call exists. fetch /
    fetchint: `k[:B*mb].view(B, mb, Hkv, -1).sum((1, 3), dtype=...)` and
    the same for V (and the scales, for fetch); fetchrow and the rings the
    same over token row 0."""
    B, mb = p.table.shape
    hkv = p.k.shape[1]
    n = B * mb
    if not torch.equal(p.table.flatten().cpu(), torch.arange(n, dtype=torch.int32)):
        return None
    if label in ("fetch", "fetchint"):
        dt = torch.int32 if label == "fetchint" else torch.float32
        parts = (p.k, p.v) + ((p.ks, p.vs) if label == "fetch" else ())
        return lambda: sum(x[:n].view(B, mb, hkv, -1).sum((1, 3), dtype=dt)
                           for x in parts)
    if label == "fetchrow" or label.startswith("v5ring"):
        return lambda: sum(x[:n, :, 0].reshape(B, mb, hkv, -1).sum(
            (1, 3), dtype=torch.float32) for x in (p.k, p.v))
    return None


def within_sum(got, want, mass, rtol: float = 1e-5) -> tuple[float, bool]:
    """A probe sum against its plain value: max |got - want| and whether
    |got - want| <= rtol * (|want| + mass) everywhere, `mass` the plain sum
    of |term| (`variant_plain(..., absolute=True)`): the float32 sums add
    terms in another order than the float64 plain ones."""
    diff = (got.double() - want.double()).abs()
    ok = diff <= rtol * (want.double().abs() + mass.double())
    return float(diff.max()) if diff.numel() else 0.0, bool(ok.all())


def within_rows(got, want, rtol: float = 2e-3) -> tuple[float, bool]:
    """matmul / matmulT outputs [B, Hkv, G, D/pack]: |got - want| <= rtol *
    max |want| of the same (lane, kv head). A score that rounds to the
    neighbouring bf16 value (the float32 dot products sum in another order)
    moves its row by one bf16 step of 2^-8 of that score's share."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().amax((-2, -1), keepdim=True)
    return (float(diff.max()) if diff.numel() else 0.0,
            bool((diff <= rtol * scale + 1e-30).all()))

