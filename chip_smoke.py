#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`cxl_speckv_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing its results; any failure exits non-zero:

1. device  -- the card's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build   -- compile every CUDA kernel of the serving path from
              `cxl_speckv_tpu_torch/csrc/` (one nvcc per source, in
              parallel), print each kernel's registers and spills, and
              require tensor-core (HMMA) instructions in the SASS of K2's
              bf16-compute kernels and none in its float32 ones;
3. K1, K2  -- decode and chunk attention kernels vs their plain PyTorch
              versions at the Llama-3-8B attention geometry (Hq 32, Hkv 8,
              D 128, bs 32). K1 runs the split count its rule chooses
              (`ops/paged_attention.decode_splits`, printed as S=) and is
              held also to the plain version's split form at that count;
              its timed rows also time, in turns, S = 1 against the chosen
              S (S = 2 where the rule chose 1), back to back and replayed
              from a CUDA graph, and rows at S > 1 a few other counts;
4. K1, K2  -- the same at the Gemma-2-9B geometry (Hq 16, Hkv 8, D 256) with
              sliding windows (none, 4096, 100) and the tanh softcap (none,
              50), q scaled so raw scores pass the cap; the uncapped plain
              result must fail the comparison the kernel passes; then at
              the Mistral-7B geometry (Hq 32, Hkv 8, D 128) with window
              4096 at the lengths and chunk starts its serve gives them;
5. schemes -- INT4 and FP8 storage: K1 and K2 vs their plain versions at
              the Llama-3-8B geometry (f32 and bf16 compute) and at
              Gemma-2-9B's (bf16, window 4096, cap 50), FP8 pools holding
              NaN bytes (0x7F) outside the context; the plain result with
              the bytes read as another scheme (FP8 as INT8, INT4 with its
              nibbles swapped) must fail the comparison the kernel passes;
              MIXED8 with scheme id 0 / 1 must equal the INT8 / FP8 kernels
              bit for bit;
5b. gpt-oss kernels -- K1 and K2 with GPT-OSS attention sinks (N(0, 2^2)
              logits) at its geometry (Hq 64, Hkv 8, D 64): INT8 at f32 and
              bf16 compute with window none and 128, and one case each of
              INT4 / FP8 / BF16; K1 lanes of 0, 1, 127, 128, 129 and the
              served 193-256 tokens, K2 at the served chunks (T 128 at start
              0 and at start 128); the plain result without sinks must fail
              the comparison the kernel passes; then the served shapes timed
              with and without sinks in turns;
5c. anatomy probes -- the decode-anatomy probes P1-P3
              (`ops/decode_anatomy.py`: K1's walk with parts stripped, K1's
              math on the TPU's kT pool, a cp.async ring) against their
              plain versions for INT8, INT4 and BF16 at Llama-3-8B's heads,
              bs 32, lanes up to 1024 tokens, and v2 against K1 at one
              split (the arithmetic v2 mirrors); then the probe's command
              line at its default geometry (B 8, ctx 8192, 512 MB pools) at
              bs 32 and 128, each variant timed back to back, K1 also in
              single-launch windows and by split count (1, the chosen S
              and multiples of it);
6. serve   -- Llama-3-8B at full width and depth, random weights from a
              seeded generator, W8A16, INT8 KV in 32-token blocks: 32
              requests x (64 prompt + 64 new tokens), batch 8, decode horizon
              32, an HBM pool of 52 blocks against a demand of 160 blocks
              (32 requests x 5; what does not fit lives in the pinned host
              tier), then the same prompts on an ample HBM pool. Every
              request must finish, the tiered run must migrate both ways,
              and both runs must emit identical tokens;
7. anatomy -- device time of one served Llama decode round by kernel
              (torch.profiler) and the W8A16 matmuls of one layer (again
              for Gemma-2 after its short serve);
8. serve-int4, serve-mixed -- the same Llama serve with INT4 KV, and with
              a per-layer table of INT8 (even layers) and FP8 (odd layers):
              same checks, launch counts exact per (scheme, window); then
              the decode-round anatomy of each;
9. switch  -- `Engine.set_kv_dtype` on the ample pool: 8 requests under
              INT8, two steps, FP8 for 8 more; each cohort equals a fresh
              engine fixed to its scheme; INT4 refused while busy, then
              rebuilt when idle (pool rows halve), equal to a fresh INT4
              engine;
9b. spec   -- speculative decoding on the serve's Llama-3-8B, gamma 4, the
              first 16 of its prompts, tiered (52 HBM blocks) and ample, in
              three arms: n-gram lookup (verify through K2, no K1 at all),
              a Llama-3.2-1B draft at full width (W8A16, INT8 draft KV; K1
              at D 64) and a self-draft (the target proposes for itself,
              INT8 draft KV); first K1 at the draft's shape and K2 at the
              verify's (T = 5 at unaligned starts) timed against their plain
              versions. Every request must finish, tiered tokens equal ample
              tokens in every arm, the tiered run migrate both ways, the
              launches be exactly K2 = target prefill dispatches x 32 +
              draft prefill dispatches x L_draft + rounds x 32 and K1 =
              rounds x 5 x L_draft (L_draft 16, 32, 0 for ngram); then the
              self-draft again at float32 activations (the served bf16
              K1 / K2 variants), whose acceptance -- the cascade-free
              agreement of decode through K1 and verify through K2 -- must
              be at least 0.95 (at bf16 activations the model's own
              matmul rounding flips 128k-vocabulary near-ties: recorded,
              with each rejection's gap, not held). Printed: acceptance,
              tokens a round, rounds, tok/s, TPOT, the `decode.spec_*`
              phase medians, and agreement with a plain serve of the same
              prompts (the top-2 gap of the dense logits at each first
              divergence);
10. gemma2 -- Gemma-2-9B at full width and depth (42 layers alternating
              window-4096 and global attention, caps 50 / 30, tied 256000
              vocabulary), same weights and KV formats: 32 requests x
              (64 + 64) tiered (52 HBM blocks) and ample, then 2 requests x
              (4608 + 32) -- prompts past the window -- with an HBM pool
              that holds one request's blocks but not both, and ample. Same
              checks, plus exact launch counts: every layer of every decode
              step through K1, of every prefill dispatch through K2, half of
              them with window 4096; the long pair's decode at S > 1 in
              every launch (`split_launches`), and its ample serve again
              with K1 at S = 1 for TTFT / TPOT beside it;
11. mistral -- Mistral-7B at full width and depth (uniform window 4096):
              2 requests x (4160 + 64), tiered and ample. Out-of-window KV
              blocks must retire (`window_retired_blocks` > 0), tokens must
              be identical, every launch must carry window 4096, every K1
              launch S > 1; the ample serve again at S = 1, as for Gemma-2;
12. gpt-oss -- GPT-OSS-20B at full width and depth (24 layers alternating
              window 128 and global attention, 32 experts top-4 in the dense
              MoE mode, q/k/v/o biases, sinks, YaRN rope, vocabulary 201088),
              W8A16 experts included: 64 requests x (192 + 64), so the second
              prefill chunk and every decode step pass the window, on 88 HBM
              blocks against a demand of 576, and ample. Same checks; half
              of the launches with window 128, every launch of this serve
              with sinks (`sink_launches` == `launches`; no other serve
              launches with sinks), no block retired; then its decode-round
              anatomy with the expert-weight copies' share.

Each serve prints K1's launches by split count. Each model's weights are
freed before the next phase draws its own. Then a `[loss]` line per kernel
(launches x (back to back - bound) summed over its served rows), one JSON
line of per-kernel numbers (launches on the served path, error against the
plain version, times in single-launch windows and K1 / K2's back to back,
bounds; K1's split count and its S = 1 (or S = 2) time beside it), the
nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Without a CUDA card the script exits 1
before printing any result.

Every kernel launch with sinks also counts in the wrapper's `sink_launches`.

Tolerances: kernel vs plain version within rtol = atol = 2e-4 at float32
compute (the two sum in different orders) and rtol = atol = 2e-2 at bfloat16
compute, where q and p * v_scale are rounded to bfloat16 and the output is
bfloat16: a different float32 sum can round to the neighbouring bfloat16,
one step of 2^-8 relative. The anatomy probes' attention outputs (P2 and
K1 there) are float32: within rtol = atol = 2e-4 of their plain versions,
and v2 of K1; their sums and products as `decode_anatomy.agreement` says.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
BS = 32                                  # KV block size (tokens)
BATCH = 8                                # the served batch (max_batch_size)
DEV = "cuda"
LLAMA_HEADS = (32, 8, 128)               # Hq, Hkv, D of Llama-3-8B
GEMMA_HEADS = (16, 8, 256)               # Hq, Hkv, D of Gemma-2-9B
WINDOW, CAP = 4096, 50.0                 # Gemma-2's (and Mistral's) window
HORIZON, QUANTUM = 32, 4
SWITCH_COHORT = 8                        # requests a scheme, switch phase
MIXED_LAYERS = ("int8", "fp8")           # the per-layer table's period
SPEC_REQ, GAMMA = 16, 4                  # the spec phase's prompts, proposals
DRAFT_HEADS = (32, 8, 64)                # Hq, Hkv, D of Llama-3.2-1B
SELF_DRAFT_MIN_ACCEPT = 0.95


@dataclass(frozen=True)
class Cell:
    """One serving configuration: requests x (prompt + new tokens), and the
    pool geometry derived from it (the JAX package's bench.py rule)."""
    n_req: int
    prompt: int
    gen: int
    batch: int
    chunk: int
    hbm_tiered: int                      # HBM blocks of the tiered run

    @property
    def max_seq(self) -> int:
        return self.prompt + self.gen + BS

    @property
    def blocks_per_seq(self) -> int:
        return -(-self.max_seq // BS)

    @property
    def host_tiered(self) -> int:
        return self.n_req * self.blocks_per_seq + 8

    @property
    def hbm_ample(self) -> int:
        return (self.n_req + self.batch) * self.blocks_per_seq + 4


# Llama-3-8B and Gemma-2-9B: 32 x (64 + 64), max_seq_len 160 -> 5 blocks
# per sequence; chunk = min(128, max(32, prompt_len)). Four groups of 8: a
# group decodes (40 blocks + growth) while the next ones prefill, so up to
# 64 blocks are live; HBM 52 blocks against a demand of 160 (decode needs
# 8 x 6 of them resident).
SHORT = Cell(32, 64, 64, BATCH, 64, hbm_tiered=52)
# the long pairs: HBM holds one request's blocks (+ 4), not both --
# 4608 + 32 + 32 -> 146 blocks a sequence, 4160 + 64 + 32 -> 133
GEMMA_LONG = Cell(2, 4608, 32, 2, 256, hbm_tiered=146 + 4)
MISTRAL = Cell(2, 4160, 64, 2, 256, hbm_tiered=133 + 4)
MISTRAL_HEADS = (32, 8, 128)             # Hq, Hkv, D of Mistral-7B
# GPT-OSS-20B: 64 x (192 + 64), max_seq_len 288 -> 9 blocks a sequence, a
# demand of 576 blocks, ample 652. The 192-token prompt (chunks of 128 +
# 64) puts the second chunk and every decode step past the 128-token
# window, so the window binds in both kernels. A group's two prefill
# dispatches and two decode rounds interleave with the next group's, so at
# most ~96 blocks are live at once (2*8*9 + 3 = 147 would never overflow):
# HBM holds one decoding group's 72 blocks and 16 more, 88 (6.5x).
GPT_OSS = Cell(64, 192, 64, BATCH, 128, hbm_tiered=BATCH * 9 + 16)
GPT_OSS_HEADS = (64, 8, 64)              # Hq, Hkv, D of GPT-OSS-20B
GPT_OSS_WINDOW = 128


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from cxl_speckv_tpu_torch.ops import cuda_build
    from cxl_speckv_tpu_torch.utils.card import card_peaks

    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | nvcc: {nvcc} | peaks used for bounds: "
          f"{card_peaks(name)}", flush=True)
    return smi, name


def phase_build() -> None:
    from cxl_speckv_tpu_torch.ops import cuda_build

    t0 = time.monotonic()
    logs = cuda_build.build()
    dt = time.monotonic() - t0
    for name, log in sorted(logs.items()):
        # ptxas: registers, shared memory and spills of each instantiation
        for line in log.splitlines():
            if any(k in line for k in ("Function properties", "registers",
                                       "spill")):
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {'compiled ' + ', '.join(sorted(logs)) if logs else 'cached'}"
          f" in {dt:.1f} s", flush=True)
    # K2: the bf16-compute kernel runs its context products on the tensor
    # cores, the float32-compute kernel on none
    hmma = {"chunk_mma_kernel": 0, "chunk_kernel": 0}
    for fn, n in cuda_build.sass_counts("chunk_attention", "HMMA").items():
        hmma["chunk_mma_kernel" if "chunk_mma_kernel" in fn
             else "chunk_kernel"] += n
    print(f"[build] chunk_attention: HMMA instructions in the SASS of the "
          f"bf16-compute kernels {hmma['chunk_mma_kernel']}, of the "
          f"float32-compute kernels {hmma['chunk_kernel']}", flush=True)
    if not hmma["chunk_mma_kernel"] or hmma["chunk_kernel"]:
        fail(f"chunk_attention: HMMA counts {hmma}: tensor cores must run "
             f"the bf16-compute kernels and only them")


# ---------------------------------------------------------------------------
# timing, bounds and launch counts
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings of one call each."""
    from cxl_speckv_tpu_torch.utils.card import single_launch_ms

    return single_launch_ms(fn, iters, warmup)


def b2b_ms(fn, iters: int = 30) -> float:
    """ms a call, `iters` calls back to back between two CUDA events: no
    host dispatch between launches, unlike `time_ms`."""
    from cxl_speckv_tpu_torch.utils.card import back_to_back_us

    return back_to_back_us(fn, iters, DEV) / 1e3


def graph_ms(fn, iters: int = 30) -> float:
    """ms a call on the device alone: `iters` calls replayed from one CUDA
    graph (`utils.card.graph_us`), no host dispatch between launches."""
    from cxl_speckv_tpu_torch.utils.card import graph_us

    return graph_us(fn, iters) / 1e3


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernels():
    from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
        paged_chunk_attention_cuda,
    )
    from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention

    return {"K1": paged_attention, "K2": paged_chunk_attention_cuda}


def reset_launches() -> None:
    for fn in kernels().values():
        fn.launches.clear()
        fn.sink_launches.clear()
    kernels()["K1"].split_launches.clear()


def read_launches(counter: str = "launches") -> dict:
    """{kernel: {(scheme, window): launches}} since the last reset (window
    0 = none; a MIXED8 layer counts under the scheme its id selects);
    `counter="sink_launches"`: those that carried sinks."""
    return {k: dict(getattr(fn, counter)) for k, fn in kernels().items()}


def total(by_variant: dict) -> int:
    return sum(by_variant.values())


# ---------------------------------------------------------------------------
# random paged pools
# ---------------------------------------------------------------------------

def make_pools(gen, kv, lens, heads, extra_blocks=0, slots=0, max_blocks=0):
    """Pools [S, Hkv, bs, D / pack] (guard slot S - 1 last) holding
    ceil(len/bs) blocks per lane at shuffled slots; table rows past a lane's
    blocks hold the guard slot, as the engine fills them. `slots` /
    `max_blocks` (0 = just enough) give the served engine's pool and table
    geometry. INT4 / FP8 pools hold quantized random K/V, as the engine
    writes them, and in FP8 pools every row no lane holds (unused and guard
    slots, the tails of partly filled blocks) holds NaN bytes (0x7F)."""
    from cxl_speckv_tpu_torch.config import KVDtype
    from cxl_speckv_tpu_torch.ops.quant import encode_for_pool, quantize_kv

    _, hkv, d = heads
    nblk = [-(-int(n) // BS) for n in lens]
    S = max(sum(nblk) + 1, slots)
    mb = max(max(max(nblk), 1) + extra_blocks, max_blocks)
    shape = (S, hkv, BS, d)
    if kv in (KVDtype.INT4, KVDtype.FP8):
        q, sc = quantize_kv(torch.randn((2, *shape), generator=gen,
                                        device=DEV), kv)
        (k, v), (ks, vs) = encode_for_pool(q, kv), sc[..., 0]
    elif kv == KVDtype.INT8:
        k = torch.randint(-127, 128, shape, generator=gen, device=DEV,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=DEV,
                          dtype=torch.int8)
        ks = torch.rand(shape[:3], generator=gen, device=DEV) * 0.02 + 0.005
        vs = torch.rand(shape[:3], generator=gen, device=DEV) * 0.02 + 0.005
    else:
        k = torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)
        ks = torch.ones(shape[:3], device=DEV)
        vs = torch.ones(shape[:3], device=DEV)
    perm = torch.randperm(S - 1, generator=gen, device=DEV).cpu().numpy()
    table = np.full((len(lens), mb), S - 1, np.int32)
    live = torch.zeros((S, BS), dtype=torch.bool)
    at = 0
    for i, (n, nb) in enumerate(zip(lens, nblk)):
        table[i, :nb] = perm[at:at + nb]
        at += nb
        for j in range(nb):
            live[table[i, j], :min(BS, n - j * BS)] = True
    if kv == KVDtype.FP8:
        dead = ~live.to(DEV)[:, None, :, None]
        k, v = k.masked_fill(dead, 0x7F), v.masked_fill(dead, 0x7F)
    return ((k.contiguous(), v.contiguous(), ks.contiguous(), vs.contiguous()),
            torch.from_numpy(table).to(DEV))


def misread(pools, kv):
    """(pools, scheme) reading `kv`'s bytes under a wrong interpretation:
    FP8 bytes as INT8, INT4 with the two nibbles of each byte swapped. A
    kernel that decoded so must fail the comparison the right one passes."""
    from cxl_speckv_tpu_torch.config import KVDtype

    if kv == KVDtype.FP8:
        return pools, KVDtype.INT8
    swap = lambda x: ((x.view(torch.uint8) << 4)
                      | (x.view(torch.uint8) >> 4)).view(torch.int8)
    return (swap(pools[0]), swap(pools[1]), *pools[2:]), KVDtype.INT4


def attn_bytes(pools, blocks: int) -> int:
    """Bytes of `blocks` pool blocks read once each: K, V, both scale rows
    and the table entry."""
    k, _, ks, _ = pools
    per_blk = 2 * (k[0].numel() * k.element_size()
                   + ks[0].numel() * ks.element_size()) + 4
    return blocks * per_blk


def attended(start: int, T: int, window) -> tuple[int, int, int]:
    """For one lane of T queries at start .. start + T - 1: (context
    positions attended, summed over the queries; fresh columns attended,
    summed; context blocks the kernel must read). T = 1 with start =
    seq_len - 1 and the query's own token as the fresh column is decode."""
    w = window or (1 << 30)
    ctx = sum(start - min(start, max(0, start + t - w + 1)) for t in range(T))
    fresh = sum(min(t + 1, w) for t in range(T))
    lo = max(0, start - w + 1)
    blocks = -(-start // BS) - lo // BS if start else 0
    return ctx, fresh, blocks


# ---------------------------------------------------------------------------
# K1 / K2 against their plain versions
# ---------------------------------------------------------------------------

def compare(got, want, tol) -> tuple[float, bool]:
    """Max |got - want|, and whether |got - want| <= tol + tol * |want|
    everywhere (a bfloat16 output is one rounding of ~2^-8 relative)."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= tol + tol * want.float().abs()).all())


def variant(window, softcap, sinks=False) -> str:
    return (f" window={window}" if window else "") + (
        f" cap={softcap:g}" if softcap else "") + (" sinks" if sinks else "")


def draw_sinks(gen, with_sinks: bool, hq: int):
    """GPT-OSS sink logits [Hq] drawn from N(0, 2^2), so they bind; None
    without."""
    return (torch.randn(hq, generator=gen, device=DEV) * 2
            if with_sinks else None)


def k1_case(gen, kv, cd, lens, peaks, heads=LLAMA_HEADS, timed=False,
            geometry=None, window=None, softcap=None, q_scale=1.0,
            sinks=False):
    """K1 at the split count its rule chooses (`default_splits`, the row's
    "splits") against the unsplit plain version and, where S > 1, against
    the plain version's split form at the same S. Timed rows also time, in
    turns with it (chosen, other, other, chosen), the other of S = 1 and
    S = 2 when the rule chose 1, else S = 1 ("alt_splits"): back to back
    ("b2b_ms", "alt_b2b_ms") and replayed from a CUDA graph ("graph_ms",
    "alt_graph_ms": the device's time without the host's dispatch), so each
    row holds its own before and after."""
    from cxl_speckv_tpu_torch.ops.paged_attention import (
        default_splits,
        paged_attention,
    )
    from cxl_speckv_tpu_torch.ops.paged_attention_ref import paged_attention_ref
    from cxl_speckv_tpu_torch.utils.card import bound_ms

    hq, _, d = heads
    pools, table = make_pools(gen, kv, lens, heads, extra_blocks=2,
                              **(geometry or {}))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    q = (torch.randn((len(lens), hq, d), generator=gen, device=DEV)
         * q_scale).to(cd)
    sk = draw_sinks(gen, sinks, hq)
    args = (q, *pools, table, lens_t, kv)
    kw = dict(compute_dtype=cd, window=window, softcap=softcap, sinks=sk)
    S = default_splits(q, pools[0], table, window)
    got = paged_attention(*args, **kw)
    want = paged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    err, ok = compare(got, want, TOL[cd])
    name = f"K1 {kv.value} cd={str(cd)[6:]} D={d} lens={lens}" + variant(
        window, softcap, sinks) + f" S={S}"
    if S > 1:
        # the same split arithmetic in the plain version's split form
        err_s, ok_s = compare(got, paged_attention_ref(
            *args, num_splits=S, **kw), TOL[cd])
        if not ok_s:
            fail(f"{name}: error {err_s} against the plain version at "
                 f"S = {S}, above rtol = atol = {TOL[cd]}")
    if not torch.isfinite(got).all():
        fail(f"{name} produced non-finite values")
    if 0 in lens and got[lens.index(0)].any():
        fail(f"{name}: a seq_len 0 lane must give zeros")
    if softcap and not timed:
        # a kernel that ignored the cap must fail the comparison
        plain = paged_attention_ref(*args, **dict(kw, softcap=None))
        if compare(plain, want, TOL[cd])[1]:
            fail(f"{name}: the uncapped result passes the comparison")
    if sinks and not timed:
        # nor may one that ignored the sinks
        plain = paged_attention_ref(*args, **dict(kw, sinks=None))
        if compare(plain, want, TOL[cd])[1]:
            fail(f"{name}: the result without sinks passes the comparison")
    if kv.value in ("int4", "fp8") and not timed:
        # nor may a kernel that decoded the bytes as another scheme pass
        wp, wkv = misread(pools, kv)
        plain = paged_attention_ref(q, *wp, table, lens_t, wkv, **kw)
        if compare(plain, want, TOL[cd])[1]:
            fail(f"{name}: the bytes read as {wkv.value} pass the comparison")
    row = {"case": name, "err": err, "ok": ok, "tol": TOL[cd], "splits": S}
    if timed:
        alt = 2 if S == 1 else 1
        turns = {S: [], alt: []}
        for n in (S, alt, alt, S):
            call = lambda: paged_attention(*args, num_splits=n, **kw)
            turns[n].append((b2b_ms(call), graph_ms(call)))
        mean = lambda n, i: (turns[n][0][i] + turns[n][1][i]) / 2
        row["ms"] = time_ms(lambda: paged_attention(*args, **kw))
        row["b2b_ms"], row["graph_ms"] = mean(S, 0), mean(S, 1)
        row["alt_splits"] = alt
        row["alt_b2b_ms"], row["alt_graph_ms"] = mean(alt, 0), mean(alt, 1)
        if S > 1:
            # around the chosen count, back to back, for the rule's next
            # tuning (not in the kernels line)
            others = sorted({max(2, S // 2), S + S // 2, min(2 * S, 64)})
            row["sweep"] = {n: b2b_ms(lambda: paged_attention(
                *args, num_splits=n, **kw)) for n in others}
        row["plain_ms"] = time_ms(lambda: paged_attention_ref(*args, **kw),
                                  iters=5)
        work = [attended(n - 1, 1, window) for n in lens if n]
        moved = (nbytes(q, lens_t, *[x for x in (sk,) if x is not None])
                 + attn_bytes(pools, sum(
            -(-n // BS) - max(0, n - (window or n)) // BS for n in lens if n))
            + nbytes(got))
        ops = sum(4 * hq * d * (c + f) for c, f, _ in work)
        row["bound_ms"], row["bound_by"] = bound_ms(peaks, moved, {
            "bf16": ops if cd == torch.bfloat16 else 0,
            "f32": ops if cd == torch.float32 else 0})
    return row


def k2_case(gen, kv, cd, T, starts, peaks, heads=LLAMA_HEADS, timed=False,
            geometry=None, window=None, softcap=None, q_scale=1.0,
            sinks=False):
    from cxl_speckv_tpu_torch.ops.chunk_attention import paged_chunk_attention
    from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
        paged_chunk_attention_cuda,
    )
    from cxl_speckv_tpu_torch.utils.card import bound_ms

    hq, hkv, d = heads
    pools, table = make_pools(gen, kv, starts, heads, extra_blocks=1,
                              **(geometry or {}))
    B = len(starts)
    start_t = torch.tensor(starts, dtype=torch.int32, device=DEV)
    q = (torch.randn((B, T, hq, d), generator=gen, device=DEV)
         * q_scale).to(cd)
    kn = torch.randn((B, T, hkv, d), generator=gen, device=DEV) * 2
    vn = torch.randn((B, T, hkv, d), generator=gen, device=DEV) * 2
    sk = draw_sinks(gen, sinks, hq)
    args = (q, kn, vn, *pools, table, start_t, kv)
    kw = dict(compute_dtype=cd, window=window, softcap=softcap, sinks=sk)
    got = paged_chunk_attention_cuda(*args, **kw)
    want = paged_chunk_attention(*args, **kw)
    torch.cuda.synchronize()
    err, ok = compare(got, want, TOL[cd])
    name = f"K2 {kv.value} cd={str(cd)[6:]} D={d} T={T} starts={starts}" + (
        variant(window, softcap, sinks))
    if not torch.isfinite(got).all():
        fail(f"{name} produced non-finite values")
    if softcap and not timed:
        plain = paged_chunk_attention(*args, **dict(kw, softcap=None))
        if compare(plain, want, TOL[cd])[1]:
            fail(f"{name}: the uncapped result passes the comparison")
    if sinks and not timed:
        plain = paged_chunk_attention(*args, **dict(kw, sinks=None))
        if compare(plain, want, TOL[cd])[1]:
            fail(f"{name}: the result without sinks passes the comparison")
    if kv.value in ("int4", "fp8") and not timed:
        wp, wkv = misread(pools, kv)
        plain = paged_chunk_attention(q, kn, vn, *wp, table, start_t, wkv,
                                      **kw)
        if compare(plain, want, TOL[cd])[1]:
            fail(f"{name}: the bytes read as {wkv.value} pass the comparison")
    row = {"case": name, "err": err, "ok": ok, "tol": TOL[cd]}
    if timed:
        row["ms"] = time_ms(lambda: paged_chunk_attention_cuda(*args, **kw))
        row["b2b_ms"] = b2b_ms(lambda: paged_chunk_attention_cuda(*args,
                                                                  **kw))
        row["plain_ms"] = time_ms(lambda: paged_chunk_attention(*args, **kw),
                                  iters=5)
        work = [attended(s, T, window) for s in starts]
        moved = (nbytes(q, kn, vn, start_t,
                        *[x for x in (sk,) if x is not None])
                 + attn_bytes(pools, sum(b for _, _, b in work))
                 + nbytes(got))
        ctx_ops = sum(4 * hq * d * c for c, _, _ in work)
        fresh_ops = sum(4 * hq * d * f for _, f, _ in work)  # IEEE f32
        row["bound_ms"], row["bound_by"] = bound_ms(peaks, moved, {
            "bf16": ctx_ops if cd == torch.bfloat16 else 0,
            "f32": fresh_ops + (ctx_ops if cd == torch.float32 else 0)})
    return row


def report(row) -> None:
    extra = ""
    if "ms" in row:
        turns = ("" if "ms_turns" not in row else " (turns " + ", ".join(
            f"{t:.4f}" for t in row["ms_turns"]) + ")")
        alt = ("" if "alt_splits" not in row else
               f" (S={row['alt_splits']}: {row['alt_b2b_ms']:.4f} ms, "
               f"{row['alt_b2b_ms'] / row['b2b_ms']:.2f}x), from a CUDA "
               f"graph {row['graph_ms']:.4f} ms (S={row['alt_splits']}: "
               f"{row['alt_graph_ms']:.4f} ms)")
        extra = (f" | kernel {row['ms']:.4f} ms{turns}, back to back "
                 f"{row['b2b_ms']:.4f} ms{alt}, plain "
                 f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                 f"({row['bound_by']})")
    if "sweep" in row:
        extra += "; back to back at other S: " + ", ".join(
            f"S={n} {t:.4f} ms" for n, t in row["sweep"].items())
    print(f"[{row['case'][:2]}] {row['case']}: max |err| {row['err']:.3e}"
          f" (rtol = atol = {row['tol']:g}){extra}", flush=True)
    if not row["ok"]:
        fail(f"{row['case']}: error {row['err']} above rtol = atol = "
             f"{row['tol']}")


def merge_turns(a: dict, b: dict) -> dict:
    """One row from two timings of the same shape: the mean time (both kept
    as ms_turns) and the larger error."""
    out = dict(a, ms=(a["ms"] + b["ms"]) / 2,
               b2b_ms=(a["b2b_ms"] + b["b2b_ms"]) / 2,
               plain_ms=(a["plain_ms"] + b["plain_ms"]) / 2,
               ms_turns=(a["ms"], b["ms"]), err=max(a["err"], b["err"]),
               ok=a["ok"] and b["ok"])
    for k in ("graph_ms", "alt_b2b_ms", "alt_graph_ms"):
        if k in a:
            out[k] = (a[k] + b[k]) / 2
    return out


def timed_in_turns(case, *args, **kw) -> tuple[dict, dict]:
    """Time one shape's sliding (window 4096) and global variants in turns
    -- sliding, global, global, sliding, each on fresh inputs of that shape
    -- so that clock drift falls on both alike."""
    runs = [case(*args, window=w, timed=True, **kw)
            for w in (WINDOW, None, None, WINDOW)]
    return merge_turns(runs[0], runs[3]), merge_turns(runs[1], runs[2])


def served_geometry(cell: Cell) -> dict:
    """The tiered engine's pool (HBM blocks + guard) and table geometry."""
    return {"slots": cell.hbm_tiered + 1, "max_blocks": cell.blocks_per_seq}


def served_lens(cell: Cell, seed: int) -> list[int]:
    """Context lengths of one decode step of the served batch."""
    rng = np.random.RandomState(seed)
    return rng.randint(cell.prompt + 1, cell.prompt + cell.gen + 1,
                       cell.batch).tolist()


def phase_kernels(peaks) -> dict:
    """Check both kernels at the Llama-3-8B geometry; returns the
    main-path timing rows."""
    from cxl_speckv_tpu_torch.config import KVDtype

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    mixed = [0, 4096, 1, 31, 33, 517, 2048, 100]   # a 0 lane, a 4096 lane
    for kv in (KVDtype.INT8, KVDtype.BF16):
        for cd in (torch.float32, torch.bfloat16):
            report(k1_case(gen, kv, cd, mixed, peaks, timed=True))
            for T, starts in ((128, [0] * BATCH),
                              (128, [1000] * (BATCH - 1) + [0]),
                              (5, [0, 3, 31, 32, 33, 200, 1000, 4091])):
                report(k2_case(gen, kv, cd, T, starts, peaks,
                               timed=(T == 128 and starts[0] == 1000)))
    # the shapes the served path gives each kernel: a decode step of the
    # 8-lane batch at 65-128 tokens of context, and the first 64-token
    # prefill chunk of 8 lanes (bf16 compute, INT8 KV, bf16 q), in the
    # tiered engine's pool and table geometry
    main_k1 = k1_case(gen, KVDtype.INT8, torch.bfloat16, served_lens(SHORT, 5),
                      peaks, timed=True, geometry=served_geometry(SHORT))
    main_k2 = k2_case(gen, KVDtype.INT8, torch.bfloat16, SHORT.chunk,
                      [0] * BATCH, peaks, timed=True,
                      geometry=served_geometry(SHORT))
    report(main_k1)
    report(main_k2)
    return {"K1": main_k1, "K2": main_k2}


def phase_kernels_gemma(peaks) -> dict:
    """Both kernels at Gemma-2-9B's attention geometry (G = 2, D = 256) with
    its window and softcap variants; q is scaled by 16 so raw scores pass
    the cap of 50 (std ~17 with these pools). Returns the timing rows of
    the served shapes, sliding ("win") and global ("glob")."""
    from cxl_speckv_tpu_torch.config import KVDtype

    gen = torch.Generator(device=DEV)
    gen.manual_seed(4321)
    lanes = [0, 1, 31, 33, 100, 4096, 4097, 6000]
    starts = [0, 3, 100, 4000, 4090, 4100, 5000, 6000]
    g = GEMMA_HEADS
    for kv in (KVDtype.INT8, KVDtype.BF16):
        for cd in (torch.float32, torch.bfloat16):
            for window in (None, WINDOW, 100):
                for cap in (None, CAP):
                    v = dict(heads=g, window=window, softcap=cap, q_scale=16.0)
                    report(k1_case(gen, kv, cd, lanes, peaks, **v))
                    for T in (5, 64):
                        report(k2_case(gen, kv, cd, T, starts, peaks, **v))
    # the served shapes: a decode step of the 8-lane batch and the first
    # 64-token prefill chunk; then the long-context pair's, a decode step
    # at ~4.6k tokens (the window skips blocks) and a late 256-token chunk
    n = GEMMA_LONG.prompt + GEMMA_LONG.gen // 2
    s = GEMMA_LONG.prompt - GEMMA_LONG.chunk
    v = dict(heads=g, softcap=CAP, geometry=served_geometry(SHORT))
    lv = dict(v, geometry=served_geometry(GEMMA_LONG))
    rows = {}
    for key, case, args, kw in (
            ("K1", k1_case, (served_lens(SHORT, 6),), v),
            ("K2", k2_case, (SHORT.chunk, [0] * BATCH), v),
            ("K1 long", k1_case, ([n, n - 7],), lv),
            ("K2 long", k2_case, (GEMMA_LONG.chunk, [s, s]), lv)):
        rows[f"{key} win"], rows[f"{key} glob"] = timed_in_turns(
            case, gen, KVDtype.INT8, torch.bfloat16, *args, peaks, **kw)
    for row in rows.values():
        report(row)
    return rows


def phase_kernels_mistral(peaks) -> dict:
    """Both kernels at Mistral-7B's attention geometry (G = 4, D = 128, so
    K2 runs 64-row tiles) with its window of 4096, in the Mistral serve's
    pool and table geometry: decode lanes past the window and 256-token
    chunks starting on both sides of it. Returns the timing rows of the
    served shapes: a decode step of the pair, and the last prefill chunk
    (start 4096, where the window masks)."""
    from cxl_speckv_tpu_torch.config import KVDtype

    gen = torch.Generator(device=DEV)
    gen.manual_seed(2024)
    v = dict(heads=MISTRAL_HEADS, window=WINDOW,
             geometry=served_geometry(MISTRAL))
    top = MISTRAL.prompt + MISTRAL.gen
    for kv in (KVDtype.INT8, KVDtype.BF16):
        for cd in (torch.float32, torch.bfloat16):
            report(k1_case(gen, kv, cd, [MISTRAL.prompt, top - 33, top],
                           peaks, **v))
            for starts in ([3840, 4096], [0, 4096]):
                report(k2_case(gen, kv, cd, MISTRAL.chunk, starts, peaks, **v))
    last = MISTRAL.prompt // MISTRAL.chunk * MISTRAL.chunk
    rows = {"K1": k1_case(gen, KVDtype.INT8, torch.bfloat16,
                          served_lens(MISTRAL, 7), peaks, timed=True, **v),
            "K2": k2_case(gen, KVDtype.INT8, torch.bfloat16, MISTRAL.chunk,
                          [last] * MISTRAL.batch, peaks, timed=True, **v)}
    for row in rows.values():
        report(row)
    return rows


def mixed8_equal(gen, kv) -> None:
    """MIXED8 with the scheme id of `kv` (INT8 0, FP8 1) must give the bits
    of the `kv` kernel, in K1 and in K2, at the served shapes."""
    from cxl_speckv_tpu_torch.config import KVDtype
    from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
        paged_chunk_attention_cuda,
    )
    from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention

    sid = 0 if kv == KVDtype.INT8 else 1
    hq, hkv, d = LLAMA_HEADS
    T = SHORT.chunk
    lens = served_lens(SHORT, 8) + [0]
    pools, table = make_pools(gen, kv, lens, LLAMA_HEADS, extra_blocks=2,
                              **served_geometry(SHORT))
    B = len(lens)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    q = torch.randn((B, hq, d), generator=gen, device=DEV).to(torch.bfloat16)
    kw = dict(compute_dtype=torch.bfloat16)
    same = [torch.equal(
        paged_attention(q, *pools, table, lens_t, KVDtype.MIXED8,
                        scheme_id=sid, **kw),
        paged_attention(q, *pools, table, lens_t, kv, **kw))]
    qc = torch.randn((B, T, hq, d), generator=gen, device=DEV).to(torch.bfloat16)
    kn = torch.randn((B, T, hkv, d), generator=gen, device=DEV)
    args = (qc, kn, kn * 0.5, *pools, table, lens_t)
    same.append(torch.equal(
        paged_chunk_attention_cuda(*args, KVDtype.MIXED8, scheme_id=sid, **kw),
        paged_chunk_attention_cuda(*args, kv, **kw)))
    torch.cuda.synchronize()
    if not all(same):
        fail(f"MIXED8 scheme id {sid} differs from the {kv.value} kernel "
             f"(K1, K2 equal: {same})")
    print(f"[mixed8] scheme id {sid}: K1 and K2 equal the {kv.value} "
          f"kernels bit for bit", flush=True)


def phase_kernels_schemes(peaks) -> dict:
    """INT4 and FP8 storage: both kernels against their plain versions at
    the Llama-3-8B geometry (f32 and bf16 compute; K1 at the served lens
    plus a seq_len 0 lane, K2 at T = 64 with starts 0 and > 0), then at
    Gemma-2-9B's (D 256, bf16, window 4096, cap 50, q x 16); MIXED8 against
    INT8 / FP8 bit for bit. FP8 pools hold NaN bytes outside the context,
    and the plain result under the wrong interpretation must fail each
    comparison (`k1_case`). Returns the timing rows of the served shapes
    ("K1 int4", "K2 fp8", ...; INT8 too), timed in turns."""
    from cxl_speckv_tpu_torch.config import KVDtype

    gen = torch.Generator(device=DEV)
    gen.manual_seed(777)
    schemes = (KVDtype.INT4, KVDtype.FP8)
    lens = served_lens(SHORT, 9) + [0]
    starts = [0, 3, 31, 32, 33, 64, 100, 0]
    for kv in schemes:
        for cd in (torch.float32, torch.bfloat16):
            report(k1_case(gen, kv, cd, lens, peaks))
            report(k2_case(gen, kv, cd, SHORT.chunk, starts, peaks))
        v = dict(heads=GEMMA_HEADS, window=WINDOW, softcap=CAP, q_scale=16.0)
        report(k1_case(gen, kv, torch.bfloat16,
                       [0, 1, 31, 33, 100, 4096, 4097, 6000], peaks, **v))
        report(k2_case(gen, kv, torch.bfloat16, 64,
                       [0, 3, 100, 4000, 4090, 4100, 5000, 6000], peaks, **v))
    for kv in (KVDtype.INT8, KVDtype.FP8):
        mixed8_equal(gen, kv)
    # the served shapes in turns, INT8 beside them for comparison:
    # int8, int4, fp8, fp8, int4, int8, each on fresh inputs
    order = (KVDtype.INT8, *schemes)
    order += order[::-1]
    rows = {}
    for key, case, args in (
            ("K1", k1_case, (served_lens(SHORT, 5), peaks)),
            ("K2", k2_case, (SHORT.chunk, [0] * BATCH, peaks))):
        runs: dict = {}
        for kv in order:
            runs.setdefault(kv, []).append(case(
                gen, kv, torch.bfloat16, *args, timed=True,
                geometry=served_geometry(SHORT)))
        for kv, (a, b) in runs.items():
            rows[f"{key} {kv.value}"] = merge_turns(a, b)
    for row in rows.values():
        report(row)
    return rows


def phase_kernels_gpt_oss(peaks) -> dict:
    """Both kernels with GPT-OSS attention sinks (N(0, 2^2) logits) at its
    geometry (G = 8, D = 64) in its serve's pool and table geometry: INT8 at
    f32 and bf16 compute, window none and 128, K1 lanes around the window
    and at the served 193-256 tokens (a seq_len 0 lane must give zeros), K2
    at the served chunks (T 128 at start 0 and at start 128); one case each
    of INT4 / FP8 / BF16. The plain result without sinks must fail each
    comparison the kernel passes. Returns the timing rows of the served
    shapes -- K1 a decode step of the 8-lane batch, K2 the second prefill
    chunk -- sliding ("win") and global ("glob"), with sinks and, timed in
    turns with them (sinks, none, none, sinks), without ("... nosink")."""
    from cxl_speckv_tpu_torch.config import KVDtype

    gen = torch.Generator(device=DEV)
    gen.manual_seed(2025)
    v = dict(heads=GPT_OSS_HEADS, geometry=served_geometry(GPT_OSS))
    lens = [0, 1, 127, 128, 129] + served_lens(GPT_OSS, 10)
    T = GPT_OSS.chunk
    for cd in (torch.float32, torch.bfloat16):
        for window in (None, GPT_OSS_WINDOW):
            report(k1_case(gen, KVDtype.INT8, cd, lens, peaks, window=window,
                           sinks=True, **v))
            for start in (0, T):
                report(k2_case(gen, KVDtype.INT8, cd, T, [start] * BATCH,
                               peaks, window=window, sinks=True, **v))
    for kv in (KVDtype.INT4, KVDtype.FP8, KVDtype.BF16):
        report(k1_case(gen, kv, torch.bfloat16, lens, peaks,
                       window=GPT_OSS_WINDOW, sinks=True, **v))
        report(k2_case(gen, kv, torch.bfloat16, T, [T] * BATCH, peaks,
                       window=GPT_OSS_WINDOW, sinks=True, **v))
    rows = {}
    for key, case, args in (("K1", k1_case, (served_lens(GPT_OSS, 11),)),
                            ("K2", k2_case, (T, [T] * BATCH))):
        for tag, window in (("win", GPT_OSS_WINDOW), ("glob", None)):
            runs = [case(gen, KVDtype.INT8, torch.bfloat16, *args, peaks,
                         timed=True, window=window, sinks=sk, **v)
                    for sk in (True, False, False, True)]
            rows[f"{key} {tag}"] = merge_turns(runs[0], runs[3])
            rows[f"{key} {tag} nosink"] = merge_turns(runs[1], runs[2])
    for row in rows.values():
        report(row)
    for key in ("K1 win", "K1 glob", "K2 win", "K2 glob"):
        a, b = rows[key], rows[f"{key} nosink"]
        print(f"[gpt-oss] {key}: {a['ms']:.4f} ms with sinks, {b['ms']:.4f} "
              f"ms without ({a['ms'] / b['ms'] - 1:+.1%}); back to back "
              f"{a['b2b_ms']:.4f} / {b['b2b_ms']:.4f} ms "
              f"({a['b2b_ms'] / b['b2b_ms'] - 1:+.1%})", flush=True)
    return rows


# ---------------------------------------------------------------------------
# the decode-anatomy probes P1-P3 and K1 timed against them
# ---------------------------------------------------------------------------

PROBE_LENS = [1024, 1023, 999, 512, 33, 32, 1, 0]     # the check's lanes
# what the wrappers refuse at Llama-3-8B's heads (D 128), by scheme and bs:
# w8a8 on BF16 pools, and a ring over the 227 KB of shared memory a block
# may have (a stage is K + V + scales of one block: 8.25 KB at INT8 bs 32,
# 16.25 KB at BF16 bs 32, 33 KB at INT8 bs 128)
PROBE_REFUSED = {("int8", BS): set(), ("int4", BS): set(),
                 ("bf16", BS): {"w8a8", "v5ring16"},
                 ("int8", 128): {"v5ring8", "v5ring16"}}
PROBE_SOURCES = {    # probe -> (source, the TPU kernel it replaces)
    "P1": ("cxl_speckv_tpu_torch/csrc/anatomy_variants.cu",
           "scripts/kernel_anatomy.py:204"),
    "P2": ("cxl_speckv_tpu_torch/csrc/anatomy_kt.cu",
           "scripts/kernel_anatomy.py:360"),
    "P3": ("cxl_speckv_tpu_torch/csrc/anatomy_ring.cu",
           "scripts/kernel_anatomy.py:462")}


def probe_of(label: str) -> str:
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    return ("P1" if label in da.P1_MODES else
            "P2" if label in da.P2_VARIANTS else "P3")


def check_probes(scheme: str, seed: int) -> None:
    """Every probe against its plain version at Llama-3-8B's heads, bs 32,
    lanes of PROBE_LENS tokens at shuffled slots; v2 against K1 on the same
    data; what PROBE_REFUSED names must raise ValueError, and nothing
    else."""
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da
    from cxl_speckv_tpu_torch.scripts.kernel_anatomy import LABELS

    p = da.build_pools(scheme, BS, max(PROBE_LENS), heads=LLAMA_HEADS,
                       seed=seed, lens=PROBE_LENS, shuffle=True, device=DEV)
    kern, plain = da.probe_calls(p), da.plain_calls(p)
    refuse = PROBE_REFUSED[(scheme, BS)]
    errs = []
    for label in LABELS[1:]:
        try:
            got = kern[label]()
        except ValueError as e:
            if label not in refuse:
                fail(f"probe {scheme} {label}: refused: {e}")
            errs.append(f"{label} refused")
            continue
        if label in refuse:
            fail(f"probe {scheme} {label}: the wrapper did not refuse it")
        torch.cuda.synchronize()
        err, ok, tol = da.agreement(label, got, plain[label](), p)
        if not ok:
            fail(f"probe {scheme} {label}: error {err} beyond {tol}")
        errs.append(f"{label} {err:.2e}")
    # both round q and p * vs to bf16 against the walk's running max and sum
    # in float32: rtol = atol = 2e-4 against K1 unsplit, the arithmetic v2
    # mirrors ("full" runs K1's chosen split count, held to the plain
    # version's split form at that count above)
    err, ok = compare(kern["v2"](), da.k1_call(p, num_splits=1)(),
                      TOL[torch.float32])
    torch.cuda.synchronize()
    if not ok:
        fail(f"probe {scheme}: v2 differs from K1 (num_splits=1) by {err}")
    print(f"[probe] {scheme} lens={PROBE_LENS}: every probe within its "
          f"tolerance of its plain version (max |err|: {', '.join(errs)}); "
          f"K1 at S={da.k1_splits(p)}; v2 vs K1 at S=1 {err:.2e} "
          f"(rtol = atol = {TOL[torch.float32]:g})", flush=True)


def phase_probe(peaks) -> list:
    """The decode-anatomy probe. First every P1 mode, P2 variant and P3
    ring against its plain version for INT8, INT4 and BF16 (`check_probes`,
    ctx 1024). Then the probe's own path, its command line
    (`cxl_speckv_tpu_torch.scripts.kernel_anatomy`) at the default geometry
    -- B 8, Hq 32, Hkv 8, D 128, ctx 8192, INT8, 512 MB pools, seeded
    random values -- at the served bs 32 and the script's bs 128, its
    launch counts read from 0; every variant that fits must have launched.
    Returns the kernel-line entries (bs 32): each probe's time back to back,
    its error, plain and library times and bound at that geometry."""
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da
    from cxl_speckv_tpu_torch.scripts import kernel_anatomy as ka
    from cxl_speckv_tpu_torch.utils.card import bound_ms

    for i, scheme in enumerate(da.SCHEMES):
        check_probes(scheme, 50 + i)
    da.reset_probe_launches()
    runs = {}
    for bs in (BS, 128):
        runs[bs] = ka.run(ka.parse_args(["--scheme", "int8", "--bs", str(bs),
                                         "--seed", "7"]))
        rows, p = runs[bs]
        failed = {label for label, row in rows.items() if "fail" in row}
        if failed != PROBE_REFUSED[("int8", bs)]:
            fail(f"probe bs {bs}: refused {sorted(failed)}, expected "
                 f"{sorted(PROBE_REFUSED[('int8', bs)])}")
        if bs != BS:
            del p, runs[bs]
    launches = da.probe_launches()
    rows, p = runs[BS]
    missing = [lb for lb in ka.LABELS[1:] if not launches.get(lb)]
    if missing:
        fail(f"probe: no launch of {missing} on the probe's path ({launches})")
    full = rows["full"]["us"]
    # K1 at ctx 8192 by split count, back to back in turns (S = 1 and the
    # chosen S first and last, a few others between)
    chosen = da.k1_splits(p)
    sweep = [1, chosen, min(2 * chosen, 64), min(4 * chosen, 64), chosen, 1]
    by_s: dict = {}
    for n in sweep:
        by_s.setdefault(n, []).append(b2b_ms(da.k1_call(p, num_splits=n)))
    print(f"[probe] K1 at ctx {int(p.lens.max())}, bs {BS}, back to back by "
          f"split count (chosen S={chosen}): " + ", ".join(
              f"S={n} {sum(t) / len(t):.4f} ms" for n, t in by_s.items())
          + f"; S=1 / S={chosen}: "
          f"{sum(by_s[1]) / sum(by_s[chosen]):.2f}x", flush=True)
    print(f"[probe] K1 at ctx {int(p.lens.max())}, bs {BS}: {full:.1f} us back to back, "
          f"{rows['full'].get('single_us', float('nan')):.1f} us in a "
          f"single-launch window; "
          "share of K1: " + ", ".join(
              f"{lb} {rows[lb]['us'] / full:.1%}" for lb in ka.LABELS[1:]
              if "us" in rows[lb]) + f"; launches {launches}", flush=True)
    # K1 at the served decode shape, back to back against single-launch
    # event windows: how much of a ~0.1 ms window is the kernel
    sp = da.build_pools("int8", BS, SHORT.prompt + SHORT.gen,
                        heads=LLAMA_HEADS, seed=8, lens=served_lens(SHORT, 5),
                        device=DEV)
    k1 = da.probe_calls(sp)["full"]
    b2b, one = b2b_ms(k1, 200) * 1e3, time_ms(k1) * 1e3
    print(f"[probe] K1 at the served decode shape (8 lanes, lens "
          f"{sp.lens.tolist()}): {b2b:.2f} us back to back (200 launches), "
          f"{one:.2f} us in single-launch windows (median of 20)", flush=True)
    del sp

    kern, plain = da.probe_calls(p), da.plain_calls(p)
    entries = []
    for label in ka.LABELS[1:]:
        got = kern[label]()
        want = plain[label]()
        torch.cuda.synchronize()
        err, ok, tol = da.agreement(label, got, want, p)
        if not ok:
            fail(f"probe {label} at ctx 8192: error {err} beyond {tol}")
        lib = da.contiguous_sums(label, p)
        nb, ops = da.probe_work(label, p)
        b_ms, by = bound_ms(peaks, nb, ops)
        src, replaces = PROBE_SOURCES[probe_of(label)]
        entry = {"name": f"anatomy {label}", "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[label],
                 "max_abs_err": err, "ms": rows[label]["us"] / 1e3,
                 "plain_ms": time_ms(plain[label], iters=2, warmup=1),
                 "bound_ms": b_ms, "bound_by": by,
                 # the PyTorch reductions of the same sums over the
                 # contiguous table (decode_anatomy.contiguous_sums), where
                 # there are such; none for dequant, the products and P2
                 "library_ms": time_ms(lib, iters=5) if lib else None}
        print(f"[probe] {label}: {entry['ms']:.4f} ms back to back, plain "
              f"{entry['plain_ms']:.3f} ms, bound {b_ms:.5f} ms ({by}), "
              f"library {entry['library_ms']}, max |err| {err:.3e} ({tol})",
              flush=True)
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# serving through the engine
# ---------------------------------------------------------------------------

def build_engine(cfg, params, cell: Cell, hbm_blocks, host_blocks,
                 kv="int8", layer_kv=None, **spec):
    """The serving engine of `cell`; KV scheme `kv`, or the per-layer
    table `layer_kv` (INT8 / FP8 entries); `spec`: the speculative-decoding
    arguments of `Engine`."""
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        KVDtype,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine

    sc = SystemConfig(
        cache=CacheConfig(block_size=BS, num_hbm_blocks=hbm_blocks,
                          num_host_blocks=host_blocks, kv_dtype=KVDtype(kv),
                          layer_kv_dtypes=(tuple(map(KVDtype, layer_kv))
                                           if layer_kv else None),
                          prefetch_reserve_frac=0.25),
        prefetch=PrefetchConfig(depth=4, min_depth=3, enabled=False,
                                train_online=False),
        engine=EngineConfig(max_batch_size=cell.batch,
                            max_seq_len=cell.max_seq,
                            prefill_chunk=cell.chunk, decode_horizon=HORIZON,
                            sched_quantum=QUANTUM, weight_dtype="int8"))
    return Engine(cfg, sc, params=params, device=DEV, **spec)


def serve(eng, prompts, gen):
    for p in prompts:
        eng.add_request(p, max_new_tokens=gen)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    outs = eng.run()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    return {o.req_id: o for o in outs}, dt


def init_model(cfg, label: str, seed: int):
    from cxl_speckv_tpu_torch.models.llama import init_params_quantized

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    params = init_params_quantized(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    print(f"[{label}] W8A16 random init on the card in "
          f"{time.monotonic() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    return params


def tiered_vs_ample(label: str, cfg, params, cell: Cell, prompts,
                    min_splits: int = 1, **kv):
    """Serve `prompts` tiered (launches counted) and ample, with the KV
    scheme arguments `kv` of `build_engine`; require every request
    finished, identical tokens, migrations both ways and the exact launch
    counts (every layer of every decode step through K1, of every prefill
    dispatch through K2; all of them with sinks for a model with sinks,
    none of them otherwise), and every K1 launch at a split count of at
    least `min_splits`. With `min_splits` > 1 the ample serve runs again
    with every K1 launch at S = 1 (the unsplit grid), and its TTFT / TPOT
    print beside the split serve's. Returns (launches, tiered stats)."""
    reset_launches()
    tiered = build_engine(cfg, params, cell, cell.hbm_tiered,
                          cell.host_tiered, **kv)
    outs_t, dt_t = serve(tiered, prompts, cell.gen)
    launches = read_launches()
    splits = dict(sorted(kernels()["K1"].split_launches.items()))
    if not splits and min_splits > 1 or min(splits, default=1) < min_splits:
        fail(f"{label}: K1 launches by split count {splits}: every decode "
             f"step must run at S >= {min_splits}")
    with_sinks = read_launches("sink_launches")
    if with_sinks != (launches if cfg.attn_sinks else
                      {k: {} for k in launches}):
        fail(f"{label}: launches with sinks {with_sinks}, all launches "
             f"{launches}, for a model {'with' if cfg.attn_sinks else 'without'}"
             f" sinks")
    st = tiered.get_statistics()
    del tiered
    ample = build_engine(cfg, params, cell, cell.hbm_ample, 0, **kv)
    outs_a, dt_a = serve(ample, prompts, cell.gen)
    sa = ample.get_statistics()
    del ample
    if min_splits > 1:
        one = ample_at_one_split(cfg, params, cell, prompts, **kv)
        e, e1 = sa["engine"], one["engine"]
        print(f"[{label}] ample at the rule's S against S = 1: TTFT p50 "
              f"{e['p50_ttft_ms']:.1f} / {e1['p50_ttft_ms']:.1f} ms, TPOT "
              f"p50 {e['p50_tpot_ms']:.2f} / {e1['p50_tpot_ms']:.2f} ms",
              flush=True)

    for tag, outs in (("tiered", outs_t), ("ample", outs_a)):
        if len(outs) != cell.n_req or any(
                o.finish_reason not in ("length", "eos")
                for o in outs.values()):
            fail(f"{label} {tag}: not every request finished "
                 f"({len(outs)}/{cell.n_req}: "
                 f"{sorted({o.finish_reason for o in outs.values()})})")
    diff = [i for i in outs_t if outs_t[i].tokens != outs_a[i].tokens]
    if diff:
        fail(f"{label}: tiered tokens differ from ample tokens for requests "
             f"{diff}")
    tr = st["transfer"]
    if not (tr["up_transfers"] > 0 and tr["down_transfers"] > 0):
        fail(f"{label}: tiered run migrated nothing both ways: {tr}")
    L = cfg.num_layers
    want = {"K1": st["scheduler"]["decode_batches"] * HORIZON * L,
            "K2": st["engine"]["prefill_dispatches"] * L}
    got = {k: total(by_window) for k, by_window in launches.items()}
    if got != want:
        fail(f"{label}: kernel launches {got} != expected {want}")

    demand = cell.n_req * cell.blocks_per_seq
    rate = {}
    for tag, outs, dt, s in (("tiered", outs_t, dt_t, st),
                             ("ample", outs_a, dt_a, sa)):
        toks = sum(len(o.tokens) for o in outs.values())
        e = s["engine"]
        phases = {k: round(v["total_s"], 3) for k, v in sorted(
            s["phases"].items()) if v.get("total_s", 0) > 0.0005}
        rate[tag] = toks / dt
        print(f"[{label}] {tag}: hbm "
              f"{s['compression']['hbm_token_capacity'] // BS} blocks for a "
              f"demand of {demand}: {toks} tokens in {dt:.2f} s = "
              f"{toks / dt:.1f} tok/s | up {s['transfer']['up_transfers']} "
              f"down {s['transfer']['down_transfers']} | hit rate "
              f"{s['directory']['hit_rate']:.3f} | retired "
              f"{s['runtime']['window_retired_blocks']} | TTFT p50 "
              f"{e['p50_ttft_ms']:.1f} ms, TPOT p50 {e['p50_tpot_ms']:.2f} ms "
              f"| phases (s) {phases}", flush=True)
    print(f"[{label}] tiered == ample tokens for all {cell.n_req} requests; "
          f"per-HBM ratio "
          f"{rate['tiered'] / rate['ample'] * demand / cell.hbm_tiered:.3f}x "
          f"at {demand / cell.hbm_tiered:.2f}x oversubscription; launches "
          f"on the tiered run {launches}; K1 launches by split count S "
          f"{splits}", flush=True)
    return launches, st


def ample_at_one_split(cfg, params, cell: Cell, prompts, **kv) -> dict:
    """The ample serve with every K1 launch at S = 1 -- the unsplit grid,
    the parent kernel's arithmetic -- by the rule's entry point
    `default_splits` answering 1 for its duration. Returns its statistics;
    its tokens may differ from the split serve's in near ties (bf16
    roundings against each split's max)."""
    mod = sys.modules["cxl_speckv_tpu_torch.ops.paged_attention"]
    rule = mod.default_splits
    mod.default_splits = lambda *args: 1
    try:
        eng = build_engine(cfg, params, cell, cell.hbm_ample, 0, **kv)
        serve(eng, prompts, cell.gen)
        return eng.get_statistics()
    finally:
        mod.default_splits = rule


def phase_serve() -> tuple:
    from cxl_speckv_tpu_torch.models.configs import llama_3_8b

    cfg = llama_3_8b()
    params = init_model(cfg, "serve", 0)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, SHORT.prompt).tolist()
               for _ in range(SHORT.n_req)]
    # warm-up: cuBLAS handles and heuristics, first launches
    serve(build_engine(cfg, params, SHORT, SHORT.hbm_ample, 0), prompts[:2],
          HORIZON)
    launches, _ = tiered_vs_ample("serve", cfg, params, SHORT, prompts)
    check_windows("serve", launches, lambda n: {("int8", 0): n})
    return launches, cfg, params, prompts


def check_windows(label, launches, want_split) -> None:
    """Each kernel's launches split by (scheme, window) as the config says:
    `want_split(total)` gives the split."""
    for k, by_variant in launches.items():
        want = want_split(total(by_variant))
        if by_variant != want:
            fail(f"{label}: {k} launches by (scheme, window) {by_variant} "
                 f"!= {want}")


def phase_serve_schemes(cfg, params, prompts) -> tuple[dict, dict]:
    """Llama-3-8B on the SHORT cell again, tiered and ample: INT4 KV, then
    a per-layer table of INT8 (even layers) and FP8 (odd layers). Returns
    the two runs' launches."""
    int4, _ = tiered_vs_ample("serve-int4", cfg, params, SHORT, prompts,
                              kv="int4")
    check_windows("serve-int4", int4, lambda n: {("int4", 0): n})
    mixed, _ = tiered_vs_ample("serve-mixed", cfg, params, SHORT, prompts,
                               layer_kv=MIXED_LAYERS * (cfg.num_layers // 2))
    check_windows("serve-mixed", mixed,
                  lambda n: {("int8", 0): n // 2, ("fp8", 0): n // 2})
    return int4, mixed


def tokens_in_order(outs: dict) -> list:
    return [outs[i].tokens for i in sorted(outs)]


def phase_switch(cfg, params, prompts) -> None:
    """The runtime scheme knob on the ample pool: SWITCH_COHORT requests
    under INT8, two steps, `set_kv_dtype("fp8")`, as many more; each cohort
    must equal a fresh engine fixed to its scheme (same pool geometry and
    batch) serving only it, and a cross-width switch on the busy engine must
    raise. Then, idle, INT4 (new pools, last dim halved): 8 requests equal a
    fresh INT4 engine's."""
    n = SWITCH_COHORT
    p8, pf, p4 = prompts[:n], prompts[n:2 * n], prompts[2 * n:3 * n]
    ample = lambda kv: build_engine(cfg, params, SHORT, SHORT.hbm_ample, 0,
                                    kv=kv)
    reset_launches()
    t0 = time.monotonic()
    eng = ample("int8")
    ids8 = [eng.add_request(p, max_new_tokens=SHORT.gen) for p in p8]
    outs = {o.req_id: o for o in eng.step() + eng.step()}
    eng.set_kv_dtype("fp8")
    idsf = [eng.add_request(p, max_new_tokens=SHORT.gen) for p in pf]
    try:
        eng.set_kv_dtype("int4")
        fail("switch: a cross-width switch on a busy engine did not raise")
    except ValueError as e:
        print(f"[switch] busy engine refused INT4: {e}", flush=True)
    outs.update((o.req_id, o) for o in eng.run())
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = read_launches()
    st = eng.get_statistics()
    if st["kv_scheme_current"] != "fp8":
        fail(f"switch: kv_scheme_current {st['kv_scheme_current']}")
    for k, by_variant in launches.items():
        if {scheme for scheme, _ in by_variant} != {"int8", "fp8"}:
            fail(f"switch: {k} launches {by_variant} lack a scheme")
    for label, ids, ps, kv in (("int8", ids8, p8, "int8"),
                               ("fp8", idsf, pf, "fp8")):
        fixed, _ = serve(ample(kv), ps, SHORT.gen)
        if [outs[i].tokens for i in ids] != tokens_in_order(fixed):
            fail(f"switch: the {label} cohort differs from a fresh {kv} "
                 f"engine")
    dp = eng.kvc.k_pools.shape[-1]
    eng.set_kv_dtype("int4")
    if eng.kvc.k_pools.shape[-1] * 2 != dp:
        fail(f"switch: INT4 pool rows {eng.kvc.k_pools.shape[-1]}, not "
             f"{dp} / 2")
    got, _ = serve(eng, p4, SHORT.gen)
    want, _ = serve(ample("int4"), p4, SHORT.gen)
    if tokens_in_order(got) != tokens_in_order(want):
        fail("switch: after the idle INT4 rebuild the tokens differ from a "
             "fresh INT4 engine's")
    toks = sum(len(o.tokens) for o in outs.values())
    print(f"[switch] {n} INT8 + {n} FP8 requests in one pool: {toks} tokens "
          f"in {dt:.2f} s = {toks / dt:.1f} tok/s, launches {launches}; each "
          f"cohort == its fixed-scheme engine; idle INT4 rebuild (pool rows "
          f"{dp} -> {dp // 2}) == a fresh INT4 engine for {len(p4)} "
          f"requests", flush=True)


def phase_kernels_spec(peaks) -> dict:
    """K1 at the draft's shape (Llama-3.2-1B's heads, 8 lanes of 65-136
    tokens in the draft cache's geometry) and K2 at the verify's (T =
    gamma + 1 at the served rounds' unaligned starts, 64-127, in the tiered
    target pool's geometry), bf16 compute, INT8, timed against their plain
    versions. Returns the two rows."""
    from cxl_speckv_tpu_torch.config import KVDtype

    gen = torch.Generator(device=DEV)
    gen.manual_seed(99)
    rng = np.random.RandomState(12)
    draft_slots = SHORT.hbm_tiered + SHORT.host_tiered + 1  # every block
    rows = {"K1": k1_case(gen, KVDtype.INT8, torch.bfloat16,
                          rng.randint(65, 137, BATCH).tolist(), peaks,
                          heads=DRAFT_HEADS, timed=True,
                          geometry={"slots": draft_slots,
                                    "max_blocks": SHORT.blocks_per_seq}),
            "K2": k2_case(gen, KVDtype.INT8, torch.bfloat16, GAMMA + 1,
                          rng.randint(SHORT.prompt, SHORT.prompt + SHORT.gen,
                                      BATCH).tolist(), peaks, timed=True,
                          geometry=served_geometry(SHORT))}
    for row in rows.values():
        report(row)
    return rows


def top2_gap(cfg, params, context: list[int]) -> float:
    """The dense forward's (`forward_dense`) top-2 logit gap after
    `context`."""
    from cxl_speckv_tpu_torch.models.llama import forward_dense

    logits = forward_dense(params, cfg, torch.tensor([context], device=DEV))
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


class VerdictRecord:
    """Records every spec round's verdict on the device's logits, by
    wrapping `engine.spec._AcceptanceMixin._accept_on_device` while the
    context is open: the verdicts (positions compared), each rejected
    draft's gap to the verify logits' top-1 and its rank there, and for a
    draft model the largest |draft - verify| logit over the vocabulary at
    each compared position (both score the same tokens). One small device
    reduction and host copy a round."""

    def __enter__(self):
        from cxl_speckv_tpu_torch.engine import spec

        self.cls, self.orig = spec._AcceptanceMixin, \
            spec._AcceptanceMixin._accept_on_device
        self.verdicts, self.gaps, self.ranks, self.diffs = 0, [], [], []
        rec = self

        def recording(mixin, logits, drafts_d, drafts, active, *args):
            emitted, n_acc = rec.orig(mixin, logits, drafts_d, drafts,
                                      active, *args)
            g = mixin.gamma
            lanes = np.nonzero(active)[0]
            if mixin._draft_logits is not None:
                d = (mixin._draft_logits - logits[:, :g]).abs().amax(-1)
                rec.diffs += d[torch.from_numpy(lanes).to(d.device)
                               ].flatten().tolist()
            for b in lanes:
                j = int(n_acc[b])
                rec.verdicts += j + (j < g)
                if j < g:
                    row = logits[b, j]
                    at = row[int(drafts[b, j])]
                    rec.gaps.append(float(row.max() - at))
                    rec.ranks.append(int((row > at).sum()))
            return emitted, n_acc

        self.cls._accept_on_device = recording
        return self

    def __exit__(self, *exc):
        self.cls._accept_on_device = self.orig

    def summary(self) -> str:
        q = lambda xs: ([round(float(x), 5) for x in np.quantile(
            xs, [0, 0.5, 0.9, 1])] if xs else [])
        return (f"per-position agreement "
                f"{1 - len(self.gaps) / max(self.verdicts, 1):.4f} "
                f"({len(self.gaps)} rejections of {self.verdicts} verdicts); "
                f"rejected draft's gap to the verify top-1, quantiles "
                f"0/50/90/100% {q(self.gaps)}, its rank there "
                f"{np.bincount(self.ranks).tolist() if self.ranks else []}; "
                f"max |draft - verify logit| a position, quantiles "
                f"0/50/90/100% {q(self.diffs)}")


def spec_arm(label, cfg, params, prompts, plain: dict, record=False,
             **spec) -> dict:
    """One arm of the spec phase: tiered (launches counted from 0) and
    ample serves of `prompts` with the speculative arguments `spec`;
    requires every request finished, tiered == ample tokens, migrations
    both ways and the exact launch counts; prints the arm's numbers and
    its agreement with the plain serve `plain`; with `record`, the ample
    serve's verdicts (`VerdictRecord`). Returns the tiered run's launches
    and statistics."""
    L = cfg.num_layers
    dcfg = spec.get("draft_config")
    L_draft = dcfg.num_layers if dcfg is not None else 0
    kw = dict(spec, spec_gamma=GAMMA)
    # warm-up: the arm's first launches at its shapes
    serve(build_engine(cfg, params, SHORT, SHORT.hbm_ample, 0, **kw),
          prompts[:2], 8)
    reset_launches()
    tiered = build_engine(cfg, params, SHORT, SHORT.hbm_tiered,
                          SHORT.host_tiered, **kw)
    outs_t, dt_t = serve(tiered, prompts, SHORT.gen)
    launches = read_launches()
    st = tiered.get_statistics()
    draft_prefills = tiered.spec.prefill_dispatches
    del tiered
    ample = build_engine(cfg, params, SHORT, SHORT.hbm_ample, 0, **kw)
    rec = VerdictRecord() if record else contextlib.nullcontext()
    with rec:
        outs_a, dt_a = serve(ample, prompts, SHORT.gen)
    sa = ample.get_statistics()
    del ample

    n = len(prompts)
    for tag, outs in (("tiered", outs_t), ("ample", outs_a)):
        if len(outs) != n or any(o.finish_reason not in ("length", "eos")
                                 for o in outs.values()):
            fail(f"{label} {tag}: not every request finished ({len(outs)}/"
                 f"{n}: {sorted({o.finish_reason for o in outs.values()})})")
    diff = [i for i in outs_t if outs_t[i].tokens != outs_a[i].tokens]
    if diff:
        fail(f"{label}: tiered tokens differ from ample tokens for requests "
             f"{diff}")
    tr = st["transfer"]
    if not (tr["up_transfers"] > 0 and tr["down_transfers"] > 0):
        fail(f"{label}: tiered run migrated nothing both ways: {tr}")
    rounds = st["scheduler"]["decode_batches"]
    if rounds != st["spec"]["rounds"]:
        fail(f"{label}: {rounds} decode batches, {st['spec']['rounds']} "
             f"spec rounds")
    want = {"K1": rounds * (GAMMA + 1) * L_draft,
            "K2": (st["engine"]["prefill_dispatches"] * L
                   + draft_prefills * L_draft + rounds * L)}
    got = {k: total(by_variant) for k, by_variant in launches.items()}
    if got != want:
        fail(f"{label}: kernel launches {got} != expected {want} ({rounds} "
             f"rounds, {st['engine']['prefill_dispatches']} target and "
             f"{draft_prefills} draft prefill dispatches, L_draft {L_draft})")
    check_windows(label, launches,
                  lambda k: {("int8", 0): k} if k else {})

    for tag, outs, dt, s in (("tiered", outs_t, dt_t, st),
                             ("ample", outs_a, dt_a, sa)):
        toks = sum(len(o.tokens) for o in outs.values())
        sp, ph = s["spec"], s["phases"]
        med = ", ".join(f"{k[len('decode.spec_'):]} "
                        f"{ph.get(k, {}).get('p50_ms', 0.0):.2f}"
                        for k in ("decode.spec_resident",
                                  "decode.spec_propose", "decode.spec_verify"))
        print(f"[{label}] {tag}: {toks} tokens in {dt:.2f} s = "
              f"{toks / dt:.1f} tok/s | acceptance {sp['acceptance_rate']:.4f}"
              f", {sp['tokens_per_round']:.3f} tokens a round, "
              f"{sp['rounds']} rounds | TPOT p50 "
              f"{s['engine']['p50_tpot_ms']:.2f} ms, TTFT p50 "
              f"{s['engine']['p50_ttft_ms']:.1f} ms | phase p50 (ms) {med} "
              f"| up {s['transfer']['up_transfers']} down "
              f"{s['transfer']['down_transfers']}", flush=True)
    # agreement with plain greedy decoding: a record, not a check (random
    # bf16 weights: one near-tie flip re-contexts every later token)
    same = tot = 0
    gaps = []
    for i, o in sorted(outs_a.items()):
        ref = plain[i].tokens
        same += sum(int(a == b) for a, b in zip(o.tokens, ref))
        tot += min(len(o.tokens), len(ref))
        if o.tokens != ref:
            j = next((k for k, (a, b) in enumerate(zip(o.tokens, ref))
                      if a != b), min(len(o.tokens), len(ref)))
            gaps.append((i, j, top2_gap(cfg, params,
                                        prompts[i] + ref[:j])))
    print(f"[{label}] agreement with the plain serve: tokens {same}/{tot} = "
          f"{same / max(tot, 1):.4f}, requests {n - len(gaps)}/{n} identical"
          + ("; first divergences (request, token, dense top-2 gap): "
             + ", ".join(f"({i}, {j}, {g:.4f})" for i, j, g in gaps)
             if gaps else ""), flush=True)
    if record:
        print(f"[{label}] ample serve's verdicts: {rec.summary()}",
              flush=True)
    print(f"[{label}] tiered == ample tokens for all {n} requests; launches "
          f"on the tiered run {launches} = expected {want}", flush=True)
    return {"launches": launches, "stats": st, "rounds": rounds}


def self_draft_f32(cfg, params, prompts) -> float:
    """The self-draft at float32 activations (the same W8A16 weights; bf16
    attention compute, so the served K1 and K2 variants run): with bf16
    activations every matmul rounds, and at Llama-3's 128256-token
    vocabulary under random weights that rounding alone flips top-2 ties
    often enough to hide what K1 and K2 do; at float32 only the two
    kernels' own sums differ. Ample pool; returns the acceptance."""
    import dataclasses

    c32 = dataclasses.replace(cfg, dtype="float32")
    eng = build_engine(c32, params, SHORT, SHORT.hbm_ample, 0,
                       draft_config=c32, draft_params=params,
                       spec_draft_kv="int8", spec_gamma=GAMMA)
    with VerdictRecord() as rec:
        outs, dt = serve(eng, prompts, SHORT.gen)
    st = eng.get_statistics()
    sp = st["spec"]
    toks = sum(len(o.tokens) for o in outs.values())
    if len(outs) != len(prompts):
        fail(f"spec-self-f32: {len(outs)}/{len(prompts)} requests finished")
    print(f"[spec-self-f32] ample: {toks} tokens in {dt:.2f} s | acceptance "
          f"{sp['acceptance_rate']:.4f}, {sp['tokens_per_round']:.3f} tokens "
          f"a round, {sp['rounds']} rounds | {rec.summary()}", flush=True)
    return sp["acceptance_rate"]


def phase_spec(cfg, params, prompts, peaks) -> dict:
    """Speculative decoding on Llama-3-8B: the kernels at the new shapes,
    a plain ample serve of the first SPEC_REQ prompts, then the n-gram,
    draft (Llama-3.2-1B) and self-draft arms (`spec_arm`). Returns the
    kernel rows and each arm's result."""
    from cxl_speckv_tpu_torch.models.configs import llama_3_2_1b

    rows = phase_kernels_spec(peaks)
    ps = prompts[:SPEC_REQ]
    plain, _ = serve(build_engine(cfg, params, SHORT, SHORT.hbm_ample, 0),
                     ps, SHORT.gen)
    dcfg = llama_3_2_1b()
    dparams = init_model(dcfg, "spec", 4)
    arms = {"ngram": dict(spec_ngram=True),
            "draft": dict(draft_config=dcfg, draft_params=dparams,
                          spec_draft_kv="int8"),
            "self": dict(draft_config=cfg, draft_params=params,
                         spec_draft_kv="int8")}
    res = {arm: spec_arm(f"spec-{arm}", cfg, params, ps, plain,
                         record=arm == "self", **kw)
           for arm, kw in arms.items()}
    acc = self_draft_f32(cfg, params, ps)
    if acc < SELF_DRAFT_MIN_ACCEPT:
        fail(f"spec-self-f32: acceptance {acc:.4f} < "
             f"{SELF_DRAFT_MIN_ACCEPT}: decode through K1 and verify "
             f"through K2 disagree beyond near-ties")
    print(f"[spec] self-draft acceptance at float32 activations {acc:.4f} "
          f">= {SELF_DRAFT_MIN_ACCEPT} (decode through K1 against verify "
          f"through K2, cascade-free); at bf16 activations "
          f"{res['self']['stats']['spec']['acceptance_rate']:.4f} (recorded, "
          f"not held: bf16 rounding of the model's matmuls)", flush=True)
    del dparams
    return {"rows": rows, **res}


def phase_gemma(peaks) -> dict:
    """Gemma-2-9B: the 32-request serve and the long-context pair; returns
    the launches of both."""
    from cxl_speckv_tpu_torch.models.configs import gemma2_9b

    cfg = gemma2_9b()
    if cfg.retirement_window is not None:     # global layers keep full KV
        fail("gemma2: a model with global layers must not retire KV")
    params = init_model(cfg, "gemma2", 1)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab_size, SHORT.prompt).tolist()
               for _ in range(SHORT.n_req)]
    serve(build_engine(cfg, params, SHORT, SHORT.hbm_ample, 0), prompts[:2],
          HORIZON)
    launches, _ = tiered_vs_ample("gemma2", cfg, params, SHORT, prompts)
    # sliding layers alternate with global ones: half of every count
    check_windows("gemma2", launches,
                  lambda n: {("int8", WINDOW): n // 2, ("int8", 0): n // 2})
    phase_anatomy("Gemma-2-9B", cfg, params, prompts, peaks)

    long_prompts = [rng.randint(1, cfg.vocab_size, GEMMA_LONG.prompt).tolist()
                    for _ in range(GEMMA_LONG.n_req)]
    long_launches, _ = tiered_vs_ample("gemma2-long", cfg, params, GEMMA_LONG,
                                       long_prompts, min_splits=2)
    check_windows("gemma2-long", long_launches,
                  lambda n: {("int8", WINDOW): n // 2, ("int8", 0): n // 2})
    del params
    return launches, long_launches


def phase_mistral() -> dict:
    """Mistral-7B: uniform window, so out-of-window blocks retire."""
    from cxl_speckv_tpu_torch.models.configs import mistral_7b

    cfg = mistral_7b()
    params = init_model(cfg, "mistral", 2)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg.vocab_size, MISTRAL.prompt).tolist()
               for _ in range(MISTRAL.n_req)]
    launches, st = tiered_vs_ample("mistral", cfg, params, MISTRAL, prompts,
                                   min_splits=2)
    check_windows("mistral", launches, lambda n: {("int8", WINDOW): n})
    retired = st["runtime"]["window_retired_blocks"]
    if retired <= 0:
        fail("mistral: no KV block retired below the window")
    print(f"[mistral] {retired} blocks retired below the window on the "
          f"tiered run; every launch carried window {WINDOW}", flush=True)
    del params
    return launches


def phase_gpt_oss(peaks) -> dict:
    """GPT-OSS-20B: sinks, the MoE MLP, biases and YaRN rope on alternating
    window-128 / global layers, so nothing retires."""
    from cxl_speckv_tpu_torch.models.configs import gpt_oss_20b

    cfg = gpt_oss_20b()
    if cfg.retirement_window is not None:     # global layers keep full KV
        fail("gpt-oss: a model with global layers must not retire KV")
    params = init_model(cfg, "gpt-oss", 3)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab_size, GPT_OSS.prompt).tolist()
               for _ in range(GPT_OSS.n_req)]
    serve(build_engine(cfg, params, GPT_OSS, GPT_OSS.hbm_ample, 0),
          prompts[:2], HORIZON)
    launches, st = tiered_vs_ample("gpt-oss", cfg, params, GPT_OSS, prompts)
    check_windows("gpt-oss", launches,
                  lambda n: {("int8", GPT_OSS_WINDOW): n // 2,
                             ("int8", 0): n // 2})
    retired = st["runtime"]["window_retired_blocks"]
    if retired:
        fail(f"gpt-oss: {retired} blocks retired in a model with global "
             f"layers")
    print(f"[gpt-oss] every launch of the tiered run carried sinks; half "
          f"with window {GPT_OSS_WINDOW}; no block retired", flush=True)
    phase_anatomy("GPT-OSS-20B", cfg, params, prompts, peaks, matmuls=False)
    del params
    return launches


# ---------------------------------------------------------------------------
# where a served decode step spends its time
# ---------------------------------------------------------------------------

def phase_anatomy(model: str, cfg, params, prompts, peaks, matmuls=True,
                  **kv) -> None:
    """Where a served decode round of `model` spends its time: one group of
    BATCH lanes (32-token prompts, 3 fused rounds of HORIZON steps), a round
    timed on the host clock, the last one under torch.profiler for the
    device time by kernel (the profiler slows the host, so its own wall
    time is not used); `kv` are the KV scheme arguments of `build_engine`.
    Then, with `matmuls`, the W8A16 matmuls of one layer (int8 -> bf16
    copy per call, as `ops.wquant.mm` runs them) against the same
    products on bf16 weights that are already converted."""
    from torch.profiler import ProfilerActivity, profile

    from cxl_speckv_tpu_torch.ops.wquant import mm

    eng = build_engine(cfg, params, SHORT, SHORT.hbm_ample, 0, **kv)
    for p in prompts[:BATCH]:
        eng.add_request(p[:SHORT.max_seq - 4 * HORIZON],
                        max_new_tokens=3 * HORIZON)
    eng.step()                          # prefill the group, first round
    torch.cuda.synchronize()
    t0 = time.monotonic()
    eng.step()                          # second round, host clock
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    # device activity only: recording the host ops as well doubles the
    # phase's time (77 s against 38 s for a Llama-3-8B round on an H100)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.step()                      # third round, profiled
        torch.cuda.synchronize()
    eng.run()
    kernels_us: dict[str, float] = {}
    n_kernels = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels_us[e.key] = kernels_us.get(e.key, 0.0) + e.self_device_time_total
            n_kernels += e.count
    busy = sum(kernels_us.values()) / 1e6                     # us -> s
    print(f"[anatomy] {model}: one fused round, {HORIZON} decode steps of "
          f"{BATCH} lanes: {wall * 1e3:.1f} ms on the host clock "
          f"({wall / HORIZON * 1e3:.2f} ms a step); device time "
          f"{busy * 1e3:.1f} ms ({busy / HORIZON * 1e3:.2f} ms a step) = "
          f"{busy / wall:.1%} busy, {1 - busy / wall:.1%} idle; "
          f"{n_kernels / HORIZON:.0f} kernels a step "
          f"({'profiler saw no device time' if not kernels_us else 'torch.profiler'})",
          flush=True)
    groups = {"int8->bf16 weight copies and other casts": "copy",
              "cuBLAS matmuls": ("nvjet", "gemm", "cutlass"),
              "K1 decode_kernel + decode_merge_kernel": (
                  "decode_kernel", "decode_merge_kernel")}
    for label, keys in groups.items():
        us = sum(v for k, v in kernels_us.items()
                 if any(x in k for x in np.atleast_1d(keys)))
        print(f"[anatomy]   {label}: {us / 1e3:.2f} ms "
              f"({us / 1e6 / max(busy, 1e-12):.1%} of device time)")
    for name, us in sorted(kernels_us.items(), key=lambda it: -it[1])[:10]:
        print(f"[anatomy]   {us / 1e3:9.2f} ms  {us / 1e6 / max(busy, 1e-12):6.1%}"
              f"  {name[:110]}")
    if cfg.num_experts:
        # the dense MoE converts each layer's three int8 expert stacks to
        # bf16 once a step (ops/wquant.py:qeinsum); timed alone
        lp = {n: params["layers"][n][0] for n in ("gate", "up", "down")}
        t_copy = time_ms(lambda: [w.q.to(torch.bfloat16) for w in lp.values()])
        step_ms = busy / HORIZON * 1e3
        print(f"[anatomy]   expert-weight int8->bf16 copies: {t_copy:.3f} ms "
              f"a layer (CUDA events, alone) x {cfg.num_layers} layers = "
              f"{t_copy * cfg.num_layers:.2f} ms = "
              f"{t_copy * cfg.num_layers / max(step_ms, 1e-12):.1%} of the "
              f"device time a step", flush=True)
    if not matmuls:
        return

    lp = {k: v[0] for k, v in params["layers"].items()}
    names = ("q", "k", "v", "o", "gate", "up", "down")
    for rows in (BATCH, BATCH * SHORT.chunk):                # decode, prefill
        x = {n: torch.randn(rows, lp[n].shape[0], device=DEV,
                            dtype=torch.bfloat16) for n in names}
        wb = {n: lp[n].q.to(torch.bfloat16) for n in names}
        t_mm = time_ms(lambda: [mm(x[n], lp[n]) for n in names])
        t_bf = time_ms(lambda: [(x[n] @ wb[n]) * lp[n].s.to(torch.bfloat16)
                                for n in names])
        w_bytes = sum(lp[n].q.numel() for n in names)
        print(f"[mm] {model}: one layer's 7 W8A16 matmuls at {rows} rows: "
              f"{t_mm:.3f} ms with the int8->bf16 copy per call, "
              f"{t_bf:.3f} ms on bf16 weights already converted; int8 "
              f"weight bytes / HBM rate {w_bytes / peaks['hbm'] * 1e3:.3f} "
              f"ms ({cfg.num_layers} layers a step)", flush=True)
        del wb


def timed(label: str, phase, *args, **kw):
    """Run one phase and print its wall time."""
    t0 = time.monotonic()
    out = phase(*args, **kw)
    print(f"[time] {label}: {time.monotonic() - t0:.1f} s", flush=True)
    return out


def kernel_entry(name, key, row, launches) -> dict:
    src, replaces = {
        "K1": ("cxl_speckv_tpu_torch/csrc/paged_attention.cu",
               "cxl_speckv_tpu/ops/paged_attention.py:232"),
        "K2": ("cxl_speckv_tpu_torch/csrc/chunk_attention.cu",
               "cxl_speckv_tpu/ops/chunk_attention_pallas.py:287")}[key]
    entry = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "launches": launches,
             "max_abs_err": row["err"], "ms": row["ms"],
             "b2b_ms": row["b2b_ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"],
             # no single PyTorch call computes attention over a paged,
             # quantized pool through a block table
             "library_ms": None}
    if key == "K1":
        # the split count the rule chose, and the other count timed in
        # turns with it (S = 1, or S = 2 where the rule chose 1)
        entry.update({k: row[k] for k in (
            "splits", "graph_ms", "alt_splits", "alt_b2b_ms", "alt_graph_ms")})
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "cxl_speckv_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository: the "
              "cxl_speckv_tpu_torch package is not beside it", file=sys.stderr)
        return 1
    from cxl_speckv_tpu_torch.utils.card import card_peaks

    t_start = time.monotonic()
    smi, name = phase_device()
    peaks = card_peaks(name)
    timed("build", phase_build)
    main_rows = timed("kernels", phase_kernels, peaks)
    gemma_rows = timed("kernels gemma2", phase_kernels_gemma, peaks)
    mistral_rows = timed("kernels mistral", phase_kernels_mistral, peaks)
    scheme_rows = timed("kernels schemes", phase_kernels_schemes, peaks)
    gpt_rows = timed("kernels gpt-oss", phase_kernels_gpt_oss, peaks)
    probe_entries = timed("anatomy probes", phase_probe, peaks)
    launches, cfg, params, prompts = timed("serve", phase_serve)
    timed("anatomy", phase_anatomy, "Llama-3-8B", cfg, params, prompts, peaks)
    int4_launches, mixed_launches = timed(
        "serve-int4, serve-mixed", phase_serve_schemes, cfg, params, prompts)
    timed("anatomy int4", phase_anatomy, "Llama-3-8B INT4", cfg, params,
          prompts, peaks, matmuls=False, kv="int4")
    timed("anatomy mixed", phase_anatomy, "Llama-3-8B INT8/FP8 layers", cfg,
          params, prompts, peaks, matmuls=False,
          layer_kv=MIXED_LAYERS * (cfg.num_layers // 2))
    timed("switch", phase_switch, cfg, params, prompts)
    spec = timed("spec", phase_spec, cfg, params, prompts, peaks)
    del params
    gemma_launches, gemma_long_launches = timed("gemma2", phase_gemma, peaks)
    mistral_launches = timed("mistral", phase_mistral)
    gpt_launches = timed("gpt-oss", phase_gpt_oss, peaks)
    entries = [kernel_entry("paged_attention", "K1", main_rows["K1"],
                            total(launches["K1"])),
               kernel_entry("paged_chunk_attention", "K2", main_rows["K2"],
                            total(launches["K2"]))]
    for key, kname in (("K1", "paged_attention"),
                       ("K2", "paged_chunk_attention")):
        for tag, window, label in (("win", WINDOW, "sliding"),
                                   ("glob", 0, "global")):
            entries.append(kernel_entry(
                f"{kname} gemma2-9b {label}", key, gemma_rows[f"{key} {tag}"],
                gemma_launches[key].get(("int8", window), 0)))
            entries.append(kernel_entry(
                f"{kname} gemma2-9b long {label}", key,
                gemma_rows[f"{key} long {tag}"],
                gemma_long_launches[key].get(("int8", window), 0)))
        entries.append(kernel_entry(
            f"{kname} mistral-7b", key, mistral_rows[key],
            total(mistral_launches[key])))
        for tag, window, label in (("win", GPT_OSS_WINDOW, "sliding"),
                                   ("glob", 0, "global")):
            entries.append(kernel_entry(
                f"{kname} gpt-oss-20b {label}", key, gpt_rows[f"{key} {tag}"],
                gpt_launches[key].get(("int8", window), 0)))
        # INT4 launches from serve-int4, FP8 from serve-mixed's odd layers
        for kv, served in (("int4", int4_launches), ("fp8", mixed_launches)):
            entries.append(kernel_entry(
                f"{kname} {kv}", key, scheme_rows[f"{key} {kv}"],
                served[key].get((kv, 0), 0)))
    # the spec phase's new shapes; launches from the tiered draft-arm serve
    # (K2's verify share: rounds x 32 layers)
    draft = spec["draft"]
    entries.append(kernel_entry("paged_attention llama-3.2-1b draft", "K1",
                                spec["rows"]["K1"],
                                total(draft["launches"]["K1"])))
    entries.append(kernel_entry("paged_chunk_attention llama-3-8b verify",
                                "K2", spec["rows"]["K2"],
                                draft["rounds"] * cfg.num_layers))
    for key, kname in (("K1", "paged_attention"),
                       ("K2", "paged_chunk_attention")):
        # time lost over the serves against the bound, back to back
        rows = [e for e in entries if e["name"].startswith(kname + " ")
                or e["name"] == kname]
        loss = {e["name"][len(kname):].strip() or "llama":
                e["launches"] * (e["b2b_ms"] - e["bound_ms"]) / 1e3
                for e in rows}
        print(f"[loss] {key}: launches x (back to back - bound) over the "
              f"serves = {sum(loss.values()):.3f} s (" + ", ".join(
                  f"{k} {v:.3f}" for k, v in loss.items()) + ")", flush=True)
        if key == "K1":
            # the device's share: CUDA-graph times, no host dispatch
            dev = sum(e["launches"] * (e["graph_ms"] - e["bound_ms"]) / 1e3
                      for e in rows)
            print(f"[loss] K1 on the device alone (CUDA-graph times): "
                  f"{dev:.3f} s", flush=True)
    entries += probe_entries
    print(f"[done] all phases passed in {time.monotonic() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
