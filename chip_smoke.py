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
5d. family kernels -- K1 and K2 at the served shapes of the families below
              (bf16 compute, INT8, each serve's pool and table geometry),
              timed: Qwen3-8B (G 4), Qwen3-30B-A3B (G 8), Phi-3-mini (G 1,
              D 96), Qwen2-57B-A14B (G 7) at a decode step of 8 lanes and
              the first 64-token chunk (448 rows at G 7), and Qwen2's
              37-token tail chunk at start 64 (259 rows); Gemma-3-12B (G 2, D 256) at a decode step of 4 lanes
              at 1281-1344 tokens and the 256-token chunk from 1024,
              window 1024 and global in turns;
5c. anatomy probes -- the decode-anatomy probes P1-P3
              (`ops/decode_anatomy.py`: K1's walk with parts stripped, K1's
              math on the TPU's kT pool, a ring of bulk copies) against
              their plain versions for INT8, INT4 and BF16 at Llama-3-8B's
              heads, bs 32, lanes up to 1024 tokens; P1 and P3 at their
              derived split count, at one split and at a forced count above
              the short lanes' blocks, and two calls bit-equal; v2 against
              K1 at one split (the arithmetic v2 mirrors); then the probe's
              command line at its default geometry (B 8, ctx 8192, 512 MB
              pools) at bs 32 and 128, each variant timed back to back, K1
              also in single-launch windows and by split count (1, the
              chosen S and multiples of it), P1 and P3 by ring depth and
              split count; each probe's time against the bytes it moves
              and against its PyTorch library call;
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
8. serve-int4, serve-mixed -- the same Llama serve, cut to its first 8
              layers (the depth cut keeps the script in time), with INT4 KV,
              and with a per-layer table of INT8 (even layers) and FP8 (odd
              layers): same checks, launch counts exact per (scheme,
              window); then the decode-round anatomy of each;
9. switch  -- `Engine.set_kv_dtype` on the ample pool: 8 requests under
              INT8, two steps, FP8 for 8 more; each cohort equals a fresh
              engine fixed to its scheme; INT4 refused while busy, then
              rebuilt when idle (pool rows halve), equal to a fresh INT4
              engine;
9b. spec   -- speculative decoding on the serve's Llama-3-8B cut to its
              first 8 layers (the depth cut keeps the script in time), gamma 4, the
              first 16 of its prompts, tiered (52 HBM blocks) and ample, in
              three arms: n-gram lookup (verify through K2, no K1 at all),
              a Llama-3.2-1B draft at full width (W8A16, INT8 draft KV; K1
              at D 64) and a self-draft (the target proposes for itself,
              INT8 draft KV); first K1 at the draft's shape and K2 at the
              verify's (T = 5 at unaligned starts) timed against their plain
              versions. Every request must finish, tiered tokens equal ample
              tokens in every arm, the tiered run migrate both ways, the
              launches be exactly K2 = target prefill dispatches x 8 +
              draft prefill dispatches x L_draft + rounds x 8 and K1 =
              rounds x 5 x L_draft (L_draft 16, 8, 0 for ngram); then the
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
9c. surface -- the serving surface on the serve's Llama-3-8B cut to its
              first 8 layers (the depth cut keeps the script in time): first K2 at
              a session turn's shape (T = 33 at unaligned starts 96-191)
              and K1 at session contexts (up to 224 tokens) timed against
              their plain versions. Sessions: 16 x 3 turns (64 + 32, then
              32 new + 32 generated twice: 224 tokens, 7 blocks a session),
              a group of 8 at a time, tiered (52 HBM blocks, a 136-block
              host tier that holds every idle session) and ample (204):
              every turn finished, tiered == ample turn by turn, 32
              restores and no re-prefill in both, migrations both ways,
              exact launches, free blocks back after `end_session`. Reclaim:
              the same turns on a 48-block host tier, so idle sessions are
              reclaimed and re-prefill, at float32 activations (the served
              bf16 K1 / K2) held to a float32 ample run (equal, or a first
              divergence at a dense top-2 gap <= 0.06) and at bf16
              recorded. A mixed 32 x (64 + 64) serve (8 greedy lanes with
              logprobs 5, 4 sampled with logprobs 5, 4 with prompt logprobs
              on 160-token prompts, 4 frequency / presence 0.5, 4
              repetition 1.3, 8 plain), tiered and ample: one record a
              token, greedy top-1 == the token, tiered == ample on the
              greedy lanes (tokens and logprobs), greedy and plain lanes ==
              a serve without penalties, a penalized lane diverging. Four
              cancels in a tiered serve (queued, after the first chunk of a
              160-token prompt, a penalized request and a session turn
              after their first decode round): all "cancelled", every
              other request == the serve without them, blocks and penalty
              rows free again, the session's next turn restored over the
              partial output == the same script on an ample pool. Decode
              logprobs against an echo's prompt logprobs (within 0.02 at
              float32 activations); an echo in chunks of 64 against one
              chunk of 256 at float32 activations and attention compute,
              with K2 and with its plain version (recorded: the plain
              version shows the same gap, the matmuls' shapes differ), K2
              held to its plain version within 0.02 at both; at bf16
              recorded; `decode_multi_packed` with the pen plane
              (the count row == the bincount of the emitted tokens, the
              prompt bit on exactly the prompt's tokens);
              `penalize_and_count` on the card == the CPU bit for bit; the
              per-step costs of logprobs and the pen plane. The spec
              phase's n-gram arm serves its first 8 requests with logprobs
              5 (one record an emitted token, top-1 == the token, tiered ==
              ample);
9d. stream -- the host-streamed path on the serve's Llama-3-8B (INT8 KV,
              32-token blocks, horizon 32, quantum 4, prefetch off; its
              mixed, cancel and session runs cut to the first 8 layers,
              the depth cut keeping the script in time): first
              K2 at its pooled prefill (T = 256 at start 0) and K1 at its
              decode contexts, timed against their plain versions.
              stream-mixed: HBM 52 blocks (every request past 1600 tokens
              streams), host 260 blocks, chunk 256, max_seq_len 160; 2
              streamed x (3072 + 64) beside 8 pooled x (64 + 64), batch 8.
              Every request finishes, the streamed decode takes the fused
              path every round; the same run at stream_stage_mb 0
              (per-wave prefill, per-token decode) gives identical streamed
              tokens; the pooled tokens equal the same engine serving them
              alone; K1 = pooled decode batches x 32 x L and K2 = pooled
              prefill dispatches x L exactly (L layers; the streamed lanes launch
              neither); host_free back at its start. At float32
              activations the streamed lanes equal an ample pooled
              engine's tokens or first diverge at a token of its top two
              whose top-2 gap is <= 0.06 (at bf16 recorded); one lane
              cancelled after its first decode round frees its blocks and
              leaves the other's tokens bit for bit; a session of 2048 +
              32, then 64 new + 32, restores once from its stream blocks
              (which grow only by the growth) and holds to a fresh
              streamed request over the whole history by the same rule.
              stream-long: 1 x (16384 + 32), chunk 1024, host 600 blocks:
              finishes, decodes token by token (its slab is over the fused
              budget), launches no kernel; prefill seconds, decode ms a
              token, staged GB a decode step and the H2D GB/s of the
              staging copies (CUDA events), the stream timer's share;
              against an ample pooled engine (600 HBM blocks), recorded;
9e. prefetch -- the speculative prefetcher and the automatic horizon on
              the serve's Llama-3-8B at full width and depth. prefetch-lstm:
              the serve cell tiered (52 HBM blocks) with prefetch off, then
              on at depth 2 with the LSTM (online training on its worker
              thread, the in-round continue-probability leg): every request
              finished, tokens equal to the prefetch-off run, launches
              exact, ingraph_pcont, prefetches_issued and train_steps > 0;
              on the first round with a live lane, the probabilities the
              round computed on the card within 1e-4 of the host
              predictor's (on the CPU, on the weights the card's copy came
              from); printed: skipped_eos_predicted, the maintain.plan /
              maintain.train p50, tok/s against prefetch off, and the
              leg's kernels and device ms a round (torch.profiler).
              prefetch-default: `Engine(cfg, SystemConfig())` with every
              default (decode_horizon 0: derived from the dispatch cost
              measured on the card) on 8 x (64 + 32), tokens equal to the
              same requests at horizon 32, launches exact; the dispatch
              cost, the derived horizon, tok/s at both; then the step
              constants of `utils/dispatch.py`: a fused step's ms at 32 and
              16 layers (decode.program p50 / 32 over 4 rounds of 8 lanes),
              fitted as weight bytes / rate + floor. The LSTM's third use
              runs in the spec phase (spec-ngram-seeded): the n-gram arm
              with the LSTM seeding lookup misses (`seed_ngram`) at float32
              activations, ample, against a plain float32 serve:
              fallback_seeded > 0, and each request equal, or first
              diverging at a token of the plain run's top two at a gap <=
              0.06 (verify through K2 and decode through K1 sum in
              different orders);
9f. migrate -- block migrations on the copy stream and fused rounds, on
              the serve's Llama-3-8B at full width (W8A16, INT8 KV). First,
              at full depth, the ordering rules on the card, each with the
              stream it guards against held busy (`torch.cuda._sleep`):
              (a) a demote behind a running round copies what the round
              writes, (b) a demoted slot is held off the free list until
              its copy completes, (c) a promote lands after a running
              round that reads its slot, and a round waits for the promote
              it reads, (d) a streamed stash lands after a demote's copy
              into the same (reused) host slot, (e) a batch's record holds
              its tensors while it is in flight. Then one 16-lane batch
              each way (`hoststore.copy_batch`) against `migrate_program`
              on copies of the same pools and pinned store, byte for byte,
              with the copy stream's ms a direction (CUDA events) and both
              versions' host-clock ms. Then the serve cell on the first 8
              layers (the depth cut keeps the script in time) three ways: split
              (the default: batches on the copy stream), fused
              (`fused_rounds=True`: the batch rides the round) and ample:
              split == fused == ample tokens, migrations both ways in both
              tiered arms, launches exact; printed per arm: tok/s, TTFT /
              TPOT p50, the copy stream's ms a batch and direction, the
              host's blocked ms (`up_wait_ms` / `down_wait_ms`);
9g. server -- the front ends on the serve's Llama-3-8B cut to its first 8
              layers (the depth cut keeps the script in time). Checkpoint:
              `models.save_params` into a temporary directory and
              `load_params(like=...)` back onto the card: every leaf
              bit-equal, the load's peak device memory at most the tree
              plus its largest leaf; bytes and seconds printed. Server:
              `SpeckvServer` on an engine of the loaded tree (W8A16, INT8
              KV, tiered on 52 HBM blocks) with a toy tokenizer: 16
              concurrent greedy clients x (64 + 32), each equal to the same
              request through the engine API or first diverging at a dense
              top-2 gap <= 0.06; one prompt streamed == non-streamed, also
              with a matching string stop (the SSE holdback); a streaming
              client of 512 tokens (ignore_eos) that closes its socket after
              the first chunk is cancelled and its blocks come back; n = 3
              sampled choices distinct; a chat completion, /health,
              /metrics (every line "name value"), /v1/stats JSON; K1 / K2
              launched, no plain-version call; client timeouts of 120 s,
              any timeout, non-200 answer or dead loop thread fails; HTTP
              TTFT / TPOT p50 beside the engine API's. Scoring:
              `Engine.score_prompts` (dense) on 4 prompts of 96-512 tokens
              against the echo prompt logprobs, within 0.02 at float32
              activations over BF16 KV (the reference's pairing), over INT8
              KV and at bf16 recorded; seconds and peak memory;
10. gemma2 -- Gemma-2-9B at full width, 12 of its 42 layers (the depth
              cut keeps the script in time; alternating
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
12. gpt-oss -- GPT-OSS-20B at full width, 8 of its 24 layers (the depth
              cut keeps the script inside its time limit; alternating
              window 128 and global attention, 32 experts top-4 in the dense
              MoE mode, q/k/v/o biases, sinks, YaRN rope, vocabulary 201088),
              W8A16 experts included: 64 requests x (192 + 64), so the second
              prefill chunk and every decode step pass the window, on 88 HBM
              blocks against a demand of 576, and ample. Same checks; half
              of the launches with window 128, every launch of this serve
              with sinks (`sink_launches` == `launches`; no other serve
              launches with sinks), no block retired; then its decode-round
              anatomy with the expert-weight copies' share;
13. qwen3  -- Qwen3-8B at full width and depth (per-head q/k RMSNorm):
              16 requests x (64 + 64), batch 8, on 40 tiered HBM blocks
              against a demand of 80, and ample; the serve's checks, every
              launch global;
14. gemma3 -- Gemma-3-12B at full width, 12 of its 48 layers (two whole
              5:1 periods; the q/k norm in the 1 + w form, the sliding
              layers' local RoPE base unscaled, the global layers' linear
              scaling by 8, tied 262208 vocabulary): 4 x (1280 + 64), batch
              4, chunk 256, on a tiered pool of two sequences' blocks + 4
              (90 against a demand of 172) and ample; the serve's checks,
              5/6 of the launches with window 1024 and 1/6 global, no
              block retired;
15. qwen3-moe -- Qwen3-30B-A3B at full width (128 experts top-8,
              renormalised, dense MoE mode), 12 of its 48 layers: the
              qwen3 cell's serve and checks; then its decode-round anatomy
              with the expert stacks' copy share;
15b. qwen2-moe -- Qwen2-57B-A14B at full width (G 7, q/k/v bias, 64
              experts top-8 without renormalisation, the sigmoid-gated
              shared expert of 20480, dense MoE mode), 8 of its 28 layers:
              a warm-up of two 64 + 37-token prompts (the tail chunk's
              launches), then the qwen3 cell's serve and checks; then its
              decode-round anatomy (device ms a step);
16. phi3-hf -- Phi-3-mini through the HF converter: `config_from_hf` of its
              HF fields in a plain namespace equals `phi3_mini()` but for
              the depth (8 of 32 layers); a random bf16 state dict with
              HF's names (fused qkv_proj / gate_up_proj) converts on the
              card with weight_dtype "int8", the peak device memory above
              the state dict printed and held to the int8 tree plus four of
              its largest float32 matrix; then the qwen3 cell's serve and
              checks on the converted weights (MHA: G 1, D 96).

Each serve prints K1's launches by split count, and its tiered run's
copy-stream time (CUDA events) and host-blocked ms for migrations. Each model's weights are
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
import re
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
SESSIONS, SESSION_TURNS, SESSION_NEW = 16, 3, 32   # the surface phase's
SURFACE_GEN, SURFACE_LONG = 64, 160     # mixed serve: new tokens, long prompt
SURFACE_AMPLE_HBM = 204                 # the serve cell's ample pool
NEAR_TIE_GAP = 0.06                     # the reference's near-tie rule
ECHO_TOL = 0.02                         # decode vs echo logprobs, float32


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
# depth cuts of earlier paths that keep the script inside its time limit
# (their layers, of 24, 42 and 32): since the family serves came, the whole
# script took 1139.5 s on a slow host (an H100 80GB HBM3 at 700 W) with
# GPT-OSS on 12, Gemma-2 on 20 and the spec, surface, INT4 / per-layer and
# migrate serves on 16 layers
GPT_OSS_LAYERS, GEMMA_LAYERS, SPEC_LAYERS, SURFACE_LAYERS = 8, 12, 8, 8
SCHEME_LAYERS = 8
STREAM_LAYERS = 8       # stream-mixed / -cancel / -session's depth cut
# the model families served from their configs (and Phi-3 from an HF state
# dict): their heads (Hq, Hkv, D), cells and depth cuts. Qwen3-8B at all 36
# layers, Qwen3-30B-A3B (128 experts top-8, G 8 = K1's MAX_G) on 12 of its
# 48 layers and Phi-3-mini (MHA, G 1, D 96) on 8 of its 32 serve 16 requests
# of the serve cell's shape, a demand of 80 blocks, on 40 tiered HBM blocks
# (at 44 or more a group's growth fits beside the next one's prefill and
# fewer blocks migrate; at 48, none). Gemma-3-12B on 12 of its 48 layers (two whole
# 5:1 periods): 4 x (1280 + 64), batch 4, chunk 256, so the window of 1024
# binds in the last prefill chunk and in every decode step; 43 blocks a
# sequence, a demand of 172 on a tiered pool of two sequences' blocks + 4
# (about half, as GEMMA_LONG's).
QWEN3_HEADS, QWEN3_MOE_HEADS = (32, 8, 128), (32, 4, 128)
GEMMA3_HEADS, PHI3_HEADS = (16, 8, 256), (32, 32, 96)
GEMMA3_WINDOW = 1024
QWEN3_CELL = Cell(16, 64, 64, BATCH, 64, hbm_tiered=40)
GEMMA3_CELL = Cell(4, 1280, 64, 4, 256, hbm_tiered=2 * 43 + 4)
GEMMA3_LAYERS, QWEN3_MOE_LAYERS, PHI3_LAYERS = 12, 12, 8
# the converted Phi-3's device memory across its conversion, above the
# state dict: at most its int8 tree plus this many of its largest float32
# matrix (the transients of one matrix's quantization; a full-precision
# tree of 8 layers would need ~3.6 GB more)
PHI3_PEAK_MATRICES = 4
# the surface phase. Sessions: 16 x 3 turns, 64 + 32 tokens, then 32 new +
# 32 generated twice: 224 tokens (7 blocks) a session, 112 blocks in all,
# on 52 tiered HBM blocks with a host tier of 16 x 8 + 8 = 136 that holds
# every idle session (max_seq_len 256 covers the last round's overshoot).
SESSION_CELL = Cell(SESSIONS, 192, 32, BATCH, 64, hbm_tiered=52)
SESSION_RECLAIM_HOST = 48               # too small for the idle sessions
# the mixed logprobs / penalties serve and the cancels: 32 requests of 64
# (four of 160) prompt tokens + 64 new, max_seq_len 256; host 264
SURFACE_CELL = Cell(32, SURFACE_LONG, SURFACE_GEN, BATCH, 64, hbm_tiered=52)
ECHO_CELL = Cell(4, SURFACE_LONG, SURFACE_GEN, BATCH, 256, hbm_tiered=52)
# the stream phase. stream-mixed: HBM 52 blocks, so every request past
# (52 - 2) x 32 = 1600 tokens streams; 8 pooled requests x (64 + 64) (32
# blocks, in HBM) beside 2 streamed x (3072 + 64) (98 blocks each) on a
# host tier of 2 x 98 + 64 = 260 blocks (562 MB pinned); chunk 256, the
# JAX default. A streamed lane decodes over 4 waves x 32 blocks x 32
# layers x 67584 B = 277 MB of staged slab, 554 MB for two: under 4 x 256
# MB, so the fused streamed decode runs.
STREAM_MIXED = Cell(8, 64, 64, BATCH, 256, hbm_tiered=52)
STREAM_HOST = 260
STREAM_PROMPT, STREAM_GEN, STREAM_LANES = 3072, 64, 2
STREAM_AMPLE = Cell(STREAM_LANES, STREAM_PROMPT, STREAM_GEN, BATCH, 256,
                    hbm_tiered=0)
# stream-long: 1 x (16384 + 32), chunk 1024 (the reference's advice for
# long prompts), host 600 blocks (1.3 GB pinned): its slab would be >= 17
# waves x 32 blocks x 2.16 MB = 1.2 GB (19 by the JAX rule), over 1 GB,
# so it decodes token by token; ample: 600 HBM blocks
STREAM_LONG = Cell(1, 16384, 32, 1, 1024, hbm_tiered=52)
STREAM_LONG_HOST = STREAM_LONG_AMPLE = 600
# streamed sessions: turn 1 = 2048 + 32, turn 2 = 64 new + 32
STREAM_TURN1, STREAM_TURN_NEW, STREAM_TURN_GEN = 2048, 64, 32
# the prefetch phase: the LSTM arm on the serve cell (prefetch depth 2);
# the default-config arm's requests, 8 x (64 + 32); the step fit's rounds
PREFETCH_DEPTH = 2
PCONT_TOL = 1e-4              # in-round continue probability vs the host
DEFAULT_REQ, DEFAULT_GEN = 8, 32
FIT_ROUNDS = 4
# the migrate phase: the serve cell's split (copy stream) / fused / ample
# arms; one 16-lane batch each way against `migrate_program` on pools of
# 64 HBM slots and a 64-slot host tier; the ordering checks hold a stream
# busy for MIGRATE_SLEEP cycles (`torch.cuda._sleep`, ~30 ms at 1.7 GHz).
# The three serves run the first MIGRATE_LAYERS layers (a depth cut, as
# above)
MIGRATE_SLOTS = 64
MIGRATE_SLEEP = 50_000_000
MIGRATE_LAYERS = 8
# Qwen2-57B-A14B: 28 query heads on 4 KV heads (G 7, the first odd group on
# the card: a 64-token chunk is 448 rows of K2's 16-row tensor-core tiles, a
# 37-token tail 259), q/k/v bias, 64 experts top-8 without renormalisation
# and a sigmoid-gated shared expert of 20480; on 8 of its 28 layers (its
# W8A16 expert stacks are ~2 GB a layer), on QWEN3_CELL. Its warm-up serves
# two prompts of 64 + QWEN2_TAIL tokens, so the tail chunk is served too.
QWEN2_HEADS = (28, 4, 128)
QWEN2_MOE_LAYERS, QWEN2_TAIL = 8, 37
# the server phase, on the serve's Llama-3-8B cut to its first
# SERVER_LAYERS layers: a checkpoint saved and loaded back, then the HTTP
# server on the loaded tree, W8A16, INT8 KV, tiered on 52 HBM blocks: 16
# clients x (64 + 32) greedy; a disconnecting client asks for 512 tokens
# (max_seq_len 608 covers it); then dense scoring of SCORE_LENS prompts
# against their echo (prompt logprobs) in chunks of 256, ample
SERVER_LAYERS, SERVER_GEN, SERVER_LONG = 8, 32, 512
SERVER_CELL = Cell(16, 64, SERVER_LONG, BATCH, 64, hbm_tiered=52)
HTTP_TIMEOUT = 120                      # seconds a client waits, at most
SCORE_LENS = (96, 200, 384, 512)
SCORE_CELL = Cell(len(SCORE_LENS), max(SCORE_LENS), 1, BATCH, 256,
                  hbm_tiered=52)


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
    # P1: the products (matmul, matmulT) on the tensor cores, the sums not
    hmma = {"product_kernel": 0, "sum kernels": 0}
    for fn, n in cuda_build.sass_counts("anatomy_variants", "HMMA").items():
        hmma["product_kernel" if "product_kernel" in fn
             else "sum kernels"] += n
    print(f"[build] anatomy_variants: HMMA instructions in the SASS of the "
          f"matmul / matmulT kernels {hmma['product_kernel']}, of the sum "
          f"kernels {hmma['sum kernels']}", flush=True)
    if not hmma["product_kernel"] or hmma["sum kernels"]:
        fail(f"anatomy_variants: HMMA counts {hmma}: tensor cores must run "
             f"the products and only them")
    # P2: the score and PV products on the tensor cores (HMMA; w8a8's
    # scores IMMA), K by 2-D TMA (UTMALDG) in every P2 kernel, no spills
    p2 = {}
    for op in ("HMMA", "IMMA", "UTMALDG"):
        for fn, n in cuda_build.sass_counts("anatomy_kt", op).items():
            kind = ("w8a8" if "kt_w8a8_kernel" in fn else
                    "mma" if "kt_mma_kernel" in fn else "merge")
            p2.setdefault((kind, op), []).append(n)
    print(f"[build] anatomy_kt: per kernel, HMMA / IMMA / UTMALDG in the "
          f"v2 / v3fused kernels {p2[('mma', 'HMMA')]} / "
          f"{p2[('mma', 'IMMA')]} / {p2[('mma', 'UTMALDG')]}, in the w8a8 "
          f"kernels {p2[('w8a8', 'HMMA')]} / {p2[('w8a8', 'IMMA')]} / "
          f"{p2[('w8a8', 'UTMALDG')]}", flush=True)
    if not (all(p2[("mma", "HMMA")]) and all(p2[("w8a8", "IMMA")])
            and all(p2[("mma", "UTMALDG")]) and all(p2[("w8a8", "UTMALDG")])
            and not any(p2[("mma", "IMMA")])):
        fail(f"anatomy_kt: SASS counts {p2}: every P2 kernel must load K by "
             f"2-D TMA and run its products on the tensor cores")
    if "anatomy_kt" in logs:
        spill = sum(int(w) for w in re.findall(r"(\d+) bytes spill",
                                               logs["anatomy_kt"]))
        if spill:
            fail(f"anatomy_kt: {spill} bytes of spills")
    for name, log in sorted(logs.items()):
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(w) for w in re.findall(r"(\d+) bytes spill", log))
        print(f"[build] {name}: {len(regs)} kernels, registers {min(regs, default=0)}"
              f"-{max(regs, default=0)}, spill bytes (stores + loads) {spill}",
              flush=True)


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


def timed_in_turns(case, *args, sliding=WINDOW, **kw) -> tuple[dict, dict]:
    """Time one shape's sliding (window `sliding`) and global variants in
    turns -- sliding, global, global, sliding, each on fresh inputs of that
    shape -- so that clock drift falls on both alike."""
    runs = [case(*args, window=w, timed=True, **kw)
            for w in (sliding, None, None, sliding)]
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


def phase_kernels_families(peaks) -> dict:
    """Both kernels at the served shapes of the families served from their
    configs (bf16 compute, INT8 KV, each serve's pool and table geometry),
    timed, against their plain versions: a decode step of the batch and the
    first prefill chunk for Qwen3-8B (G 4), Qwen3-30B-A3B (G 8), Phi-3-mini
    (G 1, D 96) and Qwen2-57B-A14B (G 7: 448 rows), and Qwen2's 37-token
    tail chunk at start 64 (259 rows); for Gemma-3-12B (G 2, D 256) a decode step at
    1281-1344 tokens and the last 256-token prompt chunk (start 1024),
    sliding (window 1024) and global in turns. Returns the rows."""
    from cxl_speckv_tpu_torch.config import KVDtype

    gen = torch.Generator(device=DEV)
    gen.manual_seed(3131)
    kv, cd = KVDtype.INT8, torch.bfloat16
    rows = {}
    for key, heads, seed in (("qwen3", QWEN3_HEADS, 12),
                             ("qwen3-moe", QWEN3_MOE_HEADS, 13),
                             ("phi3", PHI3_HEADS, 14),
                             ("qwen2", QWEN2_HEADS, 16)):
        v = dict(heads=heads, timed=True,
                 geometry=served_geometry(QWEN3_CELL))
        rows[f"K1 {key}"] = k1_case(gen, kv, cd, served_lens(QWEN3_CELL, seed),
                                    peaks, **v)
        rows[f"K2 {key}"] = k2_case(gen, kv, cd, QWEN3_CELL.chunk,
                                    [0] * BATCH, peaks, **v)
    # [kernels qwen2]: G 7's tail chunk, 37 x 7 = 259 rows at start 64
    rows["K2 qwen2 tail"] = k2_case(
        gen, kv, cd, QWEN2_TAIL, [QWEN3_CELL.chunk] * BATCH, peaks,
        heads=QWEN2_HEADS, timed=True, geometry=served_geometry(QWEN3_CELL))
    c = GEMMA3_CELL
    v = dict(heads=GEMMA3_HEADS, geometry=served_geometry(c),
             sliding=GEMMA3_WINDOW)
    for key, case, args in (
            ("K1", k1_case, (served_lens(c, 15),)),
            ("K2", k2_case, (c.chunk, [c.prompt - c.chunk] * c.batch))):
        rows[f"{key} gemma3 win"], rows[f"{key} gemma3 glob"] = (
            timed_in_turns(case, gen, kv, cd, *args, peaks, **v))
    for row in rows.values():
        report(row)
    return rows


# ---------------------------------------------------------------------------
# the decode-anatomy probes P1-P3 and K1 timed against them
# ---------------------------------------------------------------------------

PROBE_LENS = [1024, 1023, 999, 512, 33, 32, 1, 0]     # the check's lanes
PROBE_FORCED_S = 12      # above the blocks of the 0- to 33-token lanes
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
    split = [lb for lb in LABELS[1:] if lb not in refuse]
    errs, want = [], {}
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
        want[label] = plain[label]()
        err, ok, tol = da.agreement(label, got, want[label], p)
        if not ok:
            fail(f"probe {scheme} {label}: error {err} beyond {tol}")
        errs.append(f"{label} {err:.2e}")
        if label in split:
            again = kern[label]()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"probe {scheme} {label}: two calls differ")
    # every probe at one split and at a count above the short lanes'
    # blocks (P2 against the plain version's split form at that count)
    worst = {}
    for ns in (1, PROBE_FORCED_S):
        forced = da.probe_calls(p, num_splits=ns)
        forced_plain = da.plain_calls(p, num_splits=ns)
        for label in split:
            got = forced[label]()
            torch.cuda.synchronize()
            ref = (forced_plain[label]() if probe_of(label) == "P2"
                   else want[label])
            err, ok, tol = da.agreement(label, got, ref, p)
            if not ok:
                fail(f"probe {scheme} {label} at S={ns}: error {err} beyond "
                     f"{tol}")
            worst[ns] = max(worst.get(ns, 0.0), err)
    # both round q and p * vs to bf16 against the walk's running max and sum
    # in float32: at one split each lane is one walk in block order in
    # both, so v2 holds to K1 unsplit at rtol = atol = 2e-4 ("full" runs
    # K1's chosen split count, held to the plain version's split form at
    # that count above; a split moves where p * vs rounds)
    err, ok = compare(da.probe_calls(p, num_splits=1)["v2"](),
                      da.k1_call(p, num_splits=1)(), TOL[torch.float32])
    torch.cuda.synchronize()
    if not ok:
        fail(f"probe {scheme}: v2 at S=1 differs from K1 (num_splits=1) by "
             f"{err}")
    derived = {lb: da.probe_setting(lb, p) for lb in split}
    print(f"[probe] {scheme} lens={PROBE_LENS}: every probe within its "
          f"tolerance of its plain version (max |err|: {', '.join(errs)}); "
          f"P1 / P2 / P3 (depth, S) derived {derived}, two calls bit-equal; "
          f"at S=1 max |err| {worst[1]:.2e}, at S={PROBE_FORCED_S} "
          f"{worst[PROBE_FORCED_S]:.2e} (fetchint exact; P2 against the "
          f"plain split form at the kernel's S); K1 at S={da.k1_splits(p)}; "
          f"v2 vs K1 at S=1 {err:.2e} (rtol = atol = "
          f"{TOL[torch.float32]:g})", flush=True)


def probe_sweep(p) -> None:
    """P1, P2 and P3 at the probe's geometry, back to back, in turns (the
    list forward, then backward; the mean of the two): every P1 mode and P2
    variant at each ring depth it takes (P1's 0: registers) at that depth's
    derived split count, and at its default depth, and each ring, also at
    1, half, twice and four times the derived count. The evidence for the
    defaults."""
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    tm = (*p.token_major(), p.table, p.lens, p.kv)
    bs, row = p.k.shape[2], p.k.shape[3] * p.k.element_size()
    cases = []
    for label in (*da.P1_MODES, *da.P2_VARIANTS,
                  *(f"v5ring{n}" for n in da.RING_DEPTHS)):
        ring = label.startswith("v5ring")
        if ring and da.ring_bytes(int(label[6:]), bs, row) > da.SMEM_LIMIT:
            continue
        default = da.probe_setting(label, p)[0]
        depths = (da.P2_DEPTHS if label in da.P2_VARIANTS else da.P1_DEPTHS)
        for depth in (default,) if ring else depths:
            try:
                d, S = da.probe_setting(label, p, None if ring else depth)
            except ValueError:                 # no such ring for this mode
                continue
            counts = ({1, max(S // 2, 1), S, min(2 * S, da.MAX_SPLITS),
                       min(4 * S, da.MAX_SPLITS)} if d == default else {S})
            cases += [(label, d, n) for n in sorted(counts)]

    def call(label, d, n):
        if label.startswith("v5ring"):
            return lambda: da.ring(d, *tm, num_splits=n)
        if label in da.P2_VARIANTS:
            sc = (p.scf, None) if label == "v3fused" else (p.ks, p.vs)
            return lambda: da.kt_attention(p.q, p.kt, p.v, *sc, p.table,
                                           p.lens, p.kv, label, num_splits=n,
                                           depth=d)
        return lambda: da.variant(label, p.q, *tm, num_splits=n, depth=d)

    times = {c: [] for c in cases}
    for order in (cases, cases[::-1]):
        for c in order:
            times[c].append(b2b_ms(call(*c)))
    for label in dict.fromkeys(c[0] for c in cases):
        mb = da.moved_bytes(label, p)
        print(f"[probe-sweep] {label} at ctx {int(p.lens.max())}, bs {bs} "
              f"(default depth, S = {da.probe_setting(label, p)}), ms back to "
              f"back in turns / GB/s moved: " + ", ".join(
                  f"depth {d} S={n} {sum(t) / 2:.4f} / "
                  f"{mb / (sum(t) / 2) / 1e6:.0f}"
                  for (lb, d, n), t in times.items() if lb == label),
              flush=True)


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
    probe_sweep(p)
    enc = {n: sorted(da.kt_map_host_us(p, n) for _ in range(20))[10]
           for n in ("v2", "v3fused")}
    print(f"[probe] P2 tensor-map encode on the host (cuTensorMapEncodeTiled "
          f"through the runtime's entry point, every call), median of 20: "
          f"v2 (one map) {enc['v2']:.2f} us, v3fused (two) "
          f"{enc['v3fused']:.2f} us", flush=True)
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
        moved = da.moved_bytes(label, p)
        moved_ms = moved / peaks["hbm"] * 1e3
        ms = rows[label]["us"] / 1e3
        src, replaces = PROBE_SOURCES[probe_of(label)]
        entry = {"name": f"anatomy {label}", "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[label],
                 "max_abs_err": err, "ms": ms,
                 "plain_ms": time_ms(plain[label], iters=2, warmup=1),
                 "bound_ms": b_ms, "bound_by": by,
                 # the whole-tile walk at the HBM rate: what the kernel
                 # moves (fetchrow and the rings: whole tiles for row 0)
                 "moved_bound_ms": moved_ms,
                 # the PyTorch reductions of the same sums over the
                 # contiguous table (decode_anatomy.contiguous_sums), where
                 # there are such, back to back as the kernel is timed;
                 # none for dequant, the products and P2
                 "library_ms": b2b_ms(lib) if lib else None}
        lib_line = "none"
        if lib:
            lib_line = (f"{entry['library_ms']:.4f} ms back to back "
                        f"({time_ms(lib, iters=5):.4f} in single-launch "
                        f"windows), kernel / library "
                        f"{ms / entry['library_ms']:.2f}x")
        entry["depth"], entry["splits"] = da.probe_setting(label, p)
        print(f"[probe] {label}: {ms:.4f} ms back to back"
              + (f" (depth {entry['depth']}, S={entry['splits']})"
                 if "splits" in entry else "")
              + f", {moved / ms / 1e6:.0f} GB/s of the {moved / 1e6:.1f} MB "
              f"it moves, {moved_ms / ms:.1%} of that moved-bytes bound "
              f"({moved_ms:.5f} ms); library {lib_line}; plain "
              f"{entry['plain_ms']:.3f} ms; bound {b_ms:.5f} ms ({by}); max "
              f"|err| {err:.3e} ({tol})", flush=True)
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# serving through the engine
# ---------------------------------------------------------------------------

def build_engine(cfg, params, cell: Cell, hbm_blocks, host_blocks,
                 kv="int8", layer_kv=None, engine_kw=None, prefetch=None,
                 **spec):
    """The serving engine of `cell`; KV scheme `kv`, or the per-layer
    table `layer_kv` (INT8 / FP8 entries); `engine_kw`: more EngineConfig
    fields; `prefetch`: a PrefetchConfig in place of prefetch off (as
    `bench.py`); `spec`: the other arguments of `Engine` (speculative
    decoding, `enable_lstm`)."""
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
        prefetch=prefetch or PrefetchConfig(depth=4, min_depth=3,
                                            enabled=False, train_online=False),
        engine=EngineConfig(max_batch_size=cell.batch,
                            max_seq_len=cell.max_seq,
                            prefill_chunk=cell.chunk, decode_horizon=HORIZON,
                            sched_quantum=QUANTUM, weight_dtype="int8",
                            **(engine_kw or {})))
    return Engine(cfg, sc, params=params, device=DEV, **spec)


def serve(eng, prompts, gen, kw_of=None):
    """Serve `prompts` to the end (`kw_of(i)`: request i's extra
    `add_request` arguments); returns ({req_id: output}, seconds)."""
    outs, dt = serve_each(eng, [
        (p, dict(max_new_tokens=gen, **(kw_of(i) if kw_of else {})))
        for i, p in enumerate(prompts)])
    return {o.req_id: o for o in outs if o is not None}, dt


def serve_each(eng, reqs):
    """Submit `reqs` [(prompt, add_request kwargs)] and serve to the end;
    returns (outputs in submission order, seconds)."""
    ids = [eng.add_request(p, **kw) for p, kw in reqs]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    outs = {o.req_id: o for o in eng.run()}
    torch.cuda.synchronize()
    return [outs.get(i) for i in ids], time.monotonic() - t0


def first_layers(cfg, params, n: int):
    """(config, weights) of the model cut to its first n layers: views of
    the same weights, nothing copied."""
    import dataclasses

    return (dataclasses.replace(cfg, num_layers=n),
            {**params, "layers": {k: v[:n] for k, v in
                                  params["layers"].items()}})


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
    tiered.kvc.copier.timings = []
    outs_t, dt_t = serve(tiered, prompts, cell.gen)
    launches = read_launches()
    down_ms, up_ms = copy_stream_ms(tiered.kvc.copier.timings)
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
    print(f"[{label}] tiered migrations: {len(down_ms)} "
          f"batches with demotes, {len(up_ms)} with promotes on the copy "
          f"stream, {sum(down_ms):.1f} / {sum(up_ms):.1f} ms of copy-stream "
          f"time (CUDA events); host blocked up_wait_ms "
          f"{tr['up_wait_ms']:.1f}, down_wait_ms {tr['down_wait_ms']:.1f}",
          flush=True)
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
            emitted, n_acc, tables = rec.orig(mixin, logits, drafts_d,
                                              drafts, active, *args)
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
            return emitted, n_acc, tables

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
             logprob_lanes=0, **spec) -> dict:
    """One arm of the spec phase: tiered (launches counted from 0) and
    ample serves of `prompts` with the speculative arguments `spec`;
    requires every request finished, tiered == ample tokens, migrations
    both ways and the exact launch counts; prints the arm's numbers and
    its agreement with the plain serve `plain`; with `record`, the ample
    serve's verdicts (`VerdictRecord`). The first `logprob_lanes` requests
    ask for logprobs=5: one record an emitted token, the token top-1,
    tiered == ample records. Returns the tiered run's launches and
    statistics."""
    L = cfg.num_layers
    dcfg = spec.get("draft_config")
    L_draft = dcfg.num_layers if dcfg is not None else 0
    kw = dict(spec, spec_gamma=GAMMA)
    lp = lambda i: {"logprobs": 5} if i < logprob_lanes else {}
    # warm-up: the arm's first launches at its shapes
    serve(build_engine(cfg, params, SHORT, SHORT.hbm_ample, 0, **kw),
          prompts[:2], 8, lp)
    reset_launches()
    tiered = build_engine(cfg, params, SHORT, SHORT.hbm_tiered,
                          SHORT.host_tiered, **kw)
    outs_t, dt_t = serve(tiered, prompts, SHORT.gen, lp)
    launches = read_launches()
    st = tiered.get_statistics()
    draft_prefills = tiered.spec.prefill_dispatches
    del tiered
    ample = build_engine(cfg, params, SHORT, SHORT.hbm_ample, 0, **kw)
    rec = VerdictRecord() if record else contextlib.nullcontext()
    with rec:
        outs_a, dt_a = serve(ample, prompts, SHORT.gen, lp)
    sa = ample.get_statistics()
    del ample
    for i in sorted(outs_t)[:logprob_lanes]:
        for tag, o in (("tiered", outs_t[i]), ("ample", outs_a[i])):
            if o.logprobs is None or len(o.logprobs) != len(o.tokens) or any(
                    e["top_ids"][0] != t or e["top_logprobs"][0] != e["logprob"]
                    for t, e in zip(o.tokens, o.logprobs)):
                fail(f"{label} {tag}: request {i}'s logprob records do not "
                     f"follow its emitted tokens")
        if outs_t[i].logprobs != outs_a[i].logprobs:
            fail(f"{label}: request {i}'s logprobs differ tiered / ample")

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


def ngram_seeded_f32(cfg, params, prompts) -> dict:
    """The n-gram arm with the prefetch LSTM seeding its lookup misses
    (`enable_lstm`, `seed_ngram`) at float32 activations on the ample
    pool, against a plain serve at float32 activations (logprobs 2):
    fallback_seeded > 0, and each request's tokens equal the plain
    serve's, or first diverge at a token of its top two at a top-2 gap <=
    NEAR_TIE_GAP (the reference's near-tie rule: the verify pass through
    K2 and decode through K1 sum in different orders)."""
    import dataclasses

    c32 = dataclasses.replace(cfg, dtype="float32")
    eng = build_engine(c32, params, SHORT, SHORT.hbm_ample, 0)
    ref, rdt = serve_each(eng, [(p, dict(max_new_tokens=SHORT.gen,
                                         logprobs=2)) for p in prompts])
    del eng
    eng = build_engine(c32, params, SHORT, SHORT.hbm_ample, 0,
                       spec_ngram=True, spec_gamma=GAMMA, enable_lstm=True)
    if eng.prefetcher.predictor is None:
        fail("spec-ngram-seeded: enable_lstm=True built no predictor")
    outs, dt = serve_each(eng, [(p, dict(max_new_tokens=SHORT.gen))
                                for p in prompts])
    sp = eng.get_statistics()["spec"]
    del eng
    if len(outs) != len(prompts) or any(o is None for o in outs):
        fail("spec-ngram-seeded: not every request finished")
    if not sp["fallback_seeded"] > 0:
        fail(f"spec-ngram-seeded: fallback_seeded {sp['fallback_seeded']}: "
             f"the LSTM seeded no lookup miss")
    toks = [o.tokens for o in outs]
    same = sum(t == r.tokens for t, r in zip(toks, ref))
    note = against("spec-ngram-seeded f32", toks, ref, True)
    print(f"[spec-ngram-seeded] f32 activations, ample: fallback_seeded "
          f"{sp['fallback_seeded']}, acceptance {sp['acceptance_rate']:.4f}, "
          f"{sp['rounds']} rounds, {dt:.2f} s (plain {rdt:.2f} s); requests "
          f"equal to the plain serve {same}/{len(prompts)}; {note}",
          flush=True)
    return {"fallback_seeded": sp["fallback_seeded"], "same": same}


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
                         record=arm == "self",
                         logprob_lanes=BATCH if arm == "ngram" else 0, **kw)
           for arm, kw in arms.items()}
    print(f"[spec] n-gram arm: the first {BATCH} requests with logprobs=5: "
          f"one record an emitted token, the token top-1, tiered == ample",
          flush=True)
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
    seeded = ngram_seeded_f32(cfg, params, ps)
    return {"rows": rows, **res, "ngram_seeded": seeded}


def phase_gemma(peaks) -> dict:
    """Gemma-2-9B at full width and GEMMA_LAYERS of its layers: the
    32-request serve and the long-context pair; returns the launches of
    both."""
    import dataclasses

    from cxl_speckv_tpu_torch.models.configs import gemma2_9b

    cfg = dataclasses.replace(gemma2_9b(), num_layers=GEMMA_LAYERS)
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
    """GPT-OSS-20B at full width and GPT_OSS_LAYERS of its layers: sinks,
    the MoE MLP, biases and YaRN rope on alternating window-128 / global
    layers, so nothing retires."""
    import dataclasses

    from cxl_speckv_tpu_torch.models.configs import gpt_oss_20b

    cfg = dataclasses.replace(gpt_oss_20b(), num_layers=GPT_OSS_LAYERS)
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


def phase_qwen3() -> dict:
    """Qwen3-8B at full width and depth (per-head q/k RMSNorm): the serve
    cell's shape on QWEN3_CELL."""
    from cxl_speckv_tpu_torch.models.configs import qwen3_8b

    cfg = qwen3_8b()
    params = init_model(cfg, "qwen3", 5)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, cfg.vocab_size, QWEN3_CELL.prompt).tolist()
               for _ in range(QWEN3_CELL.n_req)]
    serve(build_engine(cfg, params, QWEN3_CELL, QWEN3_CELL.hbm_ample, 0),
          prompts[:2], HORIZON)
    launches, _ = tiered_vs_ample("qwen3", cfg, params, QWEN3_CELL, prompts)
    check_windows("qwen3", launches, lambda n: {("int8", 0): n})
    del params
    return launches


def phase_gemma3() -> dict:
    """Gemma-3-12B at full width and GEMMA3_LAYERS of its layers: the q/k
    norm in the 1 + w form, five sliding layers (window 1024, the local
    RoPE base unscaled) to one global (linear RoPE scaling 8) on
    GEMMA3_CELL, where the window binds; nothing may retire."""
    import dataclasses

    from cxl_speckv_tpu_torch.models.configs import gemma3_12b

    cfg = dataclasses.replace(gemma3_12b(), num_layers=GEMMA3_LAYERS)
    if cfg.retirement_window is not None:     # global layers keep full KV
        fail("gemma3: a model with global layers must not retire KV")
    params = init_model(cfg, "gemma3", 6)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, cfg.vocab_size, GEMMA3_CELL.prompt).tolist()
               for _ in range(GEMMA3_CELL.n_req)]
    launches, st = tiered_vs_ample("gemma3", cfg, params, GEMMA3_CELL,
                                   prompts)
    # five sliding layers to one global: 5/6 and 1/6 of every count
    check_windows("gemma3", launches,
                  lambda n: {("int8", GEMMA3_WINDOW): n * 5 // 6,
                             ("int8", 0): n // 6})
    retired = st["runtime"]["window_retired_blocks"]
    if retired:
        fail(f"gemma3: {retired} blocks retired in a model with global "
             f"layers")
    print(f"[gemma3] 5/6 of the launches with window {GEMMA3_WINDOW}, 1/6 "
          f"global; no block retired", flush=True)
    del params
    return launches


def phase_qwen3_moe(peaks) -> dict:
    """Qwen3-30B-A3B at full width (128 experts top-8, renormalised, the
    dense MoE mode, q/k norm) and QWEN3_MOE_LAYERS of its layers, W8A16
    expert stacks drawn expert by expert, on QWEN3_CELL; then its
    decode-round anatomy with the expert stacks' int8 -> bf16 copy share."""
    import dataclasses

    from cxl_speckv_tpu_torch.models.configs import qwen3_moe_30b

    cfg = dataclasses.replace(qwen3_moe_30b(), num_layers=QWEN3_MOE_LAYERS)
    params = init_model(cfg, "qwen3-moe", 7)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, cfg.vocab_size, QWEN3_CELL.prompt).tolist()
               for _ in range(QWEN3_CELL.n_req)]
    serve(build_engine(cfg, params, QWEN3_CELL, QWEN3_CELL.hbm_ample, 0),
          prompts[:2], HORIZON)
    launches, _ = tiered_vs_ample("qwen3-moe", cfg, params, QWEN3_CELL,
                                  prompts)
    check_windows("qwen3-moe", launches, lambda n: {("int8", 0): n})
    phase_anatomy(f"Qwen3-30B-A3B ({QWEN3_MOE_LAYERS} layers)", cfg, params,
                  prompts, peaks, matmuls=False)
    del params
    return launches


def phase_qwen2_moe(peaks) -> dict:
    """Qwen2-57B-A14B at full width and QWEN2_MOE_LAYERS of its layers: G 7,
    q/k/v bias, 64 experts top-8 without top-k renormalisation, the
    sigmoid-gated shared expert, the dense MoE mode, W8A16 expert stacks
    drawn expert by expert. A warm-up serves two prompts of 64 + QWEN2_TAIL
    tokens on the ample pool (its second prefill dispatch is the 37-token
    tail chunk at start 64: 259 rows); then QWEN3_CELL tiered and ample, and
    the decode-round anatomy. Returns the serve's launches, with the tail
    dispatch's K2 launches under "tail"."""
    import dataclasses

    from cxl_speckv_tpu_torch.models.configs import qwen2_moe_57b

    cfg = dataclasses.replace(qwen2_moe_57b(), num_layers=QWEN2_MOE_LAYERS)
    if not (cfg.q_group == 7 and cfg.attn_bias and not cfg.moe_norm_topk
            and cfg.moe_shared_expert and cfg.moe_impl == "dense"):
        fail(f"qwen2-moe: the config lost a feature of Qwen2-57B-A14B: {cfg}")
    params = init_model(cfg, "qwen2-moe", 9)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, cfg.vocab_size, QWEN3_CELL.prompt).tolist()
               for _ in range(QWEN3_CELL.n_req)]
    reset_launches()
    warm = build_engine(cfg, params, QWEN3_CELL, QWEN3_CELL.hbm_ample, 0)
    serve(warm, [p + p[:QWEN2_TAIL] for p in prompts[:2]], HORIZON)
    dispatches = warm.get_statistics()["engine"]["prefill_dispatches"]
    tail = total(read_launches()["K2"]) - cfg.num_layers
    if dispatches != 2 or tail != cfg.num_layers:
        fail(f"qwen2-moe: the warm-up took {dispatches} prefill dispatches "
             f"and {tail + cfg.num_layers} K2 launches; want 2 (64, then "
             f"{QWEN2_TAIL} tokens) and {2 * cfg.num_layers}")
    del warm
    launches, _ = tiered_vs_ample("qwen2-moe", cfg, params, QWEN3_CELL,
                                  prompts)
    check_windows("qwen2-moe", launches, lambda n: {("int8", 0): n})
    phase_anatomy(f"Qwen2-57B-A14B ({QWEN2_MOE_LAYERS} layers)", cfg, params,
                  prompts, peaks, matmuls=False)
    del params
    return dict(launches, tail=tail)


def phi3_hf_config(num_layers: int):
    """Phi-3-mini-4k's HF config fields (`microsoft/Phi-3-mini-4k-instruct`,
    its window off as `phi3_mini()` has it) in a plain namespace, as a
    machine without `transformers` would pass them."""
    import types

    return types.SimpleNamespace(
        model_type="phi3", vocab_size=32064, hidden_size=3072,
        intermediate_size=8192, num_hidden_layers=num_layers,
        num_attention_heads=32, num_key_value_heads=32, rope_theta=10000.0,
        rope_scaling=None, rms_norm_eps=1e-5, tie_word_embeddings=False,
        max_position_embeddings=4096, eos_token_id=32000,
        sliding_window=None, attention_bias=False)


def phi3_state_dict(cfg, gen) -> dict:
    """A random bf16 state dict on the card with HF's Phi-3 names: fused
    qkv_proj [3 x 3072, 3072] and gate_up_proj [2 x 8192, 3072] (weights
    N(0, 1 / fan_in)), unit norms."""
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qkv = (cfg.num_q_heads + 2 * cfg.num_kv_heads) * cfg.head_dim

    def w(out, fan_in):
        return (torch.randn((out, fan_in), generator=gen, device=DEV)
                * fan_in ** -0.5).to(torch.bfloat16)

    ones = lambda: torch.ones(H, dtype=torch.bfloat16, device=DEV)
    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": ones(),
          "lm_head.weight": w(V, H)}
    for i in range(cfg.num_layers):
        lay = f"model.layers.{i}."
        sd.update({lay + "input_layernorm.weight": ones(),
                   lay + "post_attention_layernorm.weight": ones(),
                   lay + "self_attn.qkv_proj.weight": w(qkv, H),
                   lay + "self_attn.o_proj.weight": w(H, H),
                   lay + "mlp.gate_up_proj.weight": w(2 * I, H),
                   lay + "mlp.down_proj.weight": w(H, I)})
    return sd


def phase_phi3_hf() -> dict:
    """Phi-3-mini through the HF converter on the card: `config_from_hf` of
    its HF fields equals `phi3_mini()` but for the depth cut; a random bf16
    state dict with HF's names (fused projections) converts with
    weight_dtype "int8" on the card, its peak device memory printed and
    held; then the converted model serves QWEN3_CELL tiered and ample --
    the first served MHA (G 1), D 96 shape."""
    import dataclasses

    from cxl_speckv_tpu_torch.models.configs import phi3_mini
    from cxl_speckv_tpu_torch.models.hf_convert import (
        config_from_hf,
        params_from_hf_state_dict,
    )
    from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

    cfg = config_from_hf(phi3_hf_config(PHI3_LAYERS))
    want = dataclasses.replace(phi3_mini(), num_layers=PHI3_LAYERS)
    diff = [f.name for f in dataclasses.fields(want)
            if getattr(cfg, f.name) != getattr(want, f.name)]
    if diff:
        fail(f"phi3-hf: config_from_hf differs from phi3_mini() in {diff}")
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(8)
    sd = phi3_state_dict(cfg, gen)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = params_from_hf_state_dict(sd, cfg, weight_dtype="int8",
                                       device=DEV)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - base
    leaves = [params["embed"], params["lm_head"], params["final_norm"],
              *params["layers"].values()]
    tree = sum(nbytes(x.q, x.s) if isinstance(x, QuantizedTensor)
               else nbytes(x) for x in leaves)
    biggest = max(t.numel() for t in sd.values()) * 4
    src = nbytes(*sd.values())
    print(f"[phi3-hf] config_from_hf == phi3_mini() but for the depth "
          f"({PHI3_LAYERS} of 32 layers); converted a {src / 2**30:.2f} GiB "
          f"bf16 state dict to W8A16 on the card in {dt * 1e3:.1f} ms: "
          f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB above "
          f"the state dict, int8 tree {tree / 2**30:.3f} GiB, largest "
          f"float32 matrix {biggest / 2**30:.3f} GiB", flush=True)
    if peak > tree + PHI3_PEAK_MATRICES * biggest:
        fail(f"phi3-hf: conversion peaked {peak} bytes above the state "
             f"dict, over the int8 tree {tree} + {PHI3_PEAK_MATRICES} x "
             f"{biggest}")
    del sd
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, cfg.vocab_size, QWEN3_CELL.prompt).tolist()
               for _ in range(QWEN3_CELL.n_req)]
    launches, _ = tiered_vs_ample("phi3-hf", cfg, params, QWEN3_CELL,
                                  prompts)
    check_windows("phi3-hf", launches, lambda n: {("int8", 0): n})
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
              "K1 decode_kernel + its merge (tile_ring::merge_lse)": (
                  "decode_kernel", "merge_lse")}
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


# ---------------------------------------------------------------------------
# the serving surface: sessions, cancel, logprobs, penalties
# ---------------------------------------------------------------------------

def first_divergence(a: list, b: list) -> int | None:
    """Index of the first token where a and b differ (a length difference
    counts at the shorter's end), None when equal."""
    if a == b:
        return None
    return next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def session_turns(eng, prompts, news, watch=None):
    """SESSIONS conversations of SESSION_TURNS turns, served a group of
    BATCH at a time (turn 1 of group A, then of group B, turn 2 of A, ...),
    each group to its end before the next is submitted, so one group's
    sessions sit idle while the other's turn runs. Turn 1 is the prompt +
    SESSION_NEW generated tokens; each later turn feeds SESSION_NEW new
    tokens and generates SESSION_NEW. Returns (session ids, outputs
    [turn][session], the (turn, session) pairs that re-prefilled, the
    transfer counts (up, down) after each group)."""
    n = len(prompts)
    sids, outs = [None] * n, [[None] * n for _ in range(SESSION_TURNS)]
    reprefilled, moves = set(), []
    for t in range(SESSION_TURNS):
        for g0 in range(0, n, BATCH):
            ids = {}
            for s in range(g0, min(n, g0 + BATCH)):
                if t == 0:
                    rid = eng.add_request(prompts[s], session=True,
                                          max_new_tokens=SESSION_NEW)
                else:
                    if not eng.get_session(sids[s]).live:
                        reprefilled.add((t, s))
                    rid = eng.continue_session(sids[s], news[t - 1][s],
                                               max_new_tokens=SESSION_NEW)
                ids[rid] = s
            for o in eng.run():
                s = ids[o.req_id]
                outs[t][s] = o
                sids[s] = o.session_id
            tr = eng.get_statistics()["transfer"]
            moves.append((tr["up_transfers"], tr["down_transfers"]))
            if watch is not None:
                watch(t, eng)
    return sids, outs, reprefilled, moves


def settle(eng) -> None:
    """Run the writebacks still queued (blocks freed while their demote
    waited for a full batch), wait for the copies in flight and reap the
    frees they deferred."""
    eng.kvc.drain()
    eng.kvc.maintain()
    eng.kvc.drain()


def session_engine(cfg, params, hbm, host, **kw):
    return build_engine(cfg, params, SESSION_CELL, hbm, host, **kw)


def hold_turns(label, cfg, params, prompts, news, got, want, reprefilled,
               hold: bool) -> str:
    """Each session's turns of `got` against `want` in order while their
    histories agree: equal, or first diverging at a near-tie (the dense
    top-2 gap at the divergence <= NEAR_TIE_GAP); a session is compared no
    further after its first divergence. With `hold`, a larger gap fails.
    Returns a summary (agreement, each divergence's gap)."""
    same = tot = 0
    gaps = []
    for s in range(len(prompts)):
        hist = list(prompts[s])
        for t in range(SESSION_TURNS):
            if t:
                hist += news[t - 1][s]
            g, w = got[t][s].tokens, want[t][s].tokens
            tot += 1
            j = first_divergence(g, w)
            if j is None:
                same += 1
                hist += w
                continue
            gap = top2_gap(cfg, params, hist + w[:j])
            gaps.append((s, t + 1, j, (t, s) in reprefilled, gap))
            if hold and gap > NEAR_TIE_GAP:
                fail(f"{label}: session {s} turn {t + 1} diverges at token "
                     f"{j} with a dense top-2 gap of {gap:.4f} > "
                     f"{NEAR_TIE_GAP}")
            break
    return (f"turns equal {same}/{tot} compared; first divergences "
            f"(session, turn, token, re-prefilled, dense top-2 gap): "
            + (", ".join(f"({s}, {t}, {j}, {'yes' if r else 'no'}, {g:.4f})"
                         for s, t, j, r, g in gaps) or "none"))


def p50(xs) -> float:
    return float(np.median(xs)) if len(xs) else float("nan")


def surface_sessions(cfg, params, prompts, rng) -> dict:
    """Sessions on the tiered pool (its host tier holds every idle
    session: demoted, never reclaimed) and on the ample pool: every turn
    finished, tiered == ample turn by turn, 32 restores and no re-prefill
    in both, migrations both ways, exact launches, and the blocks free
    again after `end_session`. Returns both runs' outputs and statistics,
    the tiered run's launches, K2's session-turn launches and the turns'
    new tokens."""
    news = [[rng.randint(1, cfg.vocab_size, SESSION_NEW).tolist()
             for _ in prompts] for _ in range(SESSION_TURNS - 1)]
    L = cfg.num_layers
    res = {}
    turn_dispatches = []
    for tag, hbm, host in (("tiered", SESSION_CELL.hbm_tiered,
                            SESSION_CELL.host_tiered),
                           ("ample", SURFACE_AMPLE_HBM, 0)):
        eng = session_engine(cfg, params, hbm, host)
        free0 = (eng.kvc.directory.hbm_free, eng.kvc.directory.host_free)
        if tag == "tiered":
            reset_launches()
            mark = lambda t, e: turn_dispatches.append(
                (t, e.get_statistics()["engine"]["prefill_dispatches"]))
        else:
            mark = None
        t0 = time.monotonic()
        sids, outs, repre, moves = session_turns(eng, prompts, news, mark)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        st = eng.get_statistics()
        if tag == "tiered":
            launches = read_launches()
            want = {"K1": st["scheduler"]["decode_batches"] * HORIZON * L,
                    "K2": st["engine"]["prefill_dispatches"] * L}
            got = {k: total(v) for k, v in launches.items()}
            if got != want:
                fail(f"surface sessions: kernel launches {got} != {want}")
        sess = [eng.get_session(s) for s in sids]
        counts = (sum(s.restores for s in sess), sum(s.reprefills for s in sess))
        if counts != (SESSIONS * (SESSION_TURNS - 1), 0) or repre:
            fail(f"surface sessions {tag}: restores / re-prefills {counts}, "
                 f"want {SESSIONS * (SESSION_TURNS - 1)} / 0")
        bad = [(t, s) for t in range(SESSION_TURNS) for s in range(SESSIONS)
               if outs[t][s] is None
               or outs[t][s].finish_reason not in ("length", "eos")]
        if bad:
            fail(f"surface sessions {tag}: turns not finished: {bad}")
        for sid in sids:
            eng.end_session(sid)
        settle(eng)
        free1 = (eng.kvc.directory.hbm_free, eng.kvc.directory.host_free)
        if free1 != free0:
            fail(f"surface sessions {tag}: free HBM / host blocks {free1} "
                 f"after end_session, {free0} at the start")
        res[tag] = dict(outs=outs, stats=st, dt=dt, moves=moves)
        del eng
    for t in range(SESSION_TURNS):
        diff = [s for s in range(SESSIONS) if res["tiered"]["outs"][t][s].tokens
                != res["ample"]["outs"][t][s].tokens]
        if diff:
            fail(f"surface sessions: turn {t + 1} tiered tokens differ from "
                 f"ample for sessions {diff}")
    tr = res["tiered"]["stats"]["transfer"]
    if not (tr["up_transfers"] > 0 and tr["down_transfers"] > 0):
        fail(f"surface sessions: the tiered run migrated nothing both ways: "
             f"{tr}")
    mv = res["tiered"]["moves"]
    per_turn = [(mv[i][0] - (mv[i - 1][0] if i else 0),
                 mv[i][1] - (mv[i - 1][1] if i else 0)) for i in range(len(mv))]
    for tag in ("tiered", "ample"):
        r = res[tag]
        o = r["outs"]
        toks = sum(len(x.tokens) for turn in o for x in turn)
        restored = [x for turn in o[1:] for x in turn]
        print(f"[surface] sessions {tag}: {SESSIONS} x {SESSION_TURNS} turns, "
              f"{toks} tokens in {r['dt']:.2f} s = {toks / r['dt']:.1f} tok/s "
              f"| turn 1 TTFT p50 {p50([x.ttft_ms for x in o[0]]):.1f} ms, "
              f"TPOT p50 {p50([x.tpot_ms for x in o[0]]):.2f} ms | restored "
              f"turns TTFT p50 {p50([x.ttft_ms for x in restored]):.1f} ms, "
              f"TPOT p50 {p50([x.tpot_ms for x in restored]):.2f} ms | up "
              f"{r['stats']['transfer']['up_transfers']} down "
              f"{r['stats']['transfer']['down_transfers']}", flush=True)
    print(f"[surface] sessions: tiered == ample for every turn; 32 restores, "
          f"0 re-prefills in both; migrations (up, down) a group of "
          f"{BATCH} sessions' turn, in order {per_turn}; launches {launches};"
          f" free blocks back to their start after end_session", flush=True)
    # K2's session-turn share: the prefill dispatches of turns 2 and 3
    first = [d for t, d in turn_dispatches if t == 0][-1]
    res["turn_k2"] = (turn_dispatches[-1][1] - first) * L
    res["launches"] = launches
    res["news"] = news
    return res


def surface_reclaim(cfg, params, prompts, news, ample_bf16) -> None:
    """The same turns on a host tier too small for the idle sessions
    (SESSION_RECLAIM_HOST blocks against 112 of session KV), so that
    sessions are reclaimed and their next turn re-prefills the history: at
    float32 activations (the served bf16 K1 / K2), held to a float32 ample
    run by the near-tie rule (`hold_turns`); at bf16, recorded against the
    bf16 ample run."""
    import dataclasses

    c32 = dataclasses.replace(cfg, dtype="float32")
    runs = {}
    for tag, c in (("f32", c32), ("bf16", cfg)):
        eng = session_engine(c, params, SESSION_CELL.hbm_tiered,
                             SESSION_RECLAIM_HOST)
        t0 = time.monotonic()
        sids, outs, repre, _ = session_turns(eng, prompts, news)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        sess = [eng.get_session(s) for s in sids]
        n_re = sum(s.reprefills for s in sess)
        reclaimed = sum(s.reprefills > 0 for s in sess)
        if reclaimed < 4:
            fail(f"surface reclaim {tag}: {reclaimed} sessions re-prefilled "
                 f"(want >= 4) on {SESSION_RECLAIM_HOST} host blocks")
        if any(x is None for turn in outs for x in turn):
            fail(f"surface reclaim {tag}: a turn did not finish")
        re_turns = [outs[t][s] for t, s in repre]
        print(f"[surface] reclaim {tag}: host {SESSION_RECLAIM_HOST} blocks "
              f"(session KV 112), HBM {SESSION_CELL.hbm_tiered}: {reclaimed} "
              f"sessions reclaimed, {n_re} re-prefilled turns, "
              f"{sum(s.restores for s in sess)} restores; re-prefilled turns "
              f"TTFT p50 {p50([x.ttft_ms for x in re_turns]):.1f} ms, TPOT "
              f"p50 {p50([x.tpot_ms for x in re_turns]):.2f} ms; {dt:.2f} s",
              flush=True)
        runs[tag] = (outs, repre)
        for sid in sids:
            eng.end_session(sid)
        del eng
    eng = session_engine(c32, params, SURFACE_AMPLE_HBM, 0)
    _, ample32, _, _ = session_turns(eng, prompts, news)
    del eng
    print(f"[surface] reclaim f32 against the f32 ample run: "
          + hold_turns("surface reclaim f32", c32, params, prompts, news,
                       runs["f32"][0], ample32, runs["f32"][1], hold=True),
          flush=True)
    print(f"[surface] reclaim bf16 against the bf16 ample run (recorded, not "
          f"held): " + hold_turns("surface reclaim bf16", cfg, params,
                                  prompts, news, runs["bf16"][0],
                                  ample_bf16, runs["bf16"][1], hold=False),
          flush=True)


def surface_requests(prompts, long_prompts) -> dict:
    """The mixed serve's 32 requests by kind (prompt, kwargs): greedy with
    logprobs 5, sampled (T 0.8, top-p 0.9) with logprobs 5, greedy with
    prompt logprobs on 160-token prompts (chunks of 64: two boundary
    re-feeds), frequency / presence 0.5, repetition 1.3, and plain."""
    g = dict(max_new_tokens=SURFACE_GEN)
    return {
        "greedy-lp": [(p, dict(g, logprobs=5)) for p in prompts[0:8]],
        "sampled-lp": [(p, dict(g, logprobs=5, temperature=0.8, top_p=0.9))
                       for p in prompts[8:12]],
        "prompt-lp": [(p, dict(g, prompt_logprobs=True))
                      for p in long_prompts],
        "freq-pres": [(p, dict(g, frequency_penalty=0.5,
                               presence_penalty=0.5)) for p in prompts[16:20]],
        "repetition": [(p, dict(g, repetition_penalty=1.3))
                       for p in prompts[20:24]],
        "plain": [(p, dict(g)) for p in prompts[24:32]]}


def check_logprob_records(label, out, k):
    """One record a token; top-k sorted descending and <= 0."""
    if out.logprobs is None or len(out.logprobs) != len(out.tokens):
        fail(f"{label}: {0 if out.logprobs is None else len(out.logprobs)} "
             f"logprob records for {len(out.tokens)} tokens")
    for e in out.logprobs:
        v = e["top_logprobs"]
        if len(v) != k or v != sorted(v, reverse=True) or max(v) > 0:
            fail(f"{label}: top-{k} logprobs {v} not sorted or above 0")


def surface_logprobs(cfg, params, kinds) -> dict:
    """The mixed serve tiered and ample, and an ample serve with the
    penalized lanes plain (the reference: the guard row passes unpenalized
    lanes through bit for bit). Returns the reference's outputs by kind."""
    flat = [(kind, i, r) for kind, reqs in kinds.items()
            for i, r in enumerate(reqs)]
    reqs = [r for _, _, r in flat]
    outs = {}
    for tag, hbm, host in (("tiered", SURFACE_CELL.hbm_tiered,
                            SURFACE_CELL.host_tiered),
                           ("ample", SURFACE_AMPLE_HBM, 0)):
        eng = build_engine(cfg, params, SURFACE_CELL, hbm, host)
        got, dt = serve_each(eng, reqs)
        st = eng.get_statistics()
        if len(eng._pen_free) != eng.config.engine.penalty_rows:
            fail(f"surface logprobs {tag}: penalty rows not all free again")
        outs[tag] = got
        toks = sum(len(o.tokens) for o in got if o is not None)
        print(f"[surface] mixed serve {tag}: {toks} tokens in {dt:.2f} s = "
              f"{toks / dt:.1f} tok/s, TTFT p50 "
              f"{st['engine']['p50_ttft_ms']:.1f} ms, TPOT p50 "
              f"{st['engine']['p50_tpot_ms']:.2f} ms, up "
              f"{st['transfer']['up_transfers']} down "
              f"{st['transfer']['down_transfers']}", flush=True)
        del eng
    plain_reqs = [(p, {k: v for k, v in kw.items() if "penalty" not in k})
                  for p, kw in reqs]
    ref, _ = serve_each(build_engine(cfg, params, SURFACE_CELL,
                                     SURFACE_AMPLE_HBM, 0), plain_reqs)
    by = lambda o: {kind: [o[j] for j, (kd, _, _) in enumerate(flat)
                           if kd == kind] for kind in kinds}
    t, a, r = by(outs["tiered"]), by(outs["ample"]), by(ref)
    for kind in kinds:
        for i, o in enumerate(a[kind]):
            if o is None or o.finish_reason not in ("length", "eos"):
                fail(f"surface logprobs: {kind} lane {i} did not finish")
    for kind in ("greedy-lp", "sampled-lp"):
        for i, o in enumerate(t[kind] + a[kind]):
            check_logprob_records(f"surface {kind} lane {i}", o, 5)
    for i, o in enumerate(t["greedy-lp"] + a["greedy-lp"]):
        for tok, e in zip(o.tokens, o.logprobs):
            if e["top_ids"][0] != tok or e["top_logprobs"][0] != e["logprob"]:
                fail(f"surface greedy-lp lane {i}: top-1 {e['top_ids'][0]} / "
                     f"{e['top_logprobs'][0]} against the token {tok} / "
                     f"{e['logprob']}")
    for kind in ("greedy-lp", "prompt-lp", "freq-pres", "repetition",
                 "plain"):
        for i, (x, y) in enumerate(zip(t[kind], a[kind])):
            if (x.tokens != y.tokens or x.logprobs != y.logprobs
                    or x.prompt_logprobs != y.prompt_logprobs):
                fail(f"surface {kind} lane {i}: tiered != ample (tokens or "
                     f"logprobs)")
    for kind in ("greedy-lp", "prompt-lp", "plain"):
        for i, (x, y) in enumerate(zip(a[kind], r[kind])):
            if x.tokens != y.tokens:
                fail(f"surface {kind} lane {i}: tokens differ from the serve "
                     f"without penalized lanes")
    for i, o in enumerate(a["prompt-lp"]):
        pl = o.prompt_logprobs
        if pl is None or len(pl) != SURFACE_LONG or pl[0] is not None or any(
                x is None or x > 0 for x in pl[1:]):
            fail(f"surface prompt-lp lane {i}: prompt logprobs malformed")
    pen = a["freq-pres"] + a["repetition"]
    diverged = sum(x.tokens != y.tokens for x, y in zip(
        pen, r["freq-pres"] + r["repetition"]))
    if not diverged:
        fail("surface: no penalized lane diverged from its unpenalized run")
    print(f"[surface] logprobs: one record a token on every logprob lane, "
          f"greedy top-1 == the token; tiered == ample on the greedy lanes "
          f"(tokens, logprobs, prompt logprobs); greedy and plain lanes == "
          f"the serve without penalties; {diverged}/{len(pen)} penalized "
          f"lanes diverged from their unpenalized runs", flush=True)
    return r


@contextlib.contextmanager
def plain_k2():
    """The model passes call K2's plain PyTorch version (on the card's
    tensors) in place of the kernel while the context is open."""
    llama = sys.modules["cxl_speckv_tpu_torch.models.llama"]
    from cxl_speckv_tpu_torch.ops.chunk_attention import paged_chunk_attention

    kernel = llama.paged_chunk_attention_cuda
    llama.paged_chunk_attention_cuda = paged_chunk_attention
    try:
        yield
    finally:
        llama.paged_chunk_attention_cuda = kernel


def echo_scores(cfg, params, seqs, cell) -> np.ndarray:
    """Prompt logprobs [n, len - 1] of an echo over `seqs` (ample pool,
    the cell's prefill chunk)."""
    out, _ = serve_each(build_engine(cfg, params, cell, SURFACE_AMPLE_HBM, 0),
                        [(x, dict(max_new_tokens=1, prompt_logprobs=True))
                         for x in seqs])
    return np.array([o.prompt_logprobs[1:] for o in out])


def decode_vs_echo(cfg, params, long_prompts) -> float:
    """Greedy decode logprobs (chunks of 64) against the prompt logprobs of
    an echo over prompt + output: the largest absolute difference."""
    dec, _ = serve_each(build_engine(cfg, params, SURFACE_CELL,
                                     SURFACE_AMPLE_HBM, 0),
                        [(p, dict(max_new_tokens=SURFACE_GEN, logprobs=5))
                         for p in long_prompts])
    echo = echo_scores(cfg, params, [p + o.tokens for p, o in
                                     zip(long_prompts, dec)], SURFACE_CELL)
    return max(abs(e["logprob"] - echo[i, len(p) + j - 1])
               for i, (p, o) in enumerate(zip(long_prompts, dec))
               for j, e in enumerate(o.logprobs))


def surface_echo(cfg, params, long_prompts) -> dict:
    """Decode logprobs against an echo's prompt logprobs, held within
    ECHO_TOL at float32 activations (the served bf16 K1 / K2). One prompt
    scored in chunks of 64 (three boundary re-feeds) and in one chunk of
    256: recorded, with K2 and with its plain version at float32 attention
    compute, and K2 held to its plain version within ECHO_TOL at both
    chunkings (a difference between the chunkings that the plain version
    shows too is the model's, not K2's: the two passes' matmuls have other
    shapes, which cuBLAS sums in other orders). At bf16 activations all
    recorded."""
    import dataclasses

    c32 = dataclasses.replace(cfg, dtype="float32")
    c32a = dataclasses.replace(c32, attn_compute_dtype="float32")
    seqs = [p + p[::-1][:SURFACE_GEN] for p in long_prompts]
    res = {"decode_echo_f32": decode_vs_echo(c32, params, long_prompts),
           "decode_echo_bf16": decode_vs_echo(cfg, params, long_prompts)}
    sc = {}
    for tag, cell in (("64", SURFACE_CELL), ("256", ECHO_CELL)):
        sc[tag] = echo_scores(c32a, params, seqs, cell)
        with plain_k2():
            sc[tag + " plain"] = echo_scores(c32a, params, seqs, cell)
    gap = lambda a, b: float(np.abs(sc[a] - sc[b]).max())
    res.update(chunk_f32=gap("64", "256"),
               chunk_f32_plain=gap("64 plain", "256 plain"),
               k2_vs_plain_64=gap("64", "64 plain"),
               k2_vs_plain_256=gap("256", "256 plain"))
    d = np.abs(sc["64"] - sc["256"])
    where = np.unravel_index(d.argmax(), d.shape)
    bf = {tag: echo_scores(cfg, params, seqs, cell)
          for tag, cell in (("64", SURFACE_CELL), ("256", ECHO_CELL))}
    res["chunk_bf16"] = float(np.abs(bf["64"] - bf["256"]).max())
    print(f"[surface] echo, max |difference| of logprobs: decode vs echo "
          f"{res['decode_echo_f32']:.5f} at float32 activations (held <= "
          f"{ECHO_TOL}), {res['decode_echo_bf16']:.5f} at bf16 (recorded); "
          f"at float32 activations and attention compute, K2 vs its plain "
          f"version {res['k2_vs_plain_64']:.5f} in chunks of 64, "
          f"{res['k2_vs_plain_256']:.5f} in one of 256 (held <= "
          f"{ECHO_TOL}); chunks of 64 vs one of 256 {res['chunk_f32']:.5f} "
          f"with K2 (largest at lane {where[0]}, position {where[1] + 1}), "
          f"{res['chunk_f32_plain']:.5f} with the plain version, "
          f"{res['chunk_bf16']:.5f} at bf16 (recorded)", flush=True)
    if max(res["decode_echo_f32"], res["k2_vs_plain_64"],
           res["k2_vs_plain_256"]) > ECHO_TOL:
        fail(f"surface echo: {res}, above {ECHO_TOL}")
    return res


def surface_pen_direct(cfg, params, prompt) -> None:
    """`decode_multi_packed` called once with the pen plane: one penalized
    lane (frequency / presence 0.5) prefilled through
    `prefill_batch_packed` (row reset, prompt marked, first token counted),
    then HORIZON steps. The count row must equal the host bincount of the
    emitted tokens, and bit 24 mark exactly the prompt's tokens."""
    from cxl_speckv_tpu_torch.engine.sampling import (
        PEN_COUNT_MASK,
        PEN_PROMPT_BIT,
        encode_pen_info,
        encode_sampling,
    )
    from cxl_speckv_tpu_torch.models.llama import (
        decode_multi_packed,
        prefill_batch_packed,
    )

    eng = build_engine(cfg, params, SURFACE_CELL, SURFACE_AMPLE_HBM, 0)
    kvc, n = eng.kvc, len(prompt)
    slot = kvc.add_seq()
    if not kvc.extend_seq(slot, n + HORIZON):
        fail("surface pen: no room for the lane")
    kvc.ensure_resident([slot])
    mb = kvc.pool.table.max_blocks_per_seq
    row = np.where(kvc.pool.table.row(slot) >= 0, kvc.pool.table.row(slot),
                   kvc.guard_slot)
    plane = torch.zeros((eng.config.engine.penalty_rows + 1, cfg.vocab_size),
                        dtype=torch.int32, device=DEV)
    packed = np.zeros((BATCH, 4 + mb + n), np.int32)
    packed[:, 4:4 + mb] = kvc.guard_slot
    packed[0, :3] = (0, n, encode_sampling(0.0))
    packed[0, 4:4 + mb] = row
    packed[0, 4 + mb:] = prompt
    info = np.zeros((BATCH, 5), np.int32)
    info[:, 0] = plane.shape[0] - 1
    info[0] = encode_pen_info(0, 0.5, 0.5, reset=True, count_sampled=True)
    first = prefill_batch_packed(params, cfg, kvc.kv_dtype, packed, kvc.pools,
                                 info, plane, max_blocks=mb)
    dp = np.full((BATCH, mb + 4), kvc.guard_slot, np.int32)
    dp[:, :4] = 0
    dp[0, :2] = (int(first[0]), n)
    dp[0, 4:] = row
    info[0] = encode_pen_info(0, 0.5, 0.5)
    toks = decode_multi_packed(params, cfg, kvc.kv_dtype, dp, kvc.pools,
                               info, plane, horizon=HORIZON)
    emitted = [int(first[0])] + toks[0].tolist()
    cells = plane[0].cpu().numpy()
    want = np.bincount(emitted, minlength=cfg.vocab_size)
    if not (cells & PEN_COUNT_MASK == want).all():
        fail("surface pen: the count row is not the bincount of the emitted "
             "tokens")
    marked = set(np.nonzero(cells & PEN_PROMPT_BIT)[0].tolist())
    if marked != set(prompt):
        fail(f"surface pen: prompt bit on {len(marked)} tokens, the prompt "
             f"holds {len(set(prompt))}")
    print(f"[surface] decode_multi_packed with the pen plane: count row == "
          f"bincount of {len(emitted)} emitted tokens "
          f"({len(set(emitted))} distinct); prompt bit on exactly the "
          f"prompt's {len(marked)} tokens", flush=True)
    del eng


def surface_pen_bitwise(cfg) -> None:
    """`penalize_and_count` (after a reset and a prompt mark) on the card
    at [BATCH, vocab] with random counts, bit for bit the port's CPU run of
    the same inputs."""
    from cxl_speckv_tpu_torch.engine import sampling as ts

    rng = np.random.RandomState(21)
    V, R = cfg.vocab_size, 16
    logits = (rng.randn(BATCH, V) * 3).astype(np.float32)
    plane = rng.randint(0, 9, (R + 1, V)).astype(np.int32)
    plane[rng.rand(R + 1, V) < 0.05] |= ts.PEN_PROMPT_BIT
    kinds = [(0.5, 0.5, 0.0), (0.0, 0.0, 1.3), (0.0, 0.0, 0.0),
             (-1.2, 0.7, 1.9)]
    info = np.array([ts.encode_pen_info(
        (0, 3, R, 5, 7, 9, 11, 15)[b], *kinds[b % 4], reset=b == 5,
        count_sampled=b != 4) for b in range(BATCH)], np.int32)
    ids = rng.randint(0, V, (BATCH, 64)).astype(np.int32)
    valid = rng.randint(0, 65, BATCH).astype(np.int32)
    out = []
    for device in ("cpu", DEV):
        t = lambda a: torch.from_numpy(a.copy()).to(device)
        pc, pi = t(plane), t(info)
        ts.pen_reset_rows(pi, pc)
        ts.pen_mark_prompt(pi, pc, t(ids), t(valid))
        toks, _ = ts.penalize_and_count(t(logits), pi, pc,
                                        lambda lg: lg.argmax(-1))
        out.append((toks.cpu(), pc.cpu()))
    if not (torch.equal(out[0][0], out[1][0])
            and torch.equal(out[0][1], out[1][1])):
        fail("surface pen: penalize_and_count on the card differs from the "
             "CPU run")
    print(f"[surface] penalize_and_count at [{BATCH}, {V}] ({R} rows + "
          f"guard): card == CPU bit for bit (tokens and plane)", flush=True)


def surface_costs(cfg) -> dict:
    """The per-step cost of the surface's device work at the served
    shape: the log-softmax and top-20 of `_token_logprobs` over [BATCH,
    vocab] float32 logits, and `penalize_and_count` with a 17-row plane."""
    from cxl_speckv_tpu_torch.engine.sampling import (
        encode_pen_info,
        penalize_and_count,
    )
    from cxl_speckv_tpu_torch.models.llama import _token_logprobs

    V = cfg.vocab_size
    logits = torch.randn(BATCH, V, device=DEV) * 3
    toks = logits.argmax(-1)
    plane = torch.zeros(17, V, dtype=torch.int32, device=DEV)
    info = torch.tensor([encode_pen_info(b % 16, 0.5, 0.5, 1.3)
                         for b in range(BATCH)], dtype=torch.int32,
                        device=DEV)
    lp_ms = time_ms(lambda: _token_logprobs(logits, toks, 20))
    pen_ms = time_ms(lambda: penalize_and_count(logits, info, plane,
                                                lambda lg: lg.argmax(-1)))
    am_ms = time_ms(lambda: logits.argmax(-1))
    print(f"[surface] per decode step at [{BATCH}, {V}]: logprobs "
          f"(log-softmax + top-20) {lp_ms:.4f} ms, penalize_and_count "
          f"{pen_ms:.4f} ms, the plain argmax {am_ms:.4f} ms (single-launch "
          f"windows); x {HORIZON} a round: {lp_ms * HORIZON:.2f} / "
          f"{pen_ms * HORIZON:.2f} ms", flush=True)
    return {"logprobs_ms": lp_ms, "pen_ms": pen_ms}


def surface_cancel(cfg, params, kinds, ref, rng) -> None:
    """Four cancels in a tiered serve of the mixed serve's greedy requests
    (penalties stripped; `ref` served them on the ample pool): one while
    queued, one after the first 64-token chunk of a 160-token prompt, one
    penalized request after its first decode round (its penalty row
    frees), one session turn after its first decode round. Each returns
    "cancelled"; every other request's tokens == `ref`'s; free blocks and
    penalty rows return to their start; the session's next turn restores
    from the KV that holds the partial output, equal to the same script on
    an ample pool without the serve around it."""
    from cxl_speckv_tpu_torch.engine.request import RequestState

    greedy = [k for k in kinds if k != "sampled-lp"]
    strip = lambda kw: {x: v for x, v in kw.items() if "penalty" not in x}
    others = [(p, strip(kw)) for k in greedy for p, kw in kinds[k]]
    want = [o.tokens for k in greedy for o in ref[k]]
    long_p = kinds["prompt-lp"][0][0][::-1]
    short_p = rng.randint(1, cfg.vocab_size, 64).tolist()
    first_turn = rng.randint(1, cfg.vocab_size, 64).tolist()
    new = rng.randint(1, cfg.vocab_size, SESSION_NEW).tolist()
    new2 = rng.randint(1, cfg.vocab_size, SESSION_NEW).tolist()
    due = {"queued": lambda r: r.state == RequestState.QUEUED,
           "prefill": lambda r: (r.state == RequestState.PREFILLING
                                 and r.prefill_pos == SURFACE_CELL.chunk),
           "decode": lambda r: (r.state == RequestState.RUNNING
                                and len(r.output) >= 1 + HORIZON),
           "session": lambda r: (r.state == RequestState.RUNNING
                                 and len(r.output) >= 1 + HORIZON)}

    def script(eng, with_serve: bool):
        """Returns (cancelled outputs by name, the other requests' outputs,
        the session id, the session's next turn)."""
        sid = serve_each(eng, [(first_turn, dict(
            max_new_tokens=SESSION_NEW, session=True))])[0][0].session_id
        ids = {}
        if with_serve:
            ids["prefill"] = eng.add_request(long_p, max_new_tokens=32)
            ids["decode"] = eng.add_request(short_p, frequency_penalty=0.5,
                                            max_new_tokens=SURFACE_GEN)
        ids["session"] = eng.continue_session(sid, new,
                                              max_new_tokens=SURFACE_GEN)
        rest = ([eng.add_request(p, **kw) for p, kw in others]
                if with_serve else [])
        if with_serve:
            ids["queued"] = eng.add_request(short_p[::-1], max_new_tokens=8)
        cancelled, outs = {}, {}
        while eng.has_work:
            outs.update((o.req_id, o) for o in eng.step())
            for name, rid in ids.items():
                if name not in cancelled and due[name](eng._requests[rid]):
                    cancelled[name] = eng.cancel(rid)
        rid = eng.continue_session(sid, new2, max_new_tokens=SESSION_NEW)
        nxt = {o.req_id: o for o in eng.run()}[rid]
        return cancelled, [outs.get(r) for r in rest], sid, nxt

    eng = build_engine(cfg, params, SURFACE_CELL, SURFACE_CELL.hbm_tiered,
                       SURFACE_CELL.host_tiered)
    free0 = (eng.kvc.directory.hbm_free, eng.kvc.directory.host_free)
    t0 = time.monotonic()
    cancelled, got, sid, nxt = script(eng, True)
    dt = time.monotonic() - t0
    names = ("queued", "prefill", "decode", "session")
    reasons = {n: getattr(cancelled.get(n), "finish_reason", None)
               for n in names}
    if set(reasons.values()) != {"cancelled"}:
        fail(f"surface cancel: {reasons}")
    partial = cancelled["session"].tokens
    sess = eng.get_session(sid)
    tail = len(new2) + len(nxt.tokens)
    if not (sess.live and sess.restores == 2
            and sess.tokens[-tail - len(partial):-tail] == partial):
        fail("surface cancel: the cancelled session turn's partial output is "
             "not in the session the next turn restored")
    diff = [i for i, (o, w) in enumerate(zip(got, want))
            if o is None or o.tokens != w]
    if diff:
        fail(f"surface cancel: requests {diff} differ from the serve without "
             f"the four cancelled ones")
    eng.end_session(sid)
    settle(eng)
    free1 = (eng.kvc.directory.hbm_free, eng.kvc.directory.host_free)
    if free1 != free0 or len(eng._pen_free) != eng.config.engine.penalty_rows:
        fail(f"surface cancel: free blocks {free1} (start {free0}), penalty "
             f"rows free {len(eng._pen_free)}")
    del eng
    solo = build_engine(cfg, params, SURFACE_CELL, SURFACE_AMPLE_HBM, 0)
    s_cancelled, _, _, s_nxt = script(solo, False)
    if (s_cancelled["session"].tokens != partial
            or s_nxt.tokens != nxt.tokens):
        fail("surface cancel: the session's partial output or next turn "
             "differs from the same script on an ample pool")
    print(f"[surface] cancel: queued, after the first chunk of a "
          f"{SURFACE_LONG}-token prompt, a penalized request after its first "
          f"decode round ({len(cancelled['decode'].tokens)} tokens), a "
          f"session turn after its first round ({len(partial)} tokens): all "
          f"'cancelled'; the other {len(got)} requests == the serve without "
          f"them; blocks and penalty rows free again; the session's next "
          f"turn, restored over the partial output, == the ample script; "
          f"{dt:.2f} s", flush=True)


def phase_kernels_surface(peaks) -> dict:
    """K2 at a session turn's shape (T = 33 at unaligned starts 96-191,
    restored contexts) and K1 at session contexts (8 lanes up to 224
    tokens), bf16 compute, INT8, in the tiered session engine's pool and
    table geometry, timed against their plain versions."""
    from cxl_speckv_tpu_torch.config import KVDtype

    gen = torch.Generator(device=DEV)
    gen.manual_seed(100)
    rng = np.random.RandomState(13)
    geo = served_geometry(SESSION_CELL)
    rows = {"K2": k2_case(gen, KVDtype.INT8, torch.bfloat16, 1 + SESSION_NEW,
                          sorted(rng.randint(96, 192, BATCH).tolist()), peaks,
                          timed=True, geometry=geo),
            "K1": k1_case(gen, KVDtype.INT8, torch.bfloat16,
                          rng.randint(97, 225, BATCH).tolist(), peaks,
                          timed=True, geometry=geo)}
    for row in rows.values():
        report(row)
    return rows


def phase_surface(cfg, params, prompts, peaks) -> dict:
    """The serving surface on Llama-3-8B: sessions (tiered, ample,
    reclaim), the mixed logprobs / penalties serve, cancel, the echo
    checks, the pen plane direct and bitwise, and the per-step costs.
    Returns the kernel rows and the launches of the session run."""
    rows = phase_kernels_surface(peaks)
    rng = np.random.RandomState(10)
    sp = prompts[:SESSIONS]
    ses = surface_sessions(cfg, params, sp, rng)
    surface_reclaim(cfg, params, sp, ses["news"], ses["ample"]["outs"])
    long_prompts = [p + rng.randint(1, cfg.vocab_size,
                                    SURFACE_LONG - len(p)).tolist()
                    for p in prompts[12:16]]
    kinds = surface_requests(prompts, long_prompts)
    ref = surface_logprobs(cfg, params, kinds)
    surface_cancel(cfg, params, kinds, ref, rng)
    echo = surface_echo(cfg, params, long_prompts)
    surface_pen_direct(cfg, params, prompts[0])
    surface_pen_bitwise(cfg)
    costs = surface_costs(cfg)
    return {"rows": rows, "launches": ses["launches"],
            "turn_k2": ses["turn_k2"], "costs": costs, "echo": echo}


# ---------------------------------------------------------------------------
# the host-streamed path
# ---------------------------------------------------------------------------

def phase_kernels_stream(peaks) -> dict:
    """K2 at the stream-mixed cell's pooled prefill (T = 256 at start 0, 64
    tokens of prompt each) and K1 at its decode contexts, bf16 compute,
    INT8, in its tiered pool and table geometry, timed against their plain
    versions (the streamed lanes run neither)."""
    from cxl_speckv_tpu_torch.config import KVDtype

    gen = torch.Generator(device=DEV)
    gen.manual_seed(110)
    geo = served_geometry(STREAM_MIXED)
    rows = {"K2": k2_case(gen, KVDtype.INT8, torch.bfloat16,
                          STREAM_MIXED.chunk, [0] * BATCH, peaks, timed=True,
                          geometry=geo),
            "K1": k1_case(gen, KVDtype.INT8, torch.bfloat16,
                          served_lens(STREAM_MIXED, 11), peaks, timed=True,
                          geometry=geo)}
    for row in rows.values():
        report(row)
    return rows


def fused_calls(eng) -> list:
    """Record each streamed decode dispatch's choice (True = the fused
    decode ran, False = the budget sent it down the per-token path)."""
    calls, fused = [], eng._stream_decode_fused

    def recording(*args):
        calls.append(fused(*args))
        return calls[-1]

    eng._stream_decode_fused = recording
    return calls


def against(label, got, ref, hold: bool) -> str:
    """Token lists `got` against `ref`'s outputs (logprobs 2): equal, or
    first diverging at a token that is one of `ref`'s top two there, at a
    top-2 logprob gap (= logit gap) <= NEAR_TIE_GAP, the reference's
    near-tie rule; with `hold` a larger gap fails. Returns a summary."""
    notes = []
    for i, (g, r) in enumerate(zip(got, ref)):
        j = first_divergence(g, r.tokens)
        if j is None:
            notes.append(f"lane {i} equal ({len(g)} tokens)")
            continue
        rec = r.logprobs[j]
        gap = rec["top_logprobs"][0] - rec["top_logprobs"][1]
        top2 = j < len(g) and g[j] in rec["top_ids"][:2]
        notes.append(f"lane {i} first diverges at token {j} of {len(g)}, "
                     f"top-2 gap {gap:.4f}, in the top 2: {top2}")
        if hold and (gap > NEAR_TIE_GAP or not top2):
            fail(f"{label}: lane {i} diverges at token {j} at a top-2 gap "
                 f"of {gap:.4f} (limit {NEAR_TIE_GAP}; in the top 2: {top2})")
    return "; ".join(notes)


def stream_record(st: dict) -> str:
    e = st["engine"]
    ph = st["phases"].get("stream", {}).get("total_s", 0.0)
    return (f"stream phase {ph:.2f} s, stream_chunks {e['stream_chunks']}, "
            f"stream_tokens {e['stream_tokens']}")


def stream_mixed(cfg, params, pooled, streamed) -> dict:
    """stream-mixed at bf16 activations: the served run (launches counted)
    and the same with stream_stage_mb 0 (per-wave prefill, per-token
    decode): identical streamed tokens; the pooled requests == the same
    engine serving them alone; exact K1 / K2 launches from the pooled
    dispatches alone; the bf16 streamed tokens against an ample pooled
    engine recorded. Returns the served run's launches and numbers."""
    L = cfg.num_layers
    reqs = ([(p, dict(max_new_tokens=STREAM_GEN)) for p in streamed]
            + [(p, dict(max_new_tokens=STREAM_MIXED.gen)) for p in pooled])
    runs = {}
    for tag, ekw in (("served", None), ("per-wave", {"stream_stage_mb": 0})):
        reset_launches()
        eng = build_engine(cfg, params, STREAM_MIXED, STREAM_MIXED.hbm_tiered,
                           STREAM_HOST, engine_kw=ekw)
        calls = fused_calls(eng)
        if eng.kvc.directory.host_free != STREAM_HOST:
            fail("stream-mixed: host tier not empty at the start")
        outs, dt = serve_each(eng, reqs)
        st = eng.get_statistics()
        runs[tag] = (outs, dt, st, read_launches(), calls)
        if any(o is None or o.finish_reason not in ("length", "eos")
               for o in outs):
            fail(f"stream-mixed {tag}: not every request finished")
        if eng.kvc.directory.host_free != STREAM_HOST:
            fail(f"stream-mixed {tag}: host_free "
                 f"{eng.kvc.directory.host_free} != {STREAM_HOST} at the end")
        del eng
    outs, dt, st, launches, calls = runs["served"]
    if not calls or not all(calls):
        fail(f"stream-mixed: the fused streamed decode did not run every "
             f"round ({calls})")
    if runs["per-wave"][4]:
        fail("stream-mixed per-wave: stage_mb 0 tried the fused decode")
    ns = len(streamed)
    s_toks = [o.tokens for o in outs[:ns]]
    p_toks = [o.tokens for o in outs[ns:]]
    if [o.tokens for o in runs["per-wave"][0][:ns]] != s_toks:
        fail("stream-mixed: staged + fused tokens differ from per-wave + "
             "per-token tokens")
    if [o.tokens for o in runs["per-wave"][0][ns:]] != p_toks:
        fail("stream-mixed: the pooled tokens changed with stream_stage_mb")
    want = {"K1": st["scheduler"]["decode_batches"] * HORIZON * L,
            "K2": st["engine"]["prefill_dispatches"] * L}
    got = {k: total(v) for k, v in launches.items()}
    if got != want:
        fail(f"stream-mixed: kernel launches {got} != {want} (the pooled "
             f"dispatches' count; streamed lanes launch neither)")
    check_windows("stream-mixed", launches, lambda n: {("int8", 0): n})
    e = st["engine"]
    if e["stream_tokens"] != sum(len(t) - 1 for t in s_toks):
        fail(f"stream-mixed: stream_tokens {e['stream_tokens']}")
    alone = build_engine(cfg, params, STREAM_MIXED, STREAM_MIXED.hbm_tiered,
                         STREAM_HOST)
    a_outs, a_dt = serve_each(alone, reqs[ns:])
    del alone
    if [o.tokens for o in a_outs] != p_toks:
        fail("stream-mixed: the pooled requests' tokens differ from the "
             "same engine serving them without the streamed requests")
    amp = build_engine(cfg, params, STREAM_AMPLE, STREAM_AMPLE.hbm_ample, 0)
    ref, _ = serve_each(amp, [(p, dict(max_new_tokens=STREAM_GEN,
                                       logprobs=2)) for p in streamed])
    del amp
    pw_dt, pw_st = runs["per-wave"][1], runs["per-wave"][2]
    s_n, p_n = sum(map(len, s_toks)), sum(map(len, p_toks))
    print(f"[stream-mixed] {ns} streamed x ({STREAM_PROMPT} + {STREAM_GEN}) "
          f"beside {len(pooled)} pooled x (64 + 64), HBM "
          f"{STREAM_MIXED.hbm_tiered}, host {STREAM_HOST} blocks: served in "
          f"{dt:.2f} s, streamed {s_n} tokens = {s_n / dt:.1f} tok/s, pooled "
          f"{p_n} = {p_n / dt:.1f} tok/s (alone {p_n / a_dt:.1f} tok/s in "
          f"{a_dt:.2f} s) | {stream_record(st)} | fused decode rounds "
          f"{len(calls)} | streamed TTFT p50 "
          f"{p50([o.ttft_ms for o in outs[:ns]]):.1f} ms, TPOT p50 "
          f"{p50([o.tpot_ms for o in outs[:ns]]):.2f} ms | launches {launches}"
          f" == decode_batches x {HORIZON} x {L}, prefill_dispatches x {L}",
          flush=True)
    print(f"[stream-mixed] per-wave (stream_stage_mb 0): {pw_dt:.2f} s, "
          f"{stream_record(pw_st)}; streamed tokens == the served run's, "
          f"pooled tokens == the served run's == served alone", flush=True)
    print(f"[stream-mixed] bf16 streamed against an ample pooled engine "
          f"(recorded): " + against("stream-mixed bf16", s_toks, ref, False),
          flush=True)
    return {"launches": launches, "dt": dt, "streamed_tok_s": s_n / dt,
            "pooled_tok_s": p_n / dt, "stream_s": st["phases"]["stream"]}


def stream_f32(cfg, params, streamed) -> list:
    """The streamed lanes alone at float32 activations against an ample
    pooled engine's, held by the near-tie rule. Returns their tokens."""
    eng = build_engine(cfg, params, STREAM_MIXED, STREAM_MIXED.hbm_tiered,
                       STREAM_HOST)
    outs, dt = serve_each(eng, [(p, dict(max_new_tokens=STREAM_GEN))
                                for p in streamed])
    st = eng.get_statistics()
    del eng
    amp = build_engine(cfg, params, STREAM_AMPLE, STREAM_AMPLE.hbm_ample, 0)
    ref, rdt = serve_each(amp, [(p, dict(max_new_tokens=STREAM_GEN,
                                         logprobs=2)) for p in streamed])
    del amp
    toks = [o.tokens for o in outs]
    print(f"[stream-mixed] f32 activations, streamed alone: {dt:.2f} s "
          f"({stream_record(st)}), ample pooled {rdt:.2f} s; against the "
          f"ample run: " + against("stream-mixed f32", toks, ref, True),
          flush=True)
    return toks


def stream_cancel(cfg, params, streamed, want: list) -> None:
    """Cancel one streamed lane (float32 activations) after its first
    decode round: its blocks free (host_free back where it started) and the
    other lane's tokens equal the run without the cancel bit for bit."""
    eng = build_engine(cfg, params, STREAM_MIXED, STREAM_MIXED.hbm_tiered,
                       STREAM_HOST)
    free0 = eng.kvc.directory.host_free
    victim, keep = (eng.add_request(p, max_new_tokens=STREAM_GEN)
                    for p in streamed)
    req = eng._requests[victim]
    while len(req.output) < 2:
        eng.step()
    out = eng.cancel(victim)
    if out.finish_reason != "cancelled" or victim in eng._streams:
        fail(f"stream cancel: {out.finish_reason}")
    outs = {o.req_id: o for o in eng.run()}
    if outs[keep].tokens != want[1]:
        fail("stream cancel: the other lane's tokens changed")
    if eng.kvc.directory.host_free != free0:
        fail(f"stream cancel: host_free {eng.kvc.directory.host_free} != "
             f"{free0}")
    print(f"[stream-cancel] lane cancelled after {len(out.tokens)} tokens "
          f"(its first decode round); the other lane == the run without the "
          f"cancel; host_free back to {free0}", flush=True)


def stream_session(cfg, params, rng) -> None:
    """A streamed session at float32 activations: turn 1 = 2048 + 32
    (stream-resident after it), turn 2 = 64 new + 32, restored from the
    session's stream blocks, which grow only by the growth; turn 2 against
    a fresh streamed request over the whole history by the near-tie rule."""
    t1 = rng.randint(1, cfg.vocab_size, STREAM_TURN1).tolist()
    new = rng.randint(1, cfg.vocab_size, STREAM_TURN_NEW).tolist()
    eng = build_engine(cfg, params, STREAM_MIXED, STREAM_MIXED.hbm_tiered,
                       STREAM_HOST)
    sid = eng.add_request(t1, max_new_tokens=STREAM_TURN_GEN, session=True)
    out1 = {o.req_id: o for o in eng.run()}[sid]
    sess = eng.get_session(sid)
    bids1 = list(sess.stream_bids or [])
    if not bids1 or not sess.live:
        fail("stream session: turn 1 left no stream-resident session")
    t0 = time.monotonic()
    rid = eng.continue_session(sid, new, max_new_tokens=STREAM_TURN_GEN)
    out2 = {o.req_id: o for o in eng.run()}[rid]
    dt2 = time.monotonic() - t0
    bids2 = list(sess.stream_bids)
    need = -(-(len(sess.tokens) - 1) // BS)
    if (sess.restores != 1 or sess.reprefills or bids2[:len(bids1)] != bids1
            or len(bids2) != need):
        fail(f"stream session: restores {sess.restores}, re-prefills "
             f"{sess.reprefills}, blocks {len(bids1)} -> {len(bids2)} "
             f"(want {need}, the first {len(bids1)} kept)")
    eng.end_session(sid)
    if eng.kvc.directory.host_free != STREAM_HOST:
        fail("stream session: end_session left host blocks held")
    del eng
    fresh = build_engine(cfg, params, STREAM_MIXED, STREAM_MIXED.hbm_tiered,
                         STREAM_HOST)
    ref, rdt = serve_each(fresh, [(t1 + out1.tokens + new,
                                   dict(max_new_tokens=STREAM_TURN_GEN,
                                        logprobs=2))])
    del fresh
    print(f"[stream-session] turn 1 {STREAM_TURN1} + {STREAM_TURN_GEN}: "
          f"{len(bids1)} stream blocks; turn 2 {STREAM_TURN_NEW} new + "
          f"{STREAM_TURN_GEN} restored in {dt2:.2f} s (TTFT "
          f"{out2.ttft_ms:.1f} ms), blocks {len(bids1)} -> {len(bids2)}, "
          f"restores 1; a fresh streamed request over the whole history "
          f"{rdt:.2f} s (TTFT {ref[0].ttft_ms:.1f} ms); turn 2 against it: "
          + against("stream session", [out2.tokens], ref, True), flush=True)


def staged_copy_rate(store, slots, groups) -> tuple[float, float]:
    """(GB, GB/s) of one decode step's staging copies (`stage_layers` of
    `slots` for each (first layer, count) of `groups`) on the device alone:
    the stream first sleeps ~1 s, so that every copy is queued before the
    first event records and the window holds no host dispatch."""
    from cxl_speckv_tpu_torch.runtime.hoststore import stage_layers

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    b0 = store.staged_bytes
    torch.cuda._sleep(2_000_000_000)
    ev[0].record()
    slabs = [stage_layers(store, slots, l0, g, DEV) for l0, g in groups]
    ev[1].record()
    torch.cuda.synchronize()
    del slabs
    gb = (store.staged_bytes - b0) / 1e9
    return gb, gb / (ev[0].elapsed_time(ev[1]) / 1e3)


def link_rate_gb_s(store) -> tuple[float, float]:
    """(GB, GB/s) of one pinned -> device copy of the store's k array,
    timed by CUDA events: the host link's rate for one large copy."""
    dst = torch.empty_like(store.k, device=DEV)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    dst.copy_(store.k, non_blocking=True)
    ev[0].record()
    dst.copy_(store.k, non_blocking=True)
    ev[1].record()
    torch.cuda.synchronize()
    gb = dst.numel() * dst.element_size() / 1e9
    return gb, gb / (ev[0].elapsed_time(ev[1]) / 1e3)


def stream_long(cfg, params, rng) -> dict:
    """stream-long at bf16: 1 x (16384 + 32), per-token decode (over the
    fused budget), no K1 / K2 launch; prefill seconds, decode ms a token,
    staged bytes a decode step and the H2D GB/s they imply (bytes over the
    CUDA-event time of the staging copies), the stream timer's share of
    the step, one step's device anatomy and the link's rate for one large
    copy; against an ample pooled engine, recorded."""
    prompt = rng.randint(1, cfg.vocab_size, STREAM_LONG.prompt).tolist()
    reset_launches()
    eng = build_engine(cfg, params, STREAM_LONG, STREAM_LONG.hbm_tiered,
                       STREAM_LONG_HOST)
    calls = fused_calls(eng)
    store = eng.kvc.store
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rid = eng.add_request(prompt, max_new_tokens=STREAM_LONG.gen)
    req = eng._requests[rid]
    outs = []
    while not req.output:
        outs += eng.step()
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    slots = eng._streams[rid].host_slots.copy()
    store.staged_bytes, store.copy_events = 0, []
    t1 = time.monotonic()
    step_ms = []
    while eng.has_work:
        t = time.monotonic()
        outs += eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t) * 1e3)
    decode_s = time.monotonic() - t1
    launches = read_launches()
    copy_s = sum(a.elapsed_time(b) for a, b in store.copy_events) / 1e3
    steps = len(req.output) - 1
    staged = store.staged_bytes
    # the last step's group gathers again (`_stream_lane`'s staging rule),
    # on the device alone
    L, ec = cfg.num_layers, eng.config.engine
    wave, wt = ec.stream_wave, ec.stream_wave * BS
    n_waves = -(-eng._stream_max_blocks // wave)
    used = -(-(req.num_tokens - 2) // wt)
    ctx_waves = min(n_waves, 1 << (used - 1).bit_length())
    G = max(1, min(L, (ec.stream_stage_mb << 20)
                   // (ctx_waves * wave * store.bytes_per_row)))
    row = np.full(min(used, n_waves) * wave, store.guard_slot)
    row[:min(len(slots), len(row))] = slots[:len(row)]
    dev_gb, dev_rate = staged_copy_rate(
        store, row, [(l0, min(G, L - l0)) for l0 in range(0, L, G)])
    link_gb, link_rate = link_rate_gb_s(store)
    st = eng.get_statistics()
    n_blocks = -(-(len(prompt) + STREAM_LONG.gen) // BS)
    del eng, store
    if len(outs) != 1 or outs[0].finish_reason not in ("length", "eos"):
        fail(f"stream-long: {[o.finish_reason for o in outs]}")
    if any(launches.values()):
        fail(f"stream-long: a streamed request launched {launches}")
    if not calls or any(calls):
        fail(f"stream-long: the decode took the fused path ({calls}); its "
             f"slab is over the budget")
    e = st["engine"]
    step_s = (e["prefill_time_s"] + e["decode_time_s"] + e["stream_time_s"]
              + e["overhead_time_s"])
    amp = build_engine(cfg, params, STREAM_LONG, STREAM_LONG_AMPLE, 0)
    ref, rdt = serve_each(amp, [(prompt, dict(max_new_tokens=STREAM_LONG.gen,
                                              logprobs=2))])
    splits = dict(kernels()["K1"].split_launches)
    del amp
    print(f"[stream-long] 1 x ({STREAM_LONG.prompt} + {STREAM_LONG.gen}), "
          f"{n_blocks} host blocks, chunk {STREAM_LONG.chunk}: prefill "
          f"{prefill_s:.2f} s, decode {decode_s:.2f} s = "
          f"{decode_s / max(steps, 1) * 1e3:.1f} ms a token (step p50 "
          f"{p50([x for x in step_ms if x is not None]):.1f} ms; per-token "
          f"path every round: {len(calls)}); staged "
          f"{staged / max(steps, 1) / 1e9:.3f} GB a decode step, the staging "
          f"copies {copy_s:.3f} s by CUDA events = "
          f"{staged / max(copy_s, 1e-9) / 1e9:.2f} GB/s (the same group "
          f"gathers queued behind a sleep, on the device alone: {dev_gb:.3f} "
          f"GB at {dev_rate:.2f} GB/s; one {link_gb:.2f} GB pinned -> device "
          f"copy: {link_rate:.2f} GB/s); the stream timer "
          f"{e['stream_time_s']:.2f} s of {step_s:.2f} s of steps "
          f"({e['stream_time_s'] / step_s:.3f}) | {stream_record(st)} | no "
          f"K1 / K2 launch", flush=True)
    print(f"[stream-long] against an ample pooled engine ({STREAM_LONG_AMPLE}"
          f" HBM blocks, {rdt:.2f} s, K1 by split count {splits}), "
          f"recorded: " + against("stream-long", [outs[0].tokens], ref,
                                  False), flush=True)
    return {"prefill_s": prefill_s, "decode_ms": decode_s / max(steps, 1) * 1e3,
            "staged_gb": staged / max(steps, 1) / 1e9,
            "h2d_gb_s": staged / max(copy_s, 1e-9) / 1e9,
            "device_gb_s": dev_rate, "link_gb_s": link_rate}


def phase_stream(cfg, params, prompts, peaks) -> dict:
    """The host-streamed path on Llama-3-8B: stream-mixed (bf16 served,
    per-wave, pooled alone, ample; float32 against ample), the streamed
    cancel and session at float32 activations, all on its first
    STREAM_LAYERS layers (the depth cut keeps the script in time), and
    stream-long at full depth (its slab must be over the fused budget).
    Returns the kernel rows and the served stream-mixed run's launches."""
    import dataclasses

    rows = phase_kernels_stream(peaks)
    rng = np.random.RandomState(20)
    streamed = [rng.randint(1, cfg.vocab_size, STREAM_PROMPT).tolist()
                for _ in range(STREAM_LANES)]
    cut, cut_params = first_layers(cfg, params, STREAM_LAYERS)
    mixed = stream_mixed(cut, cut_params, prompts[:STREAM_MIXED.n_req],
                         streamed)
    c32 = dataclasses.replace(cut, dtype="float32")
    want32 = stream_f32(c32, cut_params, streamed)
    stream_cancel(c32, cut_params, streamed, want32)
    stream_session(c32, cut_params, rng)
    long = stream_long(cfg, params, rng)
    return {"rows": rows, "launches": mixed["launches"], "mixed": mixed,
            "long": long}


# ---------------------------------------------------------------------------
# the prefetcher: the LSTM gate, the in-round leg, the automatic horizon
# ---------------------------------------------------------------------------

def lstm_prefetch():
    """The LSTM arm's prefetch: on, depth 2, the LSTM trained online on
    its worker thread, the in-round continue-probability leg."""
    from cxl_speckv_tpu_torch.config import PrefetchConfig

    return PrefetchConfig(enabled=True, depth=PREFETCH_DEPTH,
                          train_online=True, train_async=True,
                          ingraph_pcont=True)


def hold_pcont(eng) -> dict:
    """Wrap the engine's `install_pcont` so that the first round with a
    live lane compares the probabilities the round computed on the card
    with the host predictor's (the CPU) on the post-round histories and
    the weights the card's copy was made from. Returns the record."""
    import copy

    pf = eng.prefetcher
    install = pf.install_pcont
    rec = {}

    def checked(slots, probs):
        live = [i for i, s in enumerate(slots) if s in pf._histories]
        if live and not rec:
            ref = copy.copy(pf.predictor)
            ref.params = eng._lstm_src
            want = ref.continue_probability(
                pf.history_matrix([slots[i] for i in live]),
                eng.eos_token_id)
            got = np.asarray(probs)[live]
            rec.update(lanes=len(live), err=float(np.abs(got - want).max()),
                       p=(float(got.min()), float(got.max())))
        install(slots, probs)

    pf.install_pcont = checked
    return rec


def pcont_leg_cost(eng) -> dict:
    """What the in-round leg adds to a round of BATCH lanes at HORIZON:
    its kernels (torch.profiler, device activity) and device ms, and its
    ms on CUDA events, alone at the served shapes."""
    from torch.profiler import ProfilerActivity, profile

    from cxl_speckv_tpu_torch.prefetcher.lstm import lstm_pcont

    pf = eng.prefetcher
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    hist = torch.randint(0, pf.predictor.n_classes,
                         (BATCH, pf.config.history_len), generator=gen,
                         device=DEV, dtype=torch.int32)
    fresh = torch.randint(0, eng.model_config.vocab_size, (BATCH, HORIZON),
                          generator=gen, device=DEV, dtype=torch.int32)
    eos = int(eng.eos_token_id) % pf.predictor.n_classes
    leg = lambda: lstm_pcont(eng._lstm_dev, hist, fresh, eos)
    ms = time_ms(leg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        leg()
        torch.cuda.synchronize()
    n = us = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += e.count
            us += e.self_device_time_total
    return {"kernels": n, "device_ms": us / 1e3, "ms": ms}


def prefetch_lstm_arm(cfg, params, prompts) -> dict:
    """(a) The serve cell tiered, prefetch off and then on with the LSTM:
    tokens equal, exact launches, the LSTM's counters, the in-round
    probabilities held to the host predictor within PCONT_TOL."""
    L = cfg.num_layers
    runs = {}
    for arm, pf in (("off", None), ("lstm", lstm_prefetch())):
        reset_launches()
        eng = build_engine(cfg, params, SHORT, SHORT.hbm_tiered,
                           SHORT.host_tiered, prefetch=pf)
        rec = hold_pcont(eng) if pf else {}
        outs, dt = serve(eng, prompts, SHORT.gen)
        launches = read_launches()
        st = eng.get_statistics()
        want = {"K1": st["scheduler"]["decode_batches"] * HORIZON * L,
                "K2": st["engine"]["prefill_dispatches"] * L}
        got = {k: total(v) for k, v in launches.items()}
        if got != want:
            fail(f"prefetch-{arm}: kernel launches {got} != expected {want}")
        if len(outs) != SHORT.n_req or any(
                o.finish_reason not in ("length", "eos")
                for o in outs.values()):
            fail(f"prefetch-{arm}: not every request finished")
        toks = sum(len(o.tokens) for o in outs.values())
        runs[arm] = {"tokens": tokens_in_order(outs), "stats": st,
                     "tok_s": toks / dt, "rec": rec, "launches": got,
                     "leg": pcont_leg_cost(eng) if pf else None}
        del eng
    off, on = runs["off"], runs["lstm"]
    if on["tokens"] != off["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(on["tokens"], off["tokens"]))
                if a != b]
        fail(f"prefetch-lstm: tokens differ from the prefetch-off run for "
             f"requests {diff}")
    ps, ph = on["stats"]["prefetch"], on["stats"]["phases"]
    for key in ("ingraph_pcont", "prefetches_issued", "train_steps"):
        if not ps[key] > 0:
            fail(f"prefetch-lstm: {key} = {ps[key]}, expected > 0: {ps}")
    rec = on["rec"]
    if not rec:
        fail("prefetch-lstm: no decode round installed a live lane's "
             "continue probability")
    if rec["err"] > PCONT_TOL:
        fail(f"prefetch-lstm: in-round continue probability against the "
             f"host predictor: max |diff| {rec['err']:.3g} > {PCONT_TOL}")
    p50s = {k: ph.get(k, {}).get("p50_ms", 0.0)
            for k in ("maintain.plan", "maintain.train", "decode.program")}
    tr = on["stats"]["transfer"]
    leg = on["leg"]
    print(f"[prefetch-lstm] tiered, {SHORT.n_req} x ({SHORT.prompt} + "
          f"{SHORT.gen}) on {SHORT.hbm_tiered} HBM blocks: tokens == the "
          f"prefetch-off run for every request; launches {on['launches']} "
          f"exact; ingraph_pcont {ps['ingraph_pcont']}, prefetches_issued "
          f"{ps['prefetches_issued']}, skipped_eos_predicted "
          f"{ps['skipped_eos_predicted']}, skipped_resident "
          f"{ps['skipped_resident']}, train_steps {ps['train_steps']} (last "
          f"loss {ps['last_train_loss']:.4f}), plans {ps['plans']}; up "
          f"{tr['up_transfers']} down {tr['down_transfers']} (prefetch off: "
          f"up {off['stats']['transfer']['up_transfers']} down "
          f"{off['stats']['transfer']['down_transfers']}); hit rate "
          f"{on['stats']['directory']['hit_rate']:.3f} (off "
          f"{off['stats']['directory']['hit_rate']:.3f})", flush=True)
    print(f"[prefetch-lstm] phase p50 (ms): maintain.plan "
          f"{p50s['maintain.plan']:.3f}, maintain.train "
          f"{p50s['maintain.train']:.3f}, decode.program "
          f"{p50s['decode.program']:.2f} (off "
          f"{off['stats']['phases']['decode.program']['p50_ms']:.2f}); "
          f"tok/s {on['tok_s']:.1f} with the LSTM against {off['tok_s']:.1f} "
          f"with prefetch off ({on['tok_s'] / off['tok_s']:.3f}x)",
          flush=True)
    print(f"[prefetch-lstm] in-round continue probability of {rec['lanes']} "
          f"live lanes against the host predictor on the CPU: max |diff| "
          f"{rec['err']:.3g} <= {PCONT_TOL} (values {rec['p'][0]:.6f}.."
          f"{rec['p'][1]:.6f}); the leg adds {leg['kernels']} kernels and "
          f"{leg['device_ms']:.3f} ms of device time to a round of "
          f"{HORIZON} steps ({leg['kernels'] / HORIZON:.2f} kernels a "
          f"step), {leg['ms']:.3f} ms alone on CUDA events", flush=True)
    return {"off_tok_s": off["tok_s"], "lstm_tok_s": on["tok_s"],
            "prefetch": ps, "leg": leg, "pcont_err": rec["err"],
            "launches": on["launches"]}


def default_serve(cfg, params, prompts, gen, **ekw) -> dict:
    """Serve `prompts` on `Engine(cfg, SystemConfig(...))` with every
    default but the EngineConfig fields `ekw`; launches held exact.
    Returns tokens, tok/s, the horizon and the decode.program p50."""
    from cxl_speckv_tpu_torch.config import EngineConfig, SystemConfig
    from cxl_speckv_tpu_torch.engine import Engine

    reset_launches()
    sc = SystemConfig(engine=EngineConfig(**ekw))
    eng = Engine(cfg, sc, params=params, device=DEV)
    outs, dt = serve(eng, prompts, gen)
    st = eng.get_statistics()
    h = sc.engine.decode_horizon
    L = cfg.num_layers
    want = {"K1": st["scheduler"]["decode_batches"] * h * L,
            "K2": st["engine"]["prefill_dispatches"] * L}
    got = {k: total(v) for k, v in read_launches().items()}
    if got != want:
        fail(f"default arm (horizon {h}, {L} layers): kernel launches {got} "
             f"!= expected {want}")
    if len(outs) != len(prompts):
        fail(f"default arm: {len(outs)}/{len(prompts)} requests finished")
    toks = sum(len(o.tokens) for o in outs.values())
    del eng
    return {"tokens": tokens_in_order(outs), "tok_s": toks / dt,
            "horizon": h,
            "round_ms": st["phases"]["decode.program"]["p50_ms"],
            "rounds": st["scheduler"]["decode_batches"]}


def prefetch_default_arm(cfg, params, prompts) -> dict:
    """(b) `EngineConfig()` with its defaults (horizon 0: derived from the
    measured dispatch cost) against the same requests at horizon 32; then
    the step constants of `utils/dispatch.py`: a fused step's ms at the
    full depth and at the first half of the layers, fitted as weight bytes
    / rate + floor."""
    from cxl_speckv_tpu_torch.utils import dispatch

    ps = [p[:SHORT.prompt] for p in prompts[:DEFAULT_REQ]]
    auto = default_serve(cfg, params, ps, DEFAULT_GEN)
    fixed = default_serve(cfg, params, ps, DEFAULT_GEN,
                          decode_horizon=HORIZON)
    if auto["tokens"] != fixed["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(auto["tokens"],
                                                 fixed["tokens"])) if a != b]
        fail(f"default arm: tokens at the derived horizon {auto['horizon']} "
             f"differ from horizon {HORIZON} for requests {diff}")
    dms = dispatch.measured_dispatch_ms(DEV)
    # the fit: BATCH lanes, FIT_ROUNDS fused rounds of HORIZON steps each
    step = {}
    for n in (cfg.num_layers, cfg.num_layers // 2):
        c, p = first_layers(cfg, params, n)
        r = default_serve(c, p, ps, FIT_ROUNDS * HORIZON + 1,
                          decode_horizon=HORIZON)
        step[n] = (dispatch.params_byte_size(p), r["round_ms"] / HORIZON)
    (b1, t1), (b0, t0) = step[cfg.num_layers], step[cfg.num_layers // 2]
    bps = (b1 - b0) / ((t1 - t0) / 1e3)
    floor = t1 - b1 / bps * 1e3
    nbytes = dispatch.params_byte_size(params)
    derived = dispatch.derive_decode_horizon(nbytes, device=DEV)
    print(f"[prefetch-default] EngineConfig() defaults, {DEFAULT_REQ} x "
          f"({SHORT.prompt} + {DEFAULT_GEN}): dispatch cost "
          f"{dms:.4f} ms (measured on {DEV}, `utils/dispatch.py`), weights "
          f"{nbytes / 1e9:.3f} GB -> derived decode_horizon "
          f"{auto['horizon']}; tokens == horizon {HORIZON} for every request; "
          f"tok/s {auto['tok_s']:.1f} at horizon {auto['horizon']}, "
          f"{fixed['tok_s']:.1f} at {HORIZON}", flush=True)
    print(f"[prefetch-default] step constants (decode.program p50 / "
          f"{HORIZON}, {BATCH} lanes, {FIT_ROUNDS} rounds): {cfg.num_layers} "
          f"layers {b1 / 1e9:.3f} GB {t1:.3f} ms a step, {cfg.num_layers // 2} "
          f"layers {b0 / 1e9:.3f} GB {t0:.3f} ms a step -> stream rate "
          f"{bps / 1e9:.1f} GB/s, floor {floor:.3f} ms (in the module: "
          f"{dispatch._STREAM_BPS / 1e9:.1f} GB/s, "
          f"{dispatch._STEP_FLOOR_MS:.3f} ms; the rule derives {derived} "
          f"with them)", flush=True)
    if derived != auto["horizon"]:
        fail(f"default arm: the engine derived {auto['horizon']}, the rule "
             f"{derived}")
    return {"dispatch_ms": dms, "horizon": auto["horizon"],
            "auto_tok_s": auto["tok_s"], "fixed_tok_s": fixed["tok_s"],
            "stream_gb_s": bps / 1e9, "floor_ms": floor}


def phase_prefetch(cfg, params, prompts) -> dict:
    """The prefetcher on the serve's Llama-3-8B at full depth: the LSTM
    arm and the default-config arm (the n-gram seed arm runs in the spec
    phase)."""
    return {"lstm": prefetch_lstm_arm(cfg, params, prompts),
            "default": prefetch_default_arm(cfg, params, prompts)}


# ---------------------------------------------------------------------------
# migrations on the copy stream, and fused rounds
# ---------------------------------------------------------------------------

def card_cache(cfg, hbm: int, host: int):
    """A tiered cache on the card at `cfg`'s KV geometry (INT8, BS)."""
    from cxl_speckv_tpu_torch.config import CacheConfig, KVDtype
    from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache

    return TieredKVCache(
        CacheConfig(block_size=BS, num_hbm_blocks=hbm, num_host_blocks=host,
                    kv_dtype=KVDtype.INT8), cfg, 8, 8, device=DEV)


def random_bytes(arrays, gen) -> None:
    """Random int8 codes and float32 scales in place, drawn on the card
    (pools there, or the pinned store)."""
    for a in arrays:
        if a.dtype == torch.float32:
            a.copy_(torch.rand(a.shape, generator=gen, device=DEV))
        else:
            a.copy_(torch.randint(-127, 128, a.shape, generator=gen,
                                  device=DEV).to(a.dtype))


def busy(stream=None) -> None:
    """Hold `stream` (default: the current one) busy for MIGRATE_SLEEP
    cycles, so that work queued behind it lags the host."""
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        torch.cuda._sleep(MIGRATE_SLEEP)


def migrate_hazards(cfg) -> None:
    """The ordering rules of migrations on the copy stream, on the card,
    each with the stream it guards against held busy: (a) a demote queued
    behind a still-running round that writes its block copies the written
    bytes; (b) a demoted slot stays off the free list while its copy
    waits, the next block lands elsewhere, and the copy reads the old
    bytes; (c) a promote into a slot freed under a still-running round
    that reads it lands after the read; a round reading a slot whose
    promote waits sees the promoted bytes; (d) a streamed stash into a
    host slot that a waiting demote writes lands after it; (e) the batch's
    record holds its tensors while the copies wait."""
    from cxl_speckv_tpu_torch.runtime.hoststore import stash_blocks

    kvc = card_cache(cfg, 8, 16)
    d = kvc.directory
    runs = kvc.store.units(0, cfg.num_layers)
    copy = kvc.copier.stream

    def slot(bid):
        return d.entry(bid).hbm_slot

    def blk(s):
        return [p[:, s].clone() for p in kvc.pools]

    def const(v):
        return [torch.full_like(p[:, 0], v) for p in kvc.pools]

    def same(a, b):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))

    def hblk(h):
        torch.cuda.synchronize()
        return [v[h].clone() for v in runs]

    def demote(bid):
        kvc._demote([bid])
        h = d.entry(bid).host_slot
        kvc.dispatch_migrations()
        return h

    seq = kvc.add_seq()
    kvc.extend_seq(seq, 2 * BS)
    random_bytes(kvc.pools, torch.Generator(device=DEV).manual_seed(5))
    b0, b1 = kvc.pool.seq(seq).blocks
    torch.cuda.synchronize()
    # (a)
    busy()
    for p in kvc.pools:
        p[:, slot(b0)].fill_(7)
    h0 = demote(b0)
    kvc.drain()
    if not same(hblk(h0), const(7)):
        fail("migrate (a): the demote did not copy the bytes the round "
             "before it wrote")
    # (b), (e)
    s1, old1 = slot(b1), blk(slot(b1))
    torch.cuda.synchronize()
    free0 = d.hbm_free
    busy(copy)
    h1 = demote(b1)
    rec = kvc.transfer.inflight[-1]
    if (d.hbm_free != free0 or kvc.transfer.inflight_down != 1
            or rec.done.query() or not rec.keep):
        fail(f"migrate (b, e): demoted slot not held in flight (free "
             f"{d.hbm_free} / {free0}, held {kvc.transfer.inflight_down}, "
             f"done {rec.done.query()}, tensors kept {len(rec.keep)})")
    seq2 = kvc.add_seq()
    kvc.extend_seq(seq2, BS)
    n1 = slot(kvc.pool.seq(seq2).blocks[0])
    if n1 == s1:
        fail("migrate (b): a block was allocated into a slot a demote is "
             "still copying")
    for p in kvc.pools:
        p[:, n1].fill_(9)
    kvc.drain()
    if not same(hblk(h1), old1) or d.hbm_free != free0:
        fail("migrate (b): the demote's bytes or its slot's release")
    # (c): the round reading n1 runs after the promote of b0 is issued
    torch.cuda.synchronize()
    busy()
    seen = blk(n1)
    kvc.free_seq(seq2)
    kvc.ensure_resident([seq])
    if slot(b0) != n1:
        fail(f"migrate (c): set-up: b0 promoted into {slot(b0)}, not {n1}")
    kvc.drain()
    torch.cuda.synchronize()
    if not same(seen, const(9)) or not same(blk(n1), const(7)):
        fail("migrate (c): the promote landed before the round that read "
             "its slot")
    # a round waits for the promote it reads
    demote(b1)
    kvc.drain()
    torch.cuda.synchronize()
    busy(copy)
    kvc.ensure_resident([seq])
    kvc.order_round([slot(b1)])
    seen = blk(slot(b1))
    torch.cuda.synchronize()
    if not same(seen, old1):
        fail("migrate: a round read a promoted slot before its copy landed")
    # (d)
    seq3 = kvc.add_seq()
    kvc.extend_seq(seq3, BS)
    for p in kvc.pools:
        p[:, slot(kvc.pool.seq(seq3).blocks[0])].fill_(11)
    torch.cuda.synchronize()
    busy(copy)
    h3 = demote(kvc.pool.seq(seq3).blocks[0])
    kvc.free_seq(seq3)
    if d.entry(d.allocate_host()).host_slot != h3:
        fail("migrate (d): set-up: the freed host slot was not reused")
    kvc.order_after_migrations()
    slabs = [torch.full((1, *v[h3].shape), 13, dtype=v[h3].dtype, device=DEV)
             for v in runs]
    stash_blocks(kvc.store, slabs, [h3])
    kvc.drain()
    if not same(hblk(h3), [x[0] for x in slabs]):
        fail("migrate (d): a demote's late copy overwrote a streamed stash")
    print("[migrate] ordering on the card (streams held busy "
          f"{MIGRATE_SLEEP} cycles): (a) demote after the round that wrote "
          "it, (b) demoted slot held until its copy completes, (c) promote "
          "after the round reading its slot, a round after the promote it "
          "reads, (d) streamed stash after the migrations in flight, (e) "
          "tensors held while in flight: all held", flush=True)


def migrate_batch_check(cfg) -> dict:
    """One 16-lane batch each way (four demoted slots promoted into in the
    same batch) at `cfg`'s geometry: `copy_batch` on the copy stream
    against `migrate_program` on copies of the same pools and store, byte
    for byte; the copy stream's ms a direction (CUDA events) and both
    versions' host-clock ms."""
    from cxl_speckv_tpu_torch.runtime.hoststore import (
        MIGRATE_BATCH,
        DeviceHostStore,
        copy_batch,
        migrate_program,
        pad_migration,
    )

    kvc = card_cache(cfg, MIGRATE_SLOTS, MIGRATE_SLOTS)
    gen = torch.Generator(device=DEV).manual_seed(6)
    random_bytes(kvc.pools + kvc.store.arrays, gen)
    st = kvc.store
    plain_store = DeviceHostStore(st.host_slots, st.num_layers,
                                  st.k.shape[2], st.k.shape[1],
                                  st.k.shape[3], st.k.dtype, pin=True)
    for a, b in zip(plain_store.arrays, st.arrays):
        a.copy_(b)
    plain_pools = [p.clone() for p in kvc.pools]
    n = MIGRATE_BATCH
    downs = [(i, i) for i in range(n)]
    ups = [(n + 8 + i, i if i < 4 else n + i) for i in range(n)]
    mig = pad_migration(ups, downs, kvc.guard_slot, st.guard_slot)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    migrate_program(plain_pools, plain_store, mig)
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3
    cs = kvc.copier
    cs.timings = []
    t0 = time.monotonic()
    cs.wait_for_compute()
    done, keep = cs.run(lambda mark: copy_batch(kvc.pools, st, mig, mark))
    done.synchronize()
    card_ms = (time.monotonic() - t0) * 1e3
    for tag, got, want in (("pools", kvc.pools, plain_pools),
                           ("store", st.arrays, plain_store.arrays)):
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                fail(f"migrate: copy_batch {tag} differ from "
                     f"migrate_program's")
    down_ms, up_ms = copy_stream_ms(cs.timings)
    gb = n * st.bytes_per_block / 1e9
    print(f"[migrate] one {n}-lane batch each way at {cfg.num_layers} "
          f"layers ({st.bytes_per_block / 1e6:.3f} MB a block, {gb:.4f} GB "
          f"a direction): copy_batch == migrate_program byte for byte "
          f"(pools and store); copy stream: down {down_ms[0]:.4f} ms "
          f"({gb / down_ms[0] * 1e3:.1f} GB/s), up {up_ms[0]:.4f} ms "
          f"({gb / up_ms[0] * 1e3:.1f} GB/s); host clock, issue to "
          f"completion: copy_batch {card_ms:.3f} ms, migrate_program "
          f"{plain_ms:.3f} ms", flush=True)
    del keep
    return {"down_ms": down_ms[0], "up_ms": up_ms[0], "card_ms": card_ms,
            "plain_ms": plain_ms, "gb": gb}


def copy_stream_ms(timings) -> tuple[list, list]:
    """Per batch, the copy stream's ms for its demotes and for its
    promotes (CUDA events at `copy_batch`'s marks), for the batches that
    carried any."""
    down, up = [], []
    for (_, nd, e0), (_, nu, e1), (_, _, e2) in timings:
        if nd:
            down.append(e0.elapsed_time(e1))
        if nu:
            up.append(e1.elapsed_time(e2))
    return down, up


def migrate_arm(cfg, params, prompts, hbm, host, fused=False) -> dict:
    """The serve cell on one engine, launches held exact; the copy
    stream's batches timed."""
    reset_launches()
    eng = build_engine(cfg, params, SHORT, hbm, host,
                       engine_kw={"fused_rounds": fused})
    eng.kvc.copier.timings = []
    outs, dt = serve(eng, prompts, SHORT.gen)
    st = eng.get_statistics()
    L = cfg.num_layers
    want = {"K1": st["scheduler"]["decode_batches"] * HORIZON * L,
            "K2": st["engine"]["prefill_dispatches"] * L}
    got = {k: total(v) for k, v in read_launches().items()}
    tag = "fused" if fused else ("split" if host else "ample")
    if got != want:
        fail(f"migrate {tag}: kernel launches {got} != expected {want}")
    if len(outs) != SHORT.n_req or any(
            o.finish_reason not in ("length", "eos") for o in outs.values()):
        fail(f"migrate {tag}: not every request finished")
    if fused != eng._fused_rounds:
        fail(f"migrate {tag}: _fused_rounds {eng._fused_rounds}")
    down, up = copy_stream_ms(eng.kvc.copier.timings)
    toks = sum(len(o.tokens) for o in outs.values())
    del eng
    return {"tokens": tokens_in_order(outs), "tok_s": toks / dt, "st": st,
            "down_ms": down, "up_ms": up, "launches": got}


def phase_migrate(cfg, params, prompts) -> dict:
    """Migrations on the copy stream and fused rounds, on the serve's
    Llama-3-8B at full width: the ordering checks and one batch against
    `migrate_program` at full depth, then the serve cell on its first
    MIGRATE_LAYERS layers split (the default: batches on the copy stream),
    fused (`fused_rounds=True`: the batch rides the round on its stream)
    and ample; tokens equal in all three, migrations both ways in both
    tiered arms, launches exact."""
    migrate_hazards(cfg)
    batch = migrate_batch_check(cfg)
    cut = first_layers(cfg, params, MIGRATE_LAYERS)
    arms = {"split": migrate_arm(*cut, prompts, SHORT.hbm_tiered,
                                 SHORT.host_tiered),
            "fused": migrate_arm(*cut, prompts, SHORT.hbm_tiered,
                                 SHORT.host_tiered, fused=True),
            "ample": migrate_arm(*cut, prompts, SHORT.hbm_ample, 0)}
    ref = arms["ample"]["tokens"]
    for tag in ("split", "fused"):
        a = arms[tag]
        diff = [i for i, (x, y) in enumerate(zip(a["tokens"], ref)) if x != y]
        if diff:
            fail(f"migrate {tag}: tokens differ from ample for requests "
                 f"{diff}")
        tr = a["st"]["transfer"]
        if not (tr["up_transfers"] > 0 and tr["down_transfers"] > 0):
            fail(f"migrate {tag}: migrated nothing both ways: {tr}")
    for tag, a in arms.items():
        e, tr = a["st"]["engine"], a["st"]["transfer"]
        rt = a["st"]["runtime"]
        med = lambda xs: f"{np.median(xs):.4f}" if xs else "-"
        print(f"[migrate] {tag}: {a['tok_s']:.1f} tok/s, TTFT p50 "
              f"{e['p50_ttft_ms']:.1f} ms, TPOT p50 {e['p50_tpot_ms']:.2f} "
              f"ms | up {tr['up_transfers']} down {tr['down_transfers']} in "
              f"{tr['up_batches']} / {tr['down_batches']} batches, "
              f"{rt['migrate_dispatches']} on the copy stream: ms a batch "
              f"(median) down {med(a['down_ms'])} ({len(a['down_ms'])}), "
              f"up {med(a['up_ms'])} ({len(a['up_ms'])}) | host blocked: "
              f"up_wait_ms {tr['up_wait_ms']:.3f}, down_wait_ms "
              f"{tr['down_wait_ms']:.3f}, polls {tr['polls']} | launches "
              f"{a['launches']}", flush=True)
    print(f"[migrate] split == fused == ample tokens for all {SHORT.n_req} "
          f"requests ({MIGRATE_LAYERS} layers); tiered / ample tok/s: split "
          f"{arms['split']['tok_s'] / arms['ample']['tok_s']:.3f}, fused "
          f"{arms['fused']['tok_s'] / arms['ample']['tok_s']:.3f}",
          flush=True)
    return {"batch": batch, **{k: {"tok_s": v["tok_s"]}
                               for k, v in arms.items()}}


# ---------------------------------------------------------------------------
# the front ends: a checkpoint, the HTTP server, dense scoring
# ---------------------------------------------------------------------------

class ToyTokenizer:
    """Token ids as characters past U+10000, so decode inverts encode on
    every id of a 128256-token vocabulary and a string `stop` taken from
    decoded output encodes back to the same ids; other text maps to ids
    1-250. `apply_chat_template` as in `tests/test_server.py`."""

    def encode(self, s):
        return [ord(c) - 0x10000 if ord(c) >= 0x10000 else ord(c) % 250 + 1
                for c in s]

    def decode(self, ids):
        return "".join(chr(0x10000 + i) for i in ids)

    def apply_chat_template(self, messages, add_generation_prompt=False):
        text = "".join(f"<{m['role']}>{m['content']}" for m in messages)
        return self.encode(text + ("<assistant>" if add_generation_prompt
                                   else ""))


def tree_leaves(tree, prefix=""):
    """(path, tensor) for every tensor of a parameter tree, a quantized
    leaf as its q and s."""
    from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, f"{prefix}{k}/")
        elif isinstance(v, QuantizedTensor):
            yield f"{prefix}{k}:q", v.q
            yield f"{prefix}{k}:s", v.s
        else:
            yield prefix + k, v


def server_checkpoint(params) -> dict:
    """`save_params` of `params` into a temporary directory, then
    `load_params(like=params)` back onto the card: every leaf bit-equal,
    the peak device memory above the tree during the load at most the tree
    plus its largest leaf. Prints the directory's bytes and both times;
    the directory is removed. Returns the loaded tree."""
    import tempfile

    from cxl_speckv_tpu_torch.models import load_params, save_params

    with tempfile.TemporaryDirectory(prefix="speckv-ckpt-") as d:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        save_params(params, d)
        t_save = time.monotonic() - t0
        size = sum(f.stat().st_size for f in Path(d).iterdir())
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        loaded = load_params(d, like=params, device=DEV)
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() - base
    want = dict(tree_leaves(params))
    got = dict(tree_leaves(loaded))
    if list(got) != list(want):
        fail(f"server: the loaded tree's leaves {list(got)} != {list(want)}")
    for key, w in want.items():
        g = got[key]
        if not (g.device.type == torch.device(DEV).type and g.dtype == w.dtype
                and g.shape == w.shape and torch.equal(g, w)):
            fail(f"server: checkpoint leaf {key} differs after the round "
                 f"trip")
    tree = nbytes(*got.values())
    largest = max(nbytes(t) for t in got.values())
    print(f"[server] checkpoint: {len(want)} tensors, {size / 2**30:.3f} GiB "
          f"on disk, saved in {t_save:.2f} s, loaded onto the card in "
          f"{t_load:.2f} s; bit-equal; torch.cuda.max_memory_allocated "
          f"{peak / 2**30:.3f} GiB above the base during the load (tree "
          f"{tree / 2**30:.3f} GiB, largest leaf {largest / 2**30:.3f} GiB)",
          flush=True)
    if peak > tree + largest:
        fail(f"server: the load peaked {peak} bytes above the base, over the "
             f"tree {tree} + its largest leaf {largest}")
    return loaded


def http(port: int, path: str, body=None, timeout=HTTP_TIMEOUT):
    """GET (body None) or POST JSON; returns (status, the response's bytes).
    A timeout or a refused connection raises."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_json(port: int, path: str, body=None) -> dict:
    """`http`, failing the phase on any status but 200."""
    code, raw = http(port, path, body)
    if code != 200:
        fail(f"server: {path} answered {code}: {raw[:300]!r}")
    return json.loads(raw)


def http_stream(port: int, body: dict) -> list:
    """A streamed completion: the chunks' tokens concatenated; fails
    without the closing [DONE]."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    toks = []
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
        for line in r:
            line = line.decode().strip()
            if line == "data: [DONE]":
                return toks
            if line.startswith("data: "):
                toks.extend(json.loads(line[6:])["tokens"])
    fail(f"server: a stream ended without [DONE] after {len(toks)} tokens")


def concurrent_clients(fn, n: int) -> list:
    """fn(i) on n threads at once; returns the results in order. A client
    that raised or did not finish within HTTP_TIMEOUT fails the phase."""
    import threading

    results, errors = [None] * n, []

    def go(i):
        try:
            results[i] = fn(i)
        except (Exception, SystemExit) as e:   # reported on the main thread
            errors.append(f"client {i}: {e!r}")
    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT)
    if errors or any(t.is_alive() for t in threads):
        fail(f"server: clients failed or timed out: {errors}")
    return results


@contextlib.contextmanager
def counting_plain():
    """Counts the calls of K1's and K2's plain versions from their
    wrappers while the context is open (a wrapper calls its plain version
    only for tensors on the CPU); yields the Counter."""
    from collections import Counter

    kernels()        # imports both wrappers' modules
    mod = lambda name: sys.modules[f"cxl_speckv_tpu_torch.ops.{name}"]
    calls = Counter()
    saved = [(mod("paged_attention"), "paged_attention_ref"),
             (mod("chunk_attention_cuda"), "paged_chunk_attention")]
    originals = [getattr(m, n) for m, n in saved]

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call
    for (m, n), fn in zip(saved, originals):
        setattr(m, n, counted(n, fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(saved, originals):
            setattr(m, n, fn)


def count_steps(eng) -> list:
    """Wraps `eng.step` to record, at each step, the requests live in the
    engine (running + waiting); returns that list."""
    live, step = [], eng.step

    def counted():
        live.append(eng.scheduler.num_running + eng.scheduler.num_waiting)
        return step()
    eng.step = counted
    return live


def server_disconnect(srv, eng, prompt) -> str:
    """A streaming client (max_tokens SERVER_LONG, ignore_eos) that closes
    its socket after the first chunk: its request must end "cancelled",
    and the free HBM and host block counts return to their values before
    it. Returns a summary."""
    import socket

    before = http_json(srv.port, "/v1/stats")
    body = json.dumps({"prompt": prompt, "max_tokens": SERVER_LONG,
                       "stream": True, "ignore_eos": True}).encode()
    with socket.create_connection(("127.0.0.1", srv.port),
                                  timeout=HTTP_TIMEOUT) as s:
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        got = b""
        while b"data: " not in got:
            chunk = s.recv(4096)
            if not chunk:
                fail("server: the stream closed before its first chunk")
            got += chunk
    deadline = time.monotonic() + HTTP_TIMEOUT
    req = None
    while time.monotonic() < deadline:
        req = next((r for r in list(eng._requests.values())
                    if r.prompt == prompt), None)
        if req is not None and req.finish_reason and not eng.has_work:
            break
        time.sleep(0.05)
    if req is None or req.finish_reason != "cancelled":
        fail(f"server: the disconnected request ended "
             f"{None if req is None else req.finish_reason!r}, not "
             f"'cancelled'")
    after = http_json(srv.port, "/v1/stats")
    free = {k: (before[k], after[k]) for k in ("hbm_free", "host_free")}
    if any(a != b for a, b in free.values()):
        fail(f"server: free blocks (before, after) a disconnect: {free}")
    return (f"disconnect after the first chunk: cancelled at "
            f"{len(req.output)} of {SERVER_LONG} tokens; free blocks back "
            f"(hbm, host) {free['hbm_free'][1]}, {free['host_free'][1]}")


def server_http(cfg, params, prompts) -> None:
    """The HTTP server on an engine of `params`: 16 concurrent greedy
    clients held to the same requests through the engine API (equal, or a
    first divergence at a dense top-2 gap <= NEAR_TIE_GAP); a prompt
    streamed alone == non-streamed alone, also with a matching string
    `stop` (the holdback path); a disconnect; n = 3 sampled choices; a chat
    completion, /health, /metrics, /v1/stats. K1 / K2 launched over the
    served requests and no plain version."""
    from cxl_speckv_tpu_torch.server import SpeckvServer

    cell, ps = SERVER_CELL, prompts[:SERVER_CELL.n_req]
    tok = ToyTokenizer()
    api = build_engine(cfg, params, cell, cell.hbm_tiered, cell.host_tiered)
    api_live = count_steps(api)
    outs, dt_api = serve(api, ps, SERVER_GEN)
    want = [outs[i] for i in sorted(outs)]
    api_lat = [(r.finish_time - r.arrival_time) * 1e3
               for r in api._requests.values()]
    del api
    eng = build_engine(cfg, params, cell, cell.hbm_tiered, cell.host_tiered)
    http_live = count_steps(eng)
    reset_launches()
    with counting_plain() as plain_calls, SpeckvServer(
            eng, host="127.0.0.1", port=0, tokenizer=tok) as srv:
        def client(i):
            t = time.monotonic()
            out = http_json(srv.port, "/v1/completions",
                            {"prompt": ps[i], "max_tokens": SERVER_GEN})
            return out, (time.monotonic() - t) * 1e3
        t0 = time.monotonic()
        got, http_lat = zip(*concurrent_clients(client, len(ps)))
        dt_http = time.monotonic() - t0
        steps_http = list(http_live)
        exact, notes = 0, []
        for i, (g, w) in enumerate(zip(got, want)):
            j = first_divergence(g["tokens"], w.tokens)
            if j is None:
                exact += 1
                continue
            gap = top2_gap(cfg, params, ps[i] + w.tokens[:j])
            notes.append(f"client {i} diverges at token {j}, top-2 gap "
                         f"{gap:.4f}")
            if gap > NEAR_TIE_GAP:
                fail(f"server: client {i} diverges from the engine API at "
                     f"token {j} at a top-2 gap of {gap:.4f} (limit "
                     f"{NEAR_TIE_GAP})")
        p = ps[0][::-1]
        full = http_json(srv.port, "/v1/completions",
                         {"prompt": p, "max_tokens": SERVER_GEN})
        streamed = http_stream(srv.port, {"prompt": p,
                                          "max_tokens": SERVER_GEN})
        t = full["tokens"]
        j = next(k for k in range(len(t) - 1) if t[k:k + 2] == t[10:12])
        stop = tok.decode(t[10:12])
        cut = http_json(srv.port, "/v1/completions",
                        {"prompt": p, "max_tokens": SERVER_GEN, "stop": stop})
        cut_streamed = http_stream(srv.port, {"prompt": p,
                                              "max_tokens": SERVER_GEN,
                                              "stop": [stop]})
        if streamed != t or cut["tokens"] != t[:j] or cut_streamed != t[:j] \
                or cut["finish_reason"] != "stop":
            fail(f"server: streamed {streamed} / non-streamed {t}; with the "
                 f"stop {t[10:12]}: {cut_streamed} / {cut['tokens']} "
                 f"({cut['finish_reason']}), want {t[:j]}")
        disconnect = server_disconnect(srv, eng, ps[1][::-1])
        ch = http_json(srv.port, "/v1/completions",
                       {"prompt": ps[2][::-1], "max_tokens": 16,
                        "temperature": 0.9, "n": 3})["choices"]
        if len(ch) != 3 or len({tuple(c["tokens"]) for c in ch}) < 2:
            fail(f"server: n = 3 gave {[c['tokens'] for c in ch]}")
        chat = http_json(srv.port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hello"}],
            "max_tokens": 8})
        if chat["object"] != "chat.completion" or len(chat["tokens"]) != 8:
            fail(f"server: chat completion {chat}")
        if http_json(srv.port, "/health") != {"status": "ok"}:
            fail("server: /health")
        http_json(srv.port, "/v1/stats")          # JSON, or the phase fails
        code, raw = http(srv.port, "/metrics")
        lines = raw.decode().strip().splitlines()
        try:
            gauges = {n: float(v) for n, v in
                      (ln.rsplit(" ", 1) for ln in lines)}
        except ValueError as e:
            fail(f"server: a /metrics line does not parse: {e}")
        if code != 200 or len(gauges) != len(lines) or not gauges:
            fail(f"server: /metrics answered {code} with {len(lines)} lines")
        if not srv.loop.alive:
            fail("server: the serving loop thread died")
    launches = read_launches()
    k1, k2 = total(launches["K1"]), total(launches["K2"])
    if not (k1 > 0 and k2 > 0) or sum(plain_calls.values()):
        fail(f"server: K1 / K2 launches {k1} / {k2} (CUDA), plain-version "
             f"calls {dict(plain_calls)}")
    print(f"[server] {len(ps)} concurrent clients x (64 + {SERVER_GEN}): "
          f"{exact}/{len(ps)} token-identical to the engine API"
          + (f" ({'; '.join(notes)})" if notes else "")
          + f"; {dt_http:.2f} s over HTTP against {dt_api:.2f} s through "
          f"the engine API; TTFT p50 {p50([g['ttft_ms'] for g in got]):.1f} "
          f"ms over HTTP / {p50([o.ttft_ms for o in want]):.1f} ms engine "
          f"API, TPOT p50 {p50([g['tpot_ms'] for g in got]):.2f} / "
          f"{p50([o.tpot_ms for o in want]):.2f} ms (the engine's own "
          f"clocks: TTFT starts at add_request, which a client reaches only "
          f"when the loop's lock is free); request latency p50 "
          f"{p50(http_lat):.1f} ms (client clock, POST to response; max "
          f"{max(http_lat):.1f}) / {p50(api_lat):.1f} ms (arrival to "
          f"finish; max {max(api_lat):.1f}); engine steps {len(steps_http)} "
          f"/ {len(api_live)}, requests live at a step at most "
          f"{max(steps_http)} / {max(api_live)} (HTTP / engine API)",
          flush=True)
    print(f"[server] streamed == non-streamed ({len(t)} tokens), and with "
          f"a matching string stop ({j} tokens, finish 'stop'); "
          f"{disconnect}; n = 3 choices distinct; chat, /health, /metrics "
          f"({len(gauges)} gauges), /v1/stats JSON; K1 {k1}, K2 {k2} CUDA "
          f"launches, no plain-version call; the loop thread alive",
          flush=True)


def server_scoring(cfg, params) -> None:
    """`Engine.score_prompts` (dense) on SCORE_LENS prompts against the
    echo prompt logprobs of the same prompts: at float32 activations over
    BF16 KV, the reference's own pairing and tolerance
    (`tests/test_logprobs.py:test_prompt_logprobs_match_dense_across_chunks`),
    held within ECHO_TOL; over INT8 KV at float32 and at bf16 activations
    (the served scheme), recorded. Prints the seconds and peak device
    memory of each scoring call above its engine."""
    import dataclasses

    rng = np.random.RandomState(15)
    seqs = [rng.randint(1, cfg.vocab_size, n).tolist() for n in SCORE_LENS]
    c32 = dataclasses.replace(cfg, dtype="float32")
    cell = SCORE_CELL
    res = {}
    for tag, c, kv in (("f32 bf16-kv", c32, "bf16"), ("f32 int8-kv", c32,
                                                      "int8"),
                       ("bf16 int8-kv", cfg, "int8")):
        eng = build_engine(c, params, cell, cell.hbm_ample, 0, kv=kv)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        scores = eng.score_prompts(seqs)
        secs = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() - base
        echo, _ = serve_each(eng, [(x, dict(max_new_tokens=1,
                                            prompt_logprobs=True))
                                   for x in seqs])
        del eng
        if [len(x) for x in scores] != [n - 1 for n in SCORE_LENS] or not \
                all(np.isfinite(x).all() for x in scores):
            fail(f"server: score_prompts {tag} gave lengths "
                 f"{[len(x) for x in scores]} or non-finite values")
        res[tag] = max(float(np.abs(np.array(x) - np.array(
            o.prompt_logprobs[1:])).max()) for x, o in zip(scores, echo))
        print(f"[server] score_prompts (dense), {tag}: {len(seqs)} prompts "
              f"of {'/'.join(map(str, SCORE_LENS))} tokens in {secs:.2f} s, "
              f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB above "
              f"the engine; max |score - echo prompt logprob| "
              f"{res[tag]:.5f}" + (f" (held <= {ECHO_TOL})" if tag ==
                                   "f32 bf16-kv" else " (recorded)"),
              flush=True)
    if res["f32 bf16-kv"] > ECHO_TOL:
        fail(f"server: dense scores differ from the BF16-KV echo by "
             f"{res['f32 bf16-kv']} at float32 activations, above {ECHO_TOL}")


def phase_server(cfg, params, prompts) -> None:
    """The front ends on `cfg` (Llama-3-8B's first SERVER_LAYERS layers): a
    checkpoint round trip, the HTTP server on the loaded tree, and dense
    scoring."""
    loaded = server_checkpoint(params)
    server_http(cfg, loaded, prompts)
    server_scoring(cfg, loaded)


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
    fam_rows = timed("kernels families", phase_kernels_families, peaks)
    probe_entries = timed("anatomy probes", phase_probe, peaks)
    launches, cfg, params, prompts = timed("serve", phase_serve)
    timed("anatomy", phase_anatomy, "Llama-3-8B", cfg, params, prompts, peaks)
    cut = first_layers(cfg, params, SCHEME_LAYERS)
    int4_launches, mixed_launches = timed(
        "serve-int4, serve-mixed", phase_serve_schemes, *cut, prompts)
    timed("anatomy int4", phase_anatomy,
          f"Llama-3-8B INT4 ({SCHEME_LAYERS} layers)", *cut,
          prompts, peaks, matmuls=False, kv="int4")
    timed("anatomy mixed", phase_anatomy,
          f"Llama-3-8B INT8/FP8 layers ({SCHEME_LAYERS} layers)", *cut,
          prompts, peaks, matmuls=False,
          layer_kv=MIXED_LAYERS * (SCHEME_LAYERS // 2))
    del cut
    timed("switch", phase_switch, cfg, params, prompts)
    spec = timed("spec", phase_spec, *first_layers(cfg, params, SPEC_LAYERS),
                 prompts, peaks)
    surface = timed("surface", phase_surface,
                    *first_layers(cfg, params, SURFACE_LAYERS), prompts, peaks)
    stream = timed("stream", phase_stream, cfg, params, prompts, peaks)
    timed("prefetch", phase_prefetch, cfg, params, prompts)
    timed("migrate", phase_migrate, cfg, params, prompts)
    timed("server", phase_server, *first_layers(cfg, params, SERVER_LAYERS),
          prompts)
    del params
    gemma_launches, gemma_long_launches = timed("gemma2", phase_gemma, peaks)
    mistral_launches = timed("mistral", phase_mistral)
    gpt_launches = timed("gpt-oss", phase_gpt_oss, peaks)
    fam_launches = {"qwen3": timed("qwen3", phase_qwen3),
                    "gemma3": timed("gemma3", phase_gemma3),
                    "qwen3-moe": timed("qwen3-moe", phase_qwen3_moe, peaks),
                    "qwen2-moe": timed("qwen2-moe", phase_qwen2_moe, peaks),
                    "phi3": timed("phi3-hf", phase_phi3_hf)}
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
                                draft["rounds"] * SPEC_LAYERS))
    # the surface phase's new shapes, launches from its tiered session run
    # (K2: the prefill dispatches of turns 2 and 3 x 32 layers)
    entries.append(kernel_entry("paged_attention llama-3-8b sessions", "K1",
                                surface["rows"]["K1"],
                                total(surface["launches"]["K1"])))
    entries.append(kernel_entry(
        "paged_chunk_attention llama-3-8b session turn", "K2",
        surface["rows"]["K2"], surface["turn_k2"]))
    # the stream phase's pooled shapes, launches from its served
    # stream-mixed run (the streamed lanes launch neither kernel)
    for key, kname in (("K1", "paged_attention"),
                       ("K2", "paged_chunk_attention")):
        entries.append(kernel_entry(f"{kname} llama-3-8b stream-mixed", key,
                                    stream["rows"][key],
                                    total(stream["launches"][key])))
    # the families served from their configs, launches from each tiered
    # serve
    for key, kname in (("K1", "paged_attention"),
                       ("K2", "paged_chunk_attention")):
        for fam, row, label in (("qwen3", "qwen3", "qwen3-8b"),
                                ("qwen3-moe", "qwen3-moe", "qwen3-30b-a3b"),
                                ("phi3", "phi3", "phi3-mini hf"),
                                ("qwen2-moe", "qwen2", "qwen2-57b-a14b")):
            entries.append(kernel_entry(f"{kname} {label}", key,
                                        fam_rows[f"{key} {row}"],
                                        total(fam_launches[fam][key])))
        for tag, window, label in (("win", GEMMA3_WINDOW, "sliding"),
                                   ("glob", 0, "global")):
            entries.append(kernel_entry(
                f"{kname} gemma3-12b {label}", key,
                fam_rows[f"{key} gemma3 {tag}"],
                fam_launches["gemma3"][key].get(("int8", window), 0)))
    # Qwen2's 37-token tail chunk (259 rows), launches from the qwen2-moe
    # warm-up's second prefill dispatch
    entries.append(kernel_entry(
        f"paged_chunk_attention qwen2-57b-a14b tail T={QWEN2_TAIL}", "K2",
        fam_rows["K2 qwen2 tail"], fam_launches["qwen2-moe"]["tail"]))
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
