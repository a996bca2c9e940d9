"""Token sampling on the device: greedy / temperature / top-k / top-p, and
the sampling-penalty plane.

Counterpart of `cxl_speckv_tpu/engine/sampling.py`. Per-lane sampling
metadata rides one int32 word (`encode_sampling` / `decode_sampling`,
bit-exact with the JAX package): temperature*1000 in the low 15 bits,
top_p*1000 in bits 16..30.

Random draws take an explicit `torch.Generator`. They are not JAX's
threefry bits, so sampled lanes agree with the JAX package in distribution,
greedy lanes token for token.
"""

from __future__ import annotations

import torch


def encode_sampling(temperature: float, top_p: float = 1.0) -> int:
    """Host-side: pack (temperature, top_p) into one int32 metadata word."""
    t = max(0, min(int(round(temperature * 1000)), 0x7FFF))
    p = top_p if 0.0 < top_p < 1.0 else 0.0  # 0 or >= 1 -> nucleus off
    pm = max(0, min(int(round(p * 1000)), 1000))
    return t | (pm << 16)


def decode_sampling(col: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 metadata word(s) -> (temperatures, top_ps) float32."""
    temps = (col & 0x7FFF).float() * 1e-3
    top_ps = ((col >> 16) & 0x7FFF).float() * 1e-3
    return temps, top_ps


# ---------------------------------------------------------------------------
# sampling penalties (OpenAI frequency / presence, HF / vLLM repetition)
#
# Per-request token statistics live in a device plane `pen_counts` int32
# [penalty_rows + 1, vocab] (the last row is the guard of unpenalized lanes),
# one row per penalized request, allocated by the engine. Each cell packs:
#   bits 0..23 -- times the token was SAMPLED this request (frequency /
#                 presence, OpenAI output-only semantics)
#   bit 24     -- the token appeared in this request's PREFILLED prompt
#                 (repetition spans prompt + output, vLLM semantics)
# The counts update on the device (a scatter-add at sample time, a
# scatter-max when the prompt is prefilled), in place, so fused multi-token
# decode pays no host round trip and no function here synchronizes.
#
# Per-lane metadata rides `pen_info` int32 [B, 5]:
#   col 0 = pen_counts row (the guard row for unpenalized lanes)
#   col 1 = frequency_penalty * 1000    (signed)
#   col 2 = presence_penalty  * 1000    (signed)
#   col 3 = repetition_penalty * 100    (0 = off)
#   col 4 = flags: bit 0 = reset the row before use (the first prefill chunk
#           of a request: fresh slots, session turns, preemption restarts),
#           bit 1 = count this dispatch's sampled token (set on the
#           prompt-completing prefill chunk only; earlier chunks' sampled
#           tokens are discarded on the host and must not count)
# The arithmetic is the JAX package's, operation for operation, so the two
# agree bit for bit on the same inputs.
# ---------------------------------------------------------------------------

PEN_PROMPT_BIT = 1 << 24
PEN_COUNT_MASK = PEN_PROMPT_BIT - 1


def encode_pen_info(row: int, frequency_penalty: float = 0.0,
                    presence_penalty: float = 0.0,
                    repetition_penalty: float = 0.0,
                    reset: bool = False, count_sampled: bool = True) -> list:
    """Host-side: one pen_info row (see the layout above). A repetition
    penalty <= 0 or == 1.0 encodes as 0 (off)."""
    rp = repetition_penalty if repetition_penalty > 0 else 0.0
    if abs(rp - 1.0) < 1e-9:
        rp = 0.0
    return [row, int(round(frequency_penalty * 1000)),
            int(round(presence_penalty * 1000)), int(round(rp * 100)),
            (1 if reset else 0) | (2 if count_sampled else 0)]


def apply_penalties(logits: torch.Tensor, rows: torch.Tensor,
                    fp: torch.Tensor, pp: torch.Tensor,
                    rp: torch.Tensor) -> torch.Tensor:
    """logits [B, V] float32; rows = the lanes' pen_counts rows [B, V]
    int32; fp / pp / rp [B] float32 (rp == 0 means off). A lane with
    fp == pp == 0 and rp off passes through bit-identically (x - 0.0 == x,
    and `where` selects the untouched input)."""
    cnt = (rows & PEN_COUNT_MASK).to(logits.dtype)
    out_seen = cnt > 0
    logits = (logits - fp[:, None] * cnt
              - pp[:, None] * out_seen.to(logits.dtype))
    rp_on = (rp > 0.0)[:, None]
    seen = out_seen | (rows >= PEN_PROMPT_BIT)
    r = torch.where(rp_on, torch.clamp_min(rp[:, None], 1e-3),
                    torch.ones_like(rp[:, None]))
    shrunk = torch.where(logits > 0, logits / r, logits * r)
    return torch.where(seen & rp_on, shrunk, logits)


def penalize_and_count(logits: torch.Tensor, pen_info: torch.Tensor,
                       pen_counts: torch.Tensor, sample_fn):
    """Gather each lane's statistics row, penalize the logits, sample with
    `sample_fn(penalized_logits) -> tokens [B]`, then add the sampled
    tokens into the plane in place (a lane whose flag bit 1 is clear, or
    that points at the guard row, adds into the guard row, which no
    penalized lane reads). Returns (tokens, pen_counts)."""
    guard = pen_counts.shape[0] - 1
    slots = pen_info[:, 0].long()
    fp = pen_info[:, 1].float() * 1e-3
    pp = pen_info[:, 2].float() * 1e-3
    rp = pen_info[:, 3].float() * 1e-2
    rows = pen_counts[slots]
    toks = sample_fn(apply_penalties(logits.float(), rows, fp, pp, rp))
    count = (pen_info[:, 4] & 2) != 0
    dst = torch.where(count, slots, torch.full_like(slots, guard))
    pen_counts.index_put_((dst, toks.long()),
                          torch.ones_like(dst, dtype=pen_counts.dtype),
                          accumulate=True)
    return toks, pen_counts


def pen_reset_rows(pen_info: torch.Tensor,
                   pen_counts: torch.Tensor) -> torch.Tensor:
    """Zero the rows whose flag bit 0 is set (a request's first prefill
    chunk), in place; unflagged lanes zero the guard row, which is
    harmless."""
    guard = pen_counts.shape[0] - 1
    dst = torch.where((pen_info[:, 4] & 1) != 0, pen_info[:, 0],
                      torch.full_like(pen_info[:, 0], guard)).long()
    pen_counts[dst] = 0
    return pen_counts


def pen_mark_prompt(pen_info: torch.Tensor, pen_counts: torch.Tensor,
                    token_ids: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Set the prompt-presence bit of this chunk's prompt tokens
    (token_ids [B, T]; positions >= valid[b] go to the guard row), in place:
    each cell becomes max(cell, PEN_PROMPT_BIT), the JAX scatter-max."""
    guard = pen_counts.shape[0] - 1
    B, T = token_ids.shape
    rows = pen_info[:, 0, None].expand(B, T).long()
    inside = torch.arange(T, device=token_ids.device)[None, :] < valid[:, None]
    rows = torch.where(inside, rows, torch.full_like(rows, guard))
    flat = (rows * pen_counts.shape[1] + token_ids.long()).reshape(-1)
    pen_counts.view(-1).scatter_reduce_(
        0, flat, torch.full_like(flat, PEN_PROMPT_BIT, dtype=pen_counts.dtype),
        reduce="amax")
    return pen_counts


def sample_tokens_penalized(logits: torch.Tensor, temperatures: torch.Tensor,
                            generator: torch.Generator | None,
                            pen_info: torch.Tensor, pen_counts: torch.Tensor,
                            top_k: int = 0,
                            top_ps: torch.Tensor | None = None,
                            sampled: bool = True):
    """`sample_tokens` with the penalty step (`penalize_and_count`).
    Returns (tokens [B], pen_counts updated in place)."""
    return penalize_and_count(
        logits, pen_info, pen_counts,
        lambda lg: sample_tokens(lg, temperatures, generator, top_k, top_ps,
                                 sampled))


def nucleus_filter(probs: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Zero out tokens outside the smallest set whose probability mass
    reaches top_p (ties at the threshold kept), renormalized. Lanes with
    top_p <= 0 or >= 1 pass through unchanged."""
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    first = (csum >= top_ps[..., None]).int().argmax(dim=-1)  # first covering
    thr = torch.gather(sp, -1, first[..., None])
    active = ((top_ps > 0.0) & (top_ps < 1.0))[..., None]
    filt = torch.where(active & (probs < thr), torch.zeros_like(probs), probs)
    return filt / torch.clamp_min(filt.sum(dim=-1, keepdim=True), 1e-20)


def sample_tokens(logits: torch.Tensor, temperatures: torch.Tensor,
                  generator: torch.Generator | None, top_k: int = 0,
                  top_ps: torch.Tensor | None = None,
                  sampled: bool = True) -> torch.Tensor:
    """Sampled token ids [B] (int64). Lanes with temperature <= 0 take the
    argmax. `sampled=False` promises that no lane samples: then only the
    argmax runs, with no random draw. top_ps [B] (0 or >= 1 = off) applies
    the nucleus filter; None skips it."""
    greedy = logits.argmax(dim=-1)
    if not sampled:
        return greedy
    scaled = logits / torch.clamp_min(temperatures, 1e-6)[:, None]
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if top_ps is not None:
        kept = nucleus_filter(torch.softmax(scaled, dim=-1), top_ps)
        scaled = scaled.masked_fill(kept <= 0.0, float("-inf"))
    # Gumbel-max: argmax(scaled + Gumbel noise) ~ Categorical(softmax(scaled))
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    draw = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temperatures <= 0.0, greedy, draw)
