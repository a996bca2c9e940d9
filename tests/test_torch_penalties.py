"""Sampling penalties (OpenAI frequency / presence, HF / vLLM repetition) on
the port: the pen plane of `engine/sampling.py` against the JAX package bit
for bit on seeded numpy inputs, the pooled-path cases of
`tests/test_penalties.py` (the penalized fused decode against a host
step-by-step reference, guard-row isolation, horizons, tiering, row reuse,
the prefix-cache skip, session turns, validation, spec refusal), and a
penalized serve against the JAX engine: the same tokens and the same
penalty rows of the plane, bit for bit (float32 attention compute)."""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import CFG, PARAMS
from torch_surface import F32, JF32, V, engine, jax_engine, run_one

from cxl_speckv_tpu.engine import sampling as js
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.engine import sampling as ts
from cxl_speckv_tpu_torch.engine.sampling import (
    PEN_COUNT_MASK,
    PEN_PROMPT_BIT,
    apply_penalties,
    encode_pen_info,
    pen_mark_prompt,
    pen_reset_rows,
    penalize_and_count,
)
from cxl_speckv_tpu_torch.models.llama import (
    decode_multi,
    decode_step,
    prefill_chunk,
)
from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache


def seeded_plane(seed, B=6, vocab=300, rows=4):
    """logits [B, V], a plane with counts and prompt bits (the guard row
    too), and pen_info rows over every kind of lane: penalized, off,
    guard-pointing, count flag clear, reset flag set."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, vocab) * 3).astype(np.float32)
    plane = rng.randint(0, 6, (rows + 1, vocab)).astype(np.int32)
    plane[rng.rand(rows + 1, vocab) < 0.2] |= PEN_PROMPT_BIT
    kinds = [(0.5, 0.25, 1.3), (0.0, 0.0, 0.0), (-1.0, 2.0, 0.8),
             (1.2, 0.0, 0.0), (0.0, 0.0, 1.9), (0.3, -0.4, 0.0)]
    info = np.array([encode_pen_info(
        [0, 1, rows, 2, 3, 0][b], *kinds[b % len(kinds)], reset=b == 3,
        count_sampled=b != 2) for b in range(B)], np.int32)
    return logits, plane, info


def jax_and_port(fn_j, fn_t, *arrays):
    return (np.asarray(fn_j(*map(jnp.asarray, arrays))),
            fn_t(*(torch.from_numpy(np.array(a)) for a in arrays)).numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_penalties_bitwise_jax(seed):
    logits, plane, info = seeded_plane(seed)
    rows = plane[info[:, 0]]
    fp = info[:, 1].astype(np.float32) * np.float32(1e-3)
    pp = info[:, 2].astype(np.float32) * np.float32(1e-3)
    rp = info[:, 3].astype(np.float32) * np.float32(1e-2)
    want, got = jax_and_port(js.apply_penalties, ts.apply_penalties,
                             logits, rows, fp, pp, rp)
    assert (want.view(np.uint32) == got.view(np.uint32)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_penalize_and_count_bitwise_jax(seed):
    logits, plane, info = seeded_plane(seed)
    jt, jpc = js.penalize_and_count(jnp.asarray(logits), jnp.asarray(info),
                                    jnp.asarray(plane),
                                    lambda lg: jnp.argmax(lg, -1))
    tt, tpc = penalize_and_count(torch.from_numpy(logits),
                                 torch.from_numpy(info),
                                 torch.from_numpy(plane.copy()),
                                 lambda lg: lg.argmax(-1))
    assert (np.asarray(jt) == tt.numpy()).all()
    assert (np.asarray(jpc) == tpc.numpy()).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_reset_and_mark_prompt_bitwise_jax(seed):
    """Reset then mark over cells that hold counts and prompt bits (the mark
    is a scatter-max, as in the JAX package)."""
    _, plane, info = seeded_plane(seed)
    rng = np.random.RandomState(seed + 10)
    ids = rng.randint(0, plane.shape[1], (len(info), 24)).astype(np.int32)
    valid = rng.randint(0, 25, len(info)).astype(np.int32)
    want = np.asarray(js.pen_mark_prompt(
        jnp.asarray(info), js.pen_reset_rows(jnp.asarray(info),
                                             jnp.asarray(plane)),
        jnp.asarray(ids), jnp.asarray(valid)))
    t = torch.from_numpy(plane.copy())
    got = pen_mark_prompt(torch.from_numpy(info),
                          pen_reset_rows(torch.from_numpy(info), t),
                          torch.from_numpy(ids), torch.from_numpy(valid))
    assert got is t and (got.numpy() == want).all()


def test_sample_tokens_penalized_greedy_bitwise_jax():
    """The fused single-step form on greedy lanes: the JAX package's tokens
    and plane."""
    import jax

    logits, plane, info = seeded_plane(3)
    temps = np.zeros(len(info), np.float32)
    jt, jpc = js.sample_tokens_penalized(
        jnp.asarray(logits), jnp.asarray(temps), jax.random.PRNGKey(0),
        jnp.asarray(info), jnp.asarray(plane))
    tt, tpc = ts.sample_tokens_penalized(
        torch.from_numpy(logits), torch.from_numpy(temps), None,
        torch.from_numpy(info), torch.from_numpy(plane.copy()), sampled=False)
    assert (np.asarray(jt) == tt.numpy()).all()
    assert (np.asarray(jpc) == tpc.numpy()).all()


def test_zero_penalties_pass_through_bit_identical():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(2, 64).astype(np.float32))
    rows = torch.from_numpy(rng.randint(0, 5, (2, 64)).astype(np.int32))
    z = torch.zeros(2)
    assert torch.equal(apply_penalties(logits, rows, z, z, z), logits)


def test_penalize_and_count_gating_and_guard():
    """Only lanes with flag bit 1 and a real row count; the rest land in
    the guard row."""
    vocab, rows = 16, 3
    plane = torch.zeros(rows + 1, vocab, dtype=torch.int32)
    logits = torch.zeros(3, vocab)
    logits[:, 5] = 10.0
    info = torch.tensor([encode_pen_info(0, 1.0, count_sampled=True),
                         encode_pen_info(1, 1.0, count_sampled=False),
                         encode_pen_info(rows, count_sampled=False)],
                        dtype=torch.int32)
    toks, pc = penalize_and_count(logits, info, plane, lambda lg: lg.argmax(-1))
    assert toks.tolist() == [5, 5, 5] and pc is plane
    assert pc[0, 5] == 1 and pc[1].sum() == 0 and pc[rows, 5] == 2


def test_reset_and_mark_prompt():
    vocab, rows = 16, 2
    pc = torch.full((rows + 1, vocab), 7, dtype=torch.int32)
    info = torch.tensor([encode_pen_info(0, 1.0, reset=True),
                         encode_pen_info(1, 1.0, reset=False)],
                        dtype=torch.int32)
    pen_reset_rows(info, pc)
    assert pc[0].sum() == 0 and (pc[1] == 7).all()
    ids = torch.tensor([[3, 4, 4, 9], [5, 6, 7, 8]], dtype=torch.int32)
    pen_mark_prompt(info, pc, ids, torch.tensor([3, 0], dtype=torch.int32))
    assert pc[0, 3] & PEN_PROMPT_BIT and pc[0, 4] & PEN_PROMPT_BIT
    assert not pc[0, 9] & PEN_PROMPT_BIT
    assert not (pc[1] & PEN_PROMPT_BIT).any()
    assert (pc[1] & PEN_COUNT_MASK == 7).all()


# -- the model pass: the fused penalized decode == a host reference ----------

def ref_penalize(logits, counts, prompt_seen, fp, pp, rp):
    """Host reference of `apply_penalties` for one lane, in float32."""
    lg = np.asarray(logits, np.float32).copy()
    out_seen = counts > 0
    lg = lg - (np.float32(fp) * counts.astype(np.float32)
               + np.float32(pp) * out_seen.astype(np.float32))
    if rp > 0:
        seen = out_seen | prompt_seen
        r = np.float32(max(rp, 1e-3))
        lg = np.where(seen, np.where(lg > 0, lg / r, lg * r), lg)
    return lg


@pytest.mark.parametrize("fp,pp,rp", [(1.0, 0.5, 0.0), (0.0, 0.0, 1.7),
                                      (-0.8, 0.3, 1.3)])
def test_decode_multi_penalized_matches_host_reference(fp, pp, rp):
    from cxl_speckv_tpu_torch.config import CacheConfig

    prompt = np.array([3, 17, 9, 3, 1, 42], np.int32)
    horizon = 10
    fp = np.float32(np.float32(round(fp * 1000)) * np.float32(1e-3))
    pp = np.float32(np.float32(round(pp * 1000)) * np.float32(1e-3))
    rp_enc = round(rp * 100) if rp > 0 and abs(rp - 1.0) > 1e-9 else 0
    rp = np.float32(np.float32(rp_enc) * np.float32(1e-2))
    table = torch.arange(1, 9, dtype=torch.int32)

    def prefilled():
        kvc = TieredKVCache(CacheConfig(block_size=8, num_hbm_blocks=32,
                                        num_host_blocks=0,
                                        kv_dtype=KVDtype.BF16),
                            CFG, max_seqs=2, max_blocks_per_seq=8,
                            device="cpu")
        lg = prefill_chunk(PARAMS, CFG, KVDtype.BF16,
                           torch.from_numpy(prompt), 0, kvc.pools, table)
        return lg, kvc.pools

    lg, pools = prefilled()
    counts = np.zeros(V, np.int64)
    seen = np.zeros(V, bool)
    seen[prompt] = True
    want = []
    tok = int(ref_penalize(lg.numpy(), counts, seen, fp, pp, rp).argmax())
    counts[tok] += 1
    want.append(tok)
    pos = len(prompt)
    for _ in range(horizon - 1):
        lg = decode_step(PARAMS, CFG, KVDtype.BF16, torch.tensor([tok]),
                         torch.tensor([pos]), pools, table[None],
                         torch.tensor([pos + 1]))[0]
        tok = int(ref_penalize(lg.numpy(), counts, seen, fp, pp, rp).argmax())
        counts[tok] += 1
        want.append(tok)
        pos += 1

    lg, pools = prefilled()
    plane = torch.zeros(2, V, dtype=torch.int32)
    info = torch.tensor([encode_pen_info(0, float(fp), float(pp), float(rp))],
                        dtype=torch.int32)
    pen_mark_prompt(info, plane, torch.from_numpy(prompt)[None],
                    torch.tensor([len(prompt)]))
    plane[0, want[0]] += 1      # the prefill pass counts the first token
    toks = decode_multi(PARAMS, CFG, KVDtype.BF16,
                        torch.tensor([want[0]], dtype=torch.int32),
                        torch.tensor([len(prompt)]), pools, table[None],
                        None, torch.zeros(1), None, info, plane,
                        horizon=horizon - 1)
    assert toks[0].tolist() == want[1:]
    for t, c in Counter(want).items():
        assert plane[0, t] & PEN_COUNT_MASK == c


# -- the engine --------------------------------------------------------------

def pen_engine(hbm=64, host=64, horizon=1, penalty_rows=16, **kw):
    return engine(hbm=hbm, host=host, batch=4, horizon=horizon,
                  prefetch=False, penalty_rows=penalty_rows, **kw)


def plen(n, seed=0, lo=6, hi=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, V, rng.randint(lo, hi)).tolist() for _ in range(n)]


def test_penalized_request_completes_and_counts_exactly():
    eng = pen_engine()
    rid = eng.add_request(plen(1)[0], max_new_tokens=10, ignore_eos=True,
                          frequency_penalty=0.7, presence_penalty=0.2)
    row = eng._requests[rid].pen_row
    assert row >= 0
    out = eng.run()[0]
    assert len(out.tokens) == 10
    pc = eng._pen_counts.numpy()[row] & PEN_COUNT_MASK
    want = Counter(out.tokens)
    assert all(pc[t] == want.get(t, 0) for t in range(V))
    assert row in eng._pen_free


def test_unpenalized_lanes_identical_next_to_penalized():
    ps = plen(3, seed=3)
    a = pen_engine()
    ids_a = [a.add_request(p, max_new_tokens=12) for p in ps]
    outs_a = {o.req_id: o.tokens for o in a.run()}
    b = pen_engine()
    ids_b = [b.add_request(p, max_new_tokens=12) for p in ps]
    b.add_request(plen(1, seed=9)[0], max_new_tokens=12,
                  frequency_penalty=1.5, presence_penalty=1.0,
                  repetition_penalty=1.4)
    outs_b = {o.req_id: o.tokens for o in b.run()}
    assert [outs_a[i] for i in ids_a] == [outs_b[i] for i in ids_b]


def test_penalty_changes_generation():
    p = [5] * 8
    base = run_one(pen_engine(), p, max_new_tokens=16, ignore_eos=True)
    pen = run_one(pen_engine(), p, max_new_tokens=16, ignore_eos=True,
                  frequency_penalty=2.0, presence_penalty=2.0,
                  repetition_penalty=1.9)
    assert base.tokens != pen.tokens
    assert len(set(pen.tokens)) > len(set(base.tokens))


def test_horizon_matches_single_step():
    kw = dict(max_new_tokens=12, ignore_eos=True, frequency_penalty=1.0,
              presence_penalty=0.5, repetition_penalty=1.3)
    p = plen(1, seed=5)[0]
    assert (run_one(pen_engine(horizon=1), p, **kw).tokens
            == run_one(pen_engine(horizon=4), p, **kw).tokens)


def test_tiered_oversubscription_matches_ample():
    p = plen(1, seed=7, lo=30, hi=31)[0]
    kw = dict(max_new_tokens=16, ignore_eos=True, frequency_penalty=1.2,
              repetition_penalty=1.5)
    assert (run_one(pen_engine(hbm=64), p, **kw).tokens
            == run_one(pen_engine(hbm=10), p, **kw).tokens)


def test_row_reuse_after_finish_resets():
    kw = dict(max_new_tokens=12, ignore_eos=True, frequency_penalty=1.1,
              repetition_penalty=1.6)
    p2 = plen(1, seed=13)[0]
    alone = run_one(pen_engine(), p2, **kw)
    eng = pen_engine()
    run_one(eng, plen(1, seed=12)[0], **kw)      # dirties the row
    assert run_one(eng, p2, **kw).tokens == alone.tokens


def test_prefix_cache_skipped_for_repetition_penalty():
    p = plen(1, seed=15, lo=30, hi=31)[0]
    kw = dict(max_new_tokens=10, ignore_eos=True, repetition_penalty=1.5)
    eng = pen_engine()
    run_one(eng, p, max_new_tokens=4)            # fills the prefix cache
    hits = eng.get_statistics()["runtime"]["prefix_hit_blocks"]
    warm = run_one(eng, p, **kw)
    assert eng.get_statistics()["runtime"]["prefix_hit_blocks"] == hits
    assert warm.tokens == run_one(pen_engine(), p, **kw).tokens


def test_session_turn_penalties():
    eng = pen_engine()
    out1 = run_one(eng, plen(1, seed=17)[0], max_new_tokens=6, session=True)
    rid2 = eng.continue_session(out1.session_id, [7, 8, 9], max_new_tokens=8,
                                frequency_penalty=1.0,
                                repetition_penalty=1.2)
    assert eng._requests[rid2].pen_row >= 0
    outs = {o.req_id: o for o in eng.run()}
    assert len(outs[rid2].tokens) >= 1
    assert len(eng._pen_free) == eng.config.engine.penalty_rows


def test_validation_and_rejections():
    eng = pen_engine()
    p = plen(1)[0]
    with pytest.raises(ValueError, match="frequency_penalty"):
        eng.add_request(p, frequency_penalty=3.0)
    with pytest.raises(ValueError, match="presence_penalty"):
        eng.add_request(p, presence_penalty=-2.5)
    with pytest.raises(ValueError, match="repetition_penalty"):
        eng.add_request(p, repetition_penalty=-1.0)
    rid = eng.add_request(p, repetition_penalty=1.0, max_new_tokens=2)
    assert eng._requests[rid].pen_row < 0 and eng._pen_counts is None


def test_row_exhaustion():
    eng = pen_engine(penalty_rows=1)
    p = plen(2, seed=19)
    eng.add_request(p[0], frequency_penalty=1.0, max_new_tokens=4)
    with pytest.raises(ValueError, match="penalty_rows"):
        eng.add_request(p[1], frequency_penalty=1.0, max_new_tokens=4)
    eng.run()
    eng.add_request(p[1], frequency_penalty=1.0, max_new_tokens=4)
    eng.run()


def test_spec_engine_rejects_penalties():
    eng = engine(spec=dict(spec_ngram=True))
    with pytest.raises(ValueError, match="speculative"):
        eng.add_request(plen(1)[0], frequency_penalty=1.0)


@pytest.mark.parametrize("horizon", [1, 4])
def test_penalized_serve_matches_jax_engine(horizon):
    """Penalized lanes of every kind beside plain ones, on a tiered pool:
    the same tokens as the JAX engine and the same penalty rows of the
    plane (the guard row also collects the padding lanes' draws, which
    depend on the guard slot's contents, and is not compared)."""
    ps = plen(6, seed=23)
    kws = [dict(frequency_penalty=0.5, presence_penalty=0.5),
           dict(repetition_penalty=1.3), dict(),
           dict(frequency_penalty=-0.4, repetition_penalty=0.9),
           dict(), dict(presence_penalty=1.5)]
    res = []
    for eng in (pen_engine(cfg=F32, hbm=14, horizon=horizon),
                jax_engine(cfg=JF32, hbm=14, host=64, batch=4,
                           horizon=horizon, prefetch=False, penalty_rows=16)):
        ids = [eng.add_request(p, max_new_tokens=10, ignore_eos=True, **kw)
               for p, kw in zip(ps, kws)]
        outs = {o.req_id: o.tokens for o in eng.run()}
        res.append(([outs[i] for i in ids], np.asarray(eng._pen_counts)))
    (got, plane), (want, jplane) = res
    assert got == want
    rows = eng.config.engine.penalty_rows
    assert (plane[:rows] == jplane[:rows]).all()
    assert (plane[:rows] & PEN_COUNT_MASK).sum() > 0
