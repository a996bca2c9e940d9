"""Multi-turn sessions on the port's engine (CPU, plain attention versions),
the pooled-path cases of `tests/test_sessions.py` and the port against the
JAX engine:

- a restored turn emits exactly the tokens of a fresh request over the
  whole history (greedy), at decode horizons 1 and 4; also when the idle
  session's KV was demoted to the host tier and promoted back, and when it
  was reclaimed and the turn re-prefills;
- an idle session's blocks are unpinned (eviction may demote them) and the
  next turn's `ensure_resident` promotes them; queued restores preload;
- capacity pressure reclaims idle sessions; `end_session` frees the KV
  (and a spec engine's draft slots); a live session blocks a cross-width
  scheme switch;
- a host tier too small for the idle sessions: a demand fetch that cannot
  make HBM room reclaims idle sessions (the JAX engine raises there, at
  the same geometry), and every turn finishes with the ample run's tokens
  or a first divergence at a near-tie;
- three turns of four sessions, ample and tiered, give the JAX engine's
  tokens bit for bit (float32 attention compute on both sides), the same
  restore counts and the same residency statistics.
"""

import numpy as np
import pytest
import torch
from test_torch_engine import NEAR_TIE, PARAMS
from torch_surface import (
    F32,
    JF32,
    engine,
    jax_engine,
    run_one,
    run_turn,
    tokens,
)

from cxl_speckv_tpu_torch.core.directory import BlockState
from cxl_speckv_tpu_torch.models.llama import forward_dense


def reference_two_turn(t1, gen1, t2, gen2, **kw):
    """Turn 2 as a fresh request over the whole history."""
    out1 = run_one(engine(**kw), t1, max_new_tokens=gen1, session=True)
    out2 = run_one(engine(**kw), t1 + out1.tokens + t2, max_new_tokens=gen2)
    return out1.tokens, out2.tokens


@pytest.mark.parametrize("horizon", [1, 4])
def test_session_restore_matches_fresh(horizon):
    t1, t2 = tokens(1, 12), tokens(2, 9)
    want1, want2 = reference_two_turn(t1, 8, t2, 8, horizon=horizon)
    eng = engine(horizon=horizon)
    out1 = run_one(eng, t1, max_new_tokens=8, session=True)
    assert out1.tokens == want1 and out1.session_id == out1.req_id
    got2 = run_turn(eng, out1.session_id, t2, max_new_tokens=8).tokens
    assert got2 == want2, "restored continuation diverged from re-prefill"
    sess = eng.get_session(out1.session_id)
    assert sess.restores == 1 and sess.reprefills == 0
    assert sess.tokens == t1 + want1 + t2 + got2


def test_session_restore_under_tiering():
    """Idle session KV demoted to the host tier between turns restores."""
    t1, t2 = tokens(3, 16), tokens(4, 10)
    want1, want2 = reference_two_turn(t1, 8, t2, 8)
    eng = engine(hbm=10)
    sid = run_one(eng, t1, max_new_tokens=8, session=True).session_id
    for i in range(3):               # churn: other requests demote the session
        eng.add_request(tokens(50 + i, 14), max_new_tokens=6)
    eng.run()
    assert eng.kvc.seq_nonresident_blocks(eng.get_session(sid).seq_slot)
    assert run_turn(eng, sid, t2, max_new_tokens=8).tokens == want2
    assert eng.get_statistics()["transfer"]["up_transfers"] > 0


def demoted_session(batch=2):
    """An engine whose one idle session had blocks demoted by the churn of
    three other requests; returns (engine, session id, its blocks)."""
    eng = engine(hbm=10, batch=batch)
    sid = run_one(eng, tokens(5, 20), max_new_tokens=6,
                  session=True).session_id
    bids = eng.kvc.pool.seq(eng.get_session(sid).seq_slot).live_blocks
    assert all(eng.kvc.directory.entry(b).pinned is False for b in bids)
    for i in range(3):
        eng.add_request(tokens(50 + i, 14), max_new_tokens=6)
    eng.run()
    assert any(eng.kvc.directory.entry(b).state == BlockState.HOST
               for b in bids)
    return eng, sid, bids


def test_idle_session_unpinned_then_promoted():
    """The finished turn unpins its blocks, eviction demotes them, and the
    next turn's demand fetch promotes every one of them back."""
    eng, sid, bids = demoted_session()
    eng.kvc.ensure_resident([eng.get_session(sid).seq_slot])
    assert all(eng.kvc.directory.entry(b).state == BlockState.HBM
               for b in bids)


def test_queued_restore_preloads():
    """A session turn still queued at the end of a step (one admission a
    step at batch 1, a plain request ahead of it) has its demoted blocks
    promoted by the maintain phase before it is admitted."""
    eng, sid, bids = demoted_session(batch=1)
    slot = eng.get_session(sid).seq_slot
    before = len(eng.kvc.seq_nonresident_blocks(slot))
    eng.add_request(tokens(8, 6), max_new_tokens=2)
    rid = eng.continue_session(sid, [3, 4], max_new_tokens=4)
    eng.step()
    assert eng._requests[rid].state.name == "QUEUED"
    assert len(eng.kvc.seq_nonresident_blocks(slot)) < before
    eng.run()


def test_session_reclaim_reprefills():
    """A reclaimed session re-prefills its history and still matches."""
    t1, t2 = tokens(9, 10), tokens(10, 7)
    want1, want2 = reference_two_turn(t1, 6, t2, 6)
    eng = engine()
    sid = run_one(eng, t1, max_new_tokens=6, session=True).session_id
    assert eng._reclaim_idle_session()
    sess = eng.get_session(sid)
    assert not sess.live
    assert run_turn(eng, sid, t2, max_new_tokens=6).tokens == want2
    assert sess.reprefills == 1 and sess.live


def test_session_capacity_gating_reclaims_idle():
    """Traffic under pressure reclaims idle sessions rather than failing."""
    eng = engine(hbm=12, host=0)
    sid = run_one(eng, tokens(11, 20), max_new_tokens=6,
                  session=True).session_id
    assert eng.get_session(sid).live
    eng.add_request(tokens(12, 70), max_new_tokens=8)
    outs = eng.run()
    assert len(outs) == 1 and outs[0].finish_reason == "length"
    assert not eng.get_session(sid).live


def test_end_session_frees():
    eng = engine()
    hbm0 = eng.kvc.directory.hbm_free
    sid = run_one(eng, tokens(13, 10), max_new_tokens=4,
                  session=True).session_id
    assert eng._idle_session_blocks() > 0
    assert eng.scheduler.extra_committed() == eng._idle_session_blocks()
    eng.end_session(sid)
    assert eng._idle_session_blocks() == 0
    assert eng.kvc.directory.hbm_free == hbm0
    with pytest.raises(ValueError):
        eng.continue_session(sid, [1, 2])


def test_continue_session_validation():
    eng = engine()
    with pytest.raises(ValueError, match="unknown session"):
        eng.continue_session(99, [1])
    sid = run_one(eng, tokens(14, 8), max_new_tokens=3,
                  session=True).session_id
    with pytest.raises(ValueError, match="empty continuation"):
        eng.continue_session(sid, [])
    eng.continue_session(sid, [5], max_new_tokens=2)
    with pytest.raises(ValueError, match="in flight"):
        eng.continue_session(sid, [6], max_new_tokens=2)
    eng.run()
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.continue_session(sid, [6], max_new_tokens=200)
    assert not eng.get_session(sid).busy


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_spec_session_restores_and_frees_draft(proposer):
    """Sessions under speculative decoding: a restored turn equals the
    plain engine's, and `end_session` frees the draft cache's slots too."""
    from test_torch_spec_engine import DCFG, DPARAMS

    spec = (dict(spec_ngram=True, spec_gamma=3) if proposer == "ngram" else
            dict(draft_config=DCFG, draft_params=DPARAMS, spec_gamma=3))
    t1, t2 = tokens(15, 12), tokens(16, 6)
    want1, want2 = reference_two_turn(t1, 8, t2, 8)
    eng = engine(spec=spec)
    out1 = run_one(eng, t1, max_new_tokens=8, session=True)
    assert out1.tokens == want1
    assert run_turn(eng, out1.session_id, t2, max_new_tokens=8).tokens == want2
    eng.end_session(out1.session_id)
    if proposer == "draft":
        assert len(eng.spec._free) == eng.spec.guard_slot
        assert (eng.spec.table == eng.spec.guard_slot).all()


def test_live_session_blocks_cross_width_switch():
    eng = engine()
    sid = run_one(eng, tokens(17, 8), max_new_tokens=3,
                  session=True).session_id
    with pytest.raises(ValueError, match="idle engine"):
        eng.set_kv_dtype("int4")
    eng.end_session(sid)
    eng.set_kv_dtype("int4")
    assert eng.kvc.k_pools.shape[-1] == F32.head_dim // 2


@pytest.mark.parametrize("hbm", [256, 14])
def test_session_turns_match_jax_engine(hbm):
    """Four sessions x three turns, interleaved, greedy: the port and the
    JAX engine emit the same tokens bit for bit, restore the same way and,
    on the tiered pool, migrate the same blocks."""
    engs = [engine(cfg=F32, hbm=hbm, horizon=2),
            jax_engine(cfg=JF32, hbm=hbm, horizon=2)]
    turns = [[tokens(20 + 3 * s + t, 9 if t else 14) for t in range(3)]
             for s in range(4)]
    results = []
    for eng in engs:
        sids = [eng.add_request(turns[s][0], max_new_tokens=6, session=True)
                for s in range(4)]
        outs = {o.req_id: o.tokens for o in eng.run()}
        got = [outs[sid] for sid in sids]
        for t in (1, 2):
            rids = [eng.continue_session(sid, turns[s][t], max_new_tokens=6)
                    for s, sid in enumerate(sids)]
            outs = {o.req_id: o.tokens for o in eng.run()}
            got += [outs[r] for r in rids]
        sess = [eng.get_session(sid) for sid in sids]
        results.append((got, [s.tokens for s in sess],
                        [(s.restores, s.reprefills, s.live) for s in sess],
                        eng.get_statistics()))
    (got, hist, counts, st), (jgot, jhist, jcounts, jst) = results
    assert got == jgot and hist == jhist and counts == jcounts
    assert all(c == (2, 0, True) for c in counts)
    for key in ("transfer", "directory", "scheduler", "pool", "runtime"):
        assert st[key] == jst[key], key
    if hbm < 256:
        assert st["transfer"]["up_transfers"] > 0
        assert st["transfer"]["down_transfers"] > 0
    assert np.isfinite(st["engine"]["p50_ttft_ms"])


def grouped_turns(eng, prompts, news, gen=8):
    """Sessions served a group of 8 at a time, turn by turn, each group to
    its end before the next: one group idles while the other runs. Returns
    (session ids, tokens [turn][session])."""
    n = len(prompts)
    sids, outs = [None] * n, [[None] * n for _ in range(len(news) + 1)]
    for t in range(len(news) + 1):
        for g0 in range(0, n, 8):
            ids = {}
            for s in range(g0, min(n, g0 + 8)):
                rid = (eng.add_request(prompts[s], max_new_tokens=gen,
                                       session=True, ignore_eos=True)
                       if t == 0 else
                       eng.continue_session(sids[s], news[t - 1][s],
                                            max_new_tokens=gen))
                ids[rid] = s
            for o in eng.run():
                sids[ids[o.req_id]] = o.session_id
                outs[t][ids[o.req_id]] = o.tokens
    return sids, outs


def test_small_host_tier_reclaims_instead_of_failing():
    """16 sessions x 3 turns (56 tokens, 7 blocks each: 112 blocks) on 52
    HBM blocks and a 56-block host tier. Idle sessions fill the host tier,
    so a turn's demand fetch finds no block it can demote: the engine
    reclaims idle sessions there (their next turns re-prefill), where it
    used to raise "cannot make HBM room" (and the JAX engine still does at
    this geometry). Each turn equals the ample run's, or first diverges at
    a near-tie."""
    rng = np.random.RandomState(0)
    ps = [rng.randint(1, F32.vocab_size, 16).tolist() for _ in range(16)]
    news = [[rng.randint(1, F32.vocab_size, 8).tolist() for _ in range(16)]
            for _ in range(2)]
    kw = dict(cfg=F32, batch=8, horizon=8, chunk=16, seq=64)
    eng = engine(hbm=52, host=56, **kw)
    sids, got = grouped_turns(eng, ps, news)
    sess = [eng.get_session(s) for s in sids]
    assert sum(s.reprefills > 0 for s in sess) >= 3
    assert sum(s.restores + s.reprefills for s in sess) == 32
    _, want = grouped_turns(engine(hbm=256, host=0, **kw), ps, news)
    for s in range(16):
        hist = list(ps[s])
        for t in range(3):
            hist += news[t - 1][s] if t else []
            g, w = got[t][s], want[t][s]
            if g != w:
                i = next(k for k, (a, b) in enumerate(zip(g, w)) if a != b)
                logits = forward_dense(PARAMS, F32, torch.tensor(
                    [hist + w[:i]]))[0, -1]
                top = torch.topk(logits, 2)
                assert {g[i], w[i]} == set(top.indices.tolist())
                assert float(top.values[0] - top.values[1]) < NEAR_TIE
                break
            hist += w


def test_session_turn_oom_drops_liveness():
    """A turn whose history outgrows the HBM pool finishes "oom" and frees
    the session's KV with it: the session is no longer live (its slot is
    gone), so the next turn cannot read freed blocks: it re-prefills the
    stored history."""
    eng = engine(hbm=6, host=0)
    sid = run_one(eng, tokens(30, 20), max_new_tokens=4,
                  session=True).session_id
    out = run_turn(eng, sid, tokens(31, 16), max_new_tokens=4)
    assert out.finish_reason == "oom"
    sess = eng.get_session(sid)
    assert not sess.live and not sess.busy and sess.seq_slot == -1
    assert not eng.kvc.pool.live_seqs()
    nxt = run_turn(eng, sid, [1, 2], max_new_tokens=4)
    assert nxt.finish_reason in ("length", "eos") and sess.reprefills == 1
    assert sess.live
    eng.end_session(sid)
    assert not eng.kvc.pool.live_seqs()
