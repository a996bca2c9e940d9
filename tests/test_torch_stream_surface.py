"""The serving surface on the port's host-streamed path, on the CPU: the
streamed cases of `tests/test_sessions.py` (a stream-resident session's
turns match fresh full-history requests; a reclaimed one re-prefills
through streaming; ending frees its blocks), `tests/test_cancel.py` (a
cancel frees the host blocks; a decoding session turn keeps them) and
`tests/test_logprobs.py` (prompt logprobs on the streamed path, with the
chunk-boundary re-feed leaving the stored KV as it was), and streamed
penalties against the JAX engine, bit for bit on the count plane.

Float32 attention compute (`F32` / `JF32`), as in `torch_surface.py`.
"""

import numpy as np
import pytest
import torch
from torch_surface import (F32, JAX, JF32, JPARAMS, LP_TOL, PARAMS,
                           assert_logprobs_close, run_one, run_turn, tokens)
from test_torch_streaming import ample, engine, stream_sys

from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu_torch.engine.request import RequestState
from cxl_speckv_tpu_torch.models.llama import forward_dense


def jax_engine(**kw):
    return JEngine(JF32, stream_sys(JAX, **kw), params=JPARAMS,
                   use_pallas=False, enable_lstm=False)


def fresh(prompt, gen):
    return run_one(ample(), prompt, max_new_tokens=gen).tokens


@pytest.mark.parametrize("horizon", [1, 4])
def test_stream_session_restore_matches_fresh(horizon):
    """A session whose KV lives as host-tier stream blocks: each turn
    appends to them, restores (no re-prefill), and matches a fresh
    full-history request on an ample pooled engine."""
    t1, t2, t3 = tokens(11, 40), tokens(12, 9), tokens(13, 7)
    eng = engine(host=256, horizon=horizon)
    sid = eng.add_request(t1, max_new_tokens=8, session=True)
    assert sid in {r.req_id for r in eng._stream_queue}
    got1 = {o.req_id: o for o in eng.run()}[sid].tokens
    sess = eng.get_session(sid)
    assert sess.live and sess.stream_bids
    held = len(sess.stream_bids)
    assert held == -(-(len(t1) + len(got1) - 1) // 8)   # headroom freed
    got2 = run_turn(eng, sid, t2, max_new_tokens=8).tokens
    assert sess.restores == 1 and sess.reprefills == 0
    got3 = run_turn(eng, sid, t3, max_new_tokens=8).tokens
    assert sess.tokens == t1 + got1 + t2 + got2 + t3 + got3
    assert len(sess.stream_bids) == -(-(len(sess.tokens) - 1) // 8)
    want1 = fresh(t1, 8)
    want2 = fresh(t1 + want1 + t2, 8)
    want3 = fresh(t1 + want1 + t2 + want2 + t3, 8)
    assert (got1, got2, got3) == (want1, want2, want3)


def test_stream_session_reclaim_reprefills_streamed():
    """A reclaimed stream session re-prefills through the streamed path
    (its history is past the pooled capacity) and still matches."""
    t1, t2 = tokens(14, 40), tokens(15, 6)
    eng = engine(host=256)
    sid = eng.add_request(t1, max_new_tokens=6, session=True)
    got1 = {o.req_id: o for o in eng.run()}[sid].tokens
    free_before = eng.kvc.directory.host_free
    assert eng._reclaim_idle_session()
    sess = eng.get_session(sid)
    assert not sess.live and sess.stream_bids is None
    assert eng.kvc.directory.host_free > free_before
    got2 = run_turn(eng, sid, t2, max_new_tokens=6).tokens
    assert sess.reprefills == 1 and sess.live and sess.stream_bids
    assert got2 == fresh(t1 + got1 + t2, 6)


def test_stream_session_end_frees_and_queued_cancel():
    eng = engine()
    sid = eng.add_request(tokens(16, 40), max_new_tokens=4, session=True)
    eng.run()
    sess = eng.get_session(sid)
    held = len(sess.stream_bids)
    assert held > 0 and eng.kvc.directory.host_free == 64 - held
    assert eng.get_statistics()["engine"]["requests_finished"] == 1
    # a QUEUED continuation's cancel leaves the session KV intact
    rid = eng.continue_session(sid, [5, 6], max_new_tokens=4)
    out = eng.cancel(rid)
    assert out.finish_reason == "cancelled" and sess.live and not sess.busy
    assert len(sess.stream_bids) == held and not eng._stream_queue
    # a cross-width switch waits for an idle engine: the live session counts
    with pytest.raises(ValueError, match="idle engine"):
        eng.set_kv_dtype("int4")
    eng.end_session(sid)
    assert eng.kvc.directory.host_free == 64
    with pytest.raises(ValueError, match="unknown session"):
        eng.continue_session(sid, [1, 2])


def test_cancel_streamed_request_frees_host_blocks():
    eng = engine(hbm=8)
    rid = eng.add_request(tokens(0, 70), max_new_tokens=8)
    free0 = eng.kvc.directory.host_free
    for _ in range(2):
        eng.step()
    assert rid in eng._streams
    assert eng.kvc.directory.host_free < free0
    with pytest.raises(ValueError, match="idle engine"):
        eng.set_kv_dtype("bf16")       # a live stream keeps the engine busy
    out = eng.cancel(rid)
    assert out.finish_reason == "cancelled"
    assert eng.kvc.directory.host_free == free0
    assert rid not in eng._streams and not eng.has_work


def test_cancel_streamed_lane_leaves_the_other_intact():
    ps = [tokens(40, 40), tokens(41, 44)]
    solo = run_one(engine(host=256), ps[1], max_new_tokens=10).tokens
    eng = engine(host=256)
    victim, keep = (eng.add_request(p, max_new_tokens=10) for p in ps)
    while not eng._requests[victim].output:
        eng.step()
    assert eng.cancel(victim).finish_reason == "cancelled"
    outs = {o.req_id: o for o in eng.run()}
    assert victim not in outs and outs[keep].tokens == solo
    assert eng.kvc.directory.host_free == 256


def test_cancelled_streamed_session_turns():
    """A decoding turn's cancel keeps the partial output as context (the
    next turn restores over it == a fresh request); a cancel mid-prefill
    drops the session's liveness, and the next turn re-prefills."""
    p = tokens(17, 40)
    eng = engine(host=256)
    rid = eng.add_request(p, max_new_tokens=10, session=True)
    while len(eng._requests[rid].output) < 3:
        eng.step()
    out = eng.cancel(rid)
    sess = eng.get_session(out.session_id)
    assert out.finish_reason == "cancelled" and sess.live and sess.stream_bids
    cont = run_turn(eng, out.session_id, [5, 9], max_new_tokens=4).tokens
    assert cont == fresh(p + out.tokens + [5, 9], 4)
    rid = eng.continue_session(out.session_id, tokens(18, 30),
                               max_new_tokens=4)
    eng.step()
    assert eng._requests[rid].state == RequestState.PREFILLING
    eng.cancel(rid)
    assert not sess.live and not sess.busy and sess.stream_bids is None
    assert eng.kvc.directory.host_free == 256
    run_turn(eng, out.session_id, [3], max_new_tokens=2)
    assert sess.reprefills == 1


def test_prompt_logprobs_on_streamed_path():
    """Streamed prefill chunks score the prompt with the pooled path's
    boundary re-feed: every token i >= 1 within INT8 KV's tolerance of
    forward_dense (`tests/test_logprobs.py`'s 2e-2), and within LP_TOL of
    the JAX engine's streamed scores."""
    p = tokens(21, 50)                 # past max_seq_len 48: 4 chunks
    kw = dict(max_new_tokens=3, prompt_logprobs=True, logprobs=2)
    eng = engine(seq=48)
    rid = eng.add_request(p, **kw)
    assert len(eng._stream_queue) == 1
    out = {o.req_id: o for o in eng.run()}[rid]
    pl = out.prompt_logprobs
    assert len(pl) == len(p) and pl[0] is None
    lp = torch.log_softmax(forward_dense(PARAMS, F32, torch.tensor([p]))[0],
                           -1)
    for i in range(1, len(p)):
        assert abs(pl[i] - float(lp[i - 1, p[i]])) <= 2e-2, i
    assert out.logprobs is not None and len(out.logprobs) == len(out.tokens)
    want = run_one(jax_engine(seq=48), p, **kw)
    assert out.tokens == want.tokens
    np.testing.assert_allclose(pl[1:], want.prompt_logprobs[1:], rtol=0,
                               atol=LP_TOL)
    assert_logprobs_close(out.logprobs, want.logprobs)


def test_streamed_prompt_logprobs_keep_stored_kv():
    """The re-fed boundary token's KV is already stored and is not written
    again: every position's bytes, once written, stay as they were through
    the later chunks and decode steps. And a scoring request generates the
    tokens of the same request without scoring."""
    p = tokens(22, 44)
    plain = run_one(engine(seq=48), p, max_new_tokens=6)
    eng = engine(seq=48)
    rid = eng.add_request(p, max_new_tokens=6, prompt_logprobs=True)
    req = eng._requests[rid]
    L, bs = F32.num_layers, 8

    def position_bytes(slots, pos):
        rows = slots[pos // bs] * L + np.arange(L)
        return [a[rows][:, :, pos % bs].clone() for a in eng.kvc.store.arrays]

    seen, slots, outs = {}, None, []
    while eng.has_work:
        outs += eng.step()
        if rid in eng._streams:
            slots = eng._streams[rid].host_slots
        for pos in range(req.num_tokens - (1 if req.output else 0)):
            now = position_bytes(slots, pos)
            for a, b in zip(now, seen.setdefault(pos, now)):
                assert torch.equal(a, b), pos
    assert outs[0].tokens == plain.tokens
    assert eng.get_statistics()["engine"]["stream_chunks"] == 3


@pytest.mark.parametrize("horizon", [1, 4])
def test_streamed_penalties_match_jax(horizon):
    """Frequency / presence / repetition penalties ride the streamed
    programs: the JAX engine's greedy tokens, and its count plane's rows
    bit for bit (the prompt bits of every chunk's tokens, the counts of the
    sampled ones), per-token and fused."""
    p = tokens(23, 44)
    kw = dict(max_new_tokens=12, ignore_eos=True, frequency_penalty=0.7,
              presence_penalty=0.4, repetition_penalty=1.3)
    jeng = jax_engine(horizon=horizon)
    want = run_one(jeng, p, **kw)
    eng = engine(horizon=horizon)
    got = run_one(eng, p, **kw)
    assert got.tokens == want.tokens
    assert eng.get_statistics()["engine"]["stream_tokens"] == 11
    # every request row; the last row is the guard that padding and
    # uncounted lanes write into and no lane reads (the JAX programs also
    # compute padded chunk positions and a fused round's overshoot steps,
    # which the port does not run)
    np.testing.assert_array_equal(eng._pen_counts.numpy()[:-1],
                                  np.asarray(jeng._pen_counts)[:-1])
    assert eng._pen_counts[:-1].any()
    # the penalty took effect: not the unpenalized tokens
    assert got.tokens != run_one(engine(horizon=horizon), p,
                                 max_new_tokens=12, ignore_eos=True).tokens


def test_streamed_session_turns_match_jax():
    """Two streamed turns (restore over the stream blocks) give the JAX
    engine's tokens, and the same blocks stay held."""
    t1, t2 = tokens(24, 40), tokens(25, 9)
    res = []
    for eng in (engine(host=256), jax_engine(host=256)):
        sid = eng.add_request(t1, max_new_tokens=8, session=True)
        a = {o.req_id: o for o in eng.run()}[sid].tokens
        b = run_turn(eng, sid, t2, max_new_tokens=8).tokens
        sess = eng.get_session(sid)
        res.append((a, b, len(sess.stream_bids), sess.restores,
                    eng.kvc.directory.host_free))
    assert res[0] == res[1]
