"""`Engine.cancel` and `ignore_eos` on the port's engine (CPU), the
pooled-path cases of `tests/test_cancel.py` and the port against the JAX
engine: a cancel frees KV as a normal finish does (a decoding session turn
keeps its KV, a session cancelled mid-prefill drops its liveness), withdraws
a queued request, frees its penalty row, and leaves every other lane's
greedy tokens untouched."""

import pytest
from torch_surface import JF32, F32, engine, jax_engine, run_one, tokens

from cxl_speckv_tpu_torch.engine.request import RequestState


def cancel_engine(**kw):
    return engine(batch=4, **kw)


def live_blocks(eng):
    return sum(len(eng.kvc.pool.seq(s).live_blocks)
               for s in eng.kvc.pool.live_seqs())


def test_cancel_queued_request():
    eng = cancel_engine()
    rid = eng.add_request(tokens(0, 12), max_new_tokens=8)
    out = eng.cancel(rid)
    assert out is not None and out.finish_reason == "cancelled"
    assert out.tokens == [] and not eng.has_work
    assert eng.cancel(rid) is None            # double cancel: a no-op
    assert eng.cancel(12345) is None          # unknown id: a no-op
    assert eng.get_statistics()["engine"]["requests_finished"] == 1


def test_cancel_running_request_frees_kv_and_leaves_others_intact():
    want = run_one(cancel_engine(), tokens(1, 12), max_new_tokens=12).tokens
    eng = cancel_engine()
    keep = eng.add_request(tokens(1, 12), max_new_tokens=12)
    victim = eng.add_request(tokens(2, 12), max_new_tokens=12)
    for _ in range(4):
        eng.step()
    assert eng._requests[victim].state in (RequestState.RUNNING,
                                           RequestState.PREFILLING)
    before = live_blocks(eng)
    assert eng.cancel(victim).finish_reason == "cancelled"
    assert live_blocks(eng) < before
    outs = {o.req_id: o for o in eng.run()}
    assert victim not in outs and outs[keep].tokens == want


def test_cancelled_session_turn_keeps_kv():
    p = tokens(3, 12)
    eng = cancel_engine()
    rid = eng.add_request(p, max_new_tokens=10, session=True)
    for _ in range(6):
        eng.step()
    req = eng._requests[rid]
    assert req.state == RequestState.RUNNING and req.output
    got = len(req.output)
    out = eng.cancel(rid)
    assert out.finish_reason == "cancelled" and len(out.tokens) == got
    sess = eng.get_session(out.session_id)
    assert sess.live and not sess.busy
    # the session holds the partial turn and continues from it
    cont = eng.continue_session(out.session_id, [5, 9], max_new_tokens=4)
    got2 = {o.req_id: o for o in eng.run()}[cont].tokens
    want = run_one(cancel_engine(), p + out.tokens + [5, 9],
                   max_new_tokens=4).tokens
    assert got2 == want and sess.restores == 1


def test_cancel_session_mid_prefill_does_not_persist_partial_kv():
    """A session turn cancelled during prefill leaves no live session whose
    tokens outrun the written KV: the next turn re-prefills."""
    p1 = tokens(6, 10)
    eng = cancel_engine()
    out1 = run_one(eng, p1, max_new_tokens=6, session=True)
    sid = out1.session_id
    cid = eng.continue_session(sid, tokens(7, 60), max_new_tokens=6)
    eng.step()                                # the first 32-token chunk
    assert eng._requests[cid].state == RequestState.PREFILLING
    assert eng.cancel(cid).finish_reason == "cancelled"
    sess = eng.get_session(sid)
    assert not sess.busy and not sess.live
    c2 = eng.continue_session(sid, [3, 5], max_new_tokens=5)
    cont = {o.req_id: o for o in eng.run()}[c2].tokens
    want = run_one(cancel_engine(), p1 + out1.tokens + [3, 5],
                   max_new_tokens=5).tokens
    assert cont == want and sess.reprefills >= 1


def test_cancel_first_turn_mid_prefill_leaves_no_session():
    eng = cancel_engine()
    hbm0 = eng.kvc.directory.hbm_free
    rid = eng.add_request(tokens(8, 60), max_new_tokens=4, session=True)
    eng.step()
    assert eng.cancel(rid).finish_reason == "cancelled"
    assert not eng._sessions and not eng.has_work
    assert eng.kvc.directory.hbm_free == hbm0


def test_cancel_queued_session_turn_keeps_the_session():
    eng = cancel_engine()
    sid = run_one(eng, tokens(9, 10), max_new_tokens=4,
                  session=True).session_id
    rid = eng.continue_session(sid, [1, 2], max_new_tokens=4)
    assert eng.cancel(rid).finish_reason == "cancelled"
    sess = eng.get_session(sid)
    assert sess.live and not sess.busy
    run_one(eng, [7], max_new_tokens=1)       # the engine still serves
    assert eng.continue_session(sid, [3], max_new_tokens=2) >= 0


def test_cancel_frees_penalty_row():
    eng = cancel_engine(penalty_rows=1)
    rid = eng.add_request(tokens(10, 12), max_new_tokens=50,
                          frequency_penalty=1.0)
    eng.step()
    assert not eng._pen_free
    assert eng.cancel(rid) is not None
    assert eng._pen_free == [0]


def test_ignore_eos_runs_to_length():
    p = tokens(4, 12)
    ref = run_one(cancel_engine(), p, max_new_tokens=12).tokens
    assert len(ref) == 12
    fake_eos = ref[3]
    out2 = run_one(cancel_engine(), p, max_new_tokens=12,
                   eos_token_id=fake_eos)
    assert out2.finish_reason == "eos"
    assert out2.tokens == ref[: ref.index(fake_eos) + 1]
    out3 = run_one(cancel_engine(), p, max_new_tokens=12,
                   eos_token_id=fake_eos, ignore_eos=True)
    assert out3.finish_reason == "length" and out3.tokens == ref


@pytest.mark.parametrize("horizon", [1, 3])
def test_cancel_matches_jax_engine(horizon):
    """One script of cancels (queued, mid-prefill, decoding, a decoding
    session turn) on both engines: the same partial results, the same
    survivors' tokens bit for bit, the same residency statistics."""
    results = []
    for eng in (engine(cfg=F32, batch=4, horizon=horizon),
                jax_engine(cfg=JF32, batch=4, horizon=horizon)):
        sid = run_one(eng, tokens(30, 10), max_new_tokens=4,
                      session=True).session_id
        ids = [eng.add_request(tokens(31 + i, 12 if i != 1 else 50),
                               max_new_tokens=20) for i in range(4)]
        turn = eng.continue_session(sid, [4, 5, 6], max_new_tokens=20)
        q = eng.add_request(tokens(40, 8), max_new_tokens=6)
        cancelled = [eng.cancel(q)]
        eng.step()
        cancelled.append(eng.cancel(ids[1]))          # mid-prefill
        for _ in range(3):
            eng.step()
        cancelled += [eng.cancel(ids[2]), eng.cancel(turn)]
        outs = {o.req_id: o for o in eng.run()}
        results.append(([(c.tokens, c.finish_reason) for c in cancelled],
                        [outs[i].tokens for i in (ids[0], ids[3])],
                        eng.get_session(sid).tokens,
                        eng.get_statistics()))
    (c, got, hist, st), (jc, jgot, jhist, jst) = results
    assert c == jc and got == jgot and hist == jhist
    assert all(r == "cancelled" for _, r in c)
    assert [len(t) > 0 for t, _ in c] == [False, False, True, True]
    for key in ("transfer", "directory", "scheduler", "pool", "runtime"):
        assert st[key] == jst[key], key
