"""Per-token logprobs (OpenAI semantics: the log-softmax of the raw model
logits, before temperature, top-p and penalties) and prompt logprobs on the
port's engine (CPU), the pooled-path cases of `tests/test_logprobs.py`, and
the port against the JAX engine within LP_TOL (float32 attention compute on
both sides): decode logprobs at horizons 1 and 4, prompt logprobs across
chunk boundaries, and logprobs under speculative decoding (verify row j
scores the token emitted at round index j). Top-k ids are compared where
the values are distinct."""

import numpy as np
import pytest
import torch
from test_torch_engine import CFG, PARAMS
from torch_surface import (
    F32,
    JF32,
    assert_logprobs_close,
    engine,
    jax_engine,
    run_one,
    system,
    tokens,
)

from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models.llama import forward_dense
from cxl_speckv_tpu_torch.utils.host import fetch

DENSE_TOL = 2e-2        # the served path (INT8 / BF16 KV) against dense


def lp_engine(horizon=1, kv="bf16", seed=0, cfg=CFG, **kw):
    return engine(cfg=cfg, horizon=horizon, kv=kv, batch=4, seed=seed, **kw)


def dense_logprobs(seq):
    """log_softmax of the dense forward's logits at every position."""
    logits = forward_dense(PARAMS, CFG, torch.tensor([seq]))
    return torch.log_softmax(logits[0].float(), -1).numpy()


@pytest.mark.parametrize("horizon", [1, 4])
def test_greedy_logprobs_match_dense(horizon):
    p = tokens(0, 10)
    out = run_one(lp_engine(horizon), p, max_new_tokens=6, logprobs=3)
    assert out.logprobs is not None and len(out.logprobs) == len(out.tokens)
    lp = dense_logprobs(p + out.tokens)
    for j, (tok, e) in enumerate(zip(out.tokens, out.logprobs)):
        assert len(e["top_ids"]) == 3 and len(e["top_logprobs"]) == 3
        assert e["top_ids"][0] == tok             # greedy: the argmax
        assert e["top_logprobs"][0] == pytest.approx(e["logprob"], abs=1e-6)
        assert e["top_logprobs"] == sorted(e["top_logprobs"], reverse=True)
        assert all(v <= 0 for v in e["top_logprobs"])
        assert e["logprob"] == pytest.approx(float(lp[len(p) + j - 1, tok]),
                                             abs=DENSE_TOL)


def test_logprob_entries_align_with_stop_trim():
    p = tokens(1, 10)
    ref = run_one(lp_engine(), p, max_new_tokens=10)
    out = run_one(lp_engine(), p, max_new_tokens=10, logprobs=2,
                  stop_sequences=[ref.tokens[3:5]])
    assert out.finish_reason == "stop"
    assert len(out.logprobs) == len(out.tokens)


def test_sampled_logprobs_are_raw_distribution():
    """With temperature the chosen token need not be top-1, but its logprob
    is still the raw distribution's."""
    p = tokens(2, 10)
    out = run_one(lp_engine(horizon=4, seed=3), p, max_new_tokens=6,
                  temperature=0.9, logprobs=2)
    lp = dense_logprobs(p + out.tokens)
    for j, (tok, e) in enumerate(zip(out.tokens, out.logprobs)):
        assert e["logprob"] == pytest.approx(float(lp[len(p) + j - 1, tok]),
                                             abs=DENSE_TOL)


def test_mixed_batch_logprob_and_plain_lanes():
    """A scoring lane beside plain lanes: plain lanes return None, and every
    lane's tokens equal an all-plain engine's (the flags change what comes
    back, not the math)."""
    ps = [tokens(11, 40), tokens(12, 9), tokens(13, 9)]
    eng = lp_engine(horizon=4)
    r0 = eng.add_request(ps[0], max_new_tokens=5, logprobs=2,
                         prompt_logprobs=True)
    r1 = eng.add_request(ps[1], max_new_tokens=5)
    r2 = eng.add_request(ps[2], max_new_tokens=5, logprobs=4)
    outs = {o.req_id: o for o in eng.run()}
    assert outs[r1].logprobs is None and outs[r1].prompt_logprobs is None
    assert len(outs[r0].logprobs) == 5
    assert all(len(e["top_ids"]) == 2 for e in outs[r0].logprobs)
    assert all(len(e["top_ids"]) == 4 for e in outs[r2].logprobs)
    assert len(outs[r0].prompt_logprobs) == len(ps[0])
    plain = lp_engine(horizon=4)
    ids = [plain.add_request(p, max_new_tokens=5) for p in ps]
    want = {o.req_id: o.tokens for o in plain.run()}
    assert [outs[r].tokens for r in (r0, r1, r2)] == [want[i] for i in ids]


def test_logprobs_validation():
    eng = lp_engine()
    with pytest.raises(ValueError, match="logprobs"):
        eng.add_request(tokens(0, 5), logprobs=21)
    eng1 = Engine(CFG, system(chunk=1), params=PARAMS, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        eng1.add_request(tokens(0, 5), prompt_logprobs=True)


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_spec_engine_logprobs_match_plain(proposer):
    """Spec engines return logprobs: a greedy spec run's records match the
    plain engine's for the identical tokens."""
    from test_torch_spec_engine import DCFG, DPARAMS

    spec = (dict(spec_ngram=True, spec_gamma=3) if proposer == "ngram" else
            dict(draft_config=DCFG, draft_params=DPARAMS, spec_gamma=3))
    p = tokens(4, 10)
    plain = run_one(lp_engine(), p, max_new_tokens=8, logprobs=3)
    out = run_one(lp_engine(spec=spec), p, max_new_tokens=8, logprobs=3)
    assert out.tokens == plain.tokens
    assert len(out.logprobs) == len(out.tokens)
    for a, b in zip(out.logprobs, plain.logprobs):
        assert a["top_ids"][0] == b["top_ids"][0]
        assert a["logprob"] == pytest.approx(b["logprob"], abs=DENSE_TOL)


def test_prompt_logprobs_match_dense_across_chunks():
    """prefill_chunk 32 over a 50-token prompt re-feeds the boundary token:
    every prompt token i >= 1 scores log p(prompt[i] | prompt[:i])."""
    p = tokens(5, 50)
    pl = run_one(lp_engine(), p, max_new_tokens=2,
                 prompt_logprobs=True).prompt_logprobs
    assert pl is not None and len(pl) == len(p) and pl[0] is None
    lp = dense_logprobs(p)
    for i in range(1, len(p)):
        assert pl[i] == pytest.approx(float(lp[i - 1, p[i]]),
                                      abs=DENSE_TOL), i


def test_prompt_logprobs_single_chunk_and_prefix_cache():
    """A prompt already in the prefix cache is still scored (the claim is
    skipped for scoring requests), with identical tokens."""
    p = tokens(6, 9)
    eng = lp_engine()
    first = run_one(eng, p, max_new_tokens=4)
    out = run_one(eng, p, max_new_tokens=4, prompt_logprobs=True)
    assert out.tokens == first.tokens
    assert len(out.prompt_logprobs) == len(p)
    assert all(x is not None for x in out.prompt_logprobs[1:])


def test_prompt_logprobs_survive_preemption():
    """A preempted scoring request restarts prefill from 0: its partial
    scores clear, so re-admission does not duplicate entries."""
    eng = lp_engine()
    p = tokens(9, 50)
    rid = eng.add_request(p, max_new_tokens=2, prompt_logprobs=True)
    eng.step()
    req = eng._requests[rid]
    assert len(req.prompt_logprobs_data) > 0
    assert eng.scheduler.preempt_youngest() is req
    assert req.prompt_logprobs_data == []
    pl = {o.req_id: o for o in eng.run()}[rid].prompt_logprobs
    assert len(pl) == len(p)
    lp = dense_logprobs(p)
    for i in (1, 25, len(p) - 1):
        assert pl[i] == pytest.approx(float(lp[i - 1, p[i]]), abs=DENSE_TOL)


def test_prompt_logprobs_on_session_first_turn():
    p = tokens(31, 12)
    plain = run_one(lp_engine(), p, max_new_tokens=4, prompt_logprobs=True)
    eng = lp_engine()
    out = run_one(eng, p, max_new_tokens=4, prompt_logprobs=True,
                  session=True)
    assert out.prompt_logprobs == plain.prompt_logprobs
    assert out.tokens == plain.tokens
    rid = eng.continue_session(out.session_id, [5, 6, 7], max_new_tokens=3)
    out2 = {o.req_id: o for o in eng.run()}[rid]
    assert len(out2.tokens) == 3 and out2.prompt_logprobs is None


def test_one_host_copy_round_trips():
    """`utils.host.fetch` returns int32 and float32 tensors bit for bit
    through one concatenated copy."""
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4) - 5
    b = torch.randn(2, 3, 5)
    b[0, 0, 0] = float("-inf")
    ga, gb = fetch(a, b)
    assert ga.dtype == np.int32 and (ga == a.numpy()).all()
    assert gb.dtype == np.float32
    assert (gb.view(np.uint32) == b.numpy().view(np.uint32)).all()
    assert fetch() == []


# -- the port against the JAX engine -----------------------------------------

def serve_both(ps, spec=None, jspec=None, horizon=1):
    """The same requests on the port and on the JAX engine (float32
    attention compute, INT8 KV as served); returns both engines' outputs in
    request order. Not BF16 KV: there a one-ulp difference of a float32 K
    or V element between the two packages can round to the neighbouring
    bf16 value (2^-8 relative), which moves later logprobs by up to ~3e-4;
    an INT8 code flips only within one ulp of a half step."""
    res = []
    for eng in (lp_engine(cfg=F32, spec=spec, horizon=horizon, kv="int8"),
                jax_engine(cfg=JF32, batch=4, kv="int8", spec=jspec,
                           horizon=horizon)):
        ids = [eng.add_request(p, **r) for p, r in ps]
        outs = {o.req_id: o for o in eng.run()}
        res.append([outs[i] for i in ids])
    return res


@pytest.mark.parametrize("horizon", [1, 4])
def test_decode_logprobs_match_jax(horizon):
    ps = [(tokens(40 + i, 9 + 4 * i), dict(max_new_tokens=7, logprobs=5))
          for i in range(3)]
    got, want = serve_both(ps, horizon=horizon)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert_logprobs_close(g.logprobs, w.logprobs)


def test_prompt_logprobs_match_jax():
    """Chunks of 32 over 70- and 33-token prompts (boundary re-feeds) and
    a one-chunk prompt beside a plain lane."""
    ps = [(tokens(50, 70), dict(max_new_tokens=3, prompt_logprobs=True,
                                logprobs=2)),
          (tokens(51, 33), dict(max_new_tokens=3, prompt_logprobs=True)),
          (tokens(52, 12), dict(max_new_tokens=3, prompt_logprobs=True)),
          (tokens(53, 20), dict(max_new_tokens=3))]
    got, want = serve_both(ps)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        if w.prompt_logprobs is None:
            assert g.prompt_logprobs is None
            continue
        assert g.prompt_logprobs[0] is None and len(g.prompt_logprobs) == len(
            w.prompt_logprobs)
        np.testing.assert_allclose(g.prompt_logprobs[1:],
                                   w.prompt_logprobs[1:], rtol=0, atol=2e-4)
    assert_logprobs_close(got[0].logprobs, want[0].logprobs)


def test_spec_logprobs_match_jax():
    """n-gram speculation on a periodic prompt (drafts accepted and
    rejected) and a random one: the emitted tokens' logprob records."""
    ps = [(([11, 23, 37, 41] * 6)[:22], dict(max_new_tokens=12, logprobs=4)),
          (tokens(54, 14), dict(max_new_tokens=9, logprobs=4))]
    spec = dict(spec_ngram=True, spec_gamma=3)
    got, want = serve_both(ps, spec=spec, jspec=spec)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert_logprobs_close(g.logprobs, w.logprobs)
