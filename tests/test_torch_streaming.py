"""The port's host-streamed serving path on the CPU: the counterparts of
`tests/test_streaming.py`, and the port's engine against the JAX engine.

A request past `max_seq_len` or the HBM pool keeps its whole KV in the host
tier and streams it through attention wave by wave. The decisive
invariants, as in the JAX tests: a streamed request generates the tokens an
ample pooled engine generates (here at float32 attention compute, `F32`, so
that the pooled kernels' plain versions and the streamed float32 math
agree); the staged-gather path equals the per-(layer, wave) path and the
fused decode equals the per-token decode bit for bit (same waves, same
bytes). Against the JAX engine (weights carried over, its reference
attention): the same greedy tokens and `stream_chunks` / `stream_tokens`
for Llama (staged), Gemma-2 (mixed windows: per-wave) and GPT-OSS (sinks),
and host-tier KV within `tests/test_torch_llama.py`'s pool bounds.
"""

import dataclasses

import jax
import numpy as np
import pytest
from torch_surface import (F32, JAX, JF32, JPARAMS, PARAMS, PORT, system,
                           tokens)

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.runtime.hoststore import StoreOps
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models import llama as tl
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.ops.quant import kv_pack, kv_storage_dtype
from cxl_speckv_tpu_torch.runtime.hoststore import DeviceHostStore

LSB_SHARE = 1e-3       # stored values one step apart (test_torch_llama.py)
# host-tier scales: test_torch_llama.py holds pool scales to 1e-6 (a few
# float32 ulps). Layer 0's streamed scales stay inside it (4.9e-7 at most);
# layer 1's input carries both packages' float32 streamed softmax over
# 40-55 tokens, summed in another order: up to 1.15e-6 (2 of 448 values
# above 1e-6, median 1.6e-7), so layer 1 is held to 2e-6
SCALE_RTOL = (1e-6, 2e-6)
GEMMA = dict(sliding_window=6, attn_pattern=(True, False), attn_softcap=30.0,
             final_softcap=10.0, norm_offset=True, post_norms=True,
             act_fn="gelu_tanh", embed_scale=True, query_scale=10.0**-0.5)
GPT_OSS = dict(attn_sinks=True, o_bias=True, attn_bias=True, num_experts=4,
               num_experts_per_tok=2, moe_style="gpt_oss", sliding_window=6,
               attn_pattern=(True, False))
FAMILIES = {"llama": {}, "gemma2": GEMMA, "gpt_oss": GPT_OSS}


def stream_sys(mods=PORT, hbm=6, host=64, seq=64, chunk=16, horizon=1,
               **ekw):
    """A 40-token prompt exceeds this pooled path's capacity (hbm 6 - 2
    blocks of 8 = 32 tokens): it routes host-streamed."""
    return system(mods, hbm=hbm, host=host, seq=seq, chunk=chunk,
                  horizon=horizon, prefetch=False, **ekw)


def engine(cfg=F32, params=PARAMS, **kw):
    return Engine(cfg, stream_sys(**kw), params=params, device="cpu")


def ample(cfg=F32, params=PARAMS, horizon=1):
    return Engine(cfg, system(hbm=64, host=64, seq=160, chunk=16,
                              horizon=horizon, prefetch=False),
                  params=params, device="cpu")


def serve(eng, prompts, gen, **kw):
    ids = [eng.add_request(p, max_new_tokens=gen, **kw) for p in prompts]
    outs = {o.req_id: o for o in eng.run()}
    return [outs[i] for i in ids]


def test_stream_routing():
    eng = engine()
    rid = eng.add_request(tokens(0, 10), max_new_tokens=8)
    assert not eng._stream_queue            # fits HBM: the pooled path
    rid2 = eng.add_request(tokens(1, 40), max_new_tokens=12)
    assert len(eng._stream_queue) == 1      # past the HBM budget: streamed
    outs = eng.run()
    assert {o.req_id for o in outs} == {rid, rid2}
    assert all(o.finish_reason in ("length", "eos") for o in outs)
    assert eng.kvc.directory.host_free == 64


def test_stream_matches_ample_greedy():
    """A sequence larger than the HBM pool decodes the tokens of an engine
    where everything fits."""
    p = tokens(3, 40)
    eng = engine()
    rid = eng.add_request(p, max_new_tokens=12)
    assert rid in {r.req_id for r in eng._stream_queue}
    out = eng.run()
    assert len(out) == 1 and len(out[0].tokens) == 12
    st = eng.get_statistics()["engine"]
    assert st["stream_chunks"] == 3          # 40 tokens in chunks of 16
    assert st["stream_tokens"] == 11         # the first token: prefill's
    assert st["stream_time_s"] > 0
    assert serve(ample(), [p], 12)[0].tokens == out[0].tokens


def test_stream_staged_paths_match():
    """Staged gathers (one per layer group), the same with the budget
    forcing groups of one layer (stage_mb 1 at a 1024-block wave), and
    per-(layer, wave) fetches give identical tokens, equal to the ample
    pooled engine's."""
    p = tokens(7, 40)
    got = {}
    for label, stage_mb, wave in (("per-wave", 0, 16), ("staged", 256, 16),
                                  ("grouped", 1, 1024)):
        eng = engine(host=1100, max_stream_seq_len=8192,
                     stream_wave=wave, stream_stage_mb=stage_mb)
        got[label] = serve(eng, [p], 8)[0].tokens
    assert got["per-wave"] == got["staged"] == got["grouped"]
    assert got["staged"] == serve(ample(), [p], 8)[0].tokens


def test_stream_mixed_with_normal_traffic():
    eng = engine(hbm=8)
    normal = [eng.add_request(tokens(i, 10), max_new_tokens=8)
              for i in range(3)]
    big = eng.add_request(tokens(9, 48), max_new_tokens=10)
    outs = {o.req_id: o for o in eng.run()}
    assert set(outs) == set(normal) | {big}
    assert len(outs[big].tokens) == 10
    assert eng.kvc.directory.host_free == 64       # stream blocks freed
    # the pooled requests are untouched by the streamed one
    alone = serve(engine(hbm=8), [tokens(i, 10) for i in range(3)], 8)
    assert [outs[i].tokens for i in normal] == [o.tokens for o in alone]


def test_concurrent_streams_one_dispatch():
    """Several streamed lanes advance in one call a phase, and each decodes
    as it does alone: lanes run one after another, never mixing."""
    ps = [tokens(20 + i, 40) for i in range(3)]
    solo = [serve(engine(), [p], 8)[0].tokens for p in ps]
    eng = engine(host=256)
    outs = serve(eng, ps, 8)
    assert [o.tokens for o in outs] == solo
    st = eng.get_statistics()["engine"]
    assert st["stream_tokens"] == 3 * 7
    assert st["steps"] <= 3 + 8               # 3 chunks, 7 tokens, admission


def test_stream_logprobs():
    eng = engine()
    out = serve(eng, [tokens(7, 40)], 6, logprobs=3)[0]
    assert out.logprobs is not None and len(out.logprobs) == len(out.tokens)
    for tok, entry in zip(out.tokens, out.logprobs):
        assert entry["top_ids"][0] == tok          # greedy = argmax
        assert abs(entry["logprob"] - entry["top_logprobs"][0]) < 1e-5
        assert len(entry["top_ids"]) == 3
    out2 = serve(eng, [tokens(8, 40)], 4, prompt_logprobs=True)[0]
    assert len(out2.prompt_logprobs) == 40


def test_stream_capacity_rejection():
    eng = engine(host=16)
    with pytest.raises(ValueError, match="host-streamed capacity"):
        eng.add_request(tokens(0, 200), max_new_tokens=100)
    off = engine(stream_enabled=False)
    with pytest.raises(ValueError, match="max_seq_len"):
        off.add_request(tokens(0, 60), max_new_tokens=8)


def test_128k_shaped_config():
    """BASELINE config 3's shape: a 128k-token stream table (only the waves
    with context run), with a real sequence beyond the HBM pool."""
    eng = engine(hbm=4, host=2052, seq=32, max_stream_seq_len=131072)
    assert eng._stream_max_blocks * 8 >= 16384      # host-capacity bound
    p = tokens(11, 100)
    out = serve(eng, [p], 8)[0]
    assert len(out.tokens) == 8
    assert out.tokens == serve(ample(), [p], 8)[0].tokens


@pytest.mark.parametrize("stage_mb", [256, 0])
def test_stream_fused_decode_matches_per_token(stage_mb):
    """Fused streamed decode (a horizon of steps against a once-staged
    slab) gives the per-token path's tokens, across block boundaries, for
    two lanes, with a final round that overshoots (21 % 4 != 0). At
    stage_mb 0 the dispatch takes the per-token path (the budget is 0)."""
    ps = [tokens(3, 50), tokens(4, 45)]
    base = [o.tokens for o in serve(engine(seq=32), ps, 21)]
    eng = engine(seq=32, horizon=4, stream_stage_mb=stage_mb)
    assert [o.tokens for o in serve(eng, ps, 21)] == base
    assert eng.get_statistics()["engine"]["stream_tokens"] == 2 * 20


def test_stream_fused_decode_logprobs_and_stops():
    p = tokens(5, 50)
    base = serve(engine(seq=32), [p], 12, logprobs=2)[0]
    out = serve(engine(seq=32, horizon=4), [p], 12, logprobs=2)[0]
    assert out.tokens == base.tokens
    assert len(out.logprobs) == len(out.tokens)
    for a, b in zip(out.logprobs, base.logprobs):
        assert a["top_ids"] == b["top_ids"]
        assert a["logprob"] == b["logprob"]
    # a stop token mid-horizon truncates the emission at the stop
    stop = base.tokens[5]
    first = base.tokens.index(stop)
    out = serve(engine(seq=32, horizon=4), [p], 12, stop_token_ids=[stop])[0]
    assert out.finish_reason == "stop"
    assert out.tokens == base.tokens[:first + 1]


def test_stream_fused_decode_budget_fallback():
    """Slabs over 4 x stream_stage_mb fall back to the per-token path, by
    the JAX rule (context waves rounded up to a power of two, live lanes
    only): the same tokens either way."""
    p = tokens(6, 50)
    base = serve(engine(seq=32, horizon=4), [p], 10)[0].tokens
    # one 4096-block wave of the 2-layer model is 5 MB, over 4 x 1 MB
    eng = engine(seq=32, horizon=4, stream_stage_mb=1, stream_wave=4096,
                 host=4200)
    calls = []
    fused = eng._stream_decode_fused
    eng._stream_decode_fused = lambda *a: calls.append(fused(*a)) or calls[-1]
    assert serve(eng, [p], 10)[0].tokens == base
    assert calls and not any(calls)       # the budget refused every round


def test_stream_fused_session_continues():
    """A streamed session served with fused decode: the continuation
    matches a fresh full-history request."""
    p = tokens(7, 50)
    eng = engine(seq=32, horizon=4)
    out = serve(eng, [p], 6, session=True)[0]
    rid = eng.continue_session(out.session_id, [11, 12, 13], max_new_tokens=6)
    got = {o.req_id: o for o in eng.run()}[rid].tokens
    want = serve(engine(seq=32, horizon=4), [p + out.tokens + [11, 12, 13]],
                 6)[0].tokens
    assert got == want


def test_streamed_request_on_spec_engine():
    """A speculative engine serves a streamed request through the streamed
    path (no speculation there), as the JAX engine does: the tokens of a
    plain engine."""
    p = tokens(9, 40)
    spec = Engine(F32, stream_sys(), params=PARAMS, device="cpu",
                  spec_ngram=True, spec_gamma=3)
    out = serve(spec, [p], 8)[0]
    assert out.tokens == serve(engine(), [p], 8)[0].tokens
    assert (spec.get_statistics()["engine"]["stream_tokens"]
            == len(out.tokens) - 1)
    assert spec.spec.get_statistics().rounds == 0


# ---------------------------------------------------------------------------
# the port's engine against the JAX engine
# ---------------------------------------------------------------------------

def family_models(family):
    kw = FAMILIES[family]
    jcfg = dataclasses.replace(j_tiny(), attn_compute_dtype="float32", **kw)
    cfg = dataclasses.replace(tiny_test_config(),
                              attn_compute_dtype="float32", **kw)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _assert_store_close(jstore, store, n_slots):
    """The used slots' rows of the 2-layer models: scales to SCALE_RTOL by
    layer, stored int8 values equal but for LSB_SHARE of them one step
    apart (the two packages' float32 sums differ in order)."""
    rows = n_slots * store.num_layers
    for want, got, name in zip((jstore.k, jstore.v, jstore.ks, jstore.vs),
                               store.arrays, ("k", "v", "ks", "vs")):
        w = np.asarray(want)[:rows]
        g = got[:rows].numpy()
        if name.startswith(("ks", "vs")):
            for layer, rtol in enumerate(SCALE_RTOL):
                np.testing.assert_allclose(g[layer::2], w[layer::2],
                                           rtol=rtol, atol=0, err_msg=name)
            continue
        d = np.abs(g.astype(np.int64) - w.astype(np.int64))
        assert d.max() <= 1, f"store {name}: a value off by {d.max()} steps"
        assert (d > 0).mean() <= LSB_SHARE, f"store {name}: {(d > 0).sum()}"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stream_engine_matches_jax(family):
    """Two concurrent streamed requests (and one pooled), decode horizon 4:
    Llama takes the staged gathers and the fused decode, Gemma-2 (mixed
    windows) and GPT-OSS (sinks, mixed windows) the per-wave fetches and
    per-token decode, in both packages."""
    jcfg, cfg, jp, tp = family_models(family)
    ps = [tokens(30, 40), tokens(31, 45), tokens(32, 9)]
    jeng = JEngine(jcfg, stream_sys(JAX, horizon=4), params=jp,
                   use_pallas=False, enable_lstm=False)
    want = serve(jeng, ps, 10)
    eng = Engine(cfg, stream_sys(horizon=4), params=tp, device="cpu")
    got = serve(eng, ps, 10)
    assert [o.tokens for o in got] == [o.tokens for o in want]
    st, jst = eng.get_statistics()["engine"], jeng.get_statistics()["engine"]
    for key in ("stream_chunks", "stream_tokens", "tokens_generated"):
        assert st[key] == jst[key], key
    assert st["stream_chunks"] == 3 + 3
    _assert_store_close(jeng.kvc.store, eng.kvc.store, 2 * 7)


def test_stream_per_wave_matches_jax():
    """The per-wave path on a uniform-window model (stage_mb 0) against the
    JAX engine's (there, its pipelined fetches): the same tokens."""
    ps = [tokens(33, 40)]
    jeng = JEngine(JF32, stream_sys(JAX, stream_stage_mb=0), params=JPARAMS,
                   use_pallas=False, enable_lstm=False)
    eng = engine(stream_stage_mb=0)
    assert ([o.tokens for o in serve(eng, ps, 8)]
            == [o.tokens for o in serve(jeng, ps, 8)])


def test_stream_chunk_not_a_block_multiple():
    """A prefill chunk of 12 on 8-token blocks with prompt logprobs (the
    boundary re-feed moves chunk starts to offsets 3, 6, ...): every
    chunk's KV is appended (the JAX packing's T // bs + 1 touched blocks
    would drop a chunk's last positions there), so the tokens and prompt
    scores are the ample pooled engine's."""
    p = tokens(34, 44)
    out = serve(engine(chunk=12), [p], 6, prompt_logprobs=True)[0]
    amp = Engine(F32, system(hbm=64, host=64, seq=160, chunk=12,
                             prefetch=False), params=PARAMS, device="cpu")
    want = serve(amp, [p], 6, prompt_logprobs=True)[0]
    assert out.tokens == want.tokens
    np.testing.assert_allclose(out.prompt_logprobs[1:],
                               want.prompt_logprobs[1:], rtol=0, atol=2e-4)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_stream_step_matches_jax(kv):
    """`stream_step` (one lane, context read wave by wave from the store,
    the chunk appended back) against the JAX function on the same store:
    two prefill chunks (the second one short) and a decode token give the
    same tokens, logprobs within LP_TOL, and store bytes within the bounds
    above."""
    import jax.numpy as jnp
    from torch_surface import LP_TOL

    cfg, jcfg = F32, JF32
    slots, bs, wave, max_blocks = 10, 8, 2, 8
    L, hkv = cfg.num_layers, cfg.num_kv_heads
    kvd = KVDtype(kv)
    store = DeviceHostStore(slots, L, bs, hkv, cfg.head_dim // kv_pack(kvd),
                            kv_storage_dtype(kvd), pin=False)
    jstores = tuple(jnp.asarray(a.numpy()) for a in store.arrays)
    row = np.random.RandomState(5).permutation(slots)
    prompt = tokens(35, 27)
    steps = [(0, prompt[:16], 16), (16, prompt[16:], 16), (27, None, 1)]
    tok = None
    for start, toks, T in steps:
        toks = toks if toks is not None else [tok]
        nblk = T // bs + 1
        tw = -(-max_blocks // wave) * wave + nblk
        packed = np.zeros(4 + tw + T, np.int32)
        packed[:3] = start, len(toks), 0
        packed[3] = start + 1
        packed[4:4 + tw] = slots
        packed[4:4 + 4] = row[:4]
        packed[4 + tw:4 + tw + len(toks)] = toks
        want = jl.stream_step(JPARAMS, jcfg, JKV(kv), jnp.asarray(packed),
                              *jstores, max_blocks=max_blocks, wave=wave,
                              store_ops=StoreOps(pinned=False), logprobs_k=3)
        jstores = tuple(want[1:5])
        got = tl.stream_step(PARAMS, cfg, kvd, packed, store,
                             max_blocks=max_blocks, wave=wave, logprobs_k=3)
        tok = int(got[0])
        assert tok == int(want[0])
        np.testing.assert_allclose(float(got[1]), float(want[5]), atol=LP_TOL)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[7]),
                                   atol=LP_TOL)

    class JStore:
        k, v, ks, vs = jstores
    _assert_store_close(JStore, store, slots)
