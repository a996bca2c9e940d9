"""Speculative decoding through the port's `Engine` on the CPU (plain
attention versions), with `tiny_test_config()` and a one-layer draft, the
JAX weights carried over:

- against itself: greedy speculative output is IDENTICAL to plain greedy
  output of the same engine, with the draft model and with n-gram lookup,
  on an ample and an oversubscribed pool (`tests/test_spec_decode.py:92`,
  `:112`, `tests/test_ngram_spec.py:138`, `:148`); a self-draft over BF16
  caches accepts every draft (`test_spec_decode.py:129`); a request that
  fills the table finishes (`:149`); sampled lanes run, finish and repeat
  under one seed (`:221`); top_p -> 0 collapses sampled n-gram serving to
  greedy (`test_ngram_spec.py:179`);
- against the JAX engine (Pallas kernels in interpret mode): the same
  greedy tokens or a first divergence at a near-tie
  (`test_torch_engine.assert_same_or_near_tie`), the same `"spec"`
  statistics keys, and, when the tokens agree, the same spec counts and
  residency statistics; the draft cache's slot table equal to the JAX
  engine's after every step, through prefix sharing, frees and
  Mistral-style window retirement;
- the refusals: both proposal sources at once, a scheme switch and
  penalties (logprobs are served: `tests/test_torch_logprobs.py`).
"""

import dataclasses

import jax
import numpy as np
import pytest
from test_torch_engine import (
    CFG,
    JPARAMS,
    PARAMS,
    assert_same_or_near_tie,
    prompts,
    system,
)

from cxl_speckv_tpu.config import CacheConfig as JCacheConfig
from cxl_speckv_tpu.config import EngineConfig as JEngineConfig
from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.config import PrefetchConfig as JPrefetchConfig
from cxl_speckv_tpu.config import SystemConfig as JSystemConfig
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models.configs import LlamaConfig as JLlamaConfig
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.models.llama import init_params as j_init_params
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models.configs import LlamaConfig
from cxl_speckv_tpu_torch.models.convert import params_from_jax

DRAFT = dict(vocab_size=CFG.vocab_size, hidden_size=32, intermediate_size=64,
             num_layers=1, num_q_heads=2, num_kv_heads=2, head_dim=16,
             rope_theta=10000.0, tie_embeddings=False, max_seq_len=512,
             eos_token_id=0, dtype="float32")
DCFG, JDCFG = LlamaConfig(**DRAFT), JLlamaConfig(**DRAFT)
JDPARAMS = j_init_params(JDCFG, jax.random.PRNGKey(7))
DPARAMS = params_from_jax(jax.tree.map(np.asarray, JDPARAMS))
JMODS = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig, JSystemConfig)
GAMMA = 3


def spec_kw(proposer, jax_side=False, gamma=GAMMA):
    if proposer == "ngram":
        return dict(spec_ngram=True, spec_gamma=gamma)
    return dict(draft_config=JDCFG if jax_side else DCFG,
                draft_params=JDPARAMS if jax_side else DPARAMS,
                spec_gamma=gamma)


def engine(proposer=None, hbm=256, batch=4, kv="int8", cfg=CFG, seed=0,
           params=PARAMS, **kw):
    spec = spec_kw(proposer) if proposer else {}
    spec.update(kw)
    return Engine(cfg, system(hbm, 256, batch, 1, kv=kv), params=params,
                  device="cpu", seed=seed, enable_lstm=False, **spec)


def jax_engine(proposer, hbm=256, batch=4, cfg=None, use_pallas=True,
               **kw):
    return JEngine(cfg or j_tiny(), system(hbm, 256, batch, 1, mods=JMODS),
                   params=JPARAMS, use_pallas=use_pallas, enable_lstm=False,
                   **spec_kw(proposer, jax_side=True), **kw)


def run_all(eng, ps, max_new=10, **kw):
    ids = [eng.add_request(p, max_new_tokens=max_new, **kw) for p in ps]
    outs = {o.req_id: o for o in eng.run()}
    return [outs[i].tokens for i in ids]


# ---------------------------------------------------------------------------
# the engine against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hbm", [256, 14])
@pytest.mark.parametrize("proposer", ["draft", "ngram"])
def test_greedy_spec_equals_plain(proposer, hbm):
    """Exactly the plain engine's greedy tokens, on an ample pool and on an
    oversubscribed one (14 blocks: migrations both ways)."""
    ps = prompts(6, seed=1)
    want = run_all(engine(), ps)
    eng = engine(proposer, hbm=hbm)
    assert run_all(eng, ps) == want
    st = eng.get_statistics()
    assert st["spec"]["rounds"] > 0 and st["spec"]["drafted"] > 0
    assert st["spec"]["tokens_per_round"] >= 1.0
    assert st["scheduler"]["decode_batches"] == st["spec"]["rounds"]
    if hbm < 256:
        assert st["transfer"]["up_transfers"] > 0
        assert st["transfer"]["down_transfers"] > 0
    for phase in ("decode.spec_resident", "decode.spec_propose",
                  "decode.spec_verify"):
        assert st["phases"][phase]["count"] == st["spec"]["rounds"]
    if proposer == "draft":
        # one draft prefill pass mirrors every target prefill wave
        assert eng.spec.prefill_dispatches == st["engine"]["prefill_dispatches"]


def test_ngram_repetitive_prompt_accepts():
    """A periodic prompt: the lookup proposals are accepted, and the output
    is still the plain engine's."""
    p = ([11, 23, 37, 41] * 8)[:30]
    want = run_all(engine(), [p], max_new=16)
    eng = engine("ngram")
    assert run_all(eng, [p], max_new=16) == want
    st = eng.get_statistics()["spec"]
    assert st["drafted"] >= 16


def test_self_draft_bf16_accepts_everything():
    """Draft == target with BF16 caches on both sides: every draft is
    accepted, so each round of one lane emits gamma + 1 tokens."""
    eng = engine(kv="bf16", draft_config=CFG, draft_params=PARAMS,
                 spec_draft_kv="bf16", spec_gamma=GAMMA)
    run_all(eng, prompts(1, seed=3), max_new=9)
    st = eng.get_statistics()["spec"]
    assert st["acceptance_rate"] == 1.0, st
    assert st["tokens_per_round"] == GAMMA + 1, st


@pytest.mark.parametrize("proposer", ["draft", "ngram"])
def test_spec_at_table_capacity(proposer):
    """prompt + max_new_tokens == max_seq_len: the verify extension is
    clamped to the table, and the request finishes with the plain
    engine's tokens."""
    prompt = np.random.RandomState(3).randint(1, CFG.vocab_size, 100).tolist()
    eng = engine(proposer)
    n = eng.config.engine.max_seq_len - len(prompt)
    rid = eng.add_request(prompt, max_new_tokens=n)
    outs = eng.run()
    assert len(outs) == 1 and outs[0].req_id == rid
    assert outs[0].finish_reason in ("length", "eos")
    assert outs[0].tokens == run_all(engine(), [prompt], max_new=n)[0]


@pytest.mark.parametrize("proposer", ["draft", "ngram"])
def test_sampled_spec_runs_finishes_and_repeats(proposer):
    """Temperature lanes under speculation finish, and one seed gives the
    same tokens twice."""
    ps = prompts(4, seed=5)

    def run():
        eng = engine(proposer, seed=11)
        return run_all(eng, ps, max_new=12, temperature=0.9), eng

    (a, eng), (b, _) = run(), run()
    assert a == b
    assert all(1 <= len(t) <= 12 for t in a)
    st = eng.get_statistics()["spec"]
    assert st["rounds"] > 0 and st["drafted"] > 0


def test_ngram_tiny_top_p_collapses_to_greedy():
    """top_p 1e-3 leaves the argmax alone in the nucleus, so sampled n-gram
    serving emits the greedy tokens (top_p >= 0.001: the sampling word
    holds it in 1e-3 units)."""
    ps = prompts(4, seed=9)
    want = run_all(engine(), ps)
    got = run_all(engine("ngram", seed=5), ps, temperature=0.7, top_p=1e-3)
    assert got == want


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("proposer", ["draft", "ngram"])
def test_spec_matches_jax_engine(proposer):
    ps = prompts(6, seed=5)
    jeng = jax_engine(proposer, hbm=14)
    want = run_all(jeng, ps)
    eng = engine(proposer, hbm=14)
    got = run_all(eng, ps)
    assert_same_or_near_tie(ps, got, want)
    st, jst = eng.get_statistics(), jeng.get_statistics()
    assert set(st["spec"]) == set(jst["spec"])
    assert st["transfer"]["up_transfers"] > 0
    if got == want:
        # the same tokens, drafts and schedule: the same counts
        assert st["spec"] == jst["spec"]
        for key in ("transfer", "directory", "scheduler", "pool", "runtime"):
            assert st[key] == jst[key], key


def test_draft_table_follows_jax_engine():
    """The draft cache's slot table, slot map and free list equal the JAX
    engine's after every step: prompts that share a 16-token prefix (two
    full blocks claimed from the prefix cache), requests that finish at
    different lengths (their slots freed, the shared ones kept), and a
    16-token sliding window (Mistral-style retirement releases slots). The
    JAX engine runs its reference attention here: the table follows the
    schedule, which the same tokens fix."""
    cfg = dataclasses.replace(CFG, sliding_window=16)
    jcfg = dataclasses.replace(j_tiny(), sliding_window=16)
    rng = np.random.RandomState(23)
    shared = rng.randint(1, CFG.vocab_size, 16).tolist()
    ps = [shared + rng.randint(1, CFG.vocab_size, n).tolist()
          for n in (3, 9, 5)] + [rng.randint(1, CFG.vocab_size, 12).tolist()]
    news = (20, 6, 14, 9)
    eng = engine("draft", cfg=cfg)
    jeng = jax_engine("draft", cfg=jcfg, use_pallas=False)
    outs, jouts = [], []
    for step in range(200):
        if step < len(ps):
            # one arrival a step: the first prompt's blocks are registered
            # in the prefix cache before the sharers arrive
            for e in (eng, jeng):
                e.add_request(ps[step], max_new_tokens=news[step])
        elif not (eng.has_work or jeng.has_work):
            break
        outs += eng.step()
        jouts += jeng.step()
        np.testing.assert_array_equal(eng.spec.table, jeng.spec.table)
        assert eng.spec._slot_of_bid == jeng.spec._slot_of_bid
        assert eng.spec._free == jeng.spec._free
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    st = eng.get_statistics()
    assert st["runtime"]["prefix_hit_blocks"] > 0
    assert st["runtime"]["window_retired_blocks"] > 0
    assert (eng.spec.table == eng.spec.guard_slot).all()
    assert len(eng.spec._free) == eng.spec.guard_slot


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_spec_refusals():
    with pytest.raises(ValueError, match="mutually exclusive"):
        engine("ngram", draft_config=DCFG)
    for proposer in ("draft", "ngram"):
        eng = engine(proposer)
        with pytest.raises(ValueError, match="single KV scheme"):
            eng.set_kv_dtype("fp8")
        eng.set_kv_dtype("int8")                  # the same scheme is fine
        # penalties are refused on spec engines, as the JAX engine refuses
        # them (`tests/test_penalties.py:409`); logprobs are served
        with pytest.raises(ValueError, match="speculative"):
            eng.add_request([1, 2, 3], frequency_penalty=0.5)
        rid = eng.add_request([1, 2, 3], max_new_tokens=3, logprobs=2)
        out = eng.run()[0]
        assert out.req_id == rid and len(out.logprobs) == len(out.tokens)


def test_seeded_draft_when_no_params():
    """draft_params=None draws a seeded draft, W8A16 under weight_dtype
    int8 as the JAX engine quantizes its drawn draft: one seed serves the
    same tokens twice, and greedy output is the plain W8A16 engine's."""
    from cxl_speckv_tpu_torch.ops.wquant import is_quantized

    def w8(**kw):
        sc = system(256, 256, 4, 1)
        sc.engine.weight_dtype = "int8"
        return Engine(CFG, sc, params=PARAMS, device="cpu", seed=4, **kw)

    ps = prompts(3, seed=13)
    want = run_all(w8(), ps)
    got = []
    for _ in range(2):
        eng = w8(draft_config=DCFG, spec_gamma=GAMMA)
        assert is_quantized(eng.spec.params)
        got.append(run_all(eng, ps))
    assert got == [want, want]


def test_draft_prefill_single_equals_batched():
    """`SpecDecoder.prefill` (one sequence's right-padded chunks through
    `prefill_chunk`) writes the draft cache as `prefill_batch` (the wave
    through `prefill_batch_packed`) does: the same slot table and the same
    pool bytes outside the guard slot (which the pads of both write); each
    pass counts one draft prefill dispatch."""
    import torch

    prompt = np.random.RandomState(29).randint(1, CFG.vocab_size, 21)
    pools = []
    for how in ("single", "batched"):
        eng = engine("draft")
        slot = eng.kvc.add_seq()
        assert eng.kvc.extend_seq(slot, len(prompt))
        spec = eng.spec
        for start, n in ((0, 16), (16, 5)):
            if how == "single":
                chunk = np.zeros(16, np.int64)
                chunk[:n] = prompt[start:start + n]
                spec.prefill(slot, torch.from_numpy(chunk), start, n)
            else:
                spec.prefill_batch([(slot, start, n, prompt[start:start + n])],
                                   chunk=16, batch=4)
        assert spec.prefill_dispatches == 2
        pools.append((spec.table[slot].copy(), spec.pools))
    np.testing.assert_array_equal(pools[0][0], pools[1][0])
    for a, b in zip(pools[0][1], pools[1][1]):
        assert torch.equal(a[:, :-1], b[:, :-1])
