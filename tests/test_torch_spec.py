"""The port's speculative-decoding pieces against the JAX package's, on the
CPU, with `tiny_test_config()` and the JAX weights and pools carried over
(`params_from_jax`, `pools_from_jax`), inputs drawn with numpy seeds:

- acceptance (`engine/spec.accept_core` against JAX `_accept_core`):
  greedy lanes' n_acc and final token bit for bit, with draft logits and
  with the one-hot q of deterministic proposals; sampled lanes by
  distribution, since torch's generator is not threefry: over DRAWS lanes
  the first emitted token's histogram lies within TV_BOUND (total
  variation) of the exact target law, softmax(target / t), nucleus-filtered
  under top-p (sampling noise alone is ~0.008 at 8 tokens);
- `verify_step` and `prefill_chunk` against the JAX ones on the same pools
  (Pallas kernels in interpret mode), at float32 and bfloat16 attention
  compute: logits within DENSE_TOL = 2e-4; at bfloat16 compute (the
  serving one, as `tests/test_torch_llama.py` checks pools) the appended
  rows and scales as that file bounds them: stored values to the last
  step, scales to a few float32 ulps. (At float32 compute the two
  attention sums' last-bit differences reach layer 1's K scales at ~1e-6
  relative, beyond that bound; the logits bound holds there.) Verify
  logits also against `forward_dense` rows;
- `decode_multi(..., return_logits=True)`: the per-step logits equal
  step-by-step `decode_step` logits bit for bit, and the JAX ones within
  DENSE_TOL;
- `NgramProposer.lookup` bit for bit against the JAX one.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llama import _assert_pools_equal, _jax_pools, _torch_pools

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.engine import spec as jspec
from cxl_speckv_tpu.engine.sampling import nucleus_filter as j_nucleus
from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.engine import spec as tspec
from cxl_speckv_tpu_torch.models import llama as tl
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax

JCFG = dataclasses.replace(j_tiny(), attn_compute_dtype="float32")
CFG = dataclasses.replace(tiny_test_config(), attn_compute_dtype="float32")
COMPUTE = ["float32", "bfloat16"]
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(11))
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS))
DENSE_TOL = 2e-4
DRAWS, TV_BOUND = 20000, 0.025
BS, SLOTS, MB, CHUNK = 8, 12, 4, 16


# ---------------------------------------------------------------------------
# acceptance
# ---------------------------------------------------------------------------

def _greedy_case(seed, B=64, gamma=3, V=16):
    """Target logits, draft logits and drafts that match the target's
    argmax for a random prefix of each lane, then differ."""
    rng = np.random.RandomState(seed)
    tgt = rng.randn(B, gamma + 1, V).astype(np.float32)
    dl = rng.randn(B, gamma, V).astype(np.float32)
    drafts = rng.randint(0, V, (B, gamma)).astype(np.int32)
    keep = rng.randint(0, gamma + 1, B)
    preds = tgt.argmax(-1)
    for b in range(B):
        drafts[b, :keep[b]] = preds[b, :keep[b]]
    return tgt, dl, drafts


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("onehot", [False, True])
def test_accept_greedy_lanes_match_jax_bitwise(onehot, sampled):
    """Greedy lanes: n_acc and final equal JAX `_accept_core`'s, bit for
    bit, with draft logits and with the one-hot q; both through the
    greedy-only path (`sampled=False`) and the full rule, where greedy
    lanes sit beside sampled ones."""
    gamma = 3
    tgt, dl, drafts = _greedy_case(1, gamma=gamma)
    B = tgt.shape[0]
    temps = np.zeros(B, np.float32)
    if sampled:
        temps[1::2] = 0.8           # odd lanes sample; even lanes compared
    top_ps = np.zeros(B, np.float32)
    want = jspec._accept_program(
        jnp.asarray(tgt), None if onehot else jnp.asarray(dl),
        jnp.asarray(drafts), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(np.array([1, 2], np.uint32)), gamma=gamma)
    got = tspec.accept_core(
        torch.from_numpy(tgt), None if onehot else torch.from_numpy(dl),
        torch.from_numpy(drafts), torch.from_numpy(temps),
        torch.from_numpy(top_ps), torch.Generator().manual_seed(3),
        gamma=gamma, sampled=sampled, nucleus=False)
    greedy = temps <= 0
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy()[greedy], np.asarray(w)[greedy])


def _law(t_log, temp, top_p):
    """The exact target law: softmax(t_log / temp), nucleus-filtered where
    top-p is on (JAX `nucleus_filter`)."""
    p = jax.nn.softmax(jnp.asarray(t_log) / temp)
    if 0 < top_p < 1:
        p = j_nucleus(p[None], jnp.asarray([top_p]))[0]
    return np.asarray(p, np.float64)


@pytest.mark.parametrize("kind", ["draft_q", "onehot_q", "top_p"])
def test_accept_sampled_lanes_follow_target_law(kind):
    """Over DRAWS lanes sharing one (p, q) pair, the first emitted token's
    histogram is within TV_BOUND of the exact target law: drafts drawn
    from q (draft_q, top_p: q nucleus-filtered as the draft draws it) or a
    fixed deterministic draft with the one-hot q (onehot_q: its acceptance
    rate is p(draft))."""
    V, gamma, temp = 8, 2, 0.9
    top_p = 0.8 if kind == "top_p" else 0.0
    rng = np.random.RandomState({"draft_q": 4, "onehot_q": 5, "top_p": 6}[kind])
    t_log = rng.randn(V).astype(np.float32) * 1.5
    d_log = rng.randn(V).astype(np.float32) * 1.5
    gen = torch.Generator().manual_seed(7)
    tgt = torch.from_numpy(np.broadcast_to(t_log, (DRAWS, gamma + 1, V)).copy())
    temps = torch.full((DRAWS,), temp)
    top_ps = torch.full((DRAWS,), top_p)
    if kind == "onehot_q":
        dl = None
        drafts = torch.full((DRAWS, gamma), int(np.argsort(t_log)[-2]),
                            dtype=torch.int32)
    else:
        dl = torch.from_numpy(np.broadcast_to(d_log, (DRAWS, gamma, V)).copy())
        q = torch.from_numpy(_law(d_log, temp, top_p)).float()
        drafts = torch.multinomial(q, DRAWS * gamma, replacement=True,
                                   generator=gen).reshape(DRAWS, gamma).int()
    n_acc, final = tspec.accept_core(tgt, dl, drafts, temps, top_ps, gen,
                                     gamma=gamma)
    first = torch.where(n_acc > 0, drafts[:, 0], final).numpy()
    emp = np.bincount(first, minlength=V) / DRAWS
    law = _law(t_log, temp, top_p)
    tv = 0.5 * np.abs(emp - law).sum()
    assert tv < TV_BOUND, (tv, emp, law)
    if kind == "onehot_q":
        p_draft = law[int(drafts[0, 0])]
        assert abs(float((n_acc > 0).float().mean()) - p_draft) < TV_BOUND
    if kind == "top_p":
        assert emp[law == 0].sum() == 0          # nothing outside the nucleus


def test_accept_tiny_top_p_collapses_to_argmax():
    """top_p -> 0 leaves the argmax alone in the nucleus of p and of q, so
    sampled acceptance emits what greedy acceptance emits, with the one-hot
    q and with a draft q whose argmax is the draft (as a draft drawn from
    it at top_p -> 0 is)."""
    tgt, dl, drafts = _greedy_case(8)
    B, gamma = drafts.shape
    dl += 10.0 * np.eye(dl.shape[-1], dtype=np.float32)[drafts]
    args = (torch.from_numpy(tgt), torch.from_numpy(dl),
            torch.from_numpy(drafts))
    greedy = tspec.accept_core(*args, torch.zeros(B), torch.zeros(B), None,
                               gamma=gamma, sampled=False)
    for dlog in (args[1], None):
        got = tspec.accept_core(args[0], dlog, args[2], torch.full((B,), 0.7),
                                torch.full((B,), 1e-3),
                                torch.Generator().manual_seed(9), gamma=gamma)
        n_acc, final = got
        np.testing.assert_array_equal(final.numpy(), greedy[1].numpy())
        np.testing.assert_array_equal(n_acc.numpy(), greedy[0].numpy())


# ---------------------------------------------------------------------------
# verify_step and prefill_chunk against the JAX package
# ---------------------------------------------------------------------------

def _configs(cd):
    """The (JAX, port) tiny configs at attention compute dtype `cd`."""
    return (dataclasses.replace(JCFG, attn_compute_dtype=cd),
            dataclasses.replace(CFG, attn_compute_dtype=cd))


def _prefilled(prompts, tables, cd="float32"):
    """JAX and port pools after one batched prefill of `prompts` (INT8)."""
    jcfg, cfg = _configs(cd)
    B = len(prompts)
    packed = np.zeros((B, 4 + MB + CHUNK), np.int32)
    for i, p in enumerate(prompts):
        packed[i, 1] = len(p)
        packed[i, 4:4 + MB] = tables[i]
        packed[i, 4 + MB:4 + MB + len(p)] = p
    jpools, tpools = _jax_pools("int8"), _torch_pools("int8")
    out = jl.prefill_batch_packed(JPARAMS, jcfg, JKV.INT8, jnp.asarray(packed),
                                  *jpools, max_blocks=MB, use_pallas=True)
    tl.prefill_batch_packed(PARAMS, cfg, KVDtype.INT8, packed, tpools,
                            max_blocks=MB)
    return list(out[1:5]), tpools


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("T", [2, 5])
def test_verify_step_matches_jax(T, cd):
    """Lane 0 starts inside a block (13: offset 5), lane 1 at 14: its T = 5
    rows cross into the next block, its T = 2 rows end on the block's last
    row; lane 2 is inactive (its rows go to the guard slot)."""
    rng = np.random.RandomState(T)
    guard = SLOTS
    tables = np.array([[3, 7, 1, guard], [10, 0, 5, guard], [2, 4, 6, guard]],
                      np.int32)
    lens = [13, 14, 9]
    prompts = [rng.randint(1, CFG.vocab_size, n) for n in lens]
    jpools, tpools = _prefilled(prompts, tables, cd)
    toks = rng.randint(1, CFG.vocab_size, (3, T)).astype(np.int32)
    start = np.array(lens, np.int32)
    active = np.array([True, True, False])
    jcfg, cfg = _configs(cd)
    out = jl.verify_step(JPARAMS, jcfg, JKV.INT8, jnp.asarray(toks),
                         jnp.asarray(start), *jpools, jnp.asarray(tables),
                         jnp.asarray(active), use_pallas=True)
    got = tl.verify_step(PARAMS, cfg, KVDtype.INT8, torch.from_numpy(toks),
                         torch.from_numpy(start), tpools,
                         torch.from_numpy(tables), torch.from_numpy(active))
    assert got.shape == (3, T, CFG.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[active], np.asarray(out[0])[active],
                               rtol=DENSE_TOL, atol=DENSE_TOL)
    if cd == "bfloat16":
        _assert_pools_equal(out[1:5], tpools)


@pytest.mark.parametrize("cd", COMPUTE)
def test_prefill_chunk_matches_jax(cd):
    """Two chunks of one sequence, each right-padded to CHUNK: 5 valid
    tokens at 0, then 11 at 5 (inside block 0, across into block 1): the
    last valid token's logits within DENSE_TOL, pools (at bfloat16
    compute) as bounded above; pads write the guard slot in both."""
    rng = np.random.RandomState(21)
    table = np.array([9, 2, 11, SLOTS], np.int32)
    toks = rng.randint(1, CFG.vocab_size, 16).astype(np.int32)
    jpools, tpools = _jax_pools("int8"), _torch_pools("int8")
    jcfg, cfg = _configs(cd)
    for start, valid in ((0, 5), (5, 11)):
        chunk = np.zeros(CHUNK, np.int32)
        chunk[:valid] = toks[start:start + valid]
        out = jl.prefill_chunk(JPARAMS, jcfg, JKV.INT8, jnp.asarray(chunk),
                               jnp.int32(start), *jpools, jnp.asarray(table),
                               jnp.int32(valid), use_pallas=True)
        jpools = list(out[1:5])
        got = tl.prefill_chunk(PARAMS, cfg, KVDtype.INT8,
                               torch.from_numpy(chunk), start, tpools,
                               torch.from_numpy(table), valid)
        assert got.shape == (CFG.vocab_size,)
        np.testing.assert_allclose(got.numpy(), np.asarray(out[0]),
                                   rtol=DENSE_TOL, atol=DENSE_TOL)
    if cd == "bfloat16":
        _assert_pools_equal(jpools, tpools)


def test_verify_step_matches_forward_dense():
    """Over BF16 pools (lossless for these float32 values up to bf16
    rounding), a prefill of 12 tokens then a verify of the next 8 gives
    the dense forward's rows 12..19 within 3e-2 and the same argmax (the
    JAX test's bound, `tests/test_spec_decode.py:62`)."""
    from cxl_speckv_tpu_torch.ops.quant import kv_storage_dtype

    slots, mb = 32, 8
    shape = (CFG.num_layers, slots, CFG.num_kv_heads, BS, CFG.head_dim)
    pools = (torch.zeros(shape, dtype=kv_storage_dtype(KVDtype.BF16)),
             torch.zeros(shape, dtype=kv_storage_dtype(KVDtype.BF16)),
             torch.ones(shape[:-1]), torch.ones(shape[:-1]))
    toks = torch.from_numpy(
        np.random.RandomState(5).randint(1, CFG.vocab_size, 20))
    table = torch.arange(1, mb + 1, dtype=torch.int32)
    tl.prefill_chunk(PARAMS, CFG, KVDtype.BF16, toks[:12], 0, pools, table)
    logits = tl.verify_step(PARAMS, CFG, KVDtype.BF16, toks[None, 12:],
                            torch.tensor([12], dtype=torch.int32), pools,
                            table[None], torch.tensor([True]))[0]
    want = tl.forward_dense(PARAMS, CFG, toks[None])[0, 12:]
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=3e-2,
                               atol=3e-2)
    assert torch.equal(logits.argmax(-1), want.argmax(-1))


def test_decode_multi_return_logits():
    """The draft's proposal distributions: `decode_multi_packed(...,
    return_logits=True)` gives [B, horizon, V] logits equal, bit for bit,
    to `decode_step` fed the same tokens step by step on a copy of the
    pools, and within DENSE_TOL of the JAX `decode_multi_packed`'s."""
    rng = np.random.RandomState(13)
    guard = SLOTS
    tables = np.array([[3, 7, 1, guard], [10, 0, 5, guard]], np.int32)
    prompts = [rng.randint(1, CFG.vocab_size, n) for n in (11, 6)]
    jpools, tpools = _prefilled(prompts, tables)
    horizon = 4
    packed = np.zeros((2, MB + 4), np.int32)
    packed[:, 0] = rng.randint(1, CFG.vocab_size, 2)
    packed[:, 1] = [11, 6]
    packed[:, 4:] = tables
    ref_pools = tuple(t.clone() for t in tpools)
    toks, logits = tl.decode_multi_packed(PARAMS, CFG, KVDtype.INT8, packed,
                                          tpools, horizon=horizon,
                                          return_logits=True)
    assert toks.shape == (2, horizon)
    assert logits.shape == (2, horizon, CFG.vocab_size)
    feed = torch.from_numpy(packed[:, 0].copy())
    tab = torch.from_numpy(tables)
    for j in range(horizon):
        pos = torch.from_numpy(packed[:, 1] + j)
        step = tl.decode_step(PARAMS, CFG, KVDtype.INT8, feed, pos, ref_pools,
                              tab, pos + 1)
        assert torch.equal(step, logits[:, j])
        feed = toks[:, j]
    out = jl.decode_multi_packed(JPARAMS, JCFG, JKV.INT8, jnp.asarray(packed),
                                 *jpools, horizon=horizon, return_logits=True,
                                 use_pallas=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(out[0]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(out[5]),
                               rtol=DENSE_TOL, atol=DENSE_TOL)


# ---------------------------------------------------------------------------
# prompt lookup
# ---------------------------------------------------------------------------

def _histories():
    rng = np.random.RandomState(17)
    out = [[], [7], [7, 7], [1, 2, 3, 4, 5]]
    out += [rng.randint(1, 12, rng.randint(2, 60)).tolist() for _ in range(40)]
    for period in (2, 3, 5):                  # repetitive histories
        cycle = rng.randint(1, 200, period).tolist()
        out.append((cycle * 30)[:rng.randint(period + 1, 80)])
    return out


@pytest.mark.parametrize("gamma,max_match,min_match",
                         [(3, 3, 1), (4, 2, 1), (5, 4, 2)])
def test_ngram_lookup_matches_jax(gamma, max_match, min_match):
    kvc = SimpleNamespace(pool=SimpleNamespace(
        table=SimpleNamespace(max_seqs=4, max_blocks_per_seq=8)))
    mine = tspec.NgramProposer(kvc, 256, gamma, max_match, min_match)
    ref = jspec.NgramProposer(kvc, 256, gamma, max_match, min_match)
    for h in _histories():
        assert mine.lookup(h) == ref.lookup(h), h


@pytest.mark.parametrize("onehot", [False, True])
def test_accept_and_accept_greedy_agree_with_jax(onehot):
    """The proposers' `accept` (device rule) and `accept_greedy` (host rule)
    on greedy lanes: the same emitted tokens and counts as the JAX
    proposer's `accept_greedy`, an inactive lane emitting nothing, and the
    same statistics."""
    tgt, dl, drafts = _greedy_case(2)
    B, gamma = drafts.shape
    active = np.arange(B) % 5 != 3
    kvc = SimpleNamespace(pool=SimpleNamespace(
        table=SimpleNamespace(max_seqs=4, max_blocks_per_seq=8)))
    ref = jspec.NgramProposer(kvc, tgt.shape[-1], gamma)
    want, want_n = ref.accept_greedy(drafts, tgt, active)
    for rule in ("accept", "accept_greedy"):
        mine = tspec.NgramProposer(kvc, tgt.shape[-1], gamma)
        mine._draft_logits = None if onehot else torch.from_numpy(dl)
        if rule == "accept":
            got, n = mine.accept(drafts, torch.from_numpy(tgt), active,
                                 np.zeros(B, np.float32))
        else:
            got, n = mine.accept_greedy(drafts, tgt, active)
        assert got == want
        np.testing.assert_array_equal(np.asarray(n)[active], want_n[active])
        assert mine.stats.as_dict() == ref.stats.as_dict()
