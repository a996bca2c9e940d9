"""The port's prefetch LSTM and controller against the JAX package's
(`tests/test_prefetcher.py`'s cases, ported, plus parity):

- the LSTM's forward (`predict_top_k`, `continue_probability`,
  `lstm_pcont`) on the same numpy weights and histories within 1e-5
  (float32), its loss, gradient and 5 AdamW steps against `optax.adamw`
  within 1e-5, and its checkpoint loading in the other package;
- the controller: prefetch of upcoming groups, the EOS gate, the priority
  order within the budget, the asynchronous refresh installed on the next
  tick, adaptive depth, the in-flight budget, online training, and the
  same decisions as the JAX controller on the same inputs;
- the engine: `enable_lstm=None` follows `prefetch.enabled`; with the LSTM
  (synchronous refresh) the JAX engine's tokens and prefetch decisions
  (float32 attention compute: the JAX reference attention against the
  port's plain versions, bit for bit in tokens); the decode round's
  continue probabilities equal the host predictor's within 1e-5; the LSTM
  seeds n-gram misses and greedy tokens stay those of plain decoding.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_surface import F32, JF32, JPARAMS, PARAMS

from cxl_speckv_tpu.config import CacheConfig as JCacheConfig
from cxl_speckv_tpu.config import EngineConfig as JEngineConfig
from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.config import PrefetchConfig as JPrefetchConfig
from cxl_speckv_tpu.config import SystemConfig as JSystemConfig
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.prefetcher import lstm as jlstm
from cxl_speckv_tpu.prefetcher.controller import (
    PrefetchController as JController,
)
from cxl_speckv_tpu.runtime.kv_cache import TieredKVCache as JTieredKVCache
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import lstm_params_from_jax
from cxl_speckv_tpu_torch.prefetcher import lstm as tlstm
from cxl_speckv_tpu_torch.prefetcher.controller import PrefetchController
from cxl_speckv_tpu_torch.prefetcher.lstm import LSTMPredictor, lstm_pcont
from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache

TOL = 1e-5
PORT = (CacheConfig, EngineConfig, KVDtype, PrefetchConfig, SystemConfig)
JAX = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig, JSystemConfig)


def twins(vocab, seed=0, **kw):
    """A JAX predictor and the port's with its weights."""
    j = jlstm.LSTMPredictor(vocab, seed=seed, **kw)
    t = LSTMPredictor(vocab, seed=seed, **kw)
    t.params = lstm_params_from_jax(jax.tree.map(np.asarray, j.params))
    return j, t


def leaves_close(j, t, tol=TOL):
    for a, b in zip(jax.tree.leaves(j.params), tlstm._leaves(t.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=tol)


# -- the LSTM ------------------------------------------------------------------

@pytest.mark.parametrize("vocab,buckets", [(64, 4096), (300, 128)])
def test_lstm_forward_matches_jax(vocab, buckets):
    """predict_top_k, continue_probability and the in-round lstm_pcont on
    the same weights and histories (ids past the classes bucket)."""
    j, t = twins(vocab, seed=3, vocab_buckets=buckets)
    rng = np.random.RandomState(0)
    hist = rng.randint(0, vocab, (6, 16)).astype(np.int32)
    hist[0, :9] = 0                                 # a left-padded history
    (ji, jp), (ti, tp) = j.predict_top_k(hist, 4), t.predict_top_k(hist, 4)
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=TOL)
    assert (ti == np.asarray(ji)).all()
    np.testing.assert_allclose(t.continue_probability(hist, 7),
                               j.continue_probability(hist, 7), rtol=0,
                               atol=TOL)
    hb = t._bucket(hist)
    for h in (1, 4):
        fresh = rng.randint(0, vocab, (6, h)).astype(np.int32)
        want = jlstm.lstm_pcont(j.params, jnp.asarray(hb), jnp.asarray(fresh),
                                7 % t.n_classes)
        got = lstm_pcont(t.params, torch.from_numpy(hb),
                         torch.from_numpy(fresh), 7 % t.n_classes)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


def test_lstm_loss_grad_and_adamw_match_optax():
    """One loss and gradient, then 5 train_batch steps (AdamW, lr 1e-3,
    weight decay 1e-4 on every leaf) against optax.adamw."""
    j, t = twins(300, seed=1, vocab_buckets=128)
    rng = np.random.RandomState(2)
    hist = rng.randint(0, 300, (8, 16)).astype(np.int32)
    tgt = rng.randint(0, 300, 8).astype(np.int32)
    jloss, jgrad = jlstm._loss_and_grad(
        j.params, jnp.asarray(j._bucket(hist)), jnp.asarray(j._bucket(tgt)),
        2, 128)
    p = tlstm._tree_map(lambda x: x.clone().requires_grad_(True), t.params)
    loss = tlstm._loss(p, t._put(t._bucket(hist)), t._put(t._bucket(tgt)))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL
    for a, b in zip(jax.tree.leaves(jgrad), tlstm._leaves(p)):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL)
    for _ in range(5):
        jl, tl = float(j.train_batch(hist, tgt)), t.train_batch(hist, tgt)
        assert abs(jl - tl) <= TOL
    leaves_close(j, t)


def test_lstm_publishes_a_new_tree_each_step():
    """Training never writes the published tree: a step publishes a new
    one (readers on other threads hold a consistent tree)."""
    t = LSTMPredictor(64, seed=0)
    before = t.params
    snap = [x.clone() for x in tlstm._leaves(before)]
    hist = np.random.RandomState(0).randint(0, 64, (4, 16)).astype(np.int32)
    t.train_batch(hist, hist[:, -1])
    assert t.params is not before
    for a, b in zip(tlstm._leaves(before), snap):
        assert torch.equal(a, b)
    assert not any(x.requires_grad for x in tlstm._leaves(t.params))


def test_lstm_shapes_and_learning():
    p = LSTMPredictor(vocab_size=64, history_len=8, seed=0)
    hist = np.random.RandomState(0).randint(0, 64, (32, 8)).astype(np.int32)
    ids, probs = p.predict_top_k(hist, 4)
    assert ids.shape == (32, 4) and probs.shape == (32, 4)
    assert (probs[:, 0] >= probs[:, -1]).all()
    # learn a trivial pattern: next token == last token
    targets = hist[:, -1].astype(np.int32)
    losses = [p.train_batch(hist, targets) for _ in range(60)]
    assert losses[-1] < losses[0] * 0.5
    ids2, _ = p.predict_top_k(hist[:4], 1)
    assert (ids2[:, 0] == targets[:4]).mean() >= 0.75


def test_lstm_save_load(tmp_path):
    p = LSTMPredictor(vocab_size=32, seed=1)
    hist = np.zeros((2, 16), np.int32)
    before = p.predict_top_k(hist, 3)[1]
    path = str(tmp_path / "lstm.npz")
    p.save(path)
    q = LSTMPredictor(vocab_size=32, seed=2)
    q.load(path)
    np.testing.assert_allclose(q.predict_top_k(hist, 3)[1], before, rtol=1e-6)
    assert p.model_size_bytes() == q.model_size_bytes() > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    """A checkpoint written by either package loads in the other, leaf for
    leaf (the reference's np.savez format)."""
    j, t = twins(300, seed=4, vocab_buckets=128)
    hist = np.random.RandomState(1).randint(0, 300, (3, 16)).astype(np.int32)
    path = str(tmp_path / "pred.npz")
    if writer == "jax":
        j.train_batch(hist, hist[:, -1])            # not the twins' weights
        j.save(path)
        t.load(path)
    else:
        t.train_batch(hist, hist[:, -1])
        t.save(path)
        j.load(path)
    for a, b in zip(jax.tree.leaves(j.params), tlstm._leaves(t.params)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert t.model_size_bytes() == j.model_size_bytes()


# -- the controller --------------------------------------------------------------

def make_kvc(hbm=8, host=32, bs=8, mods=PORT, kvc_cls=TieredKVCache):
    cc = mods[0](block_size=bs, num_hbm_blocks=hbm, num_host_blocks=host,
                 kv_dtype=mods[2].INT8, prefetch_reserve_frac=0.25)
    model = tiny_test_config() if mods is PORT else j_tiny()
    return kvc_cls(cc, model, max_seqs=8, max_blocks_per_seq=8)


def drain(kvc):
    if isinstance(kvc, TieredKVCache):
        kvc.dispatch_migrations()
    else:
        kvc.drain()


def demote_all(kvc, seq):
    kvc.pin_seq(seq, False)
    for bid in list(kvc.pool.seq(seq).blocks):
        if kvc.directory.entry(bid).state.name != "HBM":
            continue
        res = kvc.directory.start_demote(bid)
        if res is not None:
            kvc.transfer.enqueue_demote(bid, *res)
    drain(kvc)


def eos_trained(pred):
    """Train `pred` (either package) so that a history of 5s predicts 0."""
    hist = np.full((64, 16), 5, np.int32)
    for _ in range(80):
        pred.train_batch(hist, np.zeros(64, np.int32))
    return pred


def test_controller_prefetches_upcoming_and_skips_resident():
    kvc = make_kvc()
    ctl = PrefetchController(PrefetchConfig(enabled=True, depth=2), kvc)
    s1, s2, s3 = kvc.add_seq(), kvc.add_seq(), kvc.add_seq()
    for s in (s1, s2, s3):
        kvc.extend_seq(s, 16)  # 2 blocks each
    demote_all(kvc, s1)
    demote_all(kvc, s3)     # s2 stays resident; s3 is beyond depth
    assert ctl.plan([[s1], [s2], [s3]]) == 2    # s1's two host blocks
    assert ctl.stats.skipped_resident == 2      # s2's resident blocks
    drain(kvc)
    assert kvc.seq_nonresident_blocks(s1) == []
    assert len(kvc.seq_nonresident_blocks(s3)) == 2


def test_controller_eos_gating():
    kvc = make_kvc()
    # train_async=False: this plan's own prediction gates it
    ctl = PrefetchController(
        PrefetchConfig(enabled=True, depth=4, train_async=False), kvc,
        predictor=eos_trained(LSTMPredictor(vocab_size=16, seed=0)),
        eos_token_id=0)
    s = kvc.add_seq()
    kvc.extend_seq(s, 16)
    demote_all(kvc, s)
    ctl.observe_tokens(s, [5] * 16)
    assert ctl.plan([[s]]) == 0
    assert ctl.stats.skipped_eos_predicted == 1


def test_controller_eos_gating_async_installs_next_tick():
    """Asynchronous refresh: the first plan keeps by default, the worker's
    probability gates the next plan."""
    kvc = make_kvc()
    ctl = PrefetchController(
        PrefetchConfig(enabled=True, depth=4), kvc,
        predictor=eos_trained(LSTMPredictor(vocab_size=16, seed=0)),
        eos_token_id=0)
    s = kvc.add_seq()
    kvc.extend_seq(s, 16)
    demote_all(kvc, s)
    ctl.observe_tokens(s, [5] * 16)
    assert ctl.plan([[s]]) == 2      # submits the refresh; not yet gated
    assert ctl.stats.skipped_eos_predicted == 0
    ctl._pcont_future[2].result(timeout=60)
    kvc.maintain()                   # land the first plan's promotes
    demote_all(kvc, s)
    assert ctl.plan([[s]]) == 0      # harvests, then gates
    assert ctl.stats.skipped_eos_predicted == 1


def test_pcont_priority_orders_budget():
    """Within a schedule group the budget goes to the sequence the LSTM
    ranks likelier to go on, whatever the group's order."""
    kvc = make_kvc(hbm=8, host=32)
    ctl = PrefetchController(
        PrefetchConfig(enabled=True, depth=4, max_inflight=2,
                       train_async=False), kvc,
        predictor=LSTMPredictor(vocab_size=16, seed=0), eos_token_id=0)
    s_lo, s_hi = kvc.add_seq(), kvc.add_seq()
    for s in (s_lo, s_hi):
        kvc.extend_seq(s, 16)
        demote_all(kvc, s)
    ctl._pcont[s_lo] = (0, 0.6)
    ctl._pcont[s_hi] = (0, 0.99)
    ctl._hist_version[s_lo] = ctl._hist_version[s_hi] = 0
    assert ctl.plan([[s_lo, s_hi]]) == 2
    drain(kvc)
    assert kvc.seq_nonresident_blocks(s_hi) == []
    assert len(kvc.seq_nonresident_blocks(s_lo)) == 2


def test_adaptive_depth_port():
    kvc = make_kvc()
    cfg = PrefetchConfig(enabled=True, depth=4, accuracy_window=20)
    ctl = PrefetchController(cfg, kvc)
    st = kvc.directory.stats
    st.prefetch_hits += 20           # accuracy 1.0 > 0.95: depth + 1
    assert ctl.update_depth() == 5
    st.prefetch_wasted += 40         # accuracy < 0.85: depth - 1
    ctl.update_depth()
    assert ctl.update_depth() < 5
    st.prefetch_wasted += 500
    for _ in range(10):
        d = ctl.update_depth()
    assert d == cfg.min_depth


def test_inflight_budget_respected():
    kvc = make_kvc(hbm=16, host=64)
    ctl = PrefetchController(
        PrefetchConfig(enabled=True, depth=8, max_inflight=3), kvc)
    seqs = []
    for _ in range(4):
        s = kvc.add_seq()
        kvc.extend_seq(s, 16)
        demote_all(kvc, s)
        seqs.append(s)
    assert ctl.plan([seqs]) == 3


def test_controller_decisions_match_jax():
    """The same schedule, histories and predictor weights through both
    controllers (synchronous refresh): the same plans, gate, order and
    statistics, plan by plan."""
    j = eos_trained(jlstm.LSTMPredictor(16, seed=0))
    t = LSTMPredictor(16, seed=0)
    t.params = lstm_params_from_jax(jax.tree.map(np.asarray, j.params))
    ctls, seqs = [], []
    for mods, kvc_cls, ctl_cls, pred in (
            (PORT, TieredKVCache, PrefetchController, t),
            (JAX, JTieredKVCache, JController, j)):
        kvc = make_kvc(hbm=16, host=64, mods=mods, kvc_cls=kvc_cls)
        ctl = ctl_cls(mods[3](enabled=True, depth=2, max_inflight=3,
                              train_async=False, pcont_refresh=2),
                      kvc, predictor=pred, eos_token_id=0)
        ss = []
        for i in range(5):
            s = kvc.add_seq()
            kvc.extend_seq(s, 16)
            demote_all(kvc, s)
            # two sequences end in 5s (predicted EOS), the rest do not
            ctl.observe_tokens(s, [5] * 16 if i in (1, 3) else
                               [(k + i) % 15 + 1 for k in range(16)])
            ss.append(s)
        ctls.append((kvc, ctl))
        seqs.append(ss)
    assert seqs[0] == seqs[1]
    ss = seqs[0]
    for step in range(4):
        sched = [[ss[(step + k) % 5] for k in (0, 1)],
                 [ss[(step + k) % 5] for k in (2, 3)]]
        got = []
        for kvc, ctl in ctls:
            got.append(ctl.plan(sched))
            drain(kvc)
            got.append(sorted(s for s in ss
                              if not kvc.seq_nonresident_blocks(s)))
            for s in ss:
                demote_all(kvc, s)
            ctl.observe_tokens(ss[step], [7])
        assert got[:2] == got[2:], (step, got)
        a, b = ctls[0][1].stats.as_dict(), ctls[1][1].stats.as_dict()
        for k in ("plans", "prefetches_issued", "skipped_resident",
                  "skipped_eos_predicted"):
            assert a[k] == b[k], (step, k, a, b)
    p, q = ctls[0][1]._pcont, ctls[1][1]._pcont
    assert p.keys() == q.keys()
    for s in p:
        assert p[s][0] == q[s][0] and abs(p[s][1] - q[s][1]) <= 1e-4
    assert ctls[0][1].stats.skipped_eos_predicted > 0


def test_online_training_learns_pattern():
    """Controller-driven online training: a periodic token stream becomes
    predictable."""
    kvc = make_kvc()
    cfg = PrefetchConfig(enabled=True, depth=2, train_online=True,
                         train_async=False, train_interval=1, train_batch=64,
                         history_len=8)
    ctl = PrefetchController(cfg, kvc, predictor=LSTMPredictor(
        vocab_size=16, history_len=8, seed=0), eos_token_id=0)
    s = kvc.add_seq()
    pattern = [3, 5, 7, 9, 11, 13]
    for rep in range(240):
        ctl.observe_tokens(s, [pattern[rep % len(pattern)]])
        ctl.maybe_train()
    assert ctl.stats.train_steps > 50
    ids, _ = ctl.predictor.predict_top_k(ctl.history_matrix([s]), 2)
    assert pattern[240 % len(pattern)] in ids[0], ids


def test_replay_indices_follow_the_seed():
    """The replay draws come from the controller's own generator: two
    controllers of one seed train to the same weights."""
    def run(seed):
        ctl = PrefetchController(
            PrefetchConfig(enabled=True, train_online=True, train_async=False,
                           train_interval=1, train_batch=8, history_len=8),
            make_kvc(), predictor=LSTMPredictor(16, history_len=8, seed=0),
            eos_token_id=0, seed=seed)
        for i in range(24):
            ctl.observe_tokens(0, [i * 7 % 16])
            ctl.maybe_train()
        return tlstm._leaves(ctl.predictor.params)

    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_async_training_off_critical_path():
    """train_async: maybe_train returns at once, the worker's step is
    harvested later, drain_training lands an in-flight step."""
    kvc = make_kvc()
    cfg = PrefetchConfig(enabled=True, depth=2, train_online=True,
                         train_async=True, train_interval=1, train_batch=32,
                         history_len=8)
    ctl = PrefetchController(cfg, kvc, predictor=LSTMPredictor(
        vocab_size=16, history_len=8, seed=0), eos_token_id=0)
    s = kvc.add_seq()
    for rep in range(80):
        ctl.observe_tokens(s, [rep % 7 + 1])
    before = ctl.predictor.params
    t0 = time.monotonic()
    assert ctl.maybe_train() is None    # submitted to the worker
    submit_s = time.monotonic() - t0
    ctl.drain_training()
    assert ctl.stats.train_steps == 1
    assert ctl.predictor.params is not before
    assert ctl.get_statistics().last_train_loss > 0
    ctl.maybe_train()
    ctl.drain_training()
    assert ctl.stats.train_steps == 2
    assert submit_s < 0.5, submit_s


# -- the engine ------------------------------------------------------------------

def system(mods=PORT, hbm=14, host=256, horizon=4, batch=2, enabled=True,
           **pkw):
    cc, ec, kvd, pc, sc = mods
    return sc(cache=cc(block_size=8, num_hbm_blocks=hbm, num_host_blocks=host,
                       kv_dtype=kvd.INT8),
              prefetch=pc(enabled=enabled, depth=2, **pkw),
              engine=ec(max_batch_size=batch, max_seq_len=128,
                        prefill_chunk=32, decode_horizon=horizon))


def prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, rng.randint(6, 24)).tolist()
            for _ in range(n)]


def gate_predictor(path):
    """A JAX predictor whose EOS class (0) is likely for some histories and
    unlikely for others (its logit is a large multiple of a random
    direction of the hidden state), saved at `path`."""
    j = jlstm.LSTMPredictor(256, seed=5)
    out = np.array(j.params["out"])
    out[:, 0] = 3000.0 * np.random.RandomState(6).randn(out.shape[0])
    j.params["out"] = jnp.asarray(out)
    j.save(path)
    return path


@pytest.mark.parametrize("enabled", [True, False])
def test_enable_lstm_follows_prefetch_enabled(enabled):
    eng = Engine(F32, system(enabled=enabled), params=PARAMS, device="cpu")
    jeng = JEngine(JF32, system(JAX, enabled=enabled), params=JPARAMS,
                   use_pallas=False)
    assert (eng.prefetcher.predictor is not None) == enabled
    assert ((eng.prefetcher.predictor is None)
            == (jeng.prefetcher.predictor is None))


@pytest.mark.parametrize("horizon", [1, 4])
def test_engine_with_lstm_matches_jax(tmp_path, horizon):
    """Tiered engines with the LSTM gating prefetch (synchronous refresh,
    the same predictor checkpoint): the JAX engine's tokens, prefetches
    and EOS skips; at horizon 4 the decode rounds' in-round leg installs
    as many probabilities as the JAX program's."""
    path = gate_predictor(str(tmp_path / "gate.npz"))
    ps = prompts(6, seed=5)
    kw = dict(hbm=14, horizon=horizon, train_async=False, predictor_path=path)
    jeng = JEngine(JF32, system(JAX, **kw), params=JPARAMS, use_pallas=False)
    want = jeng.generate(ps, max_new_tokens=16)
    eng = Engine(F32, system(**kw), params=PARAMS, device="cpu")
    got = eng.generate(ps, max_new_tokens=16)
    assert got == want
    st, jst = (e.get_statistics()["prefetch"] for e in (eng, jeng))
    for k in ("plans", "prefetches_issued", "skipped_resident",
              "skipped_eos_predicted", "ingraph_pcont"):
        assert st[k] == jst[k], (k, st, jst)
    assert st["prefetches_issued"] > 0 and st["skipped_eos_predicted"] > 0
    assert (st["ingraph_pcont"] > 0) == (horizon > 1)


def test_ingraph_pcont_matches_host_predictor():
    """The decode round's continue probabilities, installed as fresh,
    equal the host predictor's on the post-round histories; with
    ingraph_pcont off none is installed and serving goes on."""
    sc = system(hbm=32, host=64, horizon=4)
    eng = Engine(tiny_test_config(), sc, params=PARAMS, device="cpu",
                 seed=3)
    rng = np.random.RandomState(4)
    for _ in range(4):
        eng.add_request(rng.randint(1, 256, 12).tolist(), max_new_tokens=16,
                        ignore_eos=True)
    for _ in range(4):
        eng.step()
    pf = eng.prefetcher
    assert pf.stats.ingraph_pcont > 0
    live = [s for s in pf._pcont if s in pf._histories]
    assert live
    for s in live:
        version, got = pf._pcont[s]
        assert version == pf._hist_version.get(s, 0)
        want = float(pf.predictor.continue_probability(
            pf.history_matrix([s]), eng.eos_token_id)[0])
        assert abs(got - want) < TOL, (s, got, want)
    eng2 = Engine(tiny_test_config(),
                  system(hbm=32, host=64, horizon=4, ingraph_pcont=False,
                         train_async=False), params=PARAMS, device="cpu")
    for _ in range(4):
        eng2.add_request(rng.randint(1, 256, 12).tolist(), max_new_tokens=8,
                         ignore_eos=True)
    assert len(eng2.run()) == 4
    assert eng2.prefetcher.stats.ingraph_pcont == 0


def test_online_training_serves_and_refreshes_the_device_copy():
    """train_online with the asynchronous worker while serving: training
    steps land, tokens equal a run without the LSTM, and the in-round
    leg's copy follows the published tree."""
    ps = prompts(6, seed=8)
    kw = dict(hbm=14, horizon=4, train_online=True, train_interval=1,
              train_batch=16)
    eng = Engine(F32, system(**kw), params=PARAMS, device="cpu")
    got = eng.generate(ps, max_new_tokens=24)
    ref = Engine(F32, system(**kw), params=PARAMS, device="cpu",
                 enable_lstm=False).generate(ps, max_new_tokens=24)
    assert got == ref
    st = eng.get_statistics()["prefetch"]
    assert st["train_steps"] > 0 and st["ingraph_pcont"] > 0
    assert st["last_train_loss"] > 0
    assert eng._lstm_src is not None and eng._lstm_dev is not None


def test_ngram_seed_fills_misses_and_keeps_greedy_tokens():
    """With the LSTM and seed_ngram, n-gram misses draft the LSTM's
    choice (fallback_seeded > 0) and greedy tokens equal plain decoding."""
    ps = prompts(4, seed=11)
    sc = system(hbm=64, horizon=1, batch=4)
    plain = Engine(tiny_test_config(), sc, params=PARAMS, device="cpu",
                   enable_lstm=False).generate(ps, max_new_tokens=12)
    eng = Engine(tiny_test_config(), system(hbm=64, horizon=1, batch=4),
                 params=PARAMS, device="cpu", spec_ngram=True, spec_gamma=3)
    assert eng.prefetcher.predictor is not None
    assert eng.generate(ps, max_new_tokens=12) == plain
    assert eng.get_statistics()["spec"]["fallback_seeded"] > 0
    off = Engine(tiny_test_config(),
                 system(hbm=64, horizon=1, batch=4, seed_ngram=False),
                 params=PARAMS, device="cpu", spec_ngram=True, spec_gamma=3)
    assert off.generate(ps, max_new_tokens=12) == plain
    assert off.get_statistics()["spec"]["fallback_seeded"] == 0


def test_engine_loads_pretrained_predictor(tmp_path):
    """PrefetchConfig.predictor_path: a checkpoint (here the JAX
    package's) rides into the port's serving engine."""
    src = jlstm.LSTMPredictor(256, history_len=16, seed=3)
    path = str(tmp_path / "pred.npz")
    src.save(path)
    sc = system(hbm=32, host=32, predictor_path=path)
    eng = Engine(tiny_test_config(), sc, params=PARAMS, device="cpu")
    np.testing.assert_array_equal(
        eng.prefetcher.predictor.params["embed"].numpy(),
        np.asarray(src.params["embed"]))


def test_train_predictor_script(tmp_path):
    """The port's `scripts/train_predictor.py` trains on the JAX script's
    synthetic trace (the same tokens from the same seed) and writes a
    checkpoint that the JAX predictor loads."""
    import importlib.util
    from pathlib import Path

    from cxl_speckv_tpu_torch.scripts import train_predictor

    spec = importlib.util.spec_from_file_location(
        "jax_train_predictor",
        Path(__file__).resolve().parent.parent / "scripts"
        / "train_predictor.py")
    jscript = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscript)
    trace = train_predictor.synthetic_trace(64, 5000)
    np.testing.assert_array_equal(trace, jscript.synthetic_trace(64, 5000))
    out = str(tmp_path / "p.npz")
    res = train_predictor.main(["--vocab", "64", "--steps", "30", "--batch",
                                "64", "--trace-len", "5000", "--out", out])
    assert res["step"] == 29 and np.isfinite(res["loss"])
    j = jlstm.LSTMPredictor(int(trace.max()) + 1)
    j.load(out)
    t = LSTMPredictor(int(trace.max()) + 1)
    t.load(out)
    hist = trace[:32].reshape(2, 16).astype(np.int32)
    np.testing.assert_allclose(t.predict_top_k(hist, 4)[1],
                               np.asarray(j.predict_top_k(hist, 4)[1]),
                               rtol=0, atol=TOL)
