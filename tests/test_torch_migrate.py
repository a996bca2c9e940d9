"""Block migrations of the port: the card's batch and its ordering rules,
and fused rounds.

- `hoststore.copy_batch` (the card's migration batch: per-slot runs of the
  pinned store, device slabs, a scatter into the pools) against the JAX
  `migrate_program` on pools carried across by `models/convert.py:
  pools_from_jax`, and against the port's plain `migrate_program`, bit for
  bit;
- the ordering hazards of migrations on a copy stream, driven through the
  cache's in-flight state with `DeferredCopier`, a copy stream whose
  copies run only when the test (or a wait) says so, and a compute stream
  that can lag behind the host the same way: (a) a demote reads a block
  only after the last round that wrote it, (b) a demoted HBM slot is
  neither allocated nor written before its copy completes, (c) a promote
  does not write a slot that a round already dispatched may still read,
  (d) the host-streamed path and migrations are ordered across the two
  streams, (e) the tensors a batch copies stay alive until it completes;
  then whole engines over the lagging copy stream against the synchronous
  CPU engine;
- `EngineConfig.fused_rounds` against the JAX engine with it (tokens and
  transfer counts, templated on `tests/test_engine.py:128`), with logprobs
  (`tests/test_logprobs.py:156`) and penalties
  (`tests/test_penalties.py:335`).
"""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch
from test_torch_engine import (
    CFG,
    JPARAMS,
    PARAMS,
    JCacheConfig,
    JEngine,
    JEngineConfig,
    JKV,
    JPrefetchConfig,
    JSystemConfig,
    j_tiny,
    jax_engine,
    prompts,
    system,
)
from torch_surface import (
    F32,
    JF32,
    assert_logprobs_close,
    engine,
    jax_engine as jax_ref_engine,
    run_one,
    tokens,
)

from cxl_speckv_tpu.runtime.hoststore import StoreOps
from cxl_speckv_tpu.runtime.hoststore import migrate_program as j_migrate
from cxl_speckv_tpu_torch.config import CacheConfig, KVDtype
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import pools_from_jax, tensor_from_numpy
from cxl_speckv_tpu_torch.runtime.hoststore import (
    DeviceHostStore,
    copy_batch,
    migrate_program,
    pad_migration,
    stash_blocks,
)
from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache

BS, HBM, HOST = 8, 10, 40
MOVES = ("up_transfers", "down_transfers", "up_batches", "down_batches",
         "bytes_up", "bytes_down")


class Completion:
    """A batch's completion under the test's control (`query` /
    `synchronize`, as a CUDA event)."""

    def __init__(self, copier, latency):
        self.copier, self.left, self.ran = copier, latency, False

    def query(self) -> bool:
        if not self.ran and self.left is not None:
            if self.left > 0:
                self.left -= 1
            else:
                self.copier.run_until(self)
        return self.ran

    def synchronize(self) -> None:
        self.copier.run_until(self)


class DeferredCopier:
    """A copy stream that lags behind the host: each batch's copies run, in
    issue order, only when its completion is waited on (`synchronize`, a
    round's `compute_waits`), the test runs them, or (with `latency`) it
    has been polled that many times. `compute` holds closures of a compute
    stream that lags too: they run when the copy stream is made to wait
    for it, or when the test finishes."""

    def __init__(self, latency=None):
        self.latency = latency
        self.copies = []              # (fn, completion, keep), oldest first
        self.compute = []
        self.waits = 0

    def wait_for_compute(self) -> None:
        self.waits += 1
        self.run_compute()

    def run_compute(self) -> None:
        while self.compute:
            self.compute.pop(0)()

    def run(self, fn):
        c, keep = Completion(self, self.latency), []
        self.copies.append((fn, c, keep))
        return c, keep

    def run_until(self, c) -> None:
        while not c.ran:
            fn, done, keep = self.copies.pop(0)
            keep.extend(fn(None))
            done.ran = True

    def compute_waits(self, c) -> None:
        self.run_until(c)

    def finish(self) -> None:
        """Every copy, then the lagging compute."""
        while self.copies:
            self.run_until(self.copies[-1][1])
        self.run_compute()


def cache(copier=None, kv="int8"):
    return TieredKVCache(
        CacheConfig(block_size=BS, num_hbm_blocks=HBM, num_host_blocks=HOST,
                    kv_dtype=KVDtype(kv)),
        tiny_test_config(), 8, 8, device="cpu", copier=copier)


def fill(pools, gen):
    for p in pools[:2]:
        p.copy_(torch.randint(-127, 128, p.shape, generator=gen).to(p.dtype))
    for p in pools[2:]:
        p.copy_(torch.rand(p.shape, generator=gen))


def slot_of(t, bid) -> int:
    return t.directory.entry(bid).hbm_slot


def block(t, slot):
    return [p[:, slot].clone() for p in t.pools]


def host_block(t, host_slot):
    return [v[host_slot].clone() for v in t.store.units(0, t.store.num_layers)]


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def demote(t, bid) -> int:
    """Queue and issue the block's demote; returns its host slot."""
    t._demote([bid])
    host = t.directory.entry(bid).host_slot
    t.dispatch_migrations()
    return host


# -- the card's batch, bit for bit ------------------------------------------

@pytest.mark.parametrize("kv,dtype,pack", [("int8", np.int8, 1),
                                            ("int4", np.int8, 2),
                                            ("bf16", "bfloat16", 1)])
def test_copy_batch_matches_jax_migrate_program(kv, dtype, pack):
    """One full 16-lane batch each way (a demoted slot promoted into in the
    same batch, pad lanes at the guard slots) through the JAX program and
    the port's two versions: identical pools and store."""
    L, S, H, D, host = 3, 40, 2, 16 // pack, 36
    rng = np.random.RandomState(0)
    dt = jax.numpy.dtype(dtype)

    def draw(shape):
        return (rng.randint(-120, 120, shape).astype(dt) if kv != "bf16"
                else rng.randn(*shape).astype(dt))
    jp = (draw((L, S + 1, D, H * BS)), draw((L, S + 1, H, BS, D)),
          rng.rand(L, S + 1, 1, H * BS).astype(np.float32),
          rng.rand(L, S + 1, 1, H * BS).astype(np.float32))
    rows = (host + 1) * L
    js = (draw((rows, H, BS, D)), draw((rows, H, BS, D)),
          rng.rand(rows, H, BS).astype(np.float32),
          rng.rand(rows, H, BS).astype(np.float32))
    downs = [(int(s), int(h)) for s, h in zip(
        rng.permutation(S)[:16], rng.permutation(host)[:16])]
    # promote from host slots no demote writes, into slots incl. demoted ones
    free_host = [h for h in range(host) if h not in {h for _, h in downs}]
    down_slots = [d for d, _ in downs]
    targets = down_slots[:4] + [d for d in range(S) if d not in down_slots]
    ups = [(free_host[i], targets[i]) for i in range(14)]
    mig = pad_migration(ups, downs, S, host)
    out = [np.asarray(a) for a in j_migrate(
        *map(jax.numpy.asarray, jp + js), jax.numpy.asarray(mig),
        ops=StoreOps(pinned=False))]
    # the guard slots absorb the JAX program's pad lanes (garbage there);
    # the port's versions move nothing for them
    want_pools = [a[:, :S] for a in pools_from_jax(*out[:4], H)]
    want_store = [tensor_from_numpy(a)[:host * L] for a in out[4:]]
    for fn in (copy_batch, migrate_program):
        pools = pools_from_jax(*(a.copy() for a in jp), H)
        store = DeviceHostStore(host, L, BS, H, D, pools[0].dtype, pin=False)
        for a, b in zip(store.arrays, js):
            a.copy_(tensor_from_numpy(b))
        fn(pools, store, mig)
        assert same([a[:, :S] for a in pools], want_pools), fn.__name__
        assert same([a[:host * L] for a in store.arrays], want_store), \
            fn.__name__


# -- the ordering hazards -----------------------------------------------------

def test_a_demote_reads_after_the_round_that_wrote_it():
    """(a) A round still queued on the compute stream writes a block; a
    demote of it issued after that round must copy the written bytes: the
    copy stream waits for the compute stream at issue."""
    fake = DeferredCopier()
    t = cache(fake)
    s = t.add_seq()
    t.extend_seq(s, 2 * BS)
    fill(t.pools, torch.Generator().manual_seed(1))
    bid = t.pool.seq(s).blocks[0]
    slot = slot_of(t, bid)
    new = [torch.full_like(p[:, slot], 7) for p in t.pools]
    fake.compute.append(
        lambda: [p[:, slot].copy_(n) for p, n in zip(t.pools, new)])
    host = demote(t, bid)
    assert fake.waits == 1
    fake.finish()
    assert same(host_block(t, host), new)


def test_b_demoted_slot_held_until_its_copy_completes():
    """(b) Until the demote's copy has run, its HBM slot is off the free
    list: the next block gets another slot, and a round writing that block
    does not reach the bytes the copy reads."""
    fake = DeferredCopier()
    t = cache(fake)
    s = t.add_seq()
    t.extend_seq(s, 2 * BS)
    fill(t.pools, torch.Generator().manual_seed(2))
    bid = t.pool.seq(s).blocks[1]
    slot = slot_of(t, bid)
    old = block(t, slot)
    free0 = t.directory.hbm_free
    host = demote(t, bid)
    assert t.directory.hbm_free == free0          # held, not free
    assert t.transfer.inflight_down == 1
    s2 = t.add_seq()
    assert t.extend_seq(s2, BS)
    slot2 = slot_of(t, t.pool.seq(s2).blocks[0])
    assert slot2 != slot
    for p in t.pools:                             # the new block's round
        p[:, slot2].fill_(5)
    fake.finish()
    assert same(host_block(t, host), old)
    assert t.transfer.poll(t.directory) == 1      # completed: slot released
    assert t.directory.hbm_free == free0
    assert t.transfer.inflight_down == 0


def test_c_promote_waits_for_rounds_reading_its_slot():
    """(c) A round still queued reads slot `sa`; its sequence is freed and
    another block is promoted into `sa`: the promote's copy must not land
    before the round has read the old contents."""
    fake = DeferredCopier()
    t = cache(fake)
    sb = t.add_seq()
    t.extend_seq(sb, BS)
    fill(t.pools, torch.Generator().manual_seed(3))
    b = t.pool.seq(sb).blocks[0]
    demote(t, b)
    fake.finish()
    t.transfer.poll(t.directory)
    sa = t.add_seq()
    t.extend_seq(sa, BS)
    fill(t.pools[:1], torch.Generator().manual_seed(4))
    slot_a = slot_of(t, t.pool.seq(sa).blocks[0])
    want = block(t, slot_a)
    seen = []
    fake.compute.append(lambda: seen.append(block(t, slot_a)))
    t.free_seq(sa)
    t.ensure_resident([sb])
    assert slot_of(t, b) == slot_a                # the freed slot, reused
    fake.finish()
    assert same(seen[0], want)


def test_d_streamed_path_after_migrations():
    """(d) A demote's copy into host slot h is still in flight when its
    block is freed and h goes to a host-streamed request: the streamed
    path must wait for the copy before it stashes into h, or the late copy
    overwrites the streamed KV. The streamed tokens equal the synchronous
    engine's."""
    prompt = list(range(3, 43))

    def serve(copier):
        eng = Engine(CFG, system(6, 64, 2, 1), params=PARAMS, device="cpu",
                     enable_lstm=False)
        if copier is not None:
            eng.kvc.copier = copier
        d = eng.kvc.directory
        bid = d.allocate(pinned=False)
        for p in eng.kvc.pools:                   # bytes far from the model's
            p[:, d.entry(bid).hbm_slot].fill_(100)
        eng.kvc._demote([bid])
        eng.kvc.dispatch_migrations()
        d.free(bid)                               # its host slot, free again
        rid = eng.add_request(prompt, max_new_tokens=4)
        out = {o.req_id: o for o in eng.run()}[rid]
        assert eng.get_statistics()["engine"]["stream_chunks"] > 0
        return out.tokens

    fake = DeferredCopier(latency=0)
    assert serve(fake) == serve(None)
    assert not fake.copies


def test_d_stash_after_order_after_migrations():
    """(d) at the cache: `order_after_migrations` runs the copies in
    flight before a streamed stash into a reused host slot; the slot holds
    the stash's bytes."""
    fake = DeferredCopier()
    t = cache(fake)
    s = t.add_seq()
    t.extend_seq(s, BS)
    fill(t.pools, torch.Generator().manual_seed(5))
    bid = t.pool.seq(s).blocks[0]
    host = demote(t, bid)
    t.free_seq(s)
    assert t.directory.entry(t.directory.allocate_host()).host_slot == host
    slabs = [torch.full_like(v[host], 3)[None] for v in
             t.store.units(0, t.store.num_layers)]
    t.order_after_migrations()
    assert not fake.copies
    stash_blocks(t.store, slabs, [host])
    fake.finish()
    assert same(host_block(t, host), [x[0] for x in slabs])


def test_e_batch_tensors_live_until_it_completes():
    """(e) The slabs and indices a batch copies stay referenced by its
    in-flight record until `poll` retires it, and no longer."""
    fake = DeferredCopier()
    t = cache(fake)
    s = t.add_seq()
    t.extend_seq(s, 2 * BS)
    demote(t, t.pool.seq(s).blocks[0])
    fake.run_until(fake.copies[0][1])           # the copies ran ...
    assert t.transfer.inflight                  # ... and are not retired yet
    refs = [weakref.ref(x) for x in t.transfer.inflight[0].keep]
    assert refs
    gc.collect()
    assert all(r() is not None for r in refs)
    t.transfer.poll(t.directory)
    assert not t.transfer.inflight
    gc.collect()
    assert all(r() is None for r in refs)


def test_round_waits_only_for_the_batches_it_reads():
    """A round waits for the in-flight batches that promote into a slot
    of its table, and for no other."""
    fake = DeferredCopier()
    t = cache(fake)
    a, b = t.add_seq(), t.add_seq()
    t.extend_seq(a, BS)
    t.extend_seq(b, BS)
    fill(t.pools, torch.Generator().manual_seed(6))
    ba, bb = t.pool.seq(a).blocks[0], t.pool.seq(b).blocks[0]
    demote(t, ba)
    demote(t, bb)
    fake.finish()
    t.transfer.poll(t.directory)
    t.ensure_resident([a])
    t.ensure_resident([b])
    assert len(fake.copies) == 2
    t.order_round([slot_of(t, ba)])
    assert len(fake.copies) == 1                # a's batch only
    other = set(range(HBM)) - {slot_of(t, ba), slot_of(t, bb)}
    t.order_round(sorted(other))
    assert len(fake.copies) == 1
    t.order_round([slot_of(t, bb), slot_of(t, ba)])
    assert not fake.copies


@pytest.mark.parametrize("horizon,fused", [(1, False), (4, False), (4, True)])
def test_engine_over_lagging_copy_stream(horizon, fused):
    """Whole engines, oversubscribed, with every batch's copies lagging
    until a wait or their second poll: the greedy tokens of the
    synchronous CPU engine, migrations both ways, batches in flight."""
    ps = prompts(8, seed=3, lo=6, hi=24)

    def serve(copier):
        sc = system(12, 256, 2, horizon)
        sc.engine.fused_rounds = fused
        eng = Engine(CFG, sc, params=PARAMS, device="cpu", enable_lstm=False)
        if copier is not None:
            eng.kvc.copier = copier
        ids = [eng.add_request(p, max_new_tokens=12) for p in ps]
        outs = {o.req_id: o.tokens for o in eng.run()}
        return [outs[i] for i in ids], eng.get_statistics()["transfer"]

    fake = DeferredCopier(latency=2)
    got, tr = serve(fake)
    want, _ = serve(None)
    assert got == want
    assert tr["up_transfers"] > 0 and tr["down_transfers"] > 0
    assert tr["polls"] > 0


# -- fused rounds ---------------------------------------------------------------

def fused_system(hbm, host, batch, horizon, **kw):
    sc = system(hbm, host, batch, horizon, **kw)
    sc.engine.fused_rounds = True
    return sc


@pytest.mark.parametrize("horizon", [1, 4])
def test_fused_rounds_match_jax(horizon):
    """Fused rounds under oversubscription: the JAX fused engine's greedy
    tokens, transfer counts and migrate dispatches, and the split
    pipeline's tokens."""
    ps = prompts(6, seed=13, lo=6, hi=20)

    def serve(eng):
        ids = [eng.add_request(p, max_new_tokens=11) for p in ps]
        outs = {o.req_id: o.tokens for o in eng.run()}
        return [outs[i] for i in ids]

    port = Engine(CFG, fused_system(14, 256, 2, horizon), params=PARAMS,
                  device="cpu", enable_lstm=False)
    assert port._fused_rounds and port.kvc.defer_migrations
    mods = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig, JSystemConfig)
    ref = JEngine(j_tiny(), fused_system(14, 256, 2, horizon, mods=mods),
                  params=JPARAMS, use_pallas=True, enable_lstm=False)
    assert ref._fused_rounds
    got, want = serve(port), serve(ref)
    assert got == want
    assert got == serve(jax_engine(hbm=14, host=256, batch=2,
                                   horizon=horizon))
    st, jst = port.get_statistics(), ref.get_statistics()
    assert ({k: st["transfer"][k] for k in MOVES}
            == {k: jst["transfer"][k] for k in MOVES})
    assert st["transfer"]["up_transfers"] > 0
    assert (st["runtime"]["migrate_dispatches"]
            == jst["runtime"]["migrate_dispatches"])


def test_fused_rounds_rule():
    """`_fused_rounds` as the JAX engine sets it: not under speculative
    decoding, not without a host tier."""
    port = Engine(CFG, fused_system(32, 0, 2, 1), params=PARAMS,
                  device="cpu", enable_lstm=False)
    assert not port._fused_rounds and not port.kvc.defer_migrations
    spec = Engine(CFG, fused_system(32, 32, 2, 1), params=PARAMS,
                  device="cpu", enable_lstm=False, spec_ngram=True)
    assert not spec._fused_rounds


def test_fused_rounds_logprobs():
    """Fused rounds return logprobs (templated on the JAX
    `test_fused_rounds_engine_logprobs`): float32 attention compute, the
    JAX fused engine's tokens and records within LP_TOL, and the port's
    split engine's records exactly. The prompts are drawn as
    `test_torch_logprobs.serve_both`'s are: INT8 KV, whose codes the two
    packages can round apart only within an ulp of a half step."""
    ps = [tokens(40 + i, 9 + 2 * i) for i in range(6)]
    kw = dict(hbm=8, host=64, batch=4, horizon=2, seq=96)

    def serve(eng):
        ids = [eng.add_request(p, max_new_tokens=6, logprobs=2) for p in ps]
        outs = {o.req_id: o for o in eng.run()}
        return [outs[i] for i in ids]

    fused = engine(cfg=F32, fused_rounds=True, **kw)
    assert fused._fused_rounds
    got = serve(fused)
    ref = serve(jax_ref_engine(cfg=JF32, fused_rounds=True, **kw))
    split = serve(engine(cfg=F32, **kw))
    assert fused.get_statistics()["transfer"]["up_transfers"] > 0
    for a, b, c in zip(got, ref, split):
        assert a.tokens == b.tokens == c.tokens
        assert len(a.logprobs) == len(a.tokens)
        assert_logprobs_close(a.logprobs, b.logprobs)
        assert a.logprobs == c.logprobs


def test_fused_rounds_penalties():
    """Penalties under fused rounds (templated on the JAX
    `test_fused_rounds_path`): the JAX fused engine's tokens and the port's
    split engine's."""
    p = tokens(11, 30)
    kw = dict(max_new_tokens=16, ignore_eos=True, frequency_penalty=1.2,
              presence_penalty=0.3)
    sys_kw = dict(hbm=10, host=256, batch=4, horizon=4)
    fused = run_one(engine(cfg=F32, fused_rounds=True, **sys_kw), p, **kw)
    ref = run_one(jax_ref_engine(cfg=JF32, fused_rounds=True, **sys_kw), p,
                  **kw)
    split = run_one(engine(cfg=F32, **sys_kw), p, **kw)
    assert fused.tokens == ref.tokens == split.tokens

