"""The native residency directory and block pool on the port
(`cxl_speckv_tpu_torch/native`, ctypes over `native/*.cpp`), on the CPU:

- the library builds from the repository's sources into the port's
  `_build/` (named by a digest; nothing written into `native/`), and a
  failed build raises;
- the directory state-machine cases of `tests/test_directory.py` and the
  block-pool cases of `tests/test_block_pool.py`, run on the port's Python
  and native classes (the JAX modules' functions with their globals bound
  to the port's);
- a lockstep fuzz (seeds 0-3) of the port's Python directory against the
  native one, with the port's held demotes (`complete_demote(hold_slot=
  True)`, `release_hbm_slot`) among the operations: the same results,
  errors, states, slots, statistics and state counts at every step;
- engines on the native directory: the same tokens and directory
  statistics as on the Python one, synchronous and over a copy stream
  that lags (held slots), and `SPECKV_NATIVE=1` selecting it.
"""

import dataclasses

import numpy as np
import pytest
import test_block_pool as jbp
import test_directory as jdir
import torch
from test_torch_engine import CFG, PARAMS, system
from test_torch_migrate import DeferredCopier

from cxl_speckv_tpu_torch import native
from cxl_speckv_tpu_torch.config import CacheConfig
from cxl_speckv_tpu_torch.core import block_table
from cxl_speckv_tpu_torch.core.block_pool import BlockPool
from cxl_speckv_tpu_torch.core.directory import (
    BlockState,
    DirectoryError,
    ResidencyDirectory,
)
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.runtime import kv_cache as kvmod
from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache

IMPLS = {"python": ResidencyDirectory,
         "native": native.NativeResidencyDirectory}


def test_builds_into_the_port_build_dir(tmp_path, monkeypatch):
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path == native.library_path()
    assert all(p.parent.name == "native" for p in native.SOURCES)
    # a failed build raises (here: a source that does not compile)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", [bad])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the native runtime"):
        native.build()
    assert not any((tmp_path / "build").glob("*.so"))


def bind(monkeypatch, module, impl):
    """Point a JAX test module's globals at the port's classes."""
    for name, value in (("CacheConfig", CacheConfig),
                        ("BlockState", BlockState),
                        ("DirectoryError", DirectoryError),
                        ("ResidencyDirectory", ResidencyDirectory),
                        ("NativeResidencyDirectory",
                         native.NativeResidencyDirectory),
                        ("BlockPool", BlockPool),
                        ("NativeBlockPool", native.NativeBlockPool),
                        ("BlockTable", block_table.BlockTable),
                        ("INVALID_SLOT", block_table.INVALID_SLOT)):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, value)
    if impl is not None:
        monkeypatch.setattr(module, "_current_impl", IMPLS[impl],
                            raising=False)


DIRECTORY_CASES = sorted(n for n in vars(jdir) if n.startswith("test_"))
POOL_CASES = sorted(n for n in vars(jbp) if n.startswith("test_")
                    and n not in ("test_table_rows_and_clear",
                                  "test_pool_lockstep_fuzz"))


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("case", DIRECTORY_CASES)
def test_directory_state_machine(case, impl, monkeypatch):
    bind(monkeypatch, jdir, impl)
    getattr(jdir, case)()


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_block_pool_cases(case, backend, monkeypatch):
    bind(monkeypatch, jbp, None)
    getattr(jbp, case)(backend)


def snapshot(d, bids):
    out = []
    for bid in bids:
        if bid in d:
            e = d.entry(bid)
            out.append((bid, e.state.name, e.hbm_slot, e.host_slot,
                        e.dirty, e.pinned, e.prefetched))
        else:
            out.append((bid, None))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lockstep_fuzz_with_held_slots(seed):
    """`tests/test_directory_fuzz.py` on the port's two directories, with
    held demotes: block ids differ once a slot has been held (the native
    binding's placeholder takes an id), so blocks are tracked by their
    allocation order."""
    cfg = CacheConfig(num_hbm_blocks=6, num_host_blocks=10,
                      prefetch_reserve_frac=0.2)
    dirs = (ResidencyDirectory(cfg), native.NativeResidencyDirectory(cfg))
    rng = np.random.RandomState(seed)
    live = ([], [])            # each directory's ids, in allocation order
    held = ([], [])            # held HBM slots

    def apply(k, op, i, flag):
        d, ids = dirs[k], live[k]
        bid = ids[i] if i is not None else 10_000
        try:
            if op == 0:
                r = d.allocate(pinned=flag)
                if r is not None:
                    ids.append(r)
                return r is not None, None
            if op == 1:
                d.free(bid)
                ids.remove(bid)
                return None, None
            if op == 2:
                return d.access(bid).name, None
            if op == 3:
                return d.mark_dirty(bid), None
            if op == 4:
                return (d.pin(bid) if flag else d.unpin(bid)), None
            if op == 5:
                return d.start_promote(bid, prefetch=flag), None
            if op == 6:
                return d.complete_promote(bid), None
            if op == 7:
                return d.start_demote(bid, eviction=flag), None
            if op == 8:
                slot = d.complete_demote(bid, hold_slot=flag)
                if flag:
                    held[k].append(slot)
                return slot, None
            if op == 9:
                return [ids.index(b) for b in d.evict_candidates(3)], None
            if op == 10:
                return d.cancel_demote(bid), None
            if op == 11 and held[k]:
                d.release_hbm_slot(held[k].pop(0))
            return None, None
        except DirectoryError:
            return None, "DirectoryError"

    for step in range(400):
        op = rng.randint(0, 12)
        n = len(live[0])
        i = (int(rng.randint(0, n)) if n and rng.rand() < 0.9 else None)
        flag = bool(rng.randint(0, 2))
        r0, r1 = apply(0, op, i, flag), apply(1, op, i, flag)
        assert r0 == r1, f"step {step} op {op}: {r0} vs {r1}"
        assert len(live[0]) == len(live[1]) and held[0] == held[1]
        # the entries of the last 12 blocks, ids aside
        snap = [[e[1:] for e in snapshot(d, ids[-12:])]
                for d, ids in zip(dirs, live)]
        assert snap[0] == snap[1], f"step {step}"
        for attr in ("hbm_free", "host_free"):
            assert getattr(dirs[0], attr) == getattr(dirs[1], attr)
        assert dirs[0].hbm_pressure() == dirs[1].hbm_pressure()
        assert len(dirs[0]) == len(dirs[1])
    s0, s1 = (d.get_statistics().as_dict() for d in dirs)
    assert s0 == s1
    assert dirs[0].state_counts() == dirs[1].state_counts()
    dirs[1].reset_statistics()
    assert dirs[1].get_statistics().allocations == 0


def native_engine(native_flag, copier=None, hbm=12):
    orig = kvmod.TieredKVCache.__init__

    def patched(self, *a, **kw):
        kw["native"] = native_flag
        return orig(self, *a, **kw)

    kvmod.TieredKVCache.__init__ = patched
    try:
        eng = Engine(CFG, system(hbm, 256, 2, 4), params=PARAMS, device="cpu",
                     enable_lstm=False)
    finally:
        kvmod.TieredKVCache.__init__ = orig
    if copier is not None:
        eng.kvc.copier = copier
    return eng


def serve(eng, ps):
    ids = [eng.add_request(p, max_new_tokens=12) for p in ps]
    outs = {o.req_id: o.tokens for o in eng.run()}
    return [outs[i] for i in ids], eng.get_statistics()


@pytest.mark.parametrize("lagging", [False, True])
def test_engine_native_equals_python(lagging):
    """Tokens and every directory statistic equal between the directories;
    with a lagging copy stream demoted slots are held (placeholders), and
    every one is released by the end."""
    rng = np.random.RandomState(3)
    ps = [rng.randint(1, CFG.vocab_size, rng.randint(6, 24)).tolist()
          for _ in range(8)]
    copier = (lambda: DeferredCopier(latency=2)) if lagging else (lambda: None)
    py = native_engine(False, copier())
    nat = native_engine(True, copier())
    assert isinstance(nat.kvc.directory, native.NativeResidencyDirectory)
    assert isinstance(nat.kvc.pool, native.NativeBlockPool)
    want, sw = serve(py, ps)
    got, sg = serve(nat, ps)
    assert got == want
    assert sg["directory"] == sw["directory"]
    assert sg["pool"] == sw["pool"]
    counts = lambda tr: {k: v for k, v in tr.items()
                         if not k.endswith("_ms")}      # host-clock waits
    assert counts(sg["transfer"]) == counts(sw["transfer"])
    assert sg["transfer"]["down_transfers"] > 0
    nat.kvc.drain()
    assert not nat.kvc.directory._held
    assert nat.kvc.directory.hbm_free == py.kvc.directory.hbm_free


def test_speckv_native_env_selects_native(monkeypatch):
    cc = CacheConfig(block_size=8, num_hbm_blocks=8, num_host_blocks=8)
    cfg = dataclasses.replace(tiny_test_config(), num_layers=1)
    monkeypatch.setenv("SPECKV_NATIVE", "1")
    kvc = TieredKVCache(cc, cfg, max_seqs=2, max_blocks_per_seq=4)
    assert isinstance(kvc.directory, native.NativeResidencyDirectory)
    monkeypatch.delenv("SPECKV_NATIVE")
    kvc = TieredKVCache(cc, cfg, max_seqs=2, max_blocks_per_seq=4)
    assert isinstance(kvc.directory, ResidencyDirectory)
    kvc = TieredKVCache(cc, cfg, max_seqs=2, max_blocks_per_seq=4,
                        native=True)
    s = kvc.add_seq()
    assert kvc.extend_seq(s, 20) and kvc.pool.table.get(s, 2) >= 0
    assert torch.equal(torch.from_numpy(kvc.pool.table.row(s)[:3].copy()),
                       torch.tensor([kvc.directory.entry(b).hbm_slot
                                     for b in kvc.pool.seq(s).blocks],
                                    dtype=torch.int32))
