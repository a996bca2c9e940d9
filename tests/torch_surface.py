"""Shared set-up of the serving-surface tests of the port
(`test_torch_sessions.py`, `test_torch_cancel.py`, `test_torch_logprobs.py`,
`test_torch_penalties.py`): engines of both packages on `tiny_test_config()`
with the JAX weights carried over (`models/convert.params_from_jax`).

`F32` / `JF32` are the same model with float32 attention compute: the JAX
engine then runs its reference attention (`use_pallas=False`) and the port
its plain versions, both in float32, so greedy tokens agree bit for bit and
logprobs within LP_TOL. The port's own cases use the bf16-compute `CFG`, as
the served model does.
"""

import dataclasses

import numpy as np
from test_torch_engine import CFG, JPARAMS, PARAMS

from cxl_speckv_tpu.config import CacheConfig as JCacheConfig
from cxl_speckv_tpu.config import EngineConfig as JEngineConfig
from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.config import PrefetchConfig as JPrefetchConfig
from cxl_speckv_tpu.config import SystemConfig as JSystemConfig
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.engine import Engine

F32 = dataclasses.replace(CFG, attn_compute_dtype="float32")
JF32 = dataclasses.replace(j_tiny(), attn_compute_dtype="float32")
V = CFG.vocab_size
LP_TOL = 2e-4          # logprobs, port against the JAX package (float32)
PORT = (CacheConfig, EngineConfig, KVDtype, PrefetchConfig, SystemConfig)
JAX = (JCacheConfig, JEngineConfig, JKV, JPrefetchConfig, JSystemConfig)


def system(mods=PORT, hbm=256, host=256, batch=2, horizon=1, kv="int8",
           chunk=32, seq=128, prefetch=True, **ekw):
    cc, ec, kvd, pc, sc = mods
    return sc(cache=cc(block_size=8, num_hbm_blocks=hbm, num_host_blocks=host,
                       kv_dtype=kvd(kv)),
              prefetch=pc(enabled=prefetch, depth=2),
              engine=ec(max_batch_size=batch, max_seq_len=seq,
                        prefill_chunk=chunk, decode_horizon=horizon, **ekw))


def engine(cfg=CFG, seed=0, spec=None, **kw):
    """The port's engine on the CPU; `spec`: its speculative arguments."""
    return Engine(cfg, system(**kw), params=PARAMS, device="cpu", seed=seed,
                  enable_lstm=False, **(spec or {}))


def jax_engine(cfg=JF32, seed=0, spec=None, **kw):
    """The JAX engine with its reference attention."""
    return JEngine(cfg, system(JAX, **kw), params=JPARAMS, use_pallas=False,
                   enable_lstm=False, seed=seed, **(spec or {}))


def tokens(seed, n, lo=1):
    return np.random.RandomState(seed).randint(lo, V, n).tolist()


def run_one(eng, prompt, **kw):
    rid = eng.add_request(prompt, **kw)
    return {o.req_id: o for o in eng.run()}[rid]


def run_turn(eng, sid, new, **kw):
    rid = eng.continue_session(sid, new, **kw)
    return {o.req_id: o for o in eng.run()}[rid]


def assert_logprobs_close(got, want, tol=LP_TOL):
    """Per-token logprob records within `tol`; top-k ids compared where the
    values are distinct (`torch.topk` and `lax.top_k` may order ties
    differently)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g["logprob"] - w["logprob"]) <= tol
        np.testing.assert_allclose(g["top_logprobs"], w["top_logprobs"],
                                   rtol=0, atol=tol)
        vals = np.asarray(w["top_logprobs"])
        distinct = np.ones(len(vals), bool)
        distinct[1:] &= np.abs(np.diff(vals)) > 2 * tol
        distinct[:-1] &= np.abs(np.diff(vals)) > 2 * tol
        assert (np.asarray(g["top_ids"])[distinct]
                == np.asarray(w["top_ids"])[distinct]).all()
