"""The automatic decode horizon (`utils/dispatch.py`) against the JAX
package's:

- `derive_decode_horizon` gives the JAX rule's horizon over a grid of
  weight bytes and pinned dispatch costs, with both modules' step
  constants set equal (the port's are the H100's own, the reference's a
  TPU's);
- `params_byte_size` counts the port's tree (int8 values and scales of a
  quantized weight) as the JAX package counts its tree;
- a default `EngineConfig` (horizon 0) builds an engine that serves, with
  the derived horizon written back into the config, as in the JAX engine.
"""

import jax
import numpy as np
import pytest
from test_torch_engine import CFG, JPARAMS, PARAMS

from cxl_speckv_tpu.config import EngineConfig as JEngineConfig
from cxl_speckv_tpu.config import SystemConfig as JSystemConfig
from cxl_speckv_tpu.engine.engine import Engine as JEngine
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.ops.wquant import quantize_weights as j_quantize
from cxl_speckv_tpu.utils import dispatch as jdispatch
from cxl_speckv_tpu_torch.config import EngineConfig, SystemConfig
from cxl_speckv_tpu_torch.engine import Engine
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.utils import dispatch

GiB = 2**30


@pytest.mark.parametrize("dispatch_ms", [0.01, 0.05, 1.0, 10.0, 25.0, 100.0])
def test_derive_decode_horizon_matches_jax(monkeypatch, dispatch_ms):
    monkeypatch.setattr(dispatch, "_STREAM_BPS", jdispatch._STREAM_BPS)
    monkeypatch.setattr(dispatch, "_STEP_FLOOR_MS", jdispatch._STEP_FLOOR_MS)
    monkeypatch.setattr(dispatch, "_dispatch_ms_cache",
                        {"cpu": dispatch_ms})
    monkeypatch.setattr(jdispatch, "_dispatch_ms_cache", dispatch_ms)
    for nbytes in (0, 10**6, GiB, int(2.5 * GiB), 8 * GiB, 16 * GiB):
        for cap in (1, 8, 32):
            assert (dispatch.derive_decode_horizon(nbytes, cap, device="cpu")
                    == jdispatch.derive_decode_horizon(nbytes, cap)), (
                nbytes, cap)


def test_dispatch_ms_pin_and_measurement(monkeypatch):
    """SPECKV_DISPATCH_MS pins the cost; without it the cost is measured
    once and cached for the device type."""
    monkeypatch.setattr(dispatch, "_dispatch_ms_cache", {})
    monkeypatch.setenv("SPECKV_DISPATCH_MS", "2.5")
    assert dispatch.measured_dispatch_ms("cpu") == 2.5
    monkeypatch.setattr(dispatch, "_dispatch_ms_cache", {})
    monkeypatch.delenv("SPECKV_DISPATCH_MS")
    ms = dispatch.measured_dispatch_ms("cpu")
    assert 0 < ms < 1000
    assert dispatch.measured_dispatch_ms("cpu") == ms


@pytest.mark.parametrize("quantized", [False, True])
def test_params_byte_size_matches_jax(quantized):
    jp = j_quantize(JPARAMS) if quantized else JPARAMS
    tree = jax.tree.map(np.asarray, jp)
    assert (dispatch.params_byte_size(params_from_jax(tree))
            == jdispatch.params_byte_size(jp))


def test_default_engine_config_serves():
    """Engine(cfg, SystemConfig()) with every default: the horizon is
    derived (the conftest's pinned 0.05 ms gives 1, as the JAX engine
    derives) and written back, and requests are served."""
    sc, jsc = SystemConfig(), JSystemConfig()
    assert sc.engine.decode_horizon == 0 == JEngineConfig().decode_horizon
    eng = Engine(CFG, sc, params=PARAMS, device="cpu")
    jeng = JEngine(j_tiny(), jsc, params=JPARAMS, use_pallas=False)
    assert sc.engine.decode_horizon == jsc.engine.decode_horizon == 1
    assert eng.config.engine is sc.engine
    assert eng.prefetcher.predictor is None     # prefetch is off by default
    rng = np.random.RandomState(0)
    ps = [rng.randint(1, CFG.vocab_size, 10).tolist() for _ in range(3)]
    outs = eng.generate(ps, max_new_tokens=6)
    assert all(len(o) == 6 or o[-1] == CFG.eos_token_id for o in outs)
    assert eng.get_statistics()["engine"]["requests_finished"] == 3
    pinned = Engine(CFG, SystemConfig(engine=EngineConfig(decode_horizon=1)),
                    params=PARAMS, device="cpu").generate(ps, max_new_tokens=6)
    assert outs == pinned
