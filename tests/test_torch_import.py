"""The port stands alone: importing every module of `cxl_speckv_tpu_torch`
(and `chip_smoke.py`) loads neither JAX nor the JAX package, and the entry
points refuse to run without a card unless the caller asks for the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# the measurement and check scripts ported from the JAX package's scripts/
SCRIPTS = ("round_anatomy", "kernel_probe", "kernel_bench",
           "verify_gamma_probe", "spec_bench", "tpu_spec_check",
           "stream_bench", "kv_quant_ppl", "kv_quant_accuracy",
           "tpu_window_check", "tpu_f32_identity", "hostop_probe",
           "bench_ablate", "multiproc_serve")
PARALLEL = ("parallel", "parallel.mesh", "parallel.distributed",
            "parallel.sharding", "parallel.shard_kernels",
            "parallel.lockstep", "parallel.pipeline", "parallel.ring")

_PROBE = r"""
import importlib, json, pkgutil, sys
import cxl_speckv_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "cxl_speckv_tpu" or m.startswith("cxl_speckv_tpu.")
             or m.split(".")[0] in ("transformers", "safetensors", "orbax"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    r = _run(_PROBE)
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], f"the port loaded {res['bad']}"
    # every module of the slice was imported
    for name in ("ops.paged_attention", "ops.chunk_attention_cuda",
                 "ops.cuda_build", "models.llama", "models.moe",
                 "models.convert", "models.hf_convert", "ops.decode_anatomy",
                 "scripts.kernel_anatomy", "utils.card",
                 "engine.engine", "engine.spec", "runtime.kv_cache",
                 "runtime.hoststore",
                 "prefetcher.controller", "prefetcher.lstm",
                 "utils.dispatch", "scripts.train_predictor",
                 "server", "engine.scoring", "models.checkpoint",
                 "native", "ops.w4_unpack", "ops.w4a16_mm", "ops.w8a16_mm",
                 "runtime.transfer",
                 *PARALLEL,
                 *(f"scripts.{m}" for m in ("common", *SCRIPTS))):
        assert f"cxl_speckv_tpu_torch.{name}" in res["modules"]


def test_parallel_package_imports_no_jax():
    """The mesh modules and the lockstep script alone, in a fresh process:
    neither JAX nor the JAX package (whose lockstep.py they copy), and no
    process group or rank process started by importing them."""
    mods = [f"cxl_speckv_tpu_torch.{m}"
            for m in (*PARALLEL, "scripts.multiproc_serve")]
    r = _run("import importlib, json, sys\n"
             f"for m in {mods!r}: importlib.import_module(m)\n"
             "import torch.distributed as dist\n"
             "print(json.dumps([dist.is_initialized(), sorted(m for m in "
             "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
             "'cxl_speckv_tpu'))]))")
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [False, []]


def test_hf_convert_imports_no_transformers():
    """The HF converter reads configs and state dicts without the
    `transformers` package (the card's machine has none)."""
    r = _run("import json, sys\n"
             "import cxl_speckv_tpu_torch.models.hf_convert\n"
             "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
             " in ('transformers', 'safetensors', 'jax'))))")
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", ["models.checkpoint", "server",
                                    "engine.scoring"])
def test_front_end_modules_import_no_jax_orbax_safetensors(module):
    """The checkpoint format is the port's own (`torch.save` and a JSON
    index): loading it, the server or the scorer brings in neither JAX nor
    orbax nor safetensors, none of which the card's machine has."""
    r = _run("import json, sys\n"
             f"import cxl_speckv_tpu_torch.{module}\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules"
             " if m.split('.')[0] in ('orbax', 'safetensors', 'jax', "
             "'jaxlib', 'cxl_speckv_tpu')})))")
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax_import():
    """No source line of the port imports jax or the JAX package."""
    files = sorted((REPO / "cxl_speckv_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not (mod == "jax" or mod.startswith("jax.")
                            or mod == "cxl_speckv_tpu"
                            or mod.startswith("cxl_speckv_tpu.")), (f, s)


def test_engine_without_device_needs_cuda():
    from cxl_speckv_tpu_torch import (
        CacheConfig,
        EngineConfig,
        SystemConfig,
        tiny_test_config,
    )
    from cxl_speckv_tpu_torch.engine import Engine

    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    sc = SystemConfig(cache=CacheConfig(block_size=8, num_hbm_blocks=8,
                                        num_host_blocks=8),
                      engine=EngineConfig(max_batch_size=2, max_seq_len=32,
                                          prefill_chunk=16, decode_horizon=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(tiny_test_config(), sc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(tiny_test_config(), sc, device="cuda")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the script exits non-zero and prints no result, also
    from a directory that holds chip_smoke.py and nothing else."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run("import runpy, sys; sys.argv = ['chip_smoke.py']; "
             "runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_need_cuda_by_default(name):
    """Each ported script runs on the card unless `--device cpu` is given,
    and raises without CUDA rather than fall back to the CPU; its
    docstring names its counterpart in the JAX package's scripts/."""
    import importlib

    mod = importlib.import_module(f"cxl_speckv_tpu_torch.scripts.{name}")
    assert f"scripts/{name}.py" in mod.__doc__
    assert mod.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        mod.main([])
