"""Parallelism on `torch.distributed`, the counterpart of the JAX package's
`parallel` package, one process a rank: mesh serving (`mesh`,
`distributed`, `sharding`, `shard_kernels`, `lockstep`) over a
(dp, ep, tp) `Mesh`, and offline scoring over a one-axis `LineMesh`: the
GPipe pipeline over "pp" (`pipeline.pipeline_forward`) and ring attention
over "sp" (`ring.sp_forward_dense`), reached through
`engine.scoring.score_prompts(mode="pp" | "sp")`.

Kept for parity with the JAX package's API and called only by the tests:
`make_mesh` / `single_device_mesh` and `Mesh(local=)` (the engine builds
its mesh itself), `param_shardings`, `pool_shardings` and `shard_pools`
(the engine cuts the params with `shard_params` and builds its pools at
the shard's width), and `host_fetch` (every pass of the port already
returns whole results: the logits are gathered over tp and the hidden
states over dp inside the model)."""

import importlib

from cxl_speckv_tpu_torch.parallel.mesh import LineMesh, make_mesh  # noqa: F401
from cxl_speckv_tpu_torch.parallel.sharding import (  # noqa: F401
    param_shardings,
    pool_shardings,
    shard_params,
    shard_pools,
)

# the scoring forwards import `models.llama`, which imports this package:
# they load on first use
_LAZY = {"pipeline_forward": "pipeline", "stage_params": "pipeline",
         "sp_forward_dense": "ring"}


def __getattr__(name: str):
    if name in _LAZY:
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
