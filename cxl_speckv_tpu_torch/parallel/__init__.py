"""Mesh serving on `torch.distributed`: the serving half of the JAX
package's `parallel` package (`mesh`, `distributed`, `sharding`,
`shard_kernels`, `lockstep`). Its offline-scoring half (`pipeline.py`,
`ring.py`) is not ported yet.

Kept for parity with the JAX package's API and called only by the tests:
`make_mesh` / `single_device_mesh` and `Mesh(local=)` (the engine builds
its mesh itself), `param_shardings`, `pool_shardings` and `shard_pools`
(the engine cuts the params with `shard_params` and builds its pools at
the shard's width), and `host_fetch` (every pass of the port already
returns whole results: the logits are gathered over tp and the hidden
states over dp inside the model)."""

from cxl_speckv_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from cxl_speckv_tpu_torch.parallel.sharding import (  # noqa: F401
    param_shardings,
    pool_shardings,
    shard_params,
    shard_pools,
)
