"""Tensor-, expert- and data-parallel layout of the parameters and the KV
pools.

Counterpart of `cxl_speckv_tpu/parallel/sharding.py`. The JAX package
writes a `PartitionSpec` a leaf and lets GSPMD lay the arrays out; here a
spec is a table {tensor axis: mesh axis} a leaf (`param_specs`, the same
rules), and `shard_params` slices a full tree to this rank's pieces:

- Megatron tensor parallelism: the "column" weights q / k / v / gate / up
  split their output axis over "tp", the "row" weights o / down their input
  axis, so a block needs one all-reduce after o and one after down
  (`models/llama.py:_block_residuals`). q heads are laid out kv-head-major
  (q head h * G + g belongs to kv head h), so a rank's q columns are
  exactly the query heads of its kv heads, and attention needs no
  cross-rank traffic;
- the KV pools split their kv-head axis over "tp" (`pool_specs`), and so
  does the host store: a block migrates rank-locally;
- the embedding splits its vocabulary rows over "tp" (a masked lookup,
  then an all-reduce) and lm_head its vocabulary columns (the logits are
  gathered before sampling);
- MoE experts split over "ep", each expert's FFN over "tp" like the dense
  MLP; the router stays whole; GPT-OSS's down_bias and the o_bias are
  added once, after the reduce;
- batch lanes split over "dp" at run time (`shard_kernels.lane_slice`).

Quantized leaves (`ops.wquant.QuantizedTensor`) follow JAX's
`quantize_specs`: q keeps the weight's spec and the scale keeps it with the
reduced axis whole. A W4A16 weight packs two half-split nibbles a byte
along its output axis, so a column shard is unpacked, cut and packed again
in its own half-split order, which needs an even shard width.

A sharded tree is a `ShardedParams`: a dict that knows the mesh it was cut
for, as a sharded `jax.Array` knows its `NamedSharding`. The model reads
the mesh from it and issues the collectives.

Every sharded axis must divide its mesh axis (the JAX package's head rule
is `validate_tp`; vocabulary and FFN widths are checked when cut).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from cxl_speckv_tpu_torch.models.configs import LlamaConfig
from cxl_speckv_tpu_torch.ops.quant import pack_int4, unpack_int4
from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

Spec = dict  # {tensor axis: mesh axis name}


class ShardedParams(dict):
    """A parameter tree cut for `mesh` (`shard_params`)."""

    def __init__(self, tree: dict, mesh):
        super().__init__(tree)
        self.mesh = mesh


def mesh_of(params) -> Any:
    """The mesh a tree was cut for, None for a whole tree."""
    return getattr(params, "mesh", None)


def param_specs(config: LlamaConfig) -> dict[str, Any]:
    """The spec tree matching `models.llama.init_params`' layout, leaf for
    leaf the JAX `param_specs` (an empty table: replicated)."""
    layers = {
        "attn_norm": {}, "q": {2: "tp"}, "k": {2: "tp"}, "v": {2: "tp"},
        "o": {1: "tp"}, "mlp_norm": {},
        "gate": {2: "tp"}, "up": {2: "tp"}, "down": {1: "tp"},
    }
    specs: dict[str, Any] = {"embed": {0: "tp"}, "layers": layers,
                             "final_norm": {}}
    c = config
    if c.num_experts > 0:
        layers["router"] = {}
        layers["gate"] = {1: "ep", 3: "tp"}
        layers["up"] = {1: "ep", 3: "tp"}
        layers["down"] = {1: "ep", 2: "tp"}
        if c.moe_shared_expert > 0:
            layers["shared_gate"] = {2: "tp"}
            layers["shared_up"] = {2: "tp"}
            layers["shared_down"] = {1: "tp"}
            layers["shared_expert_gate"] = {}
        if c.moe_style == "gpt_oss":
            layers["router_bias"] = {}
            layers["gate_bias"] = {1: "ep", 2: "tp"}
            layers["up_bias"] = {1: "ep", 2: "tp"}
            layers["down_bias"] = {1: "ep"}
    if c.attn_bias:
        layers.update(q_bias={1: "tp"}, k_bias={1: "tp"}, v_bias={1: "tp"})
    if c.qk_norm:
        layers.update(q_norm={}, k_norm={})
    if c.attn_sinks:
        layers["sinks"] = {1: "tp"}
    if c.o_bias:
        layers["o_bias"] = {}
    if c.post_norms:
        layers.update(post_attn_norm={}, post_mlp_norm={})
    if not c.tie_embeddings:
        specs["lm_head"] = {1: "tp"}
    return specs


def quantized_specs(spec: Spec, w: QuantizedTensor) -> tuple[Spec, Spec]:
    """(q's spec, s's spec) of a quantized leaf, as JAX's `quantize_specs`:
    q keeps the weight's, s drops its reduced axis."""
    red = len(w.shape) + w.axis
    return dict(spec), {d: a for d, a in spec.items() if d != red}


def pool_specs() -> tuple[Spec, Spec, Spec, Spec]:
    """(k_pool, v_pool, k_scale, v_scale): the port's pools are
    [L, S, Hkv, bs, Dp] and the scales [L, S, Hkv, bs], the kv-head axis
    over tp (the JAX package's kT layout puts the same heads on its column
    axis)."""
    kv = {2: "tp"}
    return kv, kv, kv, kv


def shard_bounds(n: int, parts: int, index: int, what: str = "axis"
                 ) -> tuple[int, int]:
    if n % parts:
        raise ValueError(f"{what} of size {n} does not divide {parts} "
                         f"shards")
    step = n // parts
    return index * step, (index + 1) * step


def _slice(t: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    return t.narrow(dim, lo, hi - lo).clone()


def shard_tensor(t, spec: Spec, mesh, name: str = "leaf"):
    """This rank's piece of one leaf (a tensor or a QuantizedTensor)."""
    if not spec:
        return t
    if isinstance(t, QuantizedTensor):
        qspec, sspec = quantized_specs(spec, t)
        q, s = t.q, t.s
        for d, ax in qspec.items():
            lo, hi = shard_bounds(t.shape[d], mesh.size(ax),
                                  mesh.index(ax), f"{name} axis {d}")
            if t.bits == 4 and d == len(t.shape) - 1:
                if (hi - lo) % 2:
                    raise ValueError(
                        f"{name}: a W4A16 column shard of odd width "
                        f"{hi - lo} cannot be packed two nibbles a byte")
                q = pack_int4(_slice(unpack_int4(q), d, lo, hi))
            else:
                q = _slice(q, d, lo, hi)
            if d in sspec:
                s = _slice(s, d, lo, hi)
        return QuantizedTensor(q, s, t.axis, t.bits)
    for d, ax in spec.items():
        lo, hi = shard_bounds(t.shape[d], mesh.size(ax), mesh.index(ax),
                              f"{name} axis {d}")
        t = _slice(t, d, lo, hi)
    return t


def shard_params(params: dict, config: LlamaConfig, mesh) -> ShardedParams:
    """This rank's pieces of a full tree (native, W8A16 or W4A16), as a
    `ShardedParams` for `mesh`."""
    specs = param_specs(config)

    def spec(table, key, name):
        if key not in table:
            raise ValueError(f"no sharding rule for leaf {name!r}")
        return table[key]

    out: dict[str, Any] = {}
    for key, val in params.items():
        if key == "layers":
            out[key] = {k: shard_tensor(v, spec(specs["layers"], k,
                                                f"layers.{k}"),
                                        mesh, f"layers.{k}")
                        for k, v in val.items()}
        else:
            out[key] = shard_tensor(val, spec(specs, key, key), mesh, key)
    return ShardedParams(out, mesh)


def param_shardings(config: LlamaConfig, mesh, params=None) -> dict:
    """The spec tree with each quantized leaf of `params` as its (q, s)
    pair of specs (`quantized_specs`), for `mesh` (the JAX name; the specs
    do not depend on the mesh's sizes)."""
    del mesh
    specs = param_specs(config)
    if params is None:
        return specs

    def node(spec, leaf):
        return (quantized_specs(spec, leaf)
                if isinstance(leaf, QuantizedTensor) else spec)

    out = {k: node(v, params[k]) for k, v in specs.items()
           if k != "layers" and k in params}
    out["layers"] = {k: node(v, params["layers"][k])
                     for k, v in specs["layers"].items()
                     if k in params["layers"]}
    return out


def pool_shardings(mesh) -> tuple[Spec, Spec, Spec, Spec]:
    del mesh
    return pool_specs()


def shard_pools(pools, mesh) -> tuple:
    """This rank's kv heads of whole (k, v, k_scale, v_scale) pools."""
    return tuple(shard_tensor(p, s, mesh, "pool")
                 for p, s in zip(pools, pool_specs()))


def host_fetch(x: torch.Tensor, mesh=None, axes=None,
               dim: int = 0) -> np.ndarray:
    """numpy copy of a result, all-gathering along `dim` over `axes` what
    this rank does not hold (the JAX `host_fetch` replicates a sharded
    program output the same way); a replicated result copies directly."""
    if mesh is not None and axes is not None:
        x = mesh.all_gather(x, axes, dim)
    return x.detach().cpu().numpy()


def tp_compatible(config: LlamaConfig, tp: int) -> bool:
    """True when every tp-sharded axis of the config divides tp: a draft
    model then shards with the target, otherwise it serves replicated."""
    c = config
    dims = [c.num_kv_heads, c.num_q_heads, c.intermediate_size, c.vocab_size]
    return all(d % tp == 0 for d in dims)


def validate_tp(config: LlamaConfig, tp: int, ep: int = 1) -> None:
    if config.num_kv_heads % tp:
        raise ValueError(
            f"num_kv_heads={config.num_kv_heads} not divisible by tp={tp}")
    if config.num_q_heads % tp:
        raise ValueError(
            f"num_q_heads={config.num_q_heads} not divisible by tp={tp}")
    if ep > 1 and (config.num_experts == 0 or config.num_experts % ep):
        raise ValueError(
            f"num_experts={config.num_experts} not divisible by ep={ep}")
