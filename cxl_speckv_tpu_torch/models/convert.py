"""Carry the JAX package's weights and pools into the port.

The input is the JAX package's tree with its leaves as numpy arrays (e.g.
`jax.tree.map(np.asarray, params)`); nothing here imports JAX. bfloat16
leaves arrive as `ml_dtypes.bfloat16` arrays, which `torch.from_numpy`
rejects, so they cross as a uint16 view. A quantized weight arrives as its
`(q, s, axis)` triple, or any object with those three attributes; an int4
q (`ml_dtypes.int4`, the JAX package's W4A16 storage) packs into the port's
two nibbles a byte (`ops/wquant.pack_int4`).
Every leaf crosses as it is, so a Gemma-2 tree keeps its post-norm leaves
(`post_attn_norm`, `post_mlp_norm`) and its tied `embed`, quantized per
row under W8A16, which then also serves as the head through `.T`; and a
GPT-OSS tree keeps its biases, sinks and router in their own dtype and its
quantized expert stacks as `(q, s, axis)` with s [L, E, 1, I].
"""

from __future__ import annotations

import numpy as np
import torch

from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor, pack_int4


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:       # views of JAX buffers are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _quantized(q, s, axis, device) -> QuantizedTensor:
    q = np.asarray(q)
    if q.dtype.name == "int4":
        return QuantizedTensor(
            pack_int4(tensor_from_numpy(q.astype(np.int8))).to(device),
            tensor_from_numpy(s, device), int(axis), bits=4)
    return QuantizedTensor(tensor_from_numpy(q, device),
                           tensor_from_numpy(s, device), int(axis))


def _leaf(x, device):
    if isinstance(x, (tuple, list)) and len(x) == 3:
        return _quantized(*x, device)
    if all(hasattr(x, a) for a in ("q", "s", "axis")):
        return _quantized(x.q, x.s, x.axis, device)
    return tensor_from_numpy(x, device)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """JAX param tree (numpy leaves) -> the port's params, same layout."""
    out = {k: _leaf(v, device) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: _leaf(v, device) for k, v in tree["layers"].items()}
    return out


def pools_from_jax(k_pools, v_pools, k_scales, v_scales, num_kv_heads: int,
                   device="cpu") -> tuple:
    """JAX pools -> the port's token-major pools. JAX K is "kT"
    [..., S, D/pack, Hkv*bs] and its scales flat [..., S, 1, Hkv*bs]; the
    port keeps K like V, [..., S, Hkv, bs, D/pack], and scales
    [..., S, Hkv, bs] (the inverse of the JAX `store_to_kt`)."""
    k = np.asarray(k_pools)
    k = k.reshape(*k.shape[:-1], num_kv_heads, -1)      # [..., Dp, Hkv, bs]
    k = np.moveaxis(k, -3, -1)                          # [..., Hkv, bs, Dp]
    sc = lambda s: np.asarray(s).reshape(*np.shape(s)[:-2], num_kv_heads, -1)
    return (tensor_from_numpy(k, device), tensor_from_numpy(v_pools, device),
            tensor_from_numpy(sc(k_scales), device),
            tensor_from_numpy(sc(v_scales), device))


def lstm_params_from_jax(tree: dict, device="cpu") -> dict:
    """The JAX prefetch predictor's tree (numpy leaves, e.g.
    `jax.tree.map(np.asarray, predictor.params)`) -> the port's
    `prefetcher.lstm` tree: embed, out and per layer wx, wh, b, float32."""
    t = lambda a: tensor_from_numpy(np.asarray(a, np.float32), device)
    return {"embed": t(tree["embed"]), "out": t(tree["out"]),
            "cells": [{k: t(c[k]) for k in ("wx", "wh", "b")}
                      for c in tree["cells"]]}
