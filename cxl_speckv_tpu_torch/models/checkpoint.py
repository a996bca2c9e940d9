"""Save and load a model's parameter tree.

Counterpart of `cxl_speckv_tpu/models/checkpoint.py`, which stores the tree
with orbax. The port's format is its own, and needs nothing beyond torch:
a directory holding

- `tensors.pt`: one `torch.save` of a flat dict of tensors keyed by the
  leaf's path in the tree ("layers/q"); a `QuantizedTensor` is stored as
  its two tensors, "<path>:q" and "<path>:s";
- `index.json`: the tree's leaves by path, each with its dtype and shape
  and, for a quantized leaf, its scale `axis`, its `bits` (8, or 4 for a
  W4A16 weight, whose q holds two nibbles a byte) and both tensors' dtypes
  and shapes.

`load_params` reads the tensors with `torch.load(weights_only=True,
mmap=True)`: no pickled object beyond tensors and dicts is accepted, and
the file's pages are mapped, not read into a second host copy. The tree
then moves to the device one leaf at a time, so the device holds at most
the tree while it loads. `like=` holds the checkpoint to a tree's
structure, shapes and dtypes before any tensor is read, as the JAX
package restores to its `like` tree's shape / dtype structs.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

TENSORS, INDEX = "tensors.pt", "index.json"
FORMAT = "cxl_speckv_tpu_torch.params"
VERSION = 1


def _leaves(tree, prefix=""):
    """(path, leaf) for every leaf of a tree of dicts, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            k = str(k)
            if "/" in k or ":" in k:
                raise ValueError(f"key {prefix + k!r}: '/' and ':' are "
                                 f"reserved in checkpoint paths")
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (torch.Tensor, QuantizedTensor)):
        yield prefix[:-1], tree
    else:
        raise TypeError(f"leaf {prefix[:-1]!r}: {type(tree).__name__} is "
                        f"neither a tensor nor a QuantizedTensor")


def _spec(t: torch.Tensor) -> dict:
    return {"dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape)}


def _entry(leaf) -> dict:
    if isinstance(leaf, QuantizedTensor):
        return {"kind": "quantized", "axis": leaf.axis, "bits": leaf.bits,
                "q": _spec(leaf.q), "s": _spec(leaf.s)}
    return {"kind": "tensor", **_spec(leaf)}


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A compact host tensor of `t`'s values: a view of a larger tensor (a
    layer slice of a stacked weight) would otherwise save its whole
    storage."""
    t = t.detach().cpu()
    if (not t.is_contiguous()
            or t.untyped_storage().nbytes() != t.numel() * t.element_size()):
        t = t.contiguous().clone()
    return t


def save_params(params: dict, path) -> None:
    """Write `params` (the port's tree: dicts of tensors and
    QuantizedTensors) into the directory `path`, created if missing; an
    existing checkpoint there is replaced."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    index, flat = {}, {}
    for key, leaf in _leaves(params):
        index[key] = _entry(leaf)
        if isinstance(leaf, QuantizedTensor):
            flat[key + ":q"] = _host_copy(leaf.q)
            flat[key + ":s"] = _host_copy(leaf.s)
        else:
            flat[key] = _host_copy(leaf)
    torch.save(flat, path / TENSORS)
    (path / INDEX).write_text(json.dumps(
        {"format": FORMAT, "version": VERSION, "leaves": index}, indent=1))


def read_index(path) -> dict:
    """The checkpoint's leaves by path (see the module docstring); a
    quantized leaf written before `bits` was recorded is int8."""
    meta = json.loads((Path(path) / INDEX).read_text())
    if meta.get("format") != FORMAT or meta.get("version") != VERSION:
        raise ValueError(f"{path}: not a checkpoint of this format "
                         f"({meta.get('format')!r} v{meta.get('version')})")
    leaves = meta["leaves"]
    for e in leaves.values():
        if e["kind"] == "quantized":
            e.setdefault("bits", 8)
    return leaves


def check_like(index: dict, like: dict) -> None:
    """Raise ValueError on the first leaf where the checkpoint and `like`
    differ in presence, kind, axis, shape or dtype, naming its path."""
    want = {k: _entry(v) for k, v in _leaves(like)}
    for key in sorted(set(want) | set(index)):
        if key not in index:
            raise ValueError(f"leaf {key!r} of the like tree is missing from "
                             f"the checkpoint")
        if key not in want:
            raise ValueError(f"leaf {key!r} of the checkpoint is not in the "
                             f"like tree")
        if index[key] != want[key]:
            raise ValueError(f"leaf {key!r}: checkpoint {index[key]} != like "
                             f"tree {want[key]}")


def load_params(path, like: dict | None = None, device=None) -> dict:
    """Read the checkpoint in directory `path` onto `device` (None: the
    card; raises without CUDA, as the engine does). With `like`, the
    checkpoint must match that tree's structure, shapes and dtypes."""
    from cxl_speckv_tpu_torch.engine.engine import resolve_device

    dev = resolve_device(device)
    index = read_index(path)
    if like is not None:
        check_like(index, like)
    flat = torch.load(Path(path) / TENSORS, map_location="cpu",
                      weights_only=True, mmap=True)
    tree: dict = {}
    for key, e in index.items():
        *parents, name = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        if e["kind"] == "quantized":
            # the scale first: it is small, and q then lands beside it
            s = flat.pop(key + ":s").to(dev)
            node[name] = QuantizedTensor(flat.pop(key + ":q").to(dev), s,
                                         int(e["axis"]), int(e["bits"]))
        else:
            node[name] = flat.pop(key).to(dev)
    if flat:
        raise ValueError(f"{path}: tensors without an index entry: "
                         f"{sorted(flat)[:4]}")
    return tree
