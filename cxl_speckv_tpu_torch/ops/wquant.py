"""Weight-only INT8 quantization of the model's matmul weights (W8A16).

Counterpart of `cxl_speckv_tpu/ops/wquant.py`; q and s are bit-exact with it
(tests/test_torch_wquant.py). Weights are stored as int8 with a float32
scale per output channel; the matmul runs in the activation dtype and the
scale multiplies the result:

    (x @ q) * s  ==  x @ (q * s)        exactly, when s is per-out-column

The embedding quantizes per ROW, so one table serves the gather and,
transposed, the tied lm_head matmul. MoE expert weights [L, E, in, out]
quantize per output channel of each expert (s [L, E, 1, out]); the router,
biases, sinks and norms stay in full precision.

`mm` and `qeinsum` convert the int8 weight to the activation dtype on
every call (`x @ q.to(x.dtype) * s`): a full-width temporary copy per call,
a known cost that a fused W8A16 kernel would remove. The JAX package runs
these products outside any Pallas kernel too (XLA fuses its convert).
"""

from __future__ import annotations

import torch


class QuantizedTensor:
    """An int8 weight with a broadcastable per-channel scale.

    q: int8, the original weight's shape.
    s: float32, same rank with `axis` reduced to size 1.
    axis: the reduced axis, negative. Matmul weights [..., in, out] use -2
       (per-output-channel); the embedding table [V, H] uses -1 (per-row).
    """

    __slots__ = ("q", "s", "axis")

    def __init__(self, q: torch.Tensor, s: torch.Tensor, axis: int):
        self.q = q
        self.s = s
        self.axis = axis

    @property
    def shape(self):
        return self.q.shape

    @property
    def T(self):
        """2-D transpose: a per-row embedding [V, H] becomes a per-out-column
        head weight [H, V]."""
        if self.q.ndim != 2:
            raise ValueError("QuantizedTensor.T is 2-D only")
        return QuantizedTensor(self.q.T, self.s.T, -3 - self.axis)

    def __getitem__(self, idx):
        """Leading-axis indexing (layer slicing of stacked weights)."""
        return QuantizedTensor(self.q[idx], self.s[idx], self.axis)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.q.float() * self.s).to(dtype)

    def __repr__(self):
        return (f"QuantizedTensor(q={tuple(self.q.shape)}, "
                f"s={tuple(self.s.shape)}, axis={self.axis})")


def quantize_tensor(w: torch.Tensor, axis: int = -2,
                    bits: int = 8) -> QuantizedTensor:
    """Symmetric per-channel int8: s = max(amax, 1e-8) / 127 over `axis`,
    q = round-half-even(w / s) clipped to [-127, 127]. The same bits on the
    card and on the CPU: 127 divides as a tensor, because CUDA turns a
    division by a Python scalar into a multiplication by its reciprocal,
    which can differ in the last bit."""
    if bits != 8:
        raise NotImplementedError("only bits=8 (W8A16) is ported")
    axis = axis if axis < 0 else axis - w.ndim
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    s = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127)
    # rounded and clipped in place: one float32 temporary of w's size, not
    # three (a converter quantizes matrices of ~0.4 GB on the card)
    q = (wf / s).round_().clamp_(-127, 127).to(torch.int8)
    return QuantizedTensor(q, s, axis)


# matmul weights of a layer (quantized per output channel)
LAYER_MM_KEYS = frozenset({"q", "k", "v", "o", "gate", "up", "down",
                           "shared_gate", "shared_up", "shared_down"})
# kept in full precision: the MoE router (routing runs in float32, and
# top-k ties depend on it), sinks and the shared expert's scalar gate
SKIP_LAYER_KEYS = frozenset({"router", "router_bias", "shared_expert_gate",
                             "sinks"})


def quantize_weights(params: dict, bits: int = 8) -> dict:
    """Quantize an `init_params`-layout tree to W8A16: every layer matmul
    weight (dense and expert) and lm_head per output channel, the embedding
    per row; norms, biases and `SKIP_LAYER_KEYS` stay as they are. A layer
    leaf of 3 or more dimensions that is neither raises, as in the JAX
    package. Idempotent on already-quantized leaves."""
    out = dict(params)
    if not isinstance(params["embed"], QuantizedTensor):
        out["embed"] = quantize_tensor(params["embed"], axis=-1, bits=bits)
    layers = dict(params["layers"])
    for k, w in layers.items():
        if isinstance(w, QuantizedTensor):
            continue
        if k in LAYER_MM_KEYS:
            layers[k] = quantize_tensor(w, axis=-2, bits=bits)
        elif (k not in SKIP_LAYER_KEYS and w.ndim >= 3
              and not k.endswith(("_norm", "_bias"))):
            raise ValueError(f"unclassified layer weight {k!r} (shape "
                             f"{tuple(w.shape)})")
    out["layers"] = layers
    if "lm_head" in params and not isinstance(params["lm_head"],
                                              QuantizedTensor):
        out["lm_head"] = quantize_tensor(params["lm_head"], axis=-2, bits=bits)
    return out


def is_quantized(params: dict) -> bool:
    return isinstance(params.get("embed"), QuantizedTensor)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain tensor or a per-out-column QuantizedTensor."""
    if isinstance(w, QuantizedTensor):
        if w.axis != -2:
            raise ValueError(f"mm needs per-out-column scales, axis={w.axis}")
        return (x @ w.q.to(x.dtype)) * w.s.to(x.dtype)
    return x @ w


def qeinsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """einsum(spec, x, w) where w may be quantized. The einsum contracts
    exactly w's scale axis, and w's kept axes line up with the result's
    last axes as [E, 1, out] against [E, C, out] (the MoE expert einsums
    "ech,ehi->eci" and "eci,eih->ech"), as in the JAX package."""
    if isinstance(w, QuantizedTensor):
        y = torch.einsum(spec, x, w.q.to(x.dtype))
        return y * w.s.squeeze(w.axis).to(x.dtype)[..., None, :]
    return torch.einsum(spec, x, w)


def take_rows(w, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Embedding gather w[ids], dequantizing per row when quantized (to
    `dtype`, default bfloat16); plain tables gather uncast."""
    if isinstance(w, QuantizedTensor):
        if w.axis != -1:
            raise ValueError("take_rows needs per-row scales (axis=-1)")
        dt = dtype or torch.bfloat16
        return w.q[ids].to(dt) * w.s[ids].to(dt)
    return w[ids]
