"""int8 w8a8 quantization for inference GEMMs.

Port of ``cross_attention_vit_tpu/ops/quant.py`` in torch's (out, in) weight
layout.  Symmetric int8 with per-output-channel weight scales (static,
computed once at load) and per-row activation scales (dynamic, one amax per
row, or a static calibrated scale); int32 accumulation; the f32 rescale
multiplies the int32 result.

Scales.  JAX keeps per-output-channel scales of its (in, ..., out) kernels;
in every case the contraction runs over torch's ``in`` axis, so they are
per-row scales of the torch weight: ``quantize_weight`` on an (F, G) kernel
gives G scales, on the fused qkv (H, 3, K, D) with axis 0 contracted a
(3, K, D) scale that flattens to the 3H rows of ``to_qkv.weight``, and on the
out projection (K, D, H) with axes (0, 1) contracted an (H,) scale.  One
``quantize_weight`` serves all three.

Rounding.  ``torch.round`` rounds half to even, as the JAX package's
``jnp.round`` and ``np.rint`` do (its docstring says half away from zero;
the code is what the port follows).  Activations are divided by their scale,
not multiplied by its reciprocal, and each product keeps the JAX function's
rescale order, so that on equal inputs the port's int8 values and outputs
equal the JAX package's bit for bit.

Integer products.  ``torch._int_mm`` (cuBLASLt int8 × int8 → int32 on the
card, an exact integer product on the CPU).  On the card it takes more than
16 rows and inner and outer sizes that are multiples of 8: rows are padded
with zeros up to ``_INT_MM_MIN_ROWS`` (zeros quantize to 0 and the padded
rows are dropped), and a width that is not a multiple of 8 raises — the
result stays an exact int32 product, never a float GEMM.
"""

from __future__ import annotations

import torch
from torch import nn

_QMAX = 127.0
# torch._int_mm on CUDA needs more than 16 rows: smaller inputs are padded
_INT_MM_MIN_ROWS = 32


def quantize_weight(weight) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weight → (int8 (out, in), f32 (out,) per-row scale).

    f32 amax per row; scale = amax/127 where amax > 0, else 1;
    q = clip(round(w/scale), −127, 127), round half to even."""
    w = torch.as_tensor(weight).float()
    amax = w.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / _QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[:, None]), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def _quantize_rows(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -_QMAX, _QMAX).to(torch.int8)


def dynamic_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) symmetric int8: (xq int8, scale f32 [..., 1])."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / _QMAX, torch.ones_like(amax))
    return _quantize_rows(x32, scale), scale


class QuantLinear(nn.Module):
    """An inference-only Linear in int8 form: ``weight_q`` int8 (out, in),
    ``weight_scale`` f32 (out,), the f32 ``bias`` (or None) and, after
    calibration, a static f32 ``act_scale``.  It holds no float copy of the
    weight.

    ``capturing`` turns on calibration capture (``models/quantize.calibrate``
    sets it for one forward and clears it): the forward then takes the
    dynamic path and records max |x| over each input as a running max in
    ``calib_amax``."""

    def __init__(self, weight_q: torch.Tensor, weight_scale: torch.Tensor,
                 bias: torch.Tensor | None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("weight_scale", weight_scale)
        self.register_buffer("bias", bias)
        self.register_buffer("act_scale", None)
        self.out_features, self.in_features = weight_q.shape
        self.capturing = False
        self.calib_amax: float | None = None

    def quantize_input(self, x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(xq, scale) of an f32 input whose rows are its last axis: capture,
        else the static ``act_scale`` when set, else per-row dynamic."""
        if self.capturing:
            amax = float(x32.abs().max())
            self.calib_amax = amax if self.calib_amax is None else max(self.calib_amax, amax)
        if self.act_scale is not None and not self.capturing:
            return _quantize_rows(x32, self.act_scale), self.act_scale
        return dynamic_quantize(x32)

    def int_mm(self, xq: torch.Tensor) -> torch.Tensor:
        """int32 (..., out) = xq (..., in) int8 · weight_qᵀ, exact."""
        lead = xq.shape[:-1]
        a = xq.reshape(-1, self.in_features)
        rows = a.shape[0]
        if a.is_cuda:
            if self.in_features % 8 or self.out_features % 8:
                raise ValueError("torch._int_mm on the card needs in and out features that "
                                 f"are multiples of 8, got {self.in_features}, "
                                 f"{self.out_features}")
            if rows < _INT_MM_MIN_ROWS:
                a = torch.cat([a, a.new_zeros((_INT_MM_MIN_ROWS - rows, a.shape[1]))])
        acc = torch._int_mm(a.contiguous(), self.weight_q.t())
        return acc[:rows].reshape(*lead, self.out_features)


def qlinear(x: torch.Tensor, layer: QuantLinear) -> torch.Tensor:
    """w8a8 Linear (JAX ``qlinear``): int8 activations against the int8
    weight, int32 accumulation, ``acc·(tok_scale·col_scale)`` + bias in f32,
    cast to x's dtype (a compute dtype is ignored, as in JAX)."""
    xq, xscale = layer.quantize_input(x.float())
    y = layer.int_mm(xq).float() * (xscale * layer.weight_scale)
    if layer.bias is not None:
        y = y + layer.bias.float()
    return y.to(x.dtype)


def qkv_projection(x: torch.Tensor, layer: QuantLinear) -> torch.Tensor:
    """int8 w8a8 fused-QKV projection (JAX ``qkv_projection``): x (B, N, H)
    → (B, N, 3H) in x's dtype, the (B, N, 3, K, D) layout the attention
    kernels read.  Rescale ``(acc·tok)·chan`` in f32, then the cast."""
    xq, xscale = layer.quantize_input(x.float())
    return (layer.int_mm(xq).float() * xscale * layer.weight_scale).to(x.dtype)


def attn_out_projection(out: torch.Tensor, layer: QuantLinear) -> torch.Tensor:
    """int8 w8a8 attention output projection (JAX ``attn_out_projection``):
    out (B, N, K·D) → (B, N, H) f32, ``(acc·tok)·col_scale``; the caller adds
    the bias and casts.  The per-token scale spans the contracted (K, D)
    axes of each (b, n), the last axis here."""
    oq, oscale = layer.quantize_input(out.float())
    return layer.int_mm(oq).float() * oscale * layer.weight_scale
