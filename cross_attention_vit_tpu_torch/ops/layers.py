"""Eval-mode layers as plain functions on tensors.

Port of ``cross_attention_vit_tpu/ops/layers.py``.  Weights are in torch's
(out_features, in_features) layout — the reference state-dict layout the
port's modules hold.  Dropout is the identity in eval mode and is not here:
training is a later slice.

Rounding: the JAX ``linear`` accumulates in f32, adds the f32 bias and casts
once.  ``torch.matmul`` on bf16 operands also accumulates in f32 but returns
bf16, so on bf16 operands the product is rounded once before the f32 bias add.
At f32 (the CPU parity tests) the two are the same computation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x @ weightᵀ + bias.  Operands go to ``compute_dtype`` when given, else
    x.dtype; the bias is added in f32 and the result cast back to x.dtype."""
    out_dtype = x.dtype
    op_dtype = compute_dtype if compute_dtype is not None else out_dtype
    y = torch.matmul(x.to(op_dtype), weight.to(op_dtype).t()).float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU — exact erf by default (torch nn.GELU); tanh when ``approximate``.

    The JAX package keeps this knob as the module global ``GELU_APPROX`` set
    from ``config.gelu_approx``; the port reads the same config field and
    passes it explicitly."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def feed_forward(x: torch.Tensor, fc1: torch.nn.Linear, fc2: torch.nn.Linear,
                 compute_dtype: torch.dtype | None = None,
                 gelu_approx: bool = False) -> torch.Tensor:
    """Linear→GELU→Linear (eval: both dropouts are the identity)
    (reference model_cross.py:19-31)."""
    h = linear(x, fc1.weight, fc1.bias, compute_dtype)
    h = gelu(h, gelu_approx)
    return linear(h, fc2.weight, fc2.bias, compute_dtype)


def mlp_head(x: torch.Tensor, fc1: torch.nn.Linear, fc2: torch.nn.Linear,
             compute_dtype: torch.dtype | None = None,
             gelu_approx: bool = False) -> torch.Tensor:
    """Linear(H→mlp)→GELU→Linear(mlp→classes) — the per-stream classification
    head (reference model_cross.py:176-183)."""
    return feed_forward(x, fc1, fc2, compute_dtype, gelu_approx)
