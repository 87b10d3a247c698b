"""Parameter initializers matching the reference's PyTorch init semantics.

Every Linear gets ``xavier_uniform_`` with zero bias, LayerNorms ones/zeros,
pos-embedding and CLS N(0, 0.02) (reference model_cross.py:214-241; JAX port
counterpart ``cross_attention_vit_tpu/ops/initializers.py``).  Draws come from
an explicit ``torch.Generator`` on the tensor's device, so full-size weights
are made on the card from a seed.  The JAX package draws from ``jax.random``:
parity with it is in distribution only.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """U(-a, a), a = sqrt(6/(fan_in+fan_out)) for a 2-D (out, in) weight."""
    fan_out, fan_in = w.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_02_(w: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """N(0, 0.02) — pos-embedding / CLS (reference model_cross.py:239-241)."""
    return w.normal_(0.0, 0.02, generator=generator)


@torch.no_grad()
def init_linear_(lin: torch.nn.Linear, generator: torch.Generator | None = None) -> None:
    xavier_uniform_(lin.weight, generator)
    if lin.bias is not None:
        lin.bias.zero_()


@torch.no_grad()
def init_layernorm_(norm: torch.nn.LayerNorm) -> None:
    norm.weight.fill_(1.0)
    norm.bias.zero_()
