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


def _fans(w: torch.Tensor, fan_in: int | None, fan_out: int | None) -> tuple[int, int]:
    """A 2-D (out, in) weight's fans, or the explicit ones (a conv kernel's
    are channels × kernel volume)."""
    if fan_in is None or fan_out is None:
        if w.dim() != 2:
            raise ValueError("pass fan_in and fan_out explicitly for a weight that is not 2-D")
        fan_out, fan_in = w.shape
    return fan_in, fan_out


@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, generator: torch.Generator | None = None,
                    fan_in: int | None = None, fan_out: int | None = None) -> torch.Tensor:
    """U(-a, a), a = sqrt(6/(fan_in+fan_out)); the fans default to a 2-D
    (out, in) weight's."""
    fan_in, fan_out = _fans(w, fan_in, fan_out)
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def xavier_normal_(w: torch.Tensor, generator: torch.Generator | None = None,
                   fan_in: int | None = None, fan_out: int | None = None) -> torch.Tensor:
    """torch ``xavier_normal_`` (gain 1): N(0, 2/(fan_in+fan_out))."""
    fan_in, fan_out = _fans(w, fan_in, fan_out)
    return w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


@torch.no_grad()
def kaiming_normal_fan_out_(w: torch.Tensor, fan_out: int,
                            generator: torch.Generator | None = None) -> torch.Tensor:
    """torch ``kaiming_normal_(mode='fan_out', nonlinearity='relu')``:
    N(0, 2/fan_out), fan_out = out_channels × kernel volume (the legacy
    CNN-stem ViT's Conv3d weights, reference model.py:244)."""
    return w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


@torch.no_grad()
def normal_02_(w: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """N(0, 0.02) — pos-embedding / CLS (reference model_cross.py:239-241;
    JAX ``trunc_or_normal_02``)."""
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
