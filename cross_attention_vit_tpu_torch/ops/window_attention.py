"""Swin's shifted-window attention and patch merging on a (B, d, h, w, C)
token grid, as MONAI's ``SwinTransformerBlock.forward_part1`` and
``PatchMergingV2`` compute them (``monai.networks.nets.swin_unetr``).

``window_attention`` takes the block's ``norm1`` output and does, inside
``span("swin:window_attention")``: the window layout's pack (zero padding
at the far end of each axis to whole windows, the cyclic roll by −shift,
the partition into windows), the qkv Linear, the attention with the
relative-position bias (and, in a shifted block, the region mask), the
output projection, and the unpack (the reverse, the roll back, the crop).
The layout runs in the hand-written gathers of ``kernels.window_layout``
on CUDA tensors whatever ``impl`` says (their plain versions, PyTorch's
chain, on CPU tensors).  ``impl="kernel"`` runs the attention in the
hand-written kernels (``kernels.window_attention.WindowAttention``; on CPU
tensors their plain versions); ``impl="plain"`` in the forward kernel's
plain version (``window_attention_reference``: the scores materialised),
differentiated by autograd.  A padded token's q, k
and v are the qkv bias (``norm1``'s output is zero there): padded tokens
attend and are attended, as in MONAI.

``get_window_size`` is MONAI's rule: an axis no longer than the
configured window is one window of its own length and is not shifted.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from ..kernels.window_attention import (WindowAttention, WindowGeometry,
                                       window_attention_reference)
from ..kernels.window_layout import window_pack, window_unpack
from ..utils.profiling import span
from .layers import layernorm, linear

SPAN = "swin:window_attention"


def get_window_size(dims, window, shift) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """MONAI ``get_window_size``: (window, shift) for a (d, h, w) token grid."""
    use_window, use_shift = list(window), list(shift)
    for i, size in enumerate(dims):
        if size <= window[i]:
            use_window[i], use_shift[i] = size, 0
    return tuple(use_window), tuple(use_shift)


def geometry(dims, window, shifted: bool) -> WindowGeometry:
    """The windows of one block over a (d, h, w) token grid: the configured
    ``window``, shifted by half of it in every second block."""
    use_window, use_shift = get_window_size(dims, window, tuple(w // 2 for w in window))
    if not shifted:
        use_shift = (0, 0, 0)
    grid = tuple(-(-d // w) for d, w in zip(dims, use_window))
    return WindowGeometry(use_window, grid, use_shift, tuple(window))


def window_attention(x: torch.Tensor, qkv_weight: torch.Tensor, qkv_bias: torch.Tensor,
                     proj: torch.nn.Linear, table: torch.Tensor, heads: int,
                     geom: WindowGeometry,
                     compute_dtype: torch.dtype | None = None,
                     impl: str = "kernel") -> torch.Tensor:
    """The attention branch of one Swin block on its ``norm1`` output x
    (B, d, h, w, C), with the qkv Linear's weight (3C, C) and bias (3C);
    returns (B, d, h, w, C) in x's dtype."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown window-attention impl {impl!r}")
    with span(SPAN):
        C = x.shape[-1]
        t = linear(window_pack(x, geom), qkv_weight, qkv_bias, compute_dtype)
        t = t.view(t.shape[0], geom.n, 3, heads, C // heads)
        scale = (C // heads) ** -0.5
        if impl == "kernel":
            o = WindowAttention.apply(t, table.float(), geom, scale)
        else:
            o = window_attention_reference(t, table.float(), geom, scale)[0]
        o = linear(o, proj.weight, proj.bias, compute_dtype, out_dtype=x.dtype)
        return window_unpack(o, geom, x.shape[1:4])


def patch_merge(x: torch.Tensor, reduction: torch.nn.Linear, norm: torch.nn.LayerNorm,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """MONAI ``PatchMergingV2``: (B, d, h, w, C) → (B, ⌈d/2⌉, ⌈h/2⌉, ⌈w/2⌉,
    2C): an odd axis padded by one, the eight 2×2×2 neighbours concatenated
    in lexicographic order of their (d, h, w) offsets, LayerNorm(8C), then
    the bias-free Linear(8C → 2C)."""
    d, h, w = x.shape[1:4]
    if d % 2 or h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in itertools.product(range(2), repeat=3)],
                  -1)
    return linear(layernorm(x, norm.weight, norm.bias), reduction.weight, None, compute_dtype)
