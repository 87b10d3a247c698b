"""Attention ops: multi-head self-attention and CLS-query cross-attention.

Port of ``cross_attention_vit_tpu/ops/attention.py``.  Reference semantics
(model_cross.py:33-102):
  * Self-attention: one fused **bias-free** QKV projection Linear(H → 3H)
    chunked into thirds, heads split as 'b n (h d) -> b h n d', scale
    head_dim**-0.5, softmax, AV, output projection + dropout.  No dropout on
    the attention probabilities.
  * Cross-attention: separate **biased** wq/wk/wv; queries come from the CLS
    token only (x[:, 0:1]), so attn is (B, K, 1, N); dropout on both the
    attention probabilities and the projected output.

``impl="flash"`` runs the hand-written kernels (K1 forward, K2 backward)
through ``kernels.flash_attention.fused_qkv_attention``; ``impl="xla"`` (the
JAX name for the plain path) runs ``_sdpa`` in plain PyTorch and
differentiates through autograd.  ``impl="ring"`` (``config.seq_parallel``
> 1) runs the plain projection and ``parallel.ring.sharded_ring_sdpa``, the
sequence split over the ambient 'seq' mesh axis (``_sdpa`` itself without
one); it overrides ``use_flash_attention``, as in the JAX package.  With the
projections in int8 form (serving ``int8+attn``), ``impl="flash"`` runs the
public ``flash_attention`` (K5, or K7 above N = 1040) between the int8 GEMMs.

``tp`` (``parallel/tensor.py``): the projections hold this rank's K/T heads
(the output projection its K/T heads' input columns); the input passes
Megatron's f, the attention runs on the local heads, the output
projection's f32 partial products are summed over the 'model' group (g)
before its bias, and the cross-attention's probability dropout keeps this
rank's heads of the whole-width mask.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention, fused_qkv_attention
from ..parallel.ring import sharded_ring_sdpa
from ..parallel.tensor import TP, copy_to, local_heads
from .layers import dropout, linear
from .quant import QuantLinear, attn_out_projection, qkv_projection


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
          attn_dropout: float = 0.0, generator: torch.Generator | None = None,
          train: bool = False, tp: TP | None = None) -> torch.Tensor:
    """Scaled-dot-product attention on (B, K, N, D) operands.

    Softmax in float32 from the operand dtype; both products take the
    already-rounded operands upcast to f32 (the JAX preferred_element_type=f32
    up to summation order); probabilities are normalised, dropped out in
    train mode, then cast to v's dtype — unlike the flash kernel, which
    normalises after AV.  ``tp``: the heads are this rank's K/T, and the
    dropout mask is the whole one's slice."""
    dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(dots, dim=-1)
    attn = dropout(attn, attn_dropout, generator, train, split=(1, tp)).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(v.dtype)


def attention_impl(config) -> str:
    """SDPA implementation a config selects: 'ring' (sequence parallelism,
    ``config.seq_parallel`` > 1, whatever ``use_flash_attention`` says: the
    kernels attend on one device), else 'flash' (the CUDA kernels) or 'xla'
    (plain PyTorch)."""
    if config.get("seq_parallel", 0) > 1:
        return "ring"
    return "flash" if config.use_flash_attention else "xla"


def self_attention(x: torch.Tensor, to_qkv: nn.Linear, to_out: nn.Linear | None,
                   num_heads: int, compute_dtype: torch.dtype | None = None,
                   impl: str = "xla", rate: float = 0.0,
                   generator: torch.Generator | None = None,
                   train: bool = False, tp: TP | None = None) -> torch.Tensor:
    """Fused-QKV multi-head self-attention (reference model_cross.py:33-61).

    to_qkv.weight is the reference (3H, H) weight; to_out is ``to_out.0``.
    heads==1 quirk: the reference builds ``to_out = nn.Identity()`` when
    num_heads == 1 (model_cross.py:37,45-48) — no output projection and no
    output dropout; the model passes ``to_out=None`` then.

    A ``to_qkv`` in int8 form (``models/quantize`` with attn=True) takes the
    w8a8 branch of JAX ``:82-112``: the int8 QKV projection, then the public
    ``flash_attention`` (K5 at N ≤ 1040, K7 above) or ``_sdpa``, then the
    output projection, int8 or float (int8 layers are never split)."""
    in_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    x = copy_to(x, tp)
    B, N, H = x.shape
    K = local_heads(num_heads, tp)
    D = to_qkv.out_features // (3 * K)
    if isinstance(to_qkv, QuantLinear):
        return _self_attention_int8(x, to_qkv, to_out, K, D, in_dtype, impl, rate, generator,
                                    train)
    w = to_qkv.weight.to(x.dtype)
    if impl == "flash":
        # (H, 3, K, D) is the JAX kernel layout: a view of the (3H, H) weight
        out = fused_qkv_attention(x, w.t().reshape(H, 3, K, D))    # (B, K, D, N)
        # back to the kernel's own (B, N, K, D) memory order: a view, no copy
        out = out.permute(0, 3, 1, 2)
    elif impl in ("xla", "ring"):
        qkv = torch.matmul(x, w.t()).view(B, N, 3, K, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, K, N, D)
        sdpa = sharded_ring_sdpa if impl == "ring" else _sdpa
        out = sdpa(q, k, v, D ** -0.5).transpose(1, 2)               # (B, N, K, D)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    out = out.reshape(B, N, K * D)
    if to_out is None:
        return out.to(in_dtype)
    y = linear(out, to_out.weight, to_out.bias, out_dtype=in_dtype, tp=tp)
    return dropout(y, rate, generator, train)


def _self_attention_int8(x: torch.Tensor, to_qkv: QuantLinear, to_out: nn.Module | None,
                         K: int, D: int, in_dtype: torch.dtype, impl: str, rate: float,
                         generator: torch.Generator | None, train: bool) -> torch.Tensor:
    """The int8 QKV projection to (B, N, 3, K, D) in x's dtype, whose q, k, v
    the attention reads as strided (B, K, N, D) views (no copies); the
    attention in float; the output projection in int8 (f32 result) or float,
    then the f32 bias, the cast and dropout."""
    B, N, _ = x.shape
    qkv = qkv_projection(x, to_qkv).view(B, N, 3, K, D)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if impl == "flash":
        out = flash_attention(q, k, v, D ** -0.5)
    elif impl in ("xla", "ring"):     # the JAX int8 branch runs _sdpa for 'ring' too
        out = _sdpa(q, k, v, D ** -0.5)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    out = out.transpose(1, 2).reshape(B, N, K * D)
    if to_out is None:                     # heads==1: no projection, no dropout
        return out.to(in_dtype)
    if isinstance(to_out, QuantLinear):
        y = (attn_out_projection(out, to_out) + to_out.bias.float()).to(in_dtype)
    else:
        y = linear(out, to_out.weight, to_out.bias, out_dtype=in_dtype)
    return dropout(y, rate, generator, train)


def _head_in(lin: nn.Linear, x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, n, H) → (B, K, n, D) with per-head bias, in x's dtype."""
    B, n, _ = x.shape
    return linear(x, lin.weight, lin.bias).view(B, n, heads, -1).transpose(1, 2)


def cross_attention_cls(x: torch.Tensor, wq: nn.Linear, wk: nn.Linear, wv: nn.Linear,
                        proj: nn.Linear, num_heads: int,
                        compute_dtype: torch.dtype | None = None, rate: float = 0.0,
                        generator: torch.Generator | None = None,
                        train: bool = False, tp: TP | None = None) -> torch.Tensor:
    """CLS-query cross-attention (reference model_cross.py:74-102).

    x is (B, N, H) = [fused-CLS ; other-stream tokens]; only x[:, 0:1] forms
    queries, so the output is one fused CLS token (B, 1, H).  Plain PyTorch:
    it was plain XLA in the JAX package."""
    in_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    x = copy_to(x, tp)
    B = x.shape[0]
    heads = local_heads(num_heads, tp)
    q = _head_in(wq, x[:, 0:1], heads)          # (B, K, 1, D)
    k = _head_in(wk, x, heads)                  # (B, K, N, D)
    v = _head_in(wv, x, heads)
    out = _sdpa(q, k, v, q.shape[-1] ** -0.5, rate, generator, train, tp)
    y = linear(out.transpose(1, 2).reshape(B, 1, -1), proj.weight, proj.bias,
               out_dtype=in_dtype, tp=tp)
    return dropout(y, rate, generator, train)
