"""Tensor parallelism: the head-aligned Megatron split over a 'model' mesh
axis — port of the TP rules of ``cross_attention_vit_tpu/parallel/sharding.py``
(``_spec_for``).

JAX shards its parameters by their layout, the port splits its own, in
torch's (out, in) layout (``parallel.sharding.tp_dim`` is the rule):

  port parameter                  JAX leaf and spec              split
  ---------------------------------------------------------------------------
  to_qkv.weight (3H, H),          qkv (H, 3, K, D), K on 'model'  rows, by head
    ViT3D's in_proj_weight                                        inside (3, K, D)
  ViT3D's in_proj_bias (3H,)      qkv bias (3, K, D), replicated  whole; the forward
                                                                  takes its heads'
  wq/wk/wv.weight (H, H), bias    (H, K, D) / (K, D), K           rows, by head
  to_out.0.weight, proj.weight,   out / proj (K, D, H), K         columns, by head
    ViT3D's out_proj.weight
  fc1.weight (mlp, H), bias,      fc1 (H, mlp) / (mlp,), mlp      rows
    ViT3D's linear1, mlp_head.1
  fc2.weight (out, mlp),          fc2 (mlp, out), mlp             columns
    ViT3D's linear2, mlp_head.2
  everything else                 replicated                      whole

At T model ranks, rank t keeps of ``to_qkv.weight`` the rows
[c·H + t·H/T, c·H + (t+1)·H/T) for c = q, k, v, so its (3H/T, H) weight is
still the (H, 3, K/T, D) kernel of K1 (a contiguous split would give rank 0
all of q and half of k).  Biases of the row-split layers stay whole.

A region is one column-split entry and one row-split exit: the
self-attention (``to_qkv`` → ``to_out.0``; ViT3D's ``in_proj`` →
``out_proj``), the cross-attention (``wq``, ``wk``, ``wv`` → ``proj``),
each feed-forward and each head (fc1 → fc2).
Megatron's pair bounds it: f (``copy_to``: identity forward, all-reduce
backward) on its input and g (``reduce_from``: all-reduce forward,
identity backward) on the f32 partial product of its exit, before the bias
is added once and the result is cast once (``ops.layers.linear``).  The
attention runs on the rank's own K/T heads; ViT3D's whole qkv bias passes
f before its heads' slice is taken, so its gradient is summed whole over
the line.  The DenseNet-stem ViT3D and CNNViT are refused, as JAX refuses
them (``sharding.jax_refuses_tp``).  A region with a layer in int8
form (a ``quantize_for_inference`` model) stays whole on every rank, as
JAX's rules, which match only float ``kernel`` leaves, leave its int8
leaves whole.

``shard_tensor_parallel(model, mesh)`` replaces each split parameter by its
slice and gives each region its ``TP`` (the 'model' group, this rank's
coordinate, the size); ``gather_tp`` and ``local_tp`` turn whole tensors
(checkpoints, Adam moments) into slices and back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from ..ops.quant import QuantLinear
from .mesh import axis_group, axis_index, axis_size


class TP(NamedTuple):
    """The 'model' line of a split region: its group, this rank's
    coordinate on it and its size."""
    group: object
    rank: int
    size: int


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (Megatron's f),
    in f32 for a low-precision gradient, rounded once."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        total = grad.float().contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """f on the input of a column-split region (x itself without one)."""
    return x if tp is None else _CopyToGroup.apply(x, tp.group)


def reduce_from(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """g on the partial product of a row-split exit (x itself without one)."""
    return x if tp is None else _ReduceFromGroup.apply(x, tp.group)


def local_heads(num_heads: int, tp: TP | None) -> int:
    """The heads of this rank's split: K/T, or K without one."""
    return num_heads if tp is None else num_heads // tp.size


# -- the split of one tensor ---------------------------------------------------------

def split_slice(t: torch.Tensor, dim: int, groups: int, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s part of ``t`` split ``size`` ways on ``dim``, where
    ``dim`` holds ``groups`` equal blocks each split alike (3 for the fused
    qkv rows, 1 for a contiguous split)."""
    dim %= t.dim()
    view = t.unflatten(dim, (groups, t.shape[dim] // groups))
    return view.chunk(size, dim + 1)[rank].flatten(dim, dim + 1)


def split_place(part: torch.Tensor, dim: int, groups: int, rank: int,
                size: int) -> torch.Tensor:
    """A zero tensor of the whole shape holding ``part`` where
    ``split_slice`` took it from: the summand of a gather by all-reduce
    (gloo has no all-gather of CUDA tensors)."""
    dim %= part.dim()
    shape = list(part.shape)
    shape[dim] *= size
    whole = part.new_zeros(shape)
    view = whole.unflatten(dim, (groups, shape[dim] // groups))
    view.chunk(size, dim + 1)[rank].copy_(part.unflatten(dim, (groups, -1)))
    return whole


# -- placing a model -------------------------------------------------------------------

def _is_float_region(region: nn.Module) -> bool:
    return not any(isinstance(m, QuantLinear) for m in region.modules())


@torch.no_grad()
def shard_tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Split ``model``'s float regions over the mesh's 'model' axis (size
    T): each split parameter becomes this rank's slice (a new parameter,
    build the optimizer afterwards) and each split region gets its ``TP``.
    Raises ValueError when T does not divide the heads or a split width
    (the config's ``mlp_dim``, or the model's ``tp_widths()``), and for a
    model JAX does not place over a 'model' axis (``jax_refuses_tp``).
    Does nothing without a 'model' axis, or twice."""
    from .sharding import jax_refuses_tp, tp_dim

    size = axis_size(mesh, "model")
    if size <= 1 or getattr(model, "tp_layout", None) is not None:
        return model
    for name, p in model.named_parameters():
        if jax_refuses_tp(name, tuple(p.shape)):
            raise ValueError(
                f"{type(model).__name__} over a 'model' axis of {size}: its 2-D parameter "
                f"{name} is a kernel JAX names 'out', to which JAX's rule gives the "
                "(K, D, H) row split P('model', None, None); JAX's shard_params refuses that "
                "spec on a rank-2 leaf, so the JAX package does not place this model either")
    cfg = model.config
    widths = (model.tp_widths() if hasattr(model, "tp_widths")
              else (("num_heads", cfg.num_heads), ("mlp_dim", cfg.mlp_dim)))
    for what, n in widths:
        if n % size:
            raise ValueError(f"the 'model' axis of {size} does not divide {what}={n}: tensor "
                             "parallelism splits whole heads and whole MLP columns")
    tp = TP(axis_group(mesh, "model"), axis_index(mesh, "model"), size)
    layout = {}
    for prefix, region in model.tp_regions():
        if not _is_float_region(region):
            continue                          # int8 layers stay whole
        for local, p in list(region.named_parameters()):
            name = f"{prefix}.{local}"
            split = tp_dim(name, tuple(p.shape))
            if split is None:
                continue
            owner_name, _, leaf = local.rpartition(".")
            owner = region.get_submodule(owner_name)
            setattr(owner, leaf, nn.Parameter(split_slice(p, *split, tp.rank, size).clone(),
                                              requires_grad=p.requires_grad))
            if leaf == "weight":            # the Linear's sizes are its slice's
                owner.out_features, owner.in_features = owner.weight.shape
            layout[name] = split
        region.tp = tp
    model.tp_layout = {name: (*split, tp) for name, split in layout.items()}
    return model


def gather_tp(model: nn.Module, tensors: dict) -> dict:
    """``tensors`` (by parameter name) with every split tensor replaced by
    the whole one, summed over its 'model' line (a collective: every rank of
    the line calls it, in the same order)."""
    out = dict(tensors)
    for name, (dim, groups, tp) in (getattr(model, "tp_layout", None) or {}).items():
        if name in out:
            whole = split_place(out[name].detach(), dim, groups, tp.rank, tp.size)
            dist.all_reduce(whole, group=tp.group)
            out[name] = whole
    return out


def local_tp(model: nn.Module, tensors: dict) -> dict:
    """``tensors`` (whole, by parameter name) with every split tensor cut to
    this rank's slice."""
    out = dict(tensors)
    for name, (dim, groups, tp) in (getattr(model, "tp_layout", None) or {}).items():
        if name in out:
            out[name] = split_slice(torch.as_tensor(out[name]), dim, groups, tp.rank, tp.size)
    return out
