"""Data parallelism, FSDP and the placement of a model over the mesh — port
of ``cross_attention_vit_tpu/parallel/sharding.py``.

Batches.  Each data coordinate loads its own rows of the global batch (its
``host_shard`` of the epoch's indices); the ranks of one data coordinate
(its 'expert', 'seq', 'model' and 'pipe' lines) load the same rows.  ``batch_sharding`` is a
descriptor the loader and the ``Trainer`` read, not a placement:
``Sharding(mesh, ("data", None, ...))``, with ``replicated(mesh)`` its
unsplit twin.

Parameters.  ``shard_params(model, mesh)`` composes the axes in JAX's
order of annotation: the MoE experts over 'expert'
(``parallel.moe.shard_experts``: JAX's ``experts/*`` rule, the router
replicated), the trunk's layers over 'pipe' (``parallel.pipeline``), the
head-aligned Megatron regions over 'model' (``parallel.tensor``, by
``tp_dim``: JAX's ``_spec_for`` on the port's names and layout), then the
data axis: a ``DistributedDataParallel`` over this rank's data line, whose
all-reduce averages the gradients across data coordinates (the DDP step
JAX's GSPMD derives from a batch-sharded input).  Gradients of what the
'expert', 'seq' and 'model' lines share are whole on each rank of a line
already (the layers that split the work sum them), so nothing reduces over
those axes.  A model over a 'pipe' axis, or one with BatchNorm layers,
stays unwrapped and ``sync_replicated_grads`` averages its gradients in one
all-reduce; its BatchNorm layers normalise over the data line's global
batch (JAX's SyncBatchNorm semantics, ``ops.conv.batch_norm3d``).

``shard_params(model, mesh, fsdp=True)`` ends instead with FSDP2's
``fully_shard`` over the data line, on every block and at the root, under
JAX's rule (``_with_fsdp``) read on the parameter's whole JAX layout
(``fsdp_dim``): before the other splits, on the stacked (depth, ...) leaf of
a trunk over 'pipe', and never on an axis JAX gives 'model', 'expert' or
'pipe', so FSDP shards the same axis whatever the other axes' sizes, and
that axis is never one a TP slice or an expert split cut.  A parameter
without such an axis stays replicated (FSDP2's ``ignored_params``, its
gradient averaged by ``sync_replicated_grads``).  Params, gradients and Adam
moments of the sharded set then live 1/W on each rank of the data line,
gathered a block at a time for the forward and backward (inside which the
'model' regions' all-reduces run) and reduce-scattered after it.

Which axes of the JAX layout the rule may take depends on JAX's TP table
(``_spec_for``): the axes it gives the 'model' mesh axis are not free even
when that axis has size 1.  ``_role`` names each parameter's part in that
table; ``_jax_axes`` (FSDP) and ``tp_dim`` (TP) read it.  At a world of
one JAX shards nothing (its rule returns early for ``data_size <= 1``); the
port applies the rule all the same, so a world of one runs FSDP2's gathers
and the sharded Adam on shards that are whole tensors.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import FSDPModule, fully_shard
from torch.distributed.tensor import DTensor, Shard
from torch.nn.parallel import DistributedDataParallel

from .mesh import axis_group, axis_index, axis_mesh, axis_size
from .moe import gather_experts, local_experts, moe_sites, shard_experts
from .pipeline import gather_stages, local_stages, shard_stages
from .tensor import gather_tp, local_tp, shard_tensor_parallel

# Parameters smaller than this stay replicated under FSDP: gathering a few KB
# per layer costs more in latency than the memory it saves.
FSDP_MIN_SIZE = 2 ** 15


@dataclass(frozen=True)
class Sharding:
    """Which axes of an array are split over which mesh axis: ``spec[i]`` is
    "data" or None (the JAX ``NamedSharding(mesh, P(*spec))``)."""
    mesh: DeviceMesh
    spec: tuple = ()

    def batch_divisor(self) -> int:
        """The number of data shards this process feeds, which its batches
        must divide: the data size over the world size, 1 with one device a
        process (JAX ``PrefetchLoader._batch_divisor``)."""
        if not self.spec or self.spec[0] != "data":
            return 1
        return max(1, axis_size(self.mesh, "data") // dist.get_world_size())


def batch_sharding(mesh: DeviceMesh, ndim: int) -> Sharding:
    """The leading (batch) axis split over "data", the rest whole."""
    return Sharding(mesh, ("data",) + (None,) * (ndim - 1))


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh)


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's data coordinate's contiguous rows of each array of a
    global batch (a tuple of arrays or tensors whose leading size the data
    size divides)."""
    n, r = axis_size(mesh, "data"), axis_index(mesh, "data")

    def rows(x):
        if len(x) % n:
            raise ValueError(f"batch of {len(x)} does not divide over {n} data shards")
        share = len(x) // n
        return x[r * share:(r + 1) * share]

    return tuple(rows(x) for x in batch)


# -- the FSDP rule ----------------------------------------------------------------

def _fc_role(parts: list[str]) -> str | None:
    """'fc1' or 'fc2' for the two Linears of a feed-forward or head (the JAX
    tree's names), None otherwise."""
    if len(parts) >= 3 and parts[-3] == "net":                       # *.ffn.fn.net.{0,3}
        return {"0": "fc1", "3": "fc2"}.get(parts[-2])
    if parts[0] == "mlp_head" and len(parts) == 4:                   # ModelCross heads
        return {"0": "fc1", "3": "fc2"}.get(parts[2])
    if parts[0] == "mlp_head" and len(parts) == 3:                   # ModelVIT head
        return {"1": "fc1", "4": "fc2"}.get(parts[1])
    return None


def _is_expert_stack(name: str) -> bool:
    """A MoE site's stacked expert weight or bias (leading E axis)."""
    parts = name.split(".")
    return len(parts) >= 3 and parts[-3] == "experts" and parts[-2] in ("fc1", "fc2")


def _role(name: str) -> str | None:
    """The part a parameter plays in JAX's TP table (``_spec_for``), by its
    port name: 'experts' (a stacked expert weight or bias), 'qkv' (the fused
    projection), 'heads_in' (wq/wk/wv weight or bias), 'heads_out' (the
    to_out / proj weight), 'fc1' or 'fc2' (weight or bias); None for the
    rest, which JAX leaves replicated."""
    parts = name.split(".")
    if len(parts) < 3:                        # pos_embedding, cls_token, patch_to_embedding
        return None
    leaf, mod = parts[-1], parts[-2]
    if _is_expert_stack(name):
        return "experts"
    if mod == "to_qkv":
        return "qkv"
    if mod in ("wq", "wk", "wv"):
        return "heads_in"
    if leaf == "weight" and (mod == "proj" or parts[-3] == "to_out"):
        return "heads_out"
    return _fc_role(parts)


def _jax_axes(name: str, shape: tuple[int, ...], heads: int) -> list[tuple[int, int, bool]]:
    """The axes of the parameter's JAX layout, in JAX's order, from the
    port's whole (unsplit) shape: (size, the port dim that holds the axis,
    taken), taken where ``_spec_for`` gives the axis 'model' or 'expert'
    (whatever those axes' sizes).  A JAX axis that is part of a port dim
    (the fused qkv's 3 and D, a head's D) names the port dim it is part of."""
    role, weight = _role(name), name.endswith(".weight")
    if role == "experts":                     # (E, a, b) ↔ (E, b, a); bias (E, m)
        if weight:
            return [(shape[0], 0, True), (shape[2], 2, False), (shape[1], 1, False)]
        return [(shape[0], 0, True), (shape[1], 1, False)]
    if role == "qkv":                         # (3H, H) ↔ (H, 3, K, D)
        return [(shape[1], 1, False), (3, 0, False), (heads, 0, True),
                (shape[1] // heads, 0, False)]
    if role == "heads_in":                    # (H, H) ↔ (H, K, D); bias (H,) ↔ (K, D)
        head = [(heads, 0, True), (shape[0] // heads, 0, False)]
        return [(shape[1], 1, False)] + head if weight else head
    if role == "heads_out":                   # (H, H) ↔ (K, D, H)
        return [(heads, 1, True), (shape[1] // heads, 1, False), (shape[0], 0, False)]
    if role == "fc1":                         # (mlp, H) ↔ (H, mlp); bias (mlp,)
        return [(shape[1], 1, False), (shape[0], 0, True)] if weight else [(shape[0], 0, True)]
    if role == "fc2":                         # (out, mlp) ↔ (mlp, out); bias (out,)
        return [(shape[1], 1, True), (shape[0], 0, False)] if weight else [(shape[0], 0, False)]
    if weight and len(shape) == 2:            # a Linear's (out, in) ↔ kernel (in, out)
        return [(shape[1], 1, False), (shape[0], 0, False)]
    return [(d, i, False) for i, d in enumerate(shape)]


def tp_dim(name: str, shape: tuple[int, ...]) -> tuple[int, int] | None:
    """How tensor parallelism splits the port's parameter ``name``: (dim,
    groups), the dim of its (out, in) layout split over 'model' and the
    number of equal blocks of that dim each split alike (3 for the fused
    qkv's (3, K, D) rows, 1 for a contiguous split); None to keep it whole.
    The split axis is the one JAX's ``_spec_for`` gives 'model'."""
    role, weight = _role(name), name.endswith(".weight")
    if role == "qkv":
        return (0, 3)
    if role in ("heads_in", "fc1"):           # the output rows (with their bias)
        return (0, 1)
    if role == "heads_out" or (role == "fc2" and weight):
        return (1, 1)                         # the contracted input columns
    return None


def fsdp_dim(name: str, shape: tuple[int, ...], heads: int, data_size: int,
             depth: int = 1) -> int | None:
    """The dim of the port's parameter ``name`` (``shape`` its whole shape,
    before any split over 'model', 'expert' or 'pipe') that FSDP shards over
    a data axis of ``data_size``, or None to keep it replicated: JAX's
    ``_with_fsdp`` on the parameter's JAX layout — at least
    ``FSDP_MIN_SIZE`` elements, then the largest free axis that the data
    size divides (the first of equals, in JAX's axis order), mapped to the
    port dim holding it.  ``depth`` > 1: the parameter is one layer of a
    trunk JAX stacks on a leading depth axis (a 'pipe' axis): the min-size
    test reads the stacked leaf, and the depth axis is 'pipe''s."""
    if depth * math.prod(shape) < FSDP_MIN_SIZE:
        return None
    best = None
    for size, dim, taken in _jax_axes(name, shape, heads):
        if not taken and size > 1 and size % data_size == 0:
            if best is None or size > best[0]:
                best = (size, dim)
    return None if best is None else best[1]


# -- placing the model --------------------------------------------------------------

def _refuse_combinations(mesh: DeviceMesh) -> None:
    """Raise for the one mesh the port does not compose because the JAX
    package does not run it either: a 'pipe' axis with a 'seq' axis.  (A
    pipelined model with MoE experts is refused where JAX refuses it, when
    the model is built.)"""
    if axis_size(mesh, "pipe") > 1 and axis_size(mesh, "seq") > 1:
        raise NotImplementedError(
            f"pipeline parallelism (a 'pipe' axis of {axis_size(mesh, 'pipe')}) together with "
            f"a 'seq' axis of {axis_size(mesh, 'seq')}: the JAX package does not run it either "
            "(its ring's shard_map nested inside the pipeline's raises ValueError: the context "
            "mesh should match the mesh passed to shard_map) (ROADMAP Queue 1, item 13)")


def _fsdp_dims(model: nn.Module, mesh: DeviceMesh) -> dict[str, int | None]:
    """``fsdp_dim`` of every parameter by name, on the whole model (before
    the splits): a trunk layer of a model over a 'pipe' axis is read as
    JAX's stacked leaf."""
    n, heads = axis_size(mesh, "data"), model.config.num_heads
    trunk = getattr(model, "PIPELINE_TRUNK", None)
    depth = len(model.get_submodule(trunk)) if trunk and axis_size(mesh, "pipe") > 1 else 1
    return {name: fsdp_dim(name, tuple(p.shape), heads, n,
                           depth if trunk and name.startswith(trunk + ".") else 1)
            for name, p in model.named_parameters()}


def _batch_norms(model: nn.Module) -> list[nn.Module]:
    return [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]


def _averaged_by_hand(model: nn.Module, mesh: DeviceMesh) -> bool:
    """A model ``shard_params`` leaves unwrapped: one over a 'pipe' axis
    (its layers' gradients accumulate inside the pipeline's backward, which
    DDP's hooks do not allow) or one with BatchNorm layers (their train
    forward reads the data group, and a truncated stem leaves parameters
    unreached); ``sync_replicated_grads`` averages their gradients."""
    return axis_size(mesh, "pipe") > 1 or bool(_batch_norms(model))


def shard_params(model: nn.Module, mesh: DeviceMesh, fsdp: bool = False) -> nn.Module:
    """The model over ``mesh``: its experts split over the 'expert' axis,
    its trunk's layers over 'pipe' (``parallel.pipeline.shard_stages``), its
    regions over 'model' (``parallel.tensor.shard_tensor_parallel``), then
    either (``fsdp``) its blocks and root under ``fully_shard`` over this
    rank's line of the data axis by JAX's rule, read on the whole JAX layout
    (``fsdp_dim``), or a ``DistributedDataParallel`` around it over that
    line.  A model over a 'pipe' axis, or with BatchNorm layers, stays
    unwrapped (``_averaged_by_hand``); its BatchNorm layers normalise over
    the data line's global batch (``ops.conv.batch_norm3d``).  Build the
    optimizer afterwards: all of them replace parameters.  A 'pipe' axis
    with a 'seq' axis raises (``_refuse_combinations``)."""
    _refuse_combinations(mesh)
    dims = _fsdp_dims(model, mesh) if fsdp else {}
    shard_experts(model, mesh)
    shard_stages(model, mesh)
    shard_tensor_parallel(model, mesh)
    data = axis_mesh(mesh, "data")
    if data.size() > 1:
        for norm in _batch_norms(model):
            norm.sync_group = data.get_group()
    if not fsdp:
        if _averaged_by_hand(model, mesh):
            return model
        return DistributedDataParallel(model, process_group=data.get_group())
    device_type = next(model.parameters()).device.type
    if device_type != mesh.device_type:
        raise ValueError(f"FSDP over a {mesh.device_type!r} mesh cannot shard a model on "
                         f"{device_type!r}: build the mesh with devices={device_type!r}")
    params = dict(model.named_parameters())
    placement = {p: dims[name] for name, p in params.items()}
    ignored = {p for p, d in placement.items() if d is None}
    kw = dict(mesh=data, shard_placement_fn=lambda p: Shard(placement[p]),
              ignored_params=ignored)
    # modules FSDP gathers one at a time: each is called as a module
    for block in (model.blocks() if hasattr(model, "blocks") else ()):
        fully_shard(block, **kw)
    fully_shard(model, **kw)
    return model


def whole_tensors(model: nn.Module, tensors: dict) -> dict:
    """``tensors`` (by parameter name, this rank's parts) made whole: split
    experts, TP slices and the other stages' layers gathered (a collective:
    every rank calls it, in the same order), FSDP shards (DTensors) first,
    through ``full_tensor``."""
    model = unwrap(model)
    tensors = {name: full_tensor(t) for name, t in tensors.items()}
    return gather_stages(model, gather_tp(model, gather_experts(model, tensors)))


def local_tensors(model: nn.Module, tensors: dict) -> dict:
    """The inverse of ``whole_tensors``: whole tensors cut to this rank's
    parts."""
    model = unwrap(model)
    return local_experts(model, local_tp(model, local_stages(model, tensors)))


def unwrap(model: nn.Module) -> nn.Module:
    """The model inside a ``DistributedDataParallel`` (its parameter names
    are the model's); any other model as it is."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of a sharded tensor (a collective: every rank calls it in
    the same order), or the tensor itself."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def no_sync(model: nn.Module, skip: bool):
    """A context in which backward accumulates gradients without reducing
    them across ranks (``skip``; the microbatches before the last)."""
    if skip and isinstance(model, DistributedDataParallel):
        return model.no_sync()
    if isinstance(model, FSDPModule):
        model.set_requires_gradient_sync(not skip)
    return contextlib.nullcontext()


@torch.no_grad()
def sync_replicated_grads(model: nn.Module, mesh: DeviceMesh) -> None:
    """Average across data coordinates, in one all-reduce, the gradients no
    wrapper reduces: an FSDP model's replicated parameters' (FSDP reduces
    only those it shards) and every gradient of a model ``shard_params``
    left unwrapped (``_averaged_by_hand``)."""
    if isinstance(model, FSDPModule):
        grads = [p.grad for p in model.parameters()
                 if not isinstance(p, DTensor) and p.grad is not None]
    elif isinstance(model, DistributedDataParallel) or not _averaged_by_hand(model, mesh):
        return
    else:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads or axis_size(mesh, "data") <= 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat.div_(axis_size(mesh, "data"))
    dist.all_reduce(flat, group=axis_group(mesh, "data"))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def gather_rows(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every data coordinate's ``t`` (one shape on all ranks) stacked along
    dim 0 in data order, on every rank: an all-reduce over the data axis of
    a zero buffer in which each rank fills its own slice (gloo has no
    all-gather of CUDA tensors)."""
    n, r, rows = axis_size(mesh, "data"), axis_index(mesh, "data"), t.shape[0]
    out = t.new_zeros((n * rows, *t.shape[1:]))
    out[r * rows:(r + 1) * rows] = t
    dist.all_reduce(out, group=axis_group(mesh, "data"))
    return out
