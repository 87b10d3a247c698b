"""Pipeline parallelism (GPipe) over a 'pipe' mesh axis — port of
``cross_attention_vit_tpu/parallel/pipeline.py``.

JAX runs one SPMD program: the trunk's layers stacked on a depth axis
sharded over 'pipe', a scan over MB + S − 1 ticks, ``ppermute`` between
stages and a final ``psum`` that replicates the last stage's outputs.  The
port keeps one process per device: stage s of S holds the layers
[s·L, (s+1)·L) of the trunk (``shard_stages``; the others are dropped from
its device), runs its microbatches in order, hands each one to stage s + 1
point to point, and the last stage's outputs are broadcast to every rank of
the pipe line, so the head and the loss run on every rank, as after JAX's
``psum``.

Microbatches use JAX's strided grouping: microbatch i holds the rows
{b : b % MB == i}.  Dropout is defined per (layer, microbatch), as in JAX:
the forward draws one seed per layer from its generator and each (layer,
microbatch) pair draws from a generator seeded by both, so the serial
schedule (no 'pipe' axis, or one of size 1; ``pipeline_stages > 1`` changes
the schedule even without a mesh) and the pipe schedule draw the same
masks.

The backward.  One ``loss.backward()`` over a graph with MB send/recv pairs
would run them in an order each rank picks for itself, which can deadlock
or pair the wrong cotangents.  So the stage's work is one autograd Function
(``_GPipe``): its forward builds each microbatch's graph on this stage
alone (the received activation a leaf), its backward runs the microbatches
in a fixed order, 0 to MB − 1: the last stage backward on its share of the
output's cotangent, the others on the cotangent received from the next
stage, each sending its input's cotangent one stage back.  Stage 0's input
cotangent is broadcast over the line, so the embedding's gradients are the
same on every stage, as the head's are.  The layers' gradients accumulate
once per microbatch, inside that backward, which DDP's hooks do not allow:
a pipelined model is not wrapped in DDP and its gradients are averaged over
'data' after the backward (``sharding.sync_replicated_grads``).

Transport, by the group's backend: device to device under NCCL; through
host memory under gloo, which cannot send CUDA tensors point to point (the
CPU tests' backend, and two ranks sharing one card).  A failed send raises.

``stack_layers`` / ``unstack_layers`` convert the port's per-layer
checkpoint trees to JAX's stacked layout and back (``models/convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .mesh import axis_group, axis_index, axis_ranks, axis_size

# The ambient pipeline mesh: models read it instead of threading a mesh
# through every forward (``Trainer`` sets it).  None: the serial schedule.
_ACTIVE_MESH = None


def set_pipeline_mesh(mesh) -> None:
    """Set (or clear, with None) the mesh ``pipeline_layers`` uses."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_pipeline_mesh():
    return _ACTIVE_MESH


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """GPipe idle fraction: (S − 1)/(MB + S − 1)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


# -- checkpoint interop ------------------------------------------------------------

def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_layers(layers: list) -> dict:
    """Per-layer param trees of one structure → one tree whose leaves carry
    a leading depth axis (JAX's PP layout)."""
    return _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *layers)


def unstack_layers(stacked: dict) -> list:
    """The inverse of ``stack_layers``."""
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    depth = len(leaf)
    return [_tree_map(lambda a, i=i: np.asarray(a)[i], stacked) for i in range(depth)]


# -- microbatches ------------------------------------------------------------------

def _microbatch(x: torch.Tensor, num_microbatches: int) -> list[torch.Tensor]:
    """(B, ...) → MB tensors (B/MB, ...), microbatch i the rows b % MB == i."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} (this data shard's) not divisible by num_microbatches="
                         f"{num_microbatches}: the strided microbatch layout needs every data "
                         "shard to contribute equally to every microbatch (raise the batch or "
                         "lower pipeline_microbatches)")
    return list(x.view(b // num_microbatches, num_microbatches, *x.shape[1:]).unbind(1))


def _unmicrobatch(parts: list[torch.Tensor]) -> torch.Tensor:
    """The inverse of ``_microbatch``: row b from microbatch b % MB."""
    return torch.stack(parts, dim=1).flatten(0, 1)


def layer_generator(seeds: list[int] | None, layer: int, microbatch: int,
                    device: torch.device) -> torch.Generator | None:
    """The dropout generator of one (layer, microbatch) pair (None without
    seeds: eval, or no generator)."""
    if seeds is None:
        return None
    state = np.random.SeedSequence((seeds[layer], microbatch)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2 ** 63 - 1))


# -- stages --------------------------------------------------------------------------

@dataclass
class Stage:
    """This rank's stage of a model split over 'pipe'."""
    index: int                  # s
    size: int                   # S
    depth: int                  # layers in the whole trunk
    ranks: list                 # the global ranks of this rank's pipe line, by stage
    group: object               # that line's group
    names: dict                 # layer → [(parameter name, shape, dtype)]

    @property
    def per_stage(self) -> int:
        return self.depth // self.size

    def owner(self, layer: int) -> int:
        return layer // self.per_stage

    def local(self) -> range:
        return range(self.index * self.per_stage, (self.index + 1) * self.per_stage)


@torch.no_grad()
def shard_stages(model: nn.Module, mesh) -> nn.Module:
    """Keep, of ``model``'s trunk (``model.PIPELINE_TRUNK``, a ModuleList),
    the layers of this rank's stage on the mesh's 'pipe' axis; the others
    become empty placeholders.  Does nothing without a 'pipe' axis."""
    size = axis_size(mesh, "pipe")
    if size <= 1 or getattr(model, "stage", None) is not None:
        return model
    prefix = getattr(model, "PIPELINE_TRUNK", None)
    if prefix is None or int(model.config.get("pipeline_stages", 0)) <= 1:
        raise ValueError(f"a 'pipe' axis of {size} needs a model with a pipelined trunk: "
                         "ModelVIT with config.pipeline_stages > 1")
    layers = model.get_submodule(prefix)
    depth = len(layers)
    if depth % size:
        raise ValueError(f"depth {depth} not divisible by pipe={size} stages")
    names = {i: [(f"{prefix}.{i}.{n}", tuple(p.shape), p.dtype)
                 for n, p in layers[i].named_parameters()] for i in range(depth)}
    stage = Stage(axis_index(mesh, "pipe"), size, depth, axis_ranks(mesh, "pipe"),
                  axis_group(mesh, "pipe"), names)
    for i in range(depth):
        if i not in stage.local():
            layers[i] = nn.ModuleDict()
    model.stage = stage
    return model


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's backend can move it: host memory for a CUDA
    tensor under gloo, else itself."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t.contiguous()


def _send(t: torch.Tensor, dst: int, group) -> None:
    dist.send(_staged(t.detach(), group), dst=dst)


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = _staged(torch.empty_like(like), group)
    dist.recv(buf, src=src)
    return buf.to(like.device)


def _broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = _staged(t, group)
    dist.broadcast(buf, src=src, group=group)
    return buf.to(t.device) if buf is not t else t


def gather_stages(model: nn.Module, tensors: dict) -> dict:
    """``tensors`` (by parameter name, this stage's layers) with every
    layer of the trunk, each broadcast by its stage over the pipe line (a
    collective: every rank of the line calls it)."""
    stage = getattr(model, "stage", None)
    if stage is None:
        return dict(tensors)
    out = dict(tensors)
    device = next(iter(tensors.values())).device
    for layer in range(stage.depth):
        src = stage.ranks[stage.owner(layer)]
        for name, shape, dtype in stage.names[layer]:
            mine = layer in stage.local()
            if mine and name not in out:
                continue
            t = out[name].detach() if mine else torch.empty(shape, dtype=dtype, device=device)
            out[name] = _broadcast(t, src, stage.group)
    return out


def local_stages(model: nn.Module, tensors: dict) -> dict:
    """``tensors`` (whole, by parameter name) without the other stages'
    layers."""
    stage = getattr(model, "stage", None)
    if stage is None:
        return dict(tensors)
    drop = {name for layer in range(stage.depth) if layer not in stage.local()
            for name, _, _ in stage.names[layer]}
    return {k: v for k, v in tensors.items() if k not in drop}


# -- the schedules -------------------------------------------------------------------

class _Schedule:
    """One call of the pipe schedule on this stage: its microbatches'
    graphs between forward and backward."""

    def __init__(self, stage: Stage, layers, layer_fn, seeds, num_microbatches: int):
        self.stage, self.layers, self.layer_fn = stage, layers, layer_fn
        self.seeds, self.mb = seeds, num_microbatches
        self.saved = []

    def _run(self, h: torch.Tensor, j: int) -> torch.Tensor:
        for i in self.stage.local():
            h = self.layer_fn(self.layers[i], h, layer_generator(self.seeds, i, j, h.device))
        return h

    def forward(self, x: torch.Tensor, keep_graph: bool) -> torch.Tensor:
        st = self.stage
        s, last = st.index, st.size - 1
        mbs = _microbatch(x, self.mb)
        outs = []
        for j in range(self.mb):
            h = mbs[j] if s == 0 else _recv(mbs[j], st.ranks[s - 1], st.group)
            if keep_graph:
                h = h.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = self._run(h, j)
                self.saved.append((h, y))
            else:
                y = self._run(h, j)
            if s < last:
                _send(y, st.ranks[s + 1], st.group)
            else:
                outs.append(y.detach())
        out = _unmicrobatch(outs) if s == last else torch.empty_like(x)
        return _broadcast(out, st.ranks[last], st.group)

    def backward(self, grad: torch.Tensor) -> torch.Tensor:
        st = self.stage
        s, last = st.index, st.size - 1
        grads = _microbatch(grad.contiguous(), self.mb) if s == last else None
        dx = []
        for j, (h, y) in enumerate(self.saved):
            g = grads[j] if s == last else _recv(y, st.ranks[s + 1], st.group)
            torch.autograd.backward(y, g)
            if s > 0:
                _send(h.grad, st.ranks[s - 1], st.group)
            else:
                dx.append(h.grad)
        self.saved = []
        out = _unmicrobatch(dx) if s == 0 else torch.empty_like(grad)
        return _broadcast(out, st.ranks[0], st.group)


class _GPipe(torch.autograd.Function):
    """The pipe schedule as one autograd node (see the module docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, schedule: _Schedule) -> torch.Tensor:
        ctx.schedule = schedule
        return schedule.forward(x, keep_graph=True)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.schedule.backward(grad), None


def pipeline_layers(layers, layer_fn, x: torch.Tensor, seeds: list[int] | None, *,
                    num_microbatches: int, stage: Stage | None = None) -> torch.Tensor:
    """Run ``layer_fn(layers[i], h, generator)`` over the trunk's layers on
    x (B, ...) with the GPipe schedule.

    ``seeds``: one per layer (None: no dropout generators).  Without an
    ambient pipeline mesh, or with a 'pipe' axis of 1, the serial schedule
    runs every layer here.  Over a 'pipe' axis of S the model's ``stage``
    (``shard_stages``) says which layers this rank holds."""
    size = axis_size(_ACTIVE_MESH, "pipe")
    if size <= 1:
        outs = []
        for j, h in enumerate(_microbatch(x, num_microbatches)):
            for i, layer in enumerate(layers):
                h = layer_fn(layer, h, layer_generator(seeds, i, j, h.device))
            outs.append(h)
        return _unmicrobatch(outs)
    if len(layers) % size:
        raise ValueError(f"depth {len(layers)} not divisible by pipe={size} stages")
    if stage is None or stage.size != size:
        raise RuntimeError(f"the pipeline mesh has a 'pipe' axis of {size} but the model is "
                           "not split over it: place it with parallel.shard_params")
    schedule = _Schedule(stage, layers, layer_fn, seeds, num_microbatches)
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for i in stage.local()
                               for p in layers[i].parameters()))
    if needs_grad:
        return _GPipe.apply(x, schedule)
    return schedule.forward(x, keep_graph=False)
