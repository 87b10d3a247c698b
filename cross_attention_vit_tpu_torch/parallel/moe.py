"""Expert parallelism: the GShard Mixture-of-Experts FFN over an 'expert'
mesh axis — port of ``cross_attention_vit_tpu/parallel/moe.py``.

The reference has no MoE; the JAX package adds one as a growth path past its
dense FFN (``config.moe_experts``), and so does the port:

  * a (H → E) router in f32, softmax, top-k; top-2 gates renormalised to sum
    to 1, a top-1 gate kept raw (the Switch rule); per-expert slots filled in
    token order with a static capacity C = ⌈k·T/E · factor⌉, every token's
    first choice claiming slots before any second choice, slot counts in
    int32; a choice past its expert's capacity is dropped (the caller's
    residual carries the token);
  * the experts in f32 with erf GELU, whatever the model's compute dtype and
    ``gelu_approx`` say;
  * the Switch balance loss E·Σ_e f_e·p_e on the top-1 choice before
    capacity (1 for uniform routing), and the fraction of token-choices that
    found a slot.

The JAX package moves tokens to the (E, C, H) expert blocks and back with
one-hot (T, E, C) einsums; the port gathers the tokens by slot and gathers
each token's k expert rows back (each slot holds at most one token, so the
dispatch is exact and the combine sums at most k terms).  ``route`` returns
the routing those masks encode: each choice's expert, gate and slot.

Expert parallelism.  Expert weights are stacked on a leading E axis; over a
mesh with an 'expert' axis of size P each rank holds E/P of them
(``shard_experts``; the router stays whole on every rank).  The tokens are
the same on every rank of an expert line (the batch is split over 'data'
only), so every rank routes all of them, runs its own experts on their
slots, and the partial outputs are summed over the line by one all-reduce.
In the backward the gradient of the tokens and gates that enter the experts
is summed over the line the same way (Megatron's f/g pair), so the router
and everything upstream get their whole gradient on every rank.  Without a
mesh, or at P = 1, the same code runs every expert on one device.

Data parallelism.  JAX routes the global batch: the capacity, the slot
order and the balance loss are over every data shard's tokens.  Over a mesh
with a 'data' axis the port keeps those semantics: each data coordinate
routes its own tokens, with the capacity of the global token count, its
slots offset by the choices of the coordinates before it (one all-gather of
per-expert counts), and the balance loss on the global means (one
all-reduce of the router probabilities' sums, whose backward sums over the
data axis too, so DDP's average of the ranks' gradients is the gradient of
the one global balance loss).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import axis_group, axis_index, axis_size
from .tensor import _CopyToGroup, _ReduceFromGroup

# The ambient expert-parallel mesh: models read it instead of threading a
# mesh through every forward (``Trainer`` sets it).  None: every expert runs
# here.
_ACTIVE_MESH = None


def set_expert_mesh(mesh) -> None:
    """Set (or clear, with None) the mesh model-embedded MoE FFNs use."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_expert_mesh():
    return _ACTIVE_MESH


def expert_capacity(num_tokens: int, num_experts: int, num_selected: int,
                    capacity_factor: float) -> int:
    """Static per-expert slot count: ceil(k·T/E · factor), min 1."""
    return max(1, math.ceil(num_selected * num_tokens / num_experts * capacity_factor))


class Routing(NamedTuple):
    experts: torch.Tensor    # (T, k) int64: each token's chosen experts, best first
    gates: torch.Tensor      # (T, k) f32 combine weights (differentiable)
    slots: torch.Tensor      # (T, k) int64: the slot in the chosen expert, -1 if dropped
    capacity: int            # slots per expert
    balance: torch.Tensor    # () f32 Switch balance loss
    dispatched: torch.Tensor  # () f32 fraction of the token-choices that found a slot


class _SumOverGroup(torch.autograd.Function):
    """Sum over the group, forward and backward: the adjoint of a sum whose
    result every rank of the group then uses alike."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def route(probs: torch.Tensor, num_selected: int, capacity: int | None = None,
          capacity_factor: float = 1.25, group=None) -> Routing:
    """Top-k routing of (T, E) f32 router probabilities (the rules of JAX's
    ``_dispatch_combine``).  The stable descending sort puts the
    lower expert first on ties, as ``lax.top_k`` does.  ``capacity``
    defaults to ``expert_capacity`` of the token count.  ``group``: the data
    axis's group, over which the tokens of one global batch are split in
    rank order (see the module's docstring)."""
    t, num_experts = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :num_selected], idx[:, :num_selected]
    if num_selected > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    hot = [F.one_hot(experts[:, i], num_experts).to(torch.int32) for i in range(num_selected)]
    counts = torch.stack([m.sum(dim=0, dtype=torch.int32) for m in hot])     # (k, E)
    prob_sums = probs.sum(dim=0)
    if group is None:
        t_all, before, total = t, torch.zeros_like(counts), counts
    else:
        # every coordinate's token count and (k, E) choice counts
        row = torch.cat([counts.new_tensor([t]), counts.reshape(-1)])
        rows = [torch.empty_like(row) for _ in range(dist.get_world_size(group))]
        dist.all_gather(rows, row, group=group)
        rows = torch.stack(rows)
        me = dist.get_rank(group)
        t_all = int(rows[:, 0].sum())
        before = rows[:me, 1:].sum(dim=0, dtype=torch.int32).view_as(counts)
        total = rows[:, 1:].sum(dim=0, dtype=torch.int32).view_as(counts)
        prob_sums = _SumOverGroup.apply(prob_sums, group)
    if capacity is None:
        capacity = expert_capacity(t_all, num_experts, num_selected, capacity_factor)
    claimed = torch.zeros(num_experts, dtype=torch.int32, device=probs.device)
    slots = []
    for i, m in enumerate(hot):
        pos = torch.cumsum(m, dim=0, dtype=torch.int32) - 1 + claimed + before[i]
        pos = pos.gather(1, experts[:, i:i + 1]).squeeze(1).long()
        slots.append(torch.where(pos < capacity, pos, -1))
        claimed = claimed + total[i]
    balance = num_experts * torch.sum(total[0].float() / t_all * (prob_sums / t_all))
    dispatched = claimed.clamp(max=capacity).sum() / float(t_all * num_selected)
    return Routing(experts, gates, torch.stack(slots, dim=1), capacity, balance, dispatched)


def _expert(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor) -> torch.Tensor:
    """One expert's fc1/GELU/fc2 on its (C, H) slots in f32.  One GEMM shape
    per expert whatever the split: a batched product over E experts rounds
    otherwise than over E/P, so a rank's experts would not compute what one
    device computes bit for bit."""
    h = F.gelu(torch.addmm(b1.float(), x, w1.float().t()))
    return torch.addmm(b2.float(), h, w2.float().t())


def moe_ffn(x: torch.Tensor, router: torch.Tensor, fc1_w: torch.Tensor, fc1_b: torch.Tensor,
            fc2_w: torch.Tensor, fc2_b: torch.Tensor, *, num_selected: int = 2,
            capacity_factor: float = 1.25, mesh=None) -> tuple[torch.Tensor, dict]:
    """The MoE FFN on (..., H) activations; returns (y, aux) with y like x
    and aux = {'balance_loss', 'dispatch_fraction'} (0-d f32 tensors).

    router (E, H); this rank's experts fc1_w (e, mlp, H), fc1_b (e, mlp),
    fc2_w (e, H, mlp), fc2_b (e, H), in torch's (out, in) layout: all E
    experts (e = E) without a mesh or an 'expert' axis, else E / P of them,
    the ones at this rank's coordinate on the axis (``shard_experts``)."""
    num_experts, local = router.shape[0], fc1_w.shape[0]
    p = axis_size(mesh, "expert")
    if local * p != num_experts:
        raise ValueError(f"the experts here are {local} of {num_experts} but the mesh's "
                         f"'expert' axis is {p}: place the model with "
                         "parallel.shard_params (expert weights split over 'expert')")
    offset = axis_index(mesh, "expert") * local
    group = axis_group(mesh, "expert") if p > 1 else None
    data = axis_group(mesh, "data") if axis_size(mesh, "data") > 1 else None
    lead, hidden = x.shape[:-1], x.shape[-1]
    tokens = x.reshape(-1, hidden).float()
    t = tokens.shape[0]
    k = min(num_selected, num_experts)

    probs = torch.softmax(tokens @ router.float().t(), dim=-1)
    r = route(probs, k, capacity_factor=capacity_factor, group=data)
    capacity = r.capacity
    # the flat slot (expert here × C + slot) of each choice, or the zero row
    # at local·C for a choice dropped or routed to another rank's experts
    here = (r.slots >= 0) & (r.experts >= offset) & (r.experts < offset + local)
    flat = torch.where(here, (r.experts - offset) * capacity + r.slots, local * capacity)
    src = torch.full((local * capacity + 1,), t, dtype=torch.long, device=x.device)
    src.scatter_(0, flat.reshape(-1),
                 torch.arange(t, device=x.device).repeat_interleave(k))
    if group is not None:
        tokens_in, gates = (_CopyToGroup.apply(a, group) for a in (tokens, r.gates))
    else:
        tokens_in, gates = tokens, r.gates
    # index_select's backward is index_add: at most k slots add into a
    # token's row, so at k <= 2 the atomic order cannot change the sum
    xe = F.pad(tokens_in, (0, 0, 0, 1)).index_select(0, src[:-1]).view(local, capacity, hidden)
    ye = torch.cat([_expert(xe[e], fc1_w[e], fc1_b[e], fc2_w[e], fc2_b[e]) for e in range(local)])
    ye = F.pad(ye, (0, 0, 0, 1))
    w = torch.where(here, gates, torch.zeros((), device=x.device))
    y = w[:, 0:1] * ye.index_select(0, flat[:, 0])
    for i in range(1, k):
        y = y + w[:, i:i + 1] * ye.index_select(0, flat[:, i])
    if group is not None:
        y = _ReduceFromGroup.apply(y, group)
    aux = {"balance_loss": r.balance, "dispatch_fraction": r.dispatched}
    return y.reshape(*lead, hidden).to(x.dtype), aux


# -- the module ---------------------------------------------------------------------

class _Weights(nn.Module):
    """A holder of ``weight`` and, when given a shape, ``bias`` — not an
    ``nn.Linear``, so a serving model's cast of its GEMM weights to the
    compute dtype leaves the MoE in f32."""

    def __init__(self, weight: tuple, bias: tuple | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight))
        self.bias = nn.Parameter(torch.zeros(bias)) if bias is not None else None


class MoEFFN(nn.Module):
    """A MoE FFN site: ``router.weight`` (E, H) and the stacked experts
    ``experts.fc1.{weight (E, mlp, H), bias (E, mlp)}`` and
    ``experts.fc2.{weight (E, H, mlp), bias (E, H)}``, in f32.  The forward
    runs over the ambient expert mesh (``set_expert_mesh``); after
    ``shard_experts`` the module holds its rank's E/P experts."""

    def __init__(self, dim: int, hidden: int, num_experts: int, num_selected: int = 2,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.num_experts = num_experts
        self.num_selected = num_selected
        self.capacity_factor = capacity_factor
        self.router = _Weights((num_experts, dim))
        self.experts = nn.ModuleDict({"fc1": _Weights((num_experts, hidden, dim),
                                                      (num_experts, hidden)),
                                      "fc2": _Weights((num_experts, dim, hidden),
                                                      (num_experts, dim))})
        self.expert_group = None     # set by shard_experts

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Each expert's fc1/fc2 and the router xavier-uniform (the dense
        FFN's law, per expert), biases zero."""
        from ..ops.initializers import xavier_uniform_

        xavier_uniform_(self.router.weight, generator)
        for fc in self.experts.values():
            for w in fc.weight:
                xavier_uniform_(w, generator)
            fc.bias.zero_()

    def expert_params(self) -> dict[str, nn.Parameter]:
        return {f"experts.{fc}.{n}": getattr(self.experts[fc], n)
                for fc in ("fc1", "fc2") for n in ("weight", "bias")}

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        e = self.experts
        return moe_ffn(x, self.router.weight, e["fc1"].weight, e["fc1"].bias, e["fc2"].weight,
                       e["fc2"].bias, num_selected=self.num_selected,
                       capacity_factor=self.capacity_factor, mesh=active_expert_mesh())


def moe_sites(model: nn.Module) -> dict[str, MoEFFN]:
    """The model's MoE FFN modules by name, in module order."""
    return {name: m for name, m in model.named_modules() if isinstance(m, MoEFFN)}


# -- placing the experts ------------------------------------------------------------

@torch.no_grad()
def shard_experts(model: nn.Module, mesh) -> nn.Module:
    """Keep, in every MoE FFN of ``model``, the E/P experts of this rank's
    coordinate on the mesh's 'expert' axis (size P), as new parameters (the
    JAX ``P('expert', None, None)``); the router stays whole.  Build the
    optimizer afterwards.  Does nothing without an 'expert' axis."""
    p = axis_size(mesh, "expert")
    if p <= 1:
        return model
    group, r = axis_group(mesh, "expert"), axis_index(mesh, "expert")
    for name, site in moe_sites(model).items():
        if site.expert_group is not None:
            continue
        if site.num_experts % p:
            raise ValueError(f"{name}: {site.num_experts} experts do not divide over the "
                             f"'expert' axis of {p}")
        local = site.num_experts // p
        for fc in site.experts.values():
            for n in ("weight", "bias"):
                whole = getattr(fc, n)
                setattr(fc, n, nn.Parameter(whole[r * local:(r + 1) * local].clone()))
        site.expert_group = (group, r, p)
    return model


def _sharded_names(model: nn.Module) -> dict[str, tuple]:
    """Parameter name → (group, coordinate, size) of the experts that
    ``shard_experts`` split."""
    return {f"{name}.{pn}" if name else pn: site.expert_group
            for name, site in moe_sites(model).items() if site.expert_group is not None
            for pn in site.expert_params()}


def gather_experts(model: nn.Module, tensors: dict[str, torch.Tensor]) -> dict:
    """``tensors`` (by parameter name, in the model's state-dict names) with
    every split expert tensor replaced by the whole E stack, gathered over
    its 'expert' line (a collective: every rank of the line calls it)."""
    out = dict(tensors)
    for name, (group, _, p) in _sharded_names(model).items():
        if name in out:
            t = out[name].contiguous()
            parts = [torch.empty_like(t) for _ in range(p)]
            dist.all_gather(parts, t, group=group)
            out[name] = torch.cat(parts)
    return out


def local_experts(model: nn.Module, tensors: dict) -> dict:
    """``tensors`` (whole E stacks by parameter name) with every split expert
    tensor cut to this rank's E/P experts."""
    out = dict(tensors)
    for name, (_, r, p) in _sharded_names(model).items():
        if name in out:
            local = len(out[name]) // p
            out[name] = out[name][r * local:(r + 1) * local]
    return out
