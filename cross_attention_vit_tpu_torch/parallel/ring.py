"""Ring attention: exact sequence-parallel attention over a mesh axis — port
of ``cross_attention_vit_tpu/parallel/ring.py``.

Each rank of a 'seq' line of P ranks holds a (B, K, N/P, D) slice of q, k
and v; the k/v blocks travel around the ring (one send to the next rank and
one receive from the previous a step) while an online-softmax accumulator
(the running (m, l, acc) of the flash kernels, statistics in f32) folds in
one block per step, so every rank ends with the exact attention of its
queries over the whole sequence and no rank holds the (N, N) scores.

The JAX package gets the backward by AD through ``lax.scan`` and
``ppermute``; torch's point-to-point ops have no autograd, so the backward
here is a ring of its own: the blocks travel again, each with its dk/dv
accumulator, p is recomputed from the forward's logsumexp, and after P
steps every accumulator is back on the rank that owns its block.

Numerics follow ``ops.attention._sdpa``: scores from the operands upcast to
f32, softmax statistics in f32, p rounded to v's dtype before p·v with an
f32 result.  Padded key positions (``n_valid``) score −1e30: once a real
key's score is in the running max their weight exp(−1e30 − m) is exactly 0.

Model path (``config.seq_parallel = P``): ``ops.attention.self_attention``
runs ``sharded_ring_sdpa`` on the whole (B, K, N, D) q, k, v, which are the
same on every rank of the line (the batch is split over 'data' only).  It
pads N to a multiple of P (the live sequences are 512·M + 1 tokens), runs
each rank's slice around the ring, and gathers the output slices, so the
output is whole on every rank again; in the backward each rank's dq, dk and
dv slices are gathered the same way, so everything upstream gets its whole
gradient on every rank.  Without an ambient seq mesh (``set_seq_mesh``;
the ``Trainer`` sets it) it is ``_sdpa`` itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import axis_group, axis_index, axis_size

# The ambient sequence-parallel mesh: models read it instead of threading a
# mesh through every forward.  None: the dense ``_sdpa``.
_ACTIVE_MESH = None


def set_seq_mesh(mesh) -> None:
    """Set (or clear, with None) the mesh ``sharded_ring_sdpa`` uses by default."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_seq_mesh():
    return _ACTIVE_MESH


class _Line(NamedTuple):
    """This rank's ring: its process group (None alone), size and place."""
    group: object
    size: int
    index: int


def _line(mesh, axis_name: str) -> _Line:
    return _Line(axis_group(mesh, axis_name), axis_size(mesh, axis_name),
                 axis_index(mesh, axis_name))


def _shift(tensors: list[torch.Tensor], line: _Line) -> list[torch.Tensor]:
    """Send the tensors to the next rank of the ring and return the previous
    rank's (one f32 message each way; bf16 and f32 values cross it exactly)."""
    if line.size == 1:
        return tensors
    send = torch.cat([t.float().reshape(-1) for t in tensors])
    recv = torch.empty_like(send)
    nxt = dist.get_global_rank(line.group, (line.index + 1) % line.size)
    prv = dist.get_global_rank(line.group, (line.index - 1) % line.size)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, line.group),
                                       dist.P2POp(dist.irecv, recv, prv, line.group)]):
        req.wait()
    parts = recv.split([t.numel() for t in tensors])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(parts, tensors)]


def _scores(q32: torch.Tensor, kb: torch.Tensor, scale: float, src: int,
            n_valid: int | None) -> torch.Tensor:
    """The f32 scores of the local queries against the block that started on
    rank ``src``, keys past ``n_valid`` at −1e30."""
    dots = torch.matmul(q32, kb.float().transpose(-1, -2)) * scale
    n = kb.shape[2]
    if n_valid is not None and (src + 1) * n > n_valid:
        pos = src * n + torch.arange(n, device=kb.device)
        dots = dots.masked_fill(pos >= n_valid, -1e30)
    return dots


def _ring_fwd(q, k, v, scale: float, line: _Line, n_valid: int | None):
    """(out in q's dtype, f32 logsumexp) of the local queries."""
    b, h, n, d = q.shape
    q32 = q.float()
    m = torch.full((b, h, n), float("-inf"), device=q.device)
    l = torch.zeros((b, h, n), device=q.device)
    acc = torch.zeros((b, h, n, d), device=q.device)
    kb, vb = k, v
    for s in range(line.size):
        dots = _scores(q32, kb, scale, (line.index - s) % line.size, n_valid)
        m_new = torch.maximum(m, dots.amax(-1))
        p = torch.exp(dots - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(vb.dtype).float(), vb.float())
        m = m_new
        if s < line.size - 1:
            kb, vb = _shift([kb, vb], line)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def _ring_bwd(q, k, v, out, lse, dout, scale: float, line: _Line, n_valid: int | None):
    """(dq, dk, dv) of the local blocks: dk and dv summed over every rank's
    queries, their accumulators carried around the ring to their owner."""
    q32, do = q.float(), dout.float()
    delta = (do * out.float()).sum(-1)
    dq = torch.zeros_like(q32)
    kb, vb = k, v
    dk, dv = torch.zeros_like(q32), torch.zeros_like(q32)
    for s in range(line.size):
        dots = _scores(q32, kb, scale, (line.index - s) % line.size, n_valid)
        p = torch.exp(dots - lse[..., None])
        dv = dv + torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do)
        ds = p * (torch.matmul(do, vb.float().transpose(-1, -2)) - delta[..., None])
        dq = dq + torch.matmul(ds, kb.float()) * scale
        dk = dk + torch.matmul(ds.transpose(-1, -2), q32) * scale
        if s < line.size - 1:
            kb, vb, dk, dv = _shift([kb, vb, dk, dv], line)
        else:
            dk, dv = _shift([dk, dv], line)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _gather_seq(t: torch.Tensor, line: _Line) -> torch.Tensor:
    """The line's slices of a (B, K, n, D) tensor joined along the sequence
    in ring order, on every rank of the line."""
    if line.size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(line.size)]
    dist.all_gather(parts, t.contiguous(), group=line.group)
    return torch.cat(parts, dim=2)


def _own(t: torch.Tensor, line: _Line) -> torch.Tensor:
    n = t.shape[2] // line.size
    return t[:, :, line.index * n:(line.index + 1) * n]


class _SeqRing(torch.autograd.Function):
    """The ring on whole (B, K, N, D) tensors that every rank of the line
    holds alike: each rank's slice goes around the ring and the output (and,
    backward, each input's gradient) is gathered whole on every rank."""

    @staticmethod
    def forward(ctx, q, k, v, scale, line, n_valid):
        q, k, v = (_own(t, line) for t in (q, k, v))
        out, lse = _ring_fwd(q, k, v, scale, line, n_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, line, n_valid)
        return _gather_seq(out, line)

    @staticmethod
    def backward(ctx, dout):
        line = ctx.args[1]
        grads = _ring_bwd(*ctx.saved_tensors, _own(dout, line), *ctx.args)
        return (*(_gather_seq(g, line) for g in grads), None, None, None)


def _sdpa(q, k, v, scale):
    from ..ops.attention import _sdpa as dense
    return dense(q, k, v, scale)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                   n_valid: int | None = None, force_ring: bool = False) -> torch.Tensor:
    """The ring on this rank alone (JAX's ``ring_attention`` at axis size
    1): ``_sdpa``, unless ``force_ring`` runs the ring's own arithmetic,
    forward and backward, on the one block.  ``n_valid``: the count of real
    key positions when the sequence was padded (padded keys are masked
    exactly; padded query rows are left for the caller to drop)."""
    if not force_ring:
        return _sdpa(q, k, v, scale)
    return _SeqRing.apply(q, k, v, scale, _Line(None, 1, 0), n_valid)


def ring_sdpa(mesh, axis_name: str = "seq"):
    """``sdpa(q, k, v)`` with the sequence split over the mesh's
    ``axis_name`` line, scale head_dim**-0.5: ``sharded_ring_sdpa``."""
    return lambda q, k, v: sharded_ring_sdpa(q, k, v, q.shape[-1] ** -0.5, mesh, axis_name)


def sharded_ring_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      mesh=None, axis_name: str = "seq") -> torch.Tensor:
    """Drop-in for ``ops.attention._sdpa`` with the sequence split over the
    mesh's ``axis_name`` (default: the ambient seq mesh).  N is zero-padded
    to a multiple of the axis size, the padded keys masked and the padded
    query rows dropped.  Without a mesh or the axis it is ``_sdpa``, bit for
    bit."""
    line = _line(active_seq_mesh() if mesh is None else mesh, axis_name)
    if line.size <= 1:
        return _sdpa(q, k, v, scale)
    n = q.shape[2]
    pad = (-n) % line.size
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    out = _SeqRing.apply(q, k, v, scale, line, n if pad else None)
    return out[:, :, :n] if pad else out
