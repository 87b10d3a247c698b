"""Pooling attention with a decomposed relative-position bias (K10), forward
and backward: the attention of MViTv2's ``MultiScaleAttention`` (Li et al.,
arXiv:2112.01526; PySlowFast ``slowfast/models/attention.py``) after its
pooled, normed q, k and v.

No TPU kernel corresponds: the JAX package has no multiscale model.  K1/K2
(``flash_attention.py``) take one fused qkv buffer with Nq = Nk at D = 64
and no bias; K9 (``window_attention.py``) attends 343-token windows at
D = 16 with a bias gathered from a table.  MViTv2 attends Nq queries to a
pooled Nk ≠ Nq keys at D = 96, and its bias depends on the query.

For one batch-head, q (Nq, D) on a (tq, hq, wq) grid, k and v (Nk, D) on
a (tk, hk, wk) grid, both in row-major (t, h, w) order, and the bias terms
e (Nq, PP) whose columns [0, tk), [tk, tk + hk) and [tk + hk, tk + hk +
wk) hold q_i·Rt[dt(i, ·)], q_i·Rh[dh(i, ·)] and q_i·Rw[dw(i, ·)]
(``ops/pooling_attention.bias_terms``; PP, the row's width, is their sum
rounded up to 8 for the kernels' 16-byte rows):

    s   = q·kᵀ·scale + e[i, jt] + e[i, tk + jh] + e[i, tk + hk + jw]      f32
    lse = logsumexp_j s;   o = softmax(s)·v + q                          o in q's dtype

The ``+ q`` is MViTv2's residual pooling.  The kernels
(``csrc/pool_attention.cu``, CUDA C++ built by ``_build`` at first call)
add the three terms per score and never store the (Nq, Nk) scores or
bias.  The backward gives dq (the residual's do included), dk, dv and de
(BH, Nq, PP) f32: dS summed over the key's other two coordinates in a
fixed order, with no atomics, so two calls give the same bits.  The
kernels take bf16 at D = 96 (MViTv2's every head) and keys with wk ≤ 32.

Bound: a batch-head reads q, k, v and e and writes o, about 4·(Nq +
Nk)·D bytes, for 4·Nq·Nk·D operations: Nq·Nk/(Nq + Nk) FLOP a byte, 283-340
at Nk = 392 and 300-1070 at Nk = 1568 across MViTv2-S's blocks, at or above
the card's 295, so the products bind but for the blocks with 1,568 or 392
queries against 392 keys, which the bytes bind barely.  The kernels run on
mma.sync with k and v (q and do in the dk/dv pass) streamed through shared
memory on a two-tile cp.async ring (the source's header has the design).

``pool_attention_fwd`` and ``pool_attention_bwd`` are the wrappers: on a
CUDA tensor each launches the kernels, on a CPU tensor each runs its plain
PyTorch version (``pool_attention_reference``,
``pool_attention_backward_reference``), which rounds where the kernels
round.  ``pool_attention_fwd.launches`` and ``pool_attention_bwd.launches``
count calls.  ``PoolAttention`` is the autograd function over the two.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# the kernels' head size
HEAD_DIM = 96
# the largest key grid's w the kernels' padded key order takes (4 groups of 8)
MAX_WK = 32
_LIB = _build.Library("pool_attention", "pool_attention_error_string", {
    # q, k, v, e, o, lse, BH, Nq, Nk, tk, hk, wk, PP, scale
    "pool_attention_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float],
    # q, k, v, e, o, do, lse, delta, dq, dk, dv, de, BH, Nq, Nk, tk, hk, wk, PP, scale
    "pool_attention_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_float]})


def terms_width(key_grid) -> int:
    """PP: the bias terms' row width, tk + hk + wk rounded up to 8."""
    return -(-sum(key_grid) // 8) * 8


def bias_from_terms(e: torch.Tensor, key_grid) -> torch.Tensor:
    """(…, Nq, Nk) f32: each score's bias, the sum of its three terms."""
    tk, hk, wk = key_grid
    et = e[..., :tk].float()[..., :, None, None]
    eh = e[..., tk:tk + hk].float()[..., None, :, None]
    ew = e[..., tk + hk:tk + hk + wk].float()[..., None, None, :]
    return (et + eh + ew).flatten(-3)


def _scores(q, k, e, key_grid, scale) -> torch.Tensor:
    return (torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            + bias_from_terms(e, key_grid))


def pool_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             e: torch.Tensor, key_grid, scale: float
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (o (BH, Nq, D) in q's dtype, lse
    (BH, Nq) f32).  The probabilities are rounded to q's dtype before the
    product with v, as the kernel rounds them; the residual q is added in
    f32 and o rounded once."""
    s = _scores(q, k, e, key_grid, scale)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None]).to(q.dtype).float()
    return (torch.matmul(p, v.float()) + q.float()).to(q.dtype), lse


def pool_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      e: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                                      lse: torch.Tensor, key_grid, scale: float
                                      ) -> tuple[torch.Tensor, ...]:
    """Plain version of the backward kernels: (dq, dk, dv in q's dtype, de
    (BH, Nq, PP) f32).  P and dS are rounded to q's dtype before their
    products, as the kernels round them; dq takes the residual's do; de sums
    the f32 dS over the key's other two coordinates (its padding columns
    zero)."""
    dtype = q.dtype
    go = do.float()
    delta = (go * (o.float() - q.float())).sum(-1)
    p = torch.exp(_scores(q, k, e, key_grid, scale) - lse[..., None])
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), go)
    ds = p * (torch.matmul(go, v.float().transpose(-1, -2)) - delta[..., None])
    ds_lowp = ds.to(dtype).float()
    dq = torch.matmul(ds_lowp, k.float()) * scale + go
    dk = torch.matmul(ds_lowp.transpose(-1, -2), q.float()) * scale
    ds = ds.unflatten(-1, tuple(key_grid))
    de = torch.zeros(*e.shape, dtype=torch.float32, device=e.device)
    tk, hk, wk = key_grid
    de[..., :tk] = ds.sum((-2, -1))
    de[..., tk:tk + hk] = ds.sum((-3, -1))
    de[..., tk + hk:tk + hk + wk] = ds.sum((-3, -2))
    return dq.to(dtype), dk.to(dtype), dv.to(dtype), de


def _check(q, k, v, e, key_grid) -> None:
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"q must be (BH, Nq, D) and k, v (BH, Nk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if math.prod(key_grid) != k.shape[1]:
        raise ValueError(f"the key grid {tuple(key_grid)} holds {math.prod(key_grid)} keys, "
                         f"k has {k.shape[1]}")
    if e.shape != (q.shape[0], q.shape[1], terms_width(key_grid)):
        raise ValueError(f"the bias terms must be ({q.shape[0]}, {q.shape[1]}, "
                         f"{terms_width(key_grid)}), got {tuple(e.shape)}")


def _check_card(q, key_grid) -> None:
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the pooling-attention kernels take bfloat16, not {q.dtype}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the pooling-attention kernels take a head size of {HEAD_DIM}, "
                         f"got {q.shape[-1]}")
    if key_grid[2] > MAX_WK:
        raise ValueError(f"the pooling-attention kernels take a key grid's w of at most "
                         f"{MAX_WK}, got {key_grid[2]}")


def _on_card(q: torch.Tensor, key_grid) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"pooling attention runs on cuda or cpu tensors, got {q.device}")
    _check_card(q, key_grid)
    return True


def pool_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, e: torch.Tensor,
                       key_grid, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """q (BH, Nq, D), k and v (BH, Nk, D) with Nk = tk·hk·wk for ``key_grid``
    (tk, hk, wk), the bias terms e (BH, Nq, PP).  Returns (o (BH, Nq, D) in
    q's dtype, lse (BH, Nq) f32)."""
    _check(q, k, v, e, key_grid)
    if not _on_card(q, key_grid):
        return pool_attention_reference(q, k, v, e, key_grid, scale)
    q, k, v, e = (t.contiguous() for t in (q, k, v, e.to(q.dtype)))
    BH, Nq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, Nq), dtype=torch.float32, device=q.device)
    _LIB.launch("pool_attention_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                e.data_ptr(), o.data_ptr(), lse.data_ptr(), BH, Nq, k.shape[1], *key_grid,
                e.shape[2], scale)
    pool_attention_fwd.launches += 1
    return o, lse


def pool_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, e: torch.Tensor,
                       o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, key_grid,
                       scale: float) -> tuple[torch.Tensor, ...]:
    """The cotangent do (BH, Nq, D) of ``pool_attention_fwd``'s o, with its o
    and lse.  Returns (dq, dk, dv in q's dtype, de (BH, Nq, PP) f32)."""
    _check(q, k, v, e, key_grid)
    if not _on_card(q, key_grid):
        return pool_attention_backward_reference(q, k, v, e, o, do, lse, key_grid, scale)
    q, k, v, e, o, lse = (t.contiguous() for t in (q, k, v, e.to(q.dtype), o, lse))
    do = do.to(q.dtype).contiguous()
    BH, Nq, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    de = torch.zeros(e.shape, dtype=torch.float32, device=q.device)
    delta = torch.empty((BH, Nq), dtype=torch.float32, device=q.device)
    _LIB.launch("pool_attention_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                e.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), de.data_ptr(), BH, Nq, k.shape[1],
                *key_grid, e.shape[2], scale)
    pool_attention_bwd.launches += 1
    return dq, dk, dv, de


pool_attention_fwd.launches = 0
pool_attention_bwd.launches = 0


class PoolAttention(torch.autograd.Function):
    """o = softmax(q·kᵀ·scale + bias(e))·v + q, through ``pool_attention_fwd``
    and ``pool_attention_bwd``; the gradient of e is de in e's dtype."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, e: torch.Tensor,
                key_grid: tuple[int, int, int], scale: float) -> torch.Tensor:
        o, lse = pool_attention_fwd(q, k, v, e, key_grid, scale)
        ctx.save_for_backward(q, k, v, e, o, lse)
        ctx.key_grid, ctx.scale = key_grid, scale
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v, e, o, lse = ctx.saved_tensors
        dq, dk, dv, de = pool_attention_bwd(q, k, v, e, o, do, lse, ctx.key_grid, ctx.scale)
        return dq, dk, dv, de.to(e.dtype), None, None
