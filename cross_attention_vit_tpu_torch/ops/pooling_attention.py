"""MViTv2's pooling attention on a (B, T·H·W, C) token sequence, as PySlowFast's
``MultiScaleAttention`` (``mode="conv"``, ``residual_pooling``,
``rel_pos_spatial`` and ``rel_pos_temporal``) and the skip path of
``MultiScaleBlock`` compute them (Li et al., arXiv:2112.01526).

``pooling_attention`` takes a block's ``norm1`` output and does, inside
``span("mvit:pool_attention")``: the qkv Linear and its split per head into
(B·h, 96, T, H, W), one copy for q, k and v; the three pools (``mvit_pool``:
a depthwise 3³ Conv3d, one weight for q, one for k and one for v, shared
by the heads, run by ``F.conv3d`` on those contiguous tensors) each
followed by a LayerNorm over the 96 channels; the decomposed
relative-position bias terms (``bias_terms``); the attention with the
``+ q`` residual in the hand-written kernels of ``kernels.pool_attention``
(their plain versions on CPU tensors); the output projection; and, at a
transition, the skip path's Linear and its max-pool.

``rel_pos_index`` is MViTv2's distance rule along one axis with Lq queries
and Lk keys: rq = max(Lk/Lq, 1), rk = max(Lq/Lk, 1), d(i, j) = i·rq − j·rk
+ (Lk − 1)·rk, into a table of 2·max(Lq, Lk) − 1 rows.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch
import torch.nn.functional as F

from ..kernels.pool_attention import PoolAttention, terms_width
from ..utils.profiling import span
from .layers import layernorm, linear

SPAN = "mvit:pool_attention"
POOL_KERNEL = (3, 3, 3)


def pooled_dims(dims, stride, kernel=POOL_KERNEL) -> tuple[int, int, int]:
    """A (T, H, W) grid after a pool of ``kernel`` with padding kernel // 2."""
    return tuple((d + 2 * (k // 2) - k) // s + 1 for d, s, k in zip(dims, stride, kernel))


def table_rows(lq: int, lk: int) -> int:
    """Rows of an axis's relative-position table for Lq queries and Lk keys."""
    return 2 * max(lq, lk) - 1


def rel_pos_index(lq: int, lk: int) -> torch.Tensor:
    """(Lq, Lk) int64: each (query, key) pair's row of the axis's table."""
    q_ratio, k_ratio = max(lk / lq, 1.0), max(lq / lk, 1.0)
    dist = torch.arange(lq)[:, None] * q_ratio - torch.arange(lk)[None, :] * k_ratio
    return (dist + (lk - 1) * k_ratio).long()


@lru_cache(maxsize=None)
def _index(lq: int, lk: int, device: str) -> torch.Tensor:
    """``rel_pos_index`` on ``device``, made once: no copy to the card a step."""
    return rel_pos_index(lq, lk).to(device)


def mvit_pool(t: torch.Tensor, weight: torch.Tensor, stride) -> torch.Tensor:
    """The depthwise pool of t (N, C, T, H, W) with ``weight`` (C, 1, k, k,
    k), padding k // 2: F.conv3d in t's dtype, returning (N, C, T', H', W').
    On a contiguous CUDA tensor PyTorch runs its own depthwise kernels
    (``conv_depthwise3d``); a channels-last one would go to cuDNN's generic
    grouped path, 3.5× slower with its backward on the H100 at MViTv2-S's
    first pool.  ``mvit_pool.launches`` counts calls."""
    C = t.shape[1]
    y = F.conv3d(t, weight.to(t.dtype), None, tuple(stride),
                 tuple(k // 2 for k in weight.shape[2:]), 1, C)
    mvit_pool.launches += 1
    return y


mvit_pool.launches = 0


def bias_terms(q: torch.Tensor, q_dims, k_dims, rel_t: torch.Tensor, rel_h: torch.Tensor,
               rel_w: torch.Tensor) -> torch.Tensor:
    """The decomposed relative-position bias of pooled, normed q (BH, Nq, D)
    on a (tq, hq, wq) grid against keys on a (tk, hk, wk) grid, as the
    kernels take it: e (BH, Nq, PP) in q's dtype, whose columns [0, tk),
    [tk, tk + hk), [tk + hk, tk + hk + wk) hold q_i·Rt[dt], q_i·Rh[dh],
    q_i·Rw[dw], and zeros to PP (``kernels.pool_attention.terms_width``).

    Three batched products without a copy of q: the t term over the
    (BH, tq) batch, the h term over (BH·tq, hq), the w term over wq with
    the (BH·tq·hq) rows at q's own stride."""
    BH, Nq, D = q.shape
    (tq, hq, wq), (tk, hk, wk) = q_dims, k_dims
    rt, rh, rw = (table.to(q.dtype)[_index(a, b, str(q.device))]
                  for table, a, b in ((rel_t, tq, tk), (rel_h, hq, hk), (rel_w, wq, wk)))
    rows = BH * tq * hq
    et = torch.matmul(q.view(BH, tq, hq * wq, D), rt.transpose(1, 2)).view(rows, wq, tk)
    eh = torch.matmul(q.view(BH * tq, hq, wq, D), rh.transpose(1, 2)).view(rows, wq, hk)
    ew = torch.bmm(q.view(rows, wq, D).transpose(0, 1), rw.transpose(1, 2)).transpose(0, 1)
    parts = [et, eh, ew]
    pad = terms_width(k_dims) - (tk + hk + wk)
    if pad:
        parts.append(q.new_zeros(()).expand(rows, wq, pad))
    return torch.cat(parts, -1).view(BH, Nq, -1)


def _pool_norm(t: torch.Tensor, weight: torch.Tensor, norm: torch.nn.LayerNorm, stride,
               eps: float) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """The pool of t (N, D, T, H, W), then its LayerNorm over D: (N, T'·H'·W',
    D) and the pooled grid."""
    y = mvit_pool(t, weight, stride)
    dims = tuple(y.shape[2:])
    return layernorm(y.flatten(2).transpose(1, 2), norm.weight, norm.bias, eps), dims


def skip_path(x: torch.Tensor, xn: torch.Tensor, thw, proj: torch.nn.Linear | None, q_stride,
              compute_dtype: torch.dtype | None) -> torch.Tensor:
    """``MultiScaleBlock``'s skip: at a transition Linear(C_in → C_out) of
    the ``norm1`` output xn, then, where the query stride pools, MaxPool3d
    with kernel s + 1 on each strided axis (s elsewhere), padding kernel //
    2; elsewhere x itself."""
    if proj is not None:
        x = linear(xn, proj.weight, proj.bias, compute_dtype)
    if math.prod(q_stride) > 1:
        kernel = tuple(s + 1 if s > 1 else s for s in q_stride)
        B, _, C = x.shape
        y = F.max_pool3d(x.view(B, *thw, C).permute(0, 4, 1, 2, 3), kernel, tuple(q_stride),
                         tuple(k // 2 for k in kernel))
        x = y.permute(0, 2, 3, 4, 1).reshape(B, -1, C)
    return x


def pooling_attention(x: torch.Tensor, xn: torch.Tensor, thw, attn: torch.nn.Module,
                      proj: torch.nn.Linear | None, heads: int, q_stride, kv_stride,
                      eps: float, compute_dtype: torch.dtype | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """The attention branch and the skip path of one block on its input x
    and ``norm1`` output xn (B, T·H·W, C_in) on the grid ``thw``.  ``attn``
    holds ``qkv`` (C_in → 3·C_out), ``proj``, ``pool_{q,k,v}``,
    ``norm_{q,k,v}`` and ``rel_pos_{t,h,w}``; ``proj`` is the transition's
    skip Linear or None.  Returns (the attention branch (B, Nq, C_out) in
    x's dtype, the skip (B, Nq, C_out), the query grid)."""
    with span(SPAN):
        B = x.shape[0]
        C = attn.proj.weight.shape[0]
        D = C // heads
        qkv = linear(xn, attn.qkv.weight, attn.qkv.bias, compute_dtype)
        # (B, T, H, W, 3, h, D) → (3, B·h, D, T, H, W): one copy for the three pools
        t = qkv.view(B, *thw, 3, heads, D).permute(4, 0, 5, 6, 1, 2, 3).reshape(
            3, B * heads, D, *thw)
        q, q_dims = _pool_norm(t[0], attn.pool_q.weight, attn.norm_q, q_stride, eps)
        k, k_dims = _pool_norm(t[1], attn.pool_k.weight, attn.norm_k, kv_stride, eps)
        v, _ = _pool_norm(t[2], attn.pool_v.weight, attn.norm_v, kv_stride, eps)
        e = bias_terms(q, q_dims, k_dims, attn.rel_pos_t, attn.rel_pos_h, attn.rel_pos_w)
        o = PoolAttention.apply(q, k, v, e, k_dims, D ** -0.5)
        Nq = o.shape[1]
        o = o.view(B, heads, Nq, D).transpose(1, 2).reshape(B, Nq, C)
        o = linear(o, attn.proj.weight, attn.proj.bias, compute_dtype, out_dtype=x.dtype)
        return o, skip_path(x, xn, thw, proj, q_stride, compute_dtype), q_dims
