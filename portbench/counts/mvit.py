"""Frozen yardsticks of MViTv2 (``configs/mvitv2_s.k400.json``): its matmul
FLOPs, and the operations and bytes of the pooling-attention kernels
(``kernels/pool_attention.py``, K10), from the shapes alone.

Matmul FLOPs count two a multiply-accumulate, as ``flops.py`` does: the
stem convolution over its output grid, and in each block the qkv Linear
over the input tokens, the three depthwise 3³ pools, the bias terms
q·R over every key coordinate, the attention's QKᵀ and PV, the output
projection, the transition's skip Linear, and the MLP; then the head.
LayerNorm, softmax, GELU, the max-pool and the layout copies are left out.
A training step counts as three forwards.

The kernels' least time takes each input read once and each output written
once: q, k, v, o, do, dq, dk, dv in bf16, the bias terms (BH, Nq, PP) in
bf16 and their gradient in f32, the row statistics in f32; the products at
the bf16 peak (the backward's five: S, dP, dV, dQ, dK)."""

from __future__ import annotations

import math

BF16, F32 = 2, 4
POOL = 27          # taps of a 3³ depthwise pool


def _pooled(dims, stride) -> list[int]:
    return [(d + 2 - 3) // s + 1 for d, s in zip(dims, stride)]


def blocks(cfg) -> list[dict]:
    """Per block: widths, heads, the input, query and key grids."""
    thw = [(d + 2 * p - k) // s + 1 for d, k, s, p in zip(
        cfg["img_size"], cfg["patch_kernel"], cfg["patch_stride"], cfg["patch_padding"])]
    dim, heads, kv = cfg["embed_dim"], cfg["num_heads"], list(cfg["pool_kv_stride_adaptive"])
    out = []
    for i in range(cfg["depth"]):
        mul = i in cfg["dim_mul_blocks"]
        stride_q = list(cfg["pool_q_stride"]) if mul else [1, 1, 1]
        kv = [max(k // s, 1) for k, s in zip(kv, stride_q)]
        dim_out, heads = (2 * dim, 2 * heads) if mul else (dim, heads)
        q_dims, k_dims = _pooled(thw, stride_q), _pooled(thw, kv)
        out.append({"C_in": dim, "C": dim_out, "heads": heads, "thw": thw, "q": q_dims,
                    "k": k_dims})
        dim, thw = dim_out, q_dims
    return out


def forward_flops(cfg, batch: int) -> int:
    """Matmul FLOPs of a forward of ``batch`` clips."""
    first = blocks(cfg)[0]
    stem = math.prod(cfg["patch_kernel"]) * cfg["num_modalities"] * cfg["in_channels"]
    total = 2 * math.prod(first["thw"]) * stem * cfg["embed_dim"]
    for b in blocks(cfg):
        n_in, nq, nk = math.prod(b["thw"]), math.prod(b["q"]), math.prod(b["k"])
        C, D = b["C"], b["C"] // b["heads"]
        total += 2 * n_in * b["C_in"] * 3 * C                     # qkv
        total += 2 * (nq + 2 * nk) * C * POOL                     # the pools
        total += 2 * nq * C * sum(b["k"])                         # the bias terms
        total += 4 * nq * nk * C                                  # QKᵀ and PV
        total += 2 * nq * C * C                                   # proj
        if b["C_in"] != C:
            total += 2 * n_in * b["C_in"] * C                     # the skip Linear
        total += 4 * nq * C * int(cfg["mlp_ratio"] * C)           # the MLP
    total += 2 * blocks(cfg)[-1]["C"] * cfg["num_classes"]
    return batch * total


def terms_width(k_dims) -> int:
    """PP: the bias terms' row width, tk + hk + wk rounded up to 8."""
    return -(-sum(k_dims) // 8) * 8


def pool_attention_calls(cfg, batch: int) -> list[tuple[int, int, int, int, int]]:
    """(B·h, Nq, Nk, D, PP) of every pooling-attention call of a forward, in order."""
    return [(batch * b["heads"], math.prod(b["q"]), math.prod(b["k"]), b["C"] // b["heads"],
             terms_width(b["k"])) for b in blocks(cfg)]


def fwd_flops(BH: int, Nq: int, Nk: int, D: int, PP: int) -> int:
    """QKᵀ and PV: 4·BH·Nq·Nk·D."""
    return 4 * BH * Nq * Nk * D


def fwd_bytes(BH: int, Nq: int, Nk: int, D: int, PP: int) -> int:
    """q, k, v and the terms read, o written (bf16); the lse written (f32)."""
    return (2 * BH * (Nq + Nk) * D + BH * Nq * PP) * BF16 + BH * Nq * F32


def bwd_flops(BH: int, Nq: int, Nk: int, D: int, PP: int) -> int:
    """S recomputed, dV, dP, dQ and dK: 10·BH·Nq·Nk·D."""
    return 10 * BH * Nq * Nk * D


def bwd_bytes(BH: int, Nq: int, Nk: int, D: int, PP: int) -> int:
    """q, k, v, o, do and the terms read, dq, dk, dv written (bf16); the
    terms' gradient written and the lse read (f32)."""
    return (4 * BH * (Nq + Nk) * D + BH * Nq * PP) * BF16 + BH * Nq * (PP + 1) * F32
