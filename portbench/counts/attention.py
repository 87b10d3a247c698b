"""Least times of the attention kernels (frozen copies of ``chip_smoke.py``'s
``attention_bound`` and ``attention_bwd_bound``): each input read once and
each output written once, the products at the bf16 peak; the larger of the
byte time and the operation time bounds the call."""

from __future__ import annotations

BF16_BYTES = 2


def k1_bytes(B: int, K: int, N: int, D: int) -> int:
    """K1 (fused forward): q, k, v read and o written, B·N·K·D each."""
    return 4 * B * N * K * D * BF16_BYTES


def k1_flops(B: int, K: int, N: int, D: int) -> int:
    """QKᵀ and PV: 4·B·K·N²·D."""
    return 4 * B * K * N * N * D


def k2_bytes(B: int, K: int, N: int, D: int) -> int:
    """K2 (backward): q, k, v, o and do read, dq, dk, dv written (8 tensors)."""
    return 8 * B * N * K * D * BF16_BYTES


def k2_flops(B: int, K: int, N: int, D: int) -> int:
    """S recomputed, dV, dP, dQ and dK: 10·B·K·N²·D."""
    return 10 * B * K * N * N * D


def least_seconds(flops: int, nbytes: int, peak_flops: float,
                  peak_bytes_s: float) -> tuple[float, str]:
    """(seconds, 'bytes' or 'operations'): the bound that sets the least time."""
    t_bytes, t_ops = nbytes / peak_bytes_s, flops / peak_flops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
