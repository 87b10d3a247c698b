"""Analytic matmul-FLOP counts for the live models — the numerator of MFU.

Port of ``cross_attention_vit_tpu/utils/flops.py``: the same integer counts.
Multiply-accumulates ×2 for every GEMM on the forward path (elementwise
ops, softmax and LayerNorm are bandwidth-, not FLOP-, dominated and are
excluded, per the usual MFU convention).  Training steps are counted as
3× forward (backward ≈ 2× forward for matmul-dominated graphs).

The peak is the card's: the JAX module's table lists TPUs; this one lists
the NVIDIA H100 SXM (dense bf16, NVIDIA's data sheet), keyed on
``torch.cuda.get_device_name()``.  A card not in the table raises, so an
MFU is never reported against a peak of another part.

Reference geometry being costed: model_cross.py:186-212 / modelv3.py:123-147.
"""

from __future__ import annotations


def _patches(cfg) -> int:
    return ((cfg.img_size[0] // cfg.patch_size[0])
            * (cfg.img_size[1] // cfg.patch_size[1])
            * (cfg.img_size[2] // cfg.patch_size[2]))


def _self_block_flops(n: int, d: int, mlp: int) -> int:
    """One pre-norm self-attention block over an n-token stream."""
    qkv = 2 * n * d * 3 * d
    scores = 2 * n * n * d          # QKᵀ over all heads
    av = 2 * n * n * d
    out = 2 * n * d * d
    ffn = 2 * n * d * mlp * 2
    return qkv + scores + av + out + ffn


def _cross_block_flops(n: int, d: int, mlp: int) -> int:
    """CLS-query cross-attention block: q is 1 token, k/v span n tokens
    (reference model_cross.py:74-114)."""
    wq = 2 * 1 * d * d
    wkv = 2 * n * d * d * 2
    scores = 2 * 1 * n * d
    av = 2 * 1 * n * d
    proj = 2 * 1 * d * d
    ffn = 2 * 1 * d * mlp * 2
    return wq + wkv + scores + av + proj + ffn


def model_cross_fwd_flops(cfg, batch: int) -> int:
    """Forward matmul FLOPs of ModelCross for one batch."""
    m = cfg.num_modalities
    n_p = _patches(cfg)
    n = n_p + 1  # + CLS
    d, mlp = cfg.hidden_dim, cfg.mlp_dim
    p1, p2, p3 = cfg.patch_size
    patch_dim = p1 * p2 * p3 * cfg.in_channels

    embed = m * 2 * n_p * patch_dim * d
    n_self = cfg.num_multi_blocks * m * cfg.num_self_blocks
    n_cross = cfg.num_multi_blocks * len(cfg.attn_order)
    blocks = (n_self * _self_block_flops(n, d, mlp)
              + n_cross * _cross_block_flops(n, d, mlp))
    heads = m * 2 * (d * mlp + mlp * cfg.num_classes)  # per-modality CLS MLP
    return batch * (embed + blocks + heads)


def model_vit_fwd_flops(cfg, batch: int) -> int:
    """Forward matmul FLOPs of ModelVIT: one concatenated stream of
    num_patches·M + 1 tokens through num_layers blocks (modelv3.py:123-147)."""
    m = cfg.num_modalities
    n_p = _patches(cfg)
    n = n_p * m + 1
    d, mlp = cfg.hidden_dim, cfg.mlp_dim
    p1, p2, p3 = cfg.patch_size
    patch_dim = p1 * p2 * p3 * cfg.in_channels

    embed = m * 2 * n_p * patch_dim * d
    blocks = cfg.num_layers * _self_block_flops(n, d, mlp)
    head = 2 * (d * mlp + mlp * cfg.num_classes)
    return batch * (embed + blocks + head)


def train_flops(fwd_flops: int) -> int:
    """fwd + bwd ≈ 3× fwd for GEMM-dominated graphs (bwd does two matmuls
    per forward matmul); the Adam update is elementwise and excluded."""
    return 3 * fwd_flops


# dense bf16 peak matmul throughput per card, FLOP/s, by a fragment of
# torch.cuda.get_device_name(): NVIDIA's H100 SXM data sheet (700 W)
_PEAK_BF16 = (
    ("H100 80GB HBM3", 989.4e12),     # the SXM part's name under CUDA
    ("H100 SXM", 989.4e12),
)


def chip_peak_bf16_flops(device_name: str | None = None) -> float:
    """Dense bf16 peak FLOP/s of the card named ``device_name`` (default:
    CUDA device 0's name).  Raises ValueError for a card not in the table."""
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name(0)
    for tag, peak in _PEAK_BF16:
        if tag in device_name:
            return peak
    raise ValueError(f"no bf16 peak known for {device_name!r}: the table lists "
                     f"{[tag for tag, _ in _PEAK_BF16]}")


def mfu(flops_per_step: int, step_seconds: float, device_name: str | None = None) -> float:
    """Model FLOP utilisation: achieved FLOP/s over the card's bf16 peak."""
    return flops_per_step / step_seconds / chip_peak_bf16_flops(device_name)
