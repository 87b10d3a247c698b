"""Matmul FLOPs of the live models (a frozen copy of the port's
``utils/flops.py``): two FLOPs a multiply-accumulate of every GEMM and
attention product on the forward path; elementwise work, softmax and
LayerNorm are left out; a training step counts as three forwards.

``cfg`` is a mapping of the configuration file's fields.  A model family's
``forward_flops`` (``families/<family>.py``) calls its count here."""

from __future__ import annotations


def patches(cfg) -> int:
    (d, h, w), (p1, p2, p3) = cfg["img_size"], cfg["patch_size"]
    return (d // p1) * (h // p2) * (w // p3)


def _patch_dim(cfg) -> int:
    p1, p2, p3 = cfg["patch_size"]
    return p1 * p2 * p3 * cfg["in_channels"]


def self_block(n: int, d: int, mlp: int) -> int:
    """One pre-norm self-attention block over n tokens: QKV, QKᵀ, AV, the
    output projection and the two FFN GEMMs."""
    return 2 * n * d * 3 * d + 2 * n * n * d + 2 * n * n * d + 2 * n * d * d + 2 * n * d * mlp * 2


def cross_block(n: int, d: int, mlp: int) -> int:
    """The CLS-query cross block: one query token against n keys."""
    return (2 * d * d + 2 * n * d * d * 2 + 2 * n * d + 2 * n * d + 2 * d * d
            + 2 * d * mlp * 2)


def model_cross_fwd(cfg, batch: int) -> int:
    m, n_p = cfg["num_modalities"], patches(cfg)
    n, d, mlp = n_p + 1, cfg["hidden_dim"], cfg["mlp_dim"]
    embed = m * 2 * n_p * _patch_dim(cfg) * d
    n_self = cfg["num_multi_blocks"] * m * cfg["num_self_blocks"]
    n_cross = cfg["num_multi_blocks"] * len(cfg["attn_order"])
    heads = m * 2 * (d * mlp + mlp * cfg["num_classes"])
    return batch * (embed + n_self * self_block(n, d, mlp) + n_cross * cross_block(n, d, mlp)
                    + heads)


def model_vit_fwd(cfg, batch: int) -> int:
    m, n_p = cfg["num_modalities"], patches(cfg)
    n, d, mlp = n_p * m + 1, cfg["hidden_dim"], cfg["mlp_dim"]
    embed = m * 2 * n_p * _patch_dim(cfg) * d
    head = 2 * (d * mlp + mlp * cfg["num_classes"])
    return batch * (embed + cfg["num_layers"] * self_block(n, d, mlp) + head)


def train_step(forward: int) -> int:
    """Matmul FLOPs of one training step whose forward is ``forward``: 3×."""
    return 3 * forward
