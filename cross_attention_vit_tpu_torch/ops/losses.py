"""Losses matching torch.nn.functional semantics (port of
``cross_attention_vit_tpu/ops/losses.py``): cross-entropy for the live
models, BCE with logits for the legacy CNN-stem ViT's single logit
(reference model.py:239)."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """F.cross_entropy with integer targets, mean reduction, in float32.

    With smoothing eps the per-sample loss is
    -(1-eps)·logp[y] - (eps/K)·Σ_c logp[c]  (torch's definition)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if label_smoothing:
        loss = (1.0 - label_smoothing) * nll + label_smoothing * -logp.mean(-1)
    else:
        loss = nll
    return loss.mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """nn.BCEWithLogitsLoss (mean reduction) in float32, the stable form
    max(x, 0) − x·y + log(1 + exp(−|x|))."""
    x, y = logits.float(), targets.float()
    return (torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()
