"""Classification metrics from confusion counts (port of
``cross_attention_vit_tpu/train/metrics.py``).

Counts are computed on the device as tensors; every derived metric is a
scalar expression of them with torchmetrics' binary definitions (a zero
denominator gives 0.0; the NPV guard of the reference's utils.py:48-52).
AUROC is the Mann-Whitney statistic with tie-averaged ranks, which equals the
trapezoidal ROC integral torchmetrics computes for binary tasks.
"""

from __future__ import annotations

import torch


def confusion_counts(preds: torch.Tensor, labels: torch.Tensor) -> dict:
    """Binary confusion counts of (B,) 0/1 predictions and labels."""
    preds, labels = preds.long(), labels.long()
    return {"tp": ((preds == 1) & (labels == 1)).sum(),
            "tn": ((preds == 0) & (labels == 0)).sum(),
            "fp": ((preds == 1) & (labels == 0)).sum(),
            "fn": ((preds == 0) & (labels == 1)).sum()}


def _safe_div(num, den) -> torch.Tensor:
    num, den = torch.as_tensor(num).float(), torch.as_tensor(den).float()
    return torch.where(den > 0, num / torch.clamp(den, min=1.0), torch.zeros_like(den))


def metrics_from_counts(c: dict) -> dict:
    """accuracy / precision / recall / specificity / f1 / npv (the metric set
    of the reference's utils.py:18-62)."""
    tp, tn, fp, fn = (c[k] for k in ("tp", "tn", "fp", "fn"))
    return {
        "accuracy": _safe_div(tp + tn, tp + tn + fp + fn),
        "precision": _safe_div(tp, tp + fp),
        "recall": _safe_div(tp, tp + fn),
        "specificity": _safe_div(tn, tn + fp),
        "f1_score": _safe_div(2 * tp, 2 * tp + fp + fn),
        "npv": _safe_div(tn, tn + fn),
    }


def compute_metrics(preds: torch.Tensor, labels: torch.Tensor) -> dict:
    """The reference's utils.compute_metrics(preds, labels)."""
    return metrics_from_counts(confusion_counts(preds, labels))


def binary_auroc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """AUROC via the Mann-Whitney U statistic with tie-averaged ranks; 0.0
    when a class is absent (torchmetrics returns NaN there)."""
    scores, labels = scores.float(), labels.float()
    n = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    s, lab = scores[order], labels[order]
    pos = torch.arange(1, n + 1, dtype=torch.float32, device=scores.device)
    new_group = torch.ones(n, dtype=torch.bool, device=scores.device)
    new_group[1:] = s[1:] != s[:-1]
    group = torch.cumsum(new_group.long(), 0) - 1
    g_sum = torch.zeros(n, device=scores.device).index_add_(0, group, pos)
    g_cnt = torch.zeros(n, device=scores.device).index_add_(0, group, torch.ones_like(pos))
    avg_rank = (g_sum / torch.clamp(g_cnt, min=1.0))[group]
    n_pos = lab.sum()
    n_neg = n - n_pos
    u = (avg_rank * lab).sum() - n_pos * (n_pos + 1) / 2.0
    denom = n_pos * n_neg
    return torch.where(denom > 0, u / torch.clamp(denom, min=1.0), torch.zeros_like(denom))


class MetricAccumulator:
    """Epoch accumulator with one host sync per epoch: ``update()`` adds the
    confusion counts and the batch-size-weighted loss as device tensors and
    keeps each batch's scores and labels where they live; ``result()``
    fetches them once.  The loss mean is weighted by batch size (Lightning's
    on_epoch aggregation); the classification metrics come from the epoch's
    confusion counts and AUROC is epoch-global, as in the JAX package."""

    def __init__(self):
        self.counts: dict | None = None
        self.loss_sum = None
        self.n = 0
        self.scores: list[torch.Tensor] = []
        self.labels: list[torch.Tensor] = []

    def update(self, loss, counts: dict, scores, labels) -> None:
        bs = int(labels.shape[0])
        w_loss = loss.detach().float() * bs
        if self.counts is None:
            self.counts = dict(counts)
            self.loss_sum = w_loss
        else:
            self.counts = {k: self.counts[k] + counts[k] for k in counts}
            self.loss_sum = self.loss_sum + w_loss
        self.n += bs
        self.scores.append(scores.detach())
        self.labels.append(labels.detach())

    def result(self) -> dict:
        if self.counts is None:
            return {}
        counts = {k: v.cpu() for k, v in self.counts.items()}
        out = {k: float(v) for k, v in metrics_from_counts(counts).items()}
        out["loss"] = float(self.loss_sum.cpu()) / max(self.n, 1)
        out["auc_roc"] = float(binary_auroc(torch.cat(self.scores).cpu(),
                                            torch.cat(self.labels).cpu()))
        return out
