"""Evaluation driver: restore a checkpoint, run a split, report metrics — port
of ``cross_attention_vit_tpu/drivers/evaluate.py``.

The architecture config comes from the ``config*.json`` sidecar the
``CheckpointManager`` writes beside the weights (the run-tagged one first);
``config_overrides`` apply on top, and are the fallback without a sidecar.
Full-state (``params/…``, ``opt/…``, ``epoch``) and params-only npz files both
load, the JAX package's included.  Metrics and ``auc_roc`` come from the
port's ``train/metrics.py``.  Runs on one device (default CUDA).

    python -m cross_attention_vit_tpu_torch.drivers.evaluate \\
        --checkpoint runs/checkpoints/cross/epoch=..npz --model cross \\
        --labels labels.csv --data ucsf-data --img-types DWI SWI ASL --only-available
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..configs import get_mgmt_config, get_mgmt_cross_config, modify_config
from ..data.dataset import BrainDataset
from ..data.labels import clean_data, load_labels
from ..data.loader import PrefetchLoader, transfer_dtype_for
from ..models.convert import params_from_flat
from ..models.model_cross import ModelCross
from ..models.model_vit import ModelVIT
from ..train.checkpoint import load_config_for, restore_flat
from ..train.metrics import binary_auroc, compute_metrics
from ..train.trainer import Trainer
from ..utils.device import resolve_device

_FAMILIES = {"cross": (ModelCross, get_mgmt_cross_config),
             "vit": (ModelVIT, get_mgmt_config)}


def evaluate(checkpoint: str | Path, model: str, data_df, *, folder, img_types,
             config_overrides=None, batch_size: int = 8, mesh=None,
             device: str | torch.device = "cuda") -> dict:
    """The full metric dict over ``data_df`` (a ``labels.Table``), with ``n``."""
    if mesh is not None:
        raise NotImplementedError("sharded evaluation is not ported yet: a device mesh is a "
                                  "later slice of the PyTorch port (ROADMAP Queue 1, item 11)")
    device = resolve_device(device)
    model_cls, factory = _FAMILIES[model]
    cfg = load_config_for(checkpoint)
    if cfg is None:
        cfg = factory()
        modify_config(cfg, dict(num_modalities=len(img_types), dropout=0.0, lr=1e-4,
                                weight_decay=0.0, label_smoothing=0.0, attn_order={},
                                img_aug=False, optim_params={"T_max": 1, "eta_min": 0}))
    if config_overrides:
        modify_config(cfg, config_overrides)
    modify_config(cfg, {"img_aug": False})

    trainer = Trainer(model_cls, cfg, max_epochs=0, device=device)
    trainer.init_state(params_from_flat(restore_flat(checkpoint)))
    ds = BrainDataset(data_df, cfg, types=img_types, is_train=False, folder=folder)
    loader = PrefetchLoader(ds, batch_size=batch_size, num_workers=4,
                            transfer_dtype=transfer_dtype_for(cfg), device=device)
    logits, targets = trainer.test(loader)
    preds = logits.argmax(axis=1)
    metrics = {k: float(v) for k, v in compute_metrics(torch.from_numpy(preds),
                                                       torch.from_numpy(targets)).items()}
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs = (probs / probs.sum(1, keepdims=True))[:, 1]
    metrics["auc_roc"] = float(binary_auroc(torch.from_numpy(probs), torch.from_numpy(targets)))
    metrics["n"] = int(len(targets))
    return metrics


def _parse_attn_order(text: str) -> dict:
    if not text:
        return {}
    return dict(pair.split(":") for pair in text.split(","))


def main(argv=None, device: str = "cuda") -> dict:
    """The JAX CLI's flags; ``device`` is where the model runs (a keyword for
    in-process callers, not a flag)."""
    import argparse

    p = argparse.ArgumentParser(description="evaluate a checkpoint")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", choices=list(_FAMILIES), default="cross")
    p.add_argument("--labels", default="/root/reference/labels.csv")
    p.add_argument("--data", default="/root/reference/ucsf-data")
    p.add_argument("--img-types", nargs="+", default=["DWI", "SWI", "ASL"])
    p.add_argument("--attn-order", default="")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--only-available", action="store_true")
    p.add_argument("--mesh", default="", help="not ported (ROADMAP Queue 1, item 11)")
    args = p.parse_args(argv)
    resolve_device(device)
    if args.mesh:
        raise SystemExit("--mesh: sharded evaluation is not ported yet (ROADMAP Queue 1, "
                         "item 11)")

    df = clean_data(load_labels(args.labels), "MGMT status")
    if args.only_available:
        from .experiments import filter_available

        df = filter_available(df, args.data)
    overrides = {}
    if args.attn_order:
        overrides["attn_order"] = _parse_attn_order(args.attn_order)
    metrics = evaluate(args.checkpoint, args.model, df, folder=args.data,
                       img_types=tuple(args.img_types), config_overrides=overrides,
                       batch_size=args.batch_size, device=device)
    print(json.dumps(metrics, indent=1))
    return metrics


if __name__ == "__main__":
    main()
