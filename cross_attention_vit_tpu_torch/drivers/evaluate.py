"""Evaluation driver: restore a checkpoint, run a split, report metrics — port
of ``cross_attention_vit_tpu/drivers/evaluate.py``.

The architecture config comes from the ``config*.json`` sidecar the
``CheckpointManager`` writes beside the weights (the run-tagged one first);
``config_overrides`` apply on top, and are the fallback without a sidecar.
Full-state (``params/…``, ``opt/…``, ``epoch``) and params-only npz files both
load, the JAX package's included, a MoE model's too (its sidecar carries
``moe_experts``).  A ``seq_parallel`` config without a seq mesh runs the
dense attention, as in JAX.  Metrics and ``auc_roc`` come from the
port's ``train/metrics.py``.  Runs on one device (default CUDA), or sharded
over a mesh (``mesh=``; ``--mesh data=D,model=T`` under torchrun, one
process per card; the 'model' axis splits the heads and MLP columns): the
cohort is padded to a multiple of batch × data coordinates, each data
coordinate evaluates its share, and the outputs are gathered and trimmed,
so the metrics are the single-process ones.

    python -m cross_attention_vit_tpu_torch.drivers.evaluate \\
        --checkpoint runs/checkpoints/cross/epoch=..npz --model cross \\
        --labels labels.csv --data ucsf-data --img-types DWI SWI ASL --only-available
    torchrun --nproc-per-node 4 -m cross_attention_vit_tpu_torch.drivers.evaluate \\
        --checkpoint ... --mesh data=4
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
from ..parallel.mesh import axis_size, make_mesh, multihost_init, rank
from ..train.checkpoint import load_config_for, restore_flat
from ..train.metrics import binary_auroc, compute_metrics
from ..train.trainer import Trainer
from ..utils.device import resolve_device

_FAMILIES = {"cross": (ModelCross, get_mgmt_cross_config),
             "vit": (ModelVIT, get_mgmt_config)}


def evaluate(checkpoint: str | Path, model: str, data_df, *, folder, img_types,
             config_overrides=None, batch_size: int = 8, mesh=None,
             device: str | torch.device = "cuda") -> dict:
    """The full metric dict over ``data_df`` (a ``labels.Table``), with ``n``.
    With a mesh every rank calls it and gets the same dict; ``batch_size`` is
    per process."""
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

    trainer = Trainer(model_cls, cfg, max_epochs=0, mesh=mesh, device=device)
    trainer.init_state(params_from_flat(restore_flat(checkpoint)))
    n = len(data_df)
    if mesh is not None:
        # every rank's share a whole number of full batches; the padded rows
        # are trimmed from the outputs
        pad = (-n) % (batch_size * axis_size(mesh, "data"))
        if pad:
            data_df = data_df.take(np.resize(np.arange(n), n + pad))
    ds = BrainDataset(data_df, cfg, types=img_types, is_train=False, folder=folder)
    loader = PrefetchLoader(ds, batch_size=batch_size, num_workers=4,
                            sharding=trainer.data_sharding,
                            transfer_dtype=transfer_dtype_for(cfg), device=device)
    logits, targets = trainer.test(loader)
    logits, targets = logits[:n], targets[:n]
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
    p.add_argument("--mesh", default="",
                   help="e.g. 'data=4' or 'data=2,model=2' for sharded eval, one process per "
                        "device under torchrun")
    args = p.parse_args(argv)
    resolve_device(device)
    mesh = None
    if args.mesh:
        spec = {k: int(v) for k, v in (kv.split("=") for kv in args.mesh.split(","))}
        try:
            multihost_init(device=device)     # torchrun's environment; no-op under a group
            mesh = make_mesh(spec.get("data", -1), spec.get("model", 1))
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}") from e

    df = clean_data(load_labels(args.labels), "MGMT status")
    if args.only_available:
        from .experiments import filter_available

        df = filter_available(df, args.data)
    overrides = {}
    if args.attn_order:
        overrides["attn_order"] = _parse_attn_order(args.attn_order)
    metrics = evaluate(args.checkpoint, args.model, df, folder=args.data,
                       img_types=tuple(args.img_types), config_overrides=overrides,
                       batch_size=args.batch_size, mesh=mesh, device=device)
    if rank() == 0:
        print(json.dumps(metrics, indent=1))
    return metrics


if __name__ == "__main__":
    main()
