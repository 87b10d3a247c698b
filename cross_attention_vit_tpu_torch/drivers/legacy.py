"""Legacy-phase drivers — port of ``cross_attention_vit_tpu/drivers/legacy.py``.

``train_vit3d`` is the stale single-model driver (reference main.py:104-187):
ViT3D with one Params entry (lr 1e-4, dropout 0.1, T1c only), the weighted
sampler, top-3 checkpoints monitored on **train_loss** (main.py:27-33),
ReduceLROnPlateau (the schedule ViT3D declares, modelv2.py:280-292), the
stateful Trainer.

``train_rsna`` is the earliest Kaggle phase (reference other_model.py:359-444
``train_mri_type`` and its hand-rolled trainer): DICOM series → the
biggest-slice window → a cubic-patch ModelVIT ((32, 32, 32) patches over the
(size, size, num_imgs) stack, other_model.py:191) → per-type training, then
``Trainer.predict``'s probabilities on the validation cases.

Labels are read without pandas and split without scikit-learn
(``data/labels.py``): the row order equals the JAX driver's.  Each driver
runs on ``device`` (default CUDA; raises without it).
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..configs import get_mgmt_config, modify_config
from ..data.dataset import BrainDataset, WeightedRandomSampler, create_sampler_weights
from ..data.dataset_rsna import RSNADataset
from ..data.labels import clean_data, load_labels, train_test_split
from ..data.loader import PrefetchLoader
from ..models.model_vit import ModelVIT
from ..models.vit3d import ViT3D
from ..train.checkpoint import CheckpointManager
from ..train.loggers import CSVLogger, MultiLogger, TensorBoardLogger
from ..train.trainer import Trainer
from ..utils.device import resolve_device


def train_vit3d(*, labels_csv="labels.csv", folder="ucsf-data", out_dir="runs", run=1,
                max_epochs=150, batch_size=8, img_types=("T1c",), seed=909, verbose=True,
                overrides=None, only_available=False, device: str | torch.device = "cuda"):
    """Returns (trainer, history)."""
    device = resolve_device(device)
    cfg = get_mgmt_config()
    modify_config(cfg, dict(lr=1e-4, dropout=0.1, weight_decay=5e-4, label_smoothing=0.0,
                            img_aug=False, num_modalities=len(img_types),
                            optim_params={"factor": 0.5, "patience": 10, "type": "val_loss"}))
    if overrides:
        modify_config(cfg, overrides)
    data = clean_data(load_labels(labels_csv), cfg.target)
    if only_available:
        from .experiments import filter_available

        data = filter_available(data, folder)
    train_df, val_df = train_test_split(data, 0.15, seed)

    out = Path(out_dir)
    run_name = f"vit3d_{run}"
    trainer = Trainer(
        ViT3D, cfg, max_epochs=max_epochs, stateful=True, schedule="plateau",
        checkpoint=CheckpointManager(out / "checkpoints" / "vit3d", monitor="train_loss",
                                     save_top_k=3, mode="min", tag=run_name),
        checkpoint_monitor="train_loss",
        logger=MultiLogger(TensorBoardLogger(out / "lightning_logs", run_name),
                           CSVLogger(out / "csv_logs", run_name)),
        seed=seed, device=device)
    sampler = WeightedRandomSampler(create_sampler_weights(train_df, cfg.target),
                                    num_samples=len(train_df), seed=seed)
    train_loader = PrefetchLoader(
        BrainDataset(train_df, cfg, types=img_types, is_train=True, folder=folder),
        batch_size=batch_size, num_workers=5, device=device)
    val_loader = PrefetchLoader(
        BrainDataset(val_df, cfg, types=img_types, is_train=False, folder=folder),
        batch_size=batch_size, num_workers=5, device=device)
    history = trainer.fit(train_loader, val_loader, sampler=sampler, verbose=verbose)
    return trainer, history


def rsna_config(num_imgs: int = 64, size: int = 256, **overrides):
    """Cubic-patch geometry over the DICOM slice stack: a (size, size,
    num_imgs) volume in (32, 32, 32) patches (reference other_model.py:187-232)."""
    cfg = get_mgmt_config()
    modify_config(cfg, dict(img_size=(size, size, num_imgs), patch_size=(32, 32, 32),
                            hidden_dim=512, mlp_dim=2048, num_heads=8, num_layers=4,
                            num_modalities=1, num_classes=2, dropout=0.1, lr=1e-4,
                            weight_decay=0.0, label_smoothing=0.0, img_aug=False,
                            optim_params={"T_max": 20, "eta_min": 1e-6}))
    modify_config(cfg, overrides)
    return cfg


def train_rsna(*, labels_csv, folder, out_dir="runs", mri_type="FLAIR", num_imgs=64, size=256,
               max_epochs=20, batch_size=4, seed=0, verbose=True, overrides=None,
               device: str | torch.device = "cuda"):
    """Per-MRI-type training over DICOM cases, then sigmoid-style positive
    probabilities on the validation cases (the train_mri_type / predict
    pipeline, other_model.py:359-503).  Returns (trainer, history, preds).
    The CSV's ``ID`` column stays a zero-padded string, the folders' names."""
    device = resolve_device(device)
    cfg = rsna_config(num_imgs=num_imgs, size=size, **(overrides or {}))
    train_df, val_df = train_test_split(load_labels(labels_csv), 0.2, seed)

    out = Path(out_dir)
    run_name = f"rsna_{mri_type}"
    trainer = Trainer(
        ModelVIT, cfg, max_epochs=max_epochs,
        checkpoint=CheckpointManager(out / "checkpoints" / "rsna", monitor="val_loss",
                                     save_top_k=1, mode="min", tag=run_name),
        logger=MultiLogger(CSVLogger(out / "csv_logs", run_name)), seed=seed, device=device)
    train_loader = PrefetchLoader(
        RSNADataset(train_df, mri_type=mri_type, folder=folder, num_imgs=num_imgs, size=size),
        batch_size=batch_size, num_workers=4, device=device)
    val_loader = PrefetchLoader(
        RSNADataset(val_df, mri_type=mri_type, folder=folder, num_imgs=num_imgs, size=size),
        batch_size=batch_size, num_workers=4, device=device)
    history = trainer.fit(train_loader, val_loader, verbose=verbose)
    preds = trainer.predict(val_loader)
    return trainer, history, preds
