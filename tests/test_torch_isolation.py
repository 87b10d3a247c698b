"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package, nor the host libraries the card's host lacks (pandas, scikit-learn,
ml_dtypes, tensorboardX), and its entry points run on CUDA unless the caller
asks for the CPU — on a host without CUDA they raise instead of quietly
running there."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from cross_attention_vit_tpu_torch.configs import (get_mgmt_config, get_mgmt_cross_config,
                                                   modify_config)
from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import cross_attention_vit_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # noqa: F401  (imports the port only; main() is not run)
        banned = ("jax", "jaxlib", "cross_attention_vit_tpu", "pandas", "sklearn",
                  "ml_dtypes", "tensorboardX")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
        new = {pkg.__name__ + ".parallel." + m for m in ("moe", "ring", "tensor", "pipeline")}
        print(len(names), bad, sorted(new - set(names)))
        sys.exit(1 if bad or len(names) < 43 or not new <= set(names) else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")


def _tiny():
    cfg = get_mgmt_cross_config()
    modify_config(cfg, dict(hidden_dim=32, mlp_dim=64, num_heads=4, num_multi_blocks=1,
                            num_self_blocks=1, img_size=(16, 16, 8), patch_size=(8, 8, 8),
                            num_modalities=2, attn_order={"0": "1"}))
    return cfg


def _tiny_vit():
    cfg = get_mgmt_config()
    modify_config(cfg, dict(hidden_dim=32, mlp_dim=64, num_heads=4, num_layers=1,
                            img_size=(16, 16, 8), patch_size=(8, 8, 8), num_modalities=2))
    return cfg


def test_resolve_device_raises_without_cuda():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelCross(_tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelCross(_tiny(), master_weights=True)    # the training model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelCross(_tiny(), device="cpu").to(resolve_device())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelVIT(_tiny_vit())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelVIT(_tiny_vit(), master_weights=True)


def test_server_defaults_to_cuda_and_raises_without_it(tmp_path):
    _no_cuda()
    from cross_attention_vit_tpu_torch.models.convert import jax_params_from_model
    from cross_attention_vit_tpu_torch.train.checkpoint import save_config, save_pytree

    cfg = _tiny()
    path = tmp_path / "epoch=00-val_loss=0.5000.npz"
    save_pytree(path, {"params": jax_params_from_model(ModelCross(cfg, device="cpu"))})
    save_config(tmp_path, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(path, img_types=("T1c", "T2"))
    srv = InferenceServer(path, img_types=("T1c", "T2"), device="cpu")
    assert srv.device.type == "cpu"
    x = np.zeros((1, 2, 1, 16, 16, 8), np.float32)
    assert srv._run_padded(x, 1).shape == (1, 2)


def test_vit_server_defaults_to_cuda_and_raises_without_it(tmp_path):
    _no_cuda()
    from cross_attention_vit_tpu_torch.models.convert import jax_params_from_model
    from cross_attention_vit_tpu_torch.train.checkpoint import save_config, save_pytree

    cfg = _tiny_vit()
    path = tmp_path / "epoch=00-val_loss=0.5000.npz"
    save_pytree(path, {"params": jax_params_from_model(ModelVIT(cfg, device="cpu"))})
    save_config(tmp_path, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(path, "vit", img_types=("T1c", "T2"))
    srv = InferenceServer(path, "vit", img_types=("T1c", "T2"), device="cpu")
    assert srv.device.type == "cpu" and isinstance(srv.model, ModelVIT)
    x = np.zeros((1, 2, 1, 16, 16, 8), np.float32)
    assert srv._run_padded(x, 1).shape == (1, 2)


def _cli_cohort(root: Path) -> tuple[Path, Path]:
    """A labels CSV and one subject's volumes for the driver entry points."""
    from cross_attention_vit_tpu_torch.data.nifti import write_volume

    case = "UCSF-PDGM-0001"
    (root / "data" / f"{case}_nifti").mkdir(parents=True)
    for m in ("DWI", "SWI", "ASL"):
        write_volume(root / "data" / f"{case}_nifti" / f"{case}_{m}.nii.gz",
                     np.zeros((8, 8, 8), np.int16))
    (root / "labels.csv").write_text("ID,MGMT status\nUCSF-PDGM-1,positive\n")
    return root / "labels.csv", root / "data"


def _trainable(cfg):
    """The training fields every grid point sets (lr, schedule, decay)."""
    modify_config(cfg, {"lr": 1e-4, "weight_decay": 0.0, "label_smoothing": 0.0,
                        "optim_params": {"T_max": 1, "eta_min": 0.0}})
    return cfg


def test_trainer_and_loader_default_to_cuda_and_raise_without_it():
    _no_cuda()
    from cross_attention_vit_tpu_torch.data.loader import PrefetchLoader
    from cross_attention_vit_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(ModelCross, _trainable(_tiny()), max_epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrefetchLoader([], batch_size=1)
    trainer = Trainer(ModelCross, _trainable(_tiny()), max_epochs=1, device="cpu")
    assert trainer.device.type == "cpu"


def test_experiments_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    _no_cuda()
    from cross_attention_vit_tpu_torch.drivers import experiments

    labels, data = _cli_cohort(tmp_path)
    args = ["--model", "cross", "--grid-index", "0", "--seeds", "2004", "--epochs", "1",
            "--labels", str(labels), "--data", str(data), "--out", str(tmp_path / "runs")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        experiments.main(args)
    assert not (tmp_path / "runs").exists()


def test_evaluate_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    _no_cuda()
    from cross_attention_vit_tpu_torch.drivers import evaluate
    from cross_attention_vit_tpu_torch.models.convert import jax_params_from_model
    from cross_attention_vit_tpu_torch.train.checkpoint import save_config, save_pytree

    labels, data = _cli_cohort(tmp_path)
    cfg = _trainable(_tiny())
    modify_config(cfg, {"num_modalities": 3, "img_size": (8, 8, 8), "patch_size": (8, 8, 8),
                        "attn_order": {}})
    path = tmp_path / "epoch=00-val_loss=0.5000.npz"
    save_pytree(path, {"params": jax_params_from_model(ModelCross(cfg, device="cpu"))})
    save_config(tmp_path, cfg)
    args = ["--checkpoint", str(path), "--labels", str(labels), "--data", str(data)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(args)
    assert evaluate.main(args, device="cpu")["n"] == 1


def test_expert_and_sequence_parallel_entry_points_default_to_cuda(tmp_path):
    """The MoE and SP models, their Trainer and the CLI's --ep/--sp default
    to CUDA and raise without it; nothing carries on on the CPU."""
    _no_cuda()
    from cross_attention_vit_tpu_torch.drivers import experiments
    from cross_attention_vit_tpu_torch.train.trainer import Trainer

    for fields in ({"moe_experts": 4}, {"seq_parallel": 2}):
        cfg = _trainable(modify_config(_tiny(), fields))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ModelCross(cfg, master_weights=True)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ModelVIT(modify_config(_tiny_vit(), fields))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(ModelCross, cfg, max_epochs=1)
    labels, data = _cli_cohort(tmp_path)
    for flags in (["--ep", "2", "--set", "moe_experts=4"], ["--sp", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            experiments.main(["--labels", str(labels), "--data", str(data), "--out",
                              str(tmp_path / "runs"), *flags])
    assert not (tmp_path / "runs").exists()


LEGACY_MODULES = ("ops.conv", "models.densenet", "models.vit3d", "models.cnn_vit",
                  "models.surgery", "data.dicom", "data.dataset_rsna", "drivers.legacy",
                  "drivers.convert", "utils.profiling", "utils.misc")


def test_legacy_modules_import_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {LEGACY_MODULES!r}:
            importlib.import_module("cross_attention_vit_tpu_torch." + name)
        banned = ("jax", "jaxlib", "cross_attention_vit_tpu", "pandas", "sklearn", "cv2",
                  "ml_dtypes", "tensorboardX")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_jax_module_has_a_port_counterpart():
    """Each module of the JAX package has a port file of the same path."""
    jax_pkg, port = ROOT / "cross_attention_vit_tpu", ROOT / "cross_attention_vit_tpu_torch"
    missing = sorted(str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*.py")
                     if not (port / p.relative_to(jax_pkg)).is_file())
    assert missing == []


def _legacy_cfg():
    cfg = get_mgmt_config()
    modify_config(cfg, dict(hidden_dim=32, num_heads=4, num_layers=1, img_size=(32, 32, 16),
                            num_modalities=1))
    return cfg


def test_legacy_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """ViT3D, CNNViT, DenseNet121, the legacy drivers, the convert CLI and
    profile_trace default to CUDA and raise here before writing anything."""
    _no_cuda()
    from cross_attention_vit_tpu_torch.drivers import convert, legacy
    from cross_attention_vit_tpu_torch.models.cnn_vit import CNNViT
    from cross_attention_vit_tpu_torch.models.densenet import DenseNet121
    from cross_attention_vit_tpu_torch.models.vit3d import ViT3D
    from cross_attention_vit_tpu_torch.train.trainer import Trainer
    from cross_attention_vit_tpu_torch.utils.profiling import profile_trace

    cfg = _legacy_cfg()
    for build in (lambda: ViT3D(cfg), lambda: CNNViT(cfg), lambda: DenseNet121(),
                  lambda: Trainer(ViT3D, cfg, max_epochs=1, stateful=True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    labels, data = _cli_cohort(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        legacy.train_vit3d(labels_csv=labels, folder=data, out_dir=tmp_path / "runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        legacy.train_rsna(labels_csv=labels, folder=data, out_dir=tmp_path / "runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.main(["--torch-ckpt", str(tmp_path / "none.ckpt"), "--out",
                      str(tmp_path / "runs" / "m.npz")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profile_trace(tmp_path / "runs" / "trace"):
            pass
    assert not (tmp_path / "runs").exists()
    assert ViT3D(cfg, device="cpu").pos_embed.device.type == "cpu"
