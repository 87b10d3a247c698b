"""Where the batch's dtype is decided on the train step's path, on the CPU at
tiny widths: each of ModelCross, ModelVIT and SwinViT3D casts its input
once, at entry, to its activation dtype, so a bf16 batch and its f32 copy
give the same logits and loss, bit for bit; the train step casts the batch
only for the augmentation, once, to ``config.augment_dtype``, and hands the
result to the model as it is, so a step on a bf16 batch and one on its f32
copy end with the same loss and parameters, bit for bit."""

from __future__ import annotations

import pytest
import torch

from cross_attention_vit_tpu_torch.configs import (get_mgmt_config, get_mgmt_cross_config,
                                                   get_swin3d_config, modify_config)
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.models.swin3d import SwinViT3D
from cross_attention_vit_tpu_torch.train import trainer
from cross_attention_vit_tpu_torch.train.optim import Adam

FAMILIES = {
    "cross": (ModelCross, get_mgmt_cross_config,
              dict(hidden_dim=32, mlp_dim=64, num_heads=2, num_multi_blocks=1,
                   num_self_blocks=1, img_size=(16, 16, 8), patch_size=(8, 8, 8),
                   num_modalities=2, attn_order={"0": "1", "1": "0"})),
    "vit": (ModelVIT, get_mgmt_config,
            dict(hidden_dim=32, mlp_dim=64, num_heads=2, num_layers=1, img_size=(16, 16, 8),
                 patch_size=(8, 8, 8), num_modalities=2)),
    "swin3d": (SwinViT3D, get_swin3d_config,
               dict(feature_size=8, swin_heads=(1, 2, 2, 4), img_size=(12, 10, 8))),
}


def _model(family: str, activation_dtype: str, **fields):
    cls, get_config, tiny = FAMILIES[family]
    cfg = get_config()
    modify_config(cfg, {**tiny, "compute_dtype": activation_dtype,
                        "activation_dtype": activation_dtype, "use_flash_attention": True,
                        **fields})
    return cls(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
               master_weights=True), cfg


def _bf16_batch(cfg, b: int = 2, seed: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator().manual_seed(seed)
    img = torch.randn((b, cfg.num_modalities, 1, *cfg.img_size), generator=gen) * 100
    return img.to(torch.bfloat16), torch.tensor([0, 1] * (b // 2))


@pytest.mark.parametrize("activation_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_bf16_batch_and_its_f32_copy_give_the_same_logits_and_loss(family, activation_dtype):
    model, cfg = _model(family, activation_dtype)
    img, labels = _bf16_batch(cfg)
    with torch.no_grad():
        got = model(img, labels)
        want = model(img.float(), labels)
    assert got[0].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("augment_dtype", ["bfloat16", "float32", None])
def test_the_step_casts_the_batch_once_for_the_augmentation_only(augment_dtype, monkeypatch):
    """``augment_dtype`` None: no augmentation.  The recorders see the dtype
    the configuration names, and a bf16 batch reaches the augmentation or
    the model without a copy where that dtype is bf16."""
    fields = ({"img_aug": False} if augment_dtype is None
              else {"img_aug": True, "augment_dtype": augment_dtype})
    seen = {"augment": [], "model": []}
    augment = trainer.augment_batch

    def record_augment(img, *args):
        seen["augment"].append(img)
        return augment(img, *args)

    monkeypatch.setattr(trainer, "augment_batch", record_augment)

    def run(batch: torch.Tensor):
        model, cfg = _model("cross", "bfloat16", dropout=0.25, **fields)
        model.register_forward_pre_hook(lambda module, args: seen["model"].append(args[0]))
        step = trainer.make_train_step(model, Adam(model.parameters(), 5e-4), cfg)
        aux = step(batch, labels, 1e-3, torch.Generator().manual_seed(1))
        return aux["loss"], model.state_dict()

    img, labels = _bf16_batch(_model("cross", "bfloat16")[1], b=4)
    loss_bf16, params_bf16 = run(img)
    want = torch.float32 if augment_dtype == "float32" else torch.bfloat16
    if augment_dtype is None:
        assert seen["augment"] == []
        assert seen["model"][0].data_ptr() == img.data_ptr()
    else:
        assert seen["augment"][0].dtype == want
        if want == torch.bfloat16:
            assert seen["augment"][0].data_ptr() == img.data_ptr()
    assert seen["model"][0].dtype == want

    loss_f32, params_f32 = run(img.float())
    assert torch.equal(loss_bf16, loss_f32)
    assert all(torch.equal(params_bf16[k], params_f32[k]) for k in params_bf16)
