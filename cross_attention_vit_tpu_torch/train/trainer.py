"""Train and eval steps — port of ``make_train_step`` and ``make_eval_step``
(``cross_attention_vit_tpu/train/trainer.py:90-231``).

The steps take either live family, ``ModelCross`` or ``ModelVIT``: both are
called as ``model(img, labels, train=..., generator=...)`` and return
(logits, loss).  One train step: promote the input to f32, cast it to bf16 when
``config.augment_dtype`` says so, augment it on the device (when
``config.img_aug``), promote again; the model's forward and backward in train
mode (dropout); Adam at a step-time learning rate.  It returns the aux dict
of the JAX step: loss, confusion counts, probs[:, 1] and labels.

The model, the optimizer state and the generators are objects that the step
updates in place, where the JAX step is a pure function of (params,
opt_state, rng).  ``remat_policy`` is a memory knob of the JAX step; at batch
8 the live models' activations fit on one H100 without recomputation, so the
port ignores it.  The epoch ``Trainer``, its loggers and the checkpoint
manager are a later slice.
"""

from __future__ import annotations

import torch

from ..configs import Config
from ..data.augment import AugmentConfig, augment_batch
from ..ops.layers import promote_input
from .metrics import confusion_counts
from .optim import Adam


def _aux(logits: torch.Tensor, loss: torch.Tensor, labels: torch.Tensor) -> dict:
    return {"loss": loss.detach(),
            "counts": confusion_counts(torch.argmax(logits, dim=1), labels),
            "probs": torch.softmax(logits.detach(), dim=1)[:, 1],
            "labels": labels}


def make_train_step(model: torch.nn.Module, optimizer: Adam, config: Config,
                    grad_accum: int = 1, augment_cfg: AugmentConfig = AugmentConfig()):
    """Returns ``step(img, labels, lr, generator) -> aux``.

    ``generator`` is a CPU ``torch.Generator``: each step draws from it the
    augmentation's gates and parameters and the seed of the dropout
    generator on the model's device, so one seed fixes the whole step.
    ``augmented`` (a dict attribute of the step) holds, after each step, the
    number of volumes that drew each transform."""
    if grad_accum != 1:
        raise NotImplementedError(
            f"grad_accum={grad_accum}: gradient accumulation comes with the epoch Trainer, "
            "a later slice of the PyTorch port (ROADMAP Queue 1, item 9)")
    if not getattr(model, "master_weights", False):
        raise ValueError("training needs float32 master weights: build the model with "
                         "master_weights=True")
    img_aug = bool(config.get("img_aug", False))
    aug_bf16 = config.get("augment_dtype", "float32") == "bfloat16"
    params = list(model.parameters())
    device = params[0].device

    def step(img: torch.Tensor, labels: torch.Tensor, lr: float,
             generator: torch.Generator) -> dict:
        img = promote_input(img.to(device))
        labels = labels.to(device)
        if img_aug:
            if aug_bf16:
                img = img.to(torch.bfloat16)
            step.augmented.clear()
            img = promote_input(augment_batch(img, generator, augment_cfg, step.augmented))
        dropout_gen = torch.Generator(device=device)
        dropout_gen.manual_seed(int(torch.randint(0, 2 ** 62, (), generator=generator)))
        for p in params:
            p.grad = None
        logits, loss = model(img, labels, train=True, generator=dropout_gen)
        loss.backward()
        optimizer.step(lr)
        return _aux(logits.detach(), loss, labels)

    step.augmented = {}
    return step


def make_eval_step(model: torch.nn.Module, config: Config):
    """Returns ``step(img, labels) -> aux`` (with the logits), eval mode."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(img: torch.Tensor, labels: torch.Tensor) -> dict:
        labels = labels.to(device)
        logits, loss = model(img.to(device), labels, train=False)
        return {**_aux(logits, loss, labels), "logits": logits}

    return step
