"""Post-training int8 rewrite of a model for serving.

Port of ``cross_attention_vit_tpu/models/quantize.py``.
``quantize_for_inference(model)`` replaces every eligible ``nn.Linear`` in
place with an ``ops.quant.QuantLinear`` (int8 weight, f32 per-row scale,
bias; no float copy of the weight); ``ops.layers`` and
``ops.attention.self_attention`` dispatch on it, so the same forward serves
float and quantized.

Eligible, as the JAX package selects its param-tree nodes (by name, then by
``min_size`` on the element count):
  * the FFN ``fc1``/``fc2`` of every block: ``*.ffn.fn.net.0`` / ``.3``
    (ModelCross self and cross blocks) and ``transformer.layers.{i}.2.fn.net.0``
    / ``.3`` (ModelVIT);
  * the head's ``fc1``/``fc2``: ``mlp_head.{m}.0`` / ``.3`` (ModelCross),
    ``mlp_head.1`` / ``.4`` (ModelVIT) — the classifier ``fc2`` is under
    ``min_size`` in every live configuration, so the logits stay float;
  * with ``attn=True`` (the ``int8+attn`` serving mode) also the
    self-attention ``to_qkv`` and ``to_out.0``.
Never: ``patch_to_embedding`` (raw voxel rows), the cross-attention
``wq``/``wk``/``wv``/``proj``.

``int8`` is the FFN mode and ``int8+attn`` also a memory mode: it keeps no
float copy of the attention projections.  The attention itself stays float
on the attention kernels (the public ``flash_attention``: K5 at N ≤ 1040,
K7 above).
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from ..ops.quant import QuantLinear, quantize_weight
from .convert import state_dict_from_jax

# below this many elements a weight stays float (the JAX package's MIN_SIZE)
MIN_SIZE = 2 ** 16

_FFN = re.compile(r"(\.ffn\.fn\.net\.[03]|^transformer\.layers\.\d+\.2\.fn\.net\.[03]"
                  r"|^mlp_head\.\d+\.[03]|^mlp_head\.[14])$")
_ATTN = re.compile(r"\.fn\.(to_qkv|to_out\.0)$")


def _eligible(name: str, lin: nn.Module, attn: bool, min_size: int) -> bool:
    return (isinstance(lin, nn.Linear) and lin.weight.numel() >= min_size
            and bool(_FFN.search(name) or (attn and _ATTN.search(name))))


def _source_weights(model: nn.Module, source) -> dict:
    """name.weight → f32 weight: from ``source`` (a JAX param tree of numpy
    arrays, or a state dict of f32 weights), else the model's own."""
    if source is None:
        return {k: v.detach() for k, v in model.state_dict().items()}
    if "patch_to_embedding.weight" in source:
        return source
    return state_dict_from_jax(source, model.config)


@torch.no_grad()
def quantize_for_inference(model: nn.Module, attn: bool = False, min_size: int = MIN_SIZE,
                           source=None) -> nn.Module:
    """Rewrites ``model``'s eligible Linears in place into ``QuantLinear``s
    and returns it.  ``source``: the f32 values to quantize — a JAX param
    tree (``params_from_flat(...)``) or f32 master weights.  A serving
    model holds its GEMM weights cast once to the compute dtype, and
    quantizing those bf16-rounded values would give other int8 values and
    scales than the JAX package's, which quantizes the f32 checkpoint."""
    weights = _source_weights(model, source)
    chosen = [(name, mod) for name, mod in model.named_modules()
              if _eligible(name, mod, attn, min_size)]
    for name, lin in chosen:
        w = weights[f"{name}.weight"]
        w = (w.detach().float() if isinstance(w, torch.Tensor)
             else torch.from_numpy(np.asarray(w, np.float32)))
        if tuple(w.shape) != tuple(lin.weight.shape):
            raise ValueError(f"{name}: source weight {tuple(w.shape)} != "
                             f"{tuple(lin.weight.shape)}")
        wq, scale = quantize_weight(w.cpu())
        device = lin.weight.device
        bias = None if lin.bias is None else lin.bias.detach()
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, child, QuantLinear(wq.to(device), scale.to(device), bias))
    return model


def quantized_layers(model: nn.Module) -> list[QuantLinear]:
    return [m for m in model.modules() if isinstance(m, QuantLinear)]


@torch.no_grad()
def calibrate(model: nn.Module, *batches: torch.Tensor, margin: float = 1.0) -> nn.Module:
    """Static activation scales: run ``model`` on each batch while every
    quantized layer records the max |x| of its input (a running max over the
    batches), then set ``act_scale = float32(margin·amax/127)`` (1 where
    amax is 0) on each layer the batches exercised.  The capture is on only
    inside this call; the forwards use the dynamic path meanwhile."""
    layers = quantized_layers(model)
    for layer in layers:
        layer.capturing, layer.calib_amax = True, None
    try:
        for batch in batches:
            model(batch)
        captured = [(layer, layer.calib_amax) for layer in layers]
    finally:
        for layer in layers:
            layer.capturing, layer.calib_amax = False, None
    for layer, amax in captured:
        if amax is None:
            continue            # layer not exercised by the batches
        scale = np.float32(margin * amax / 127.0 if amax > 0 else 1.0)
        layer.act_scale = torch.tensor(scale, device=layer.weight_q.device)
    return model


def count_quantized(model: nn.Module) -> tuple[int, int]:
    """(quantized layers, int8 weight bytes) — for logging and /healthz."""
    layers = quantized_layers(model)
    return len(layers), sum(layer.weight_q.numel() for layer in layers)
