"""3-D DenseNet-121 backbone with dotted-path truncation.

Port of ``cross_attention_vit_tpu/models/densenet.py``: the capability of
``monai.networks.nets.DenseNet121`` with ``modify_model.get_model_upto_layer``
(reference modelv2.py:131-141, modify_model.py:63-125), a DenseNet whose
forward can stop after any dotted layer path, such as the reference's live
truncation point ``features.denseblock3.denselayer24.layers.conv1``.

The module tree is MONAI's, so the reference's path strings are this
module's own ``named_modules()`` names:

  features.conv0 / norm0 / relu0 / pool0
  features.denseblock{i}.denselayer{j}.layers.{norm1,relu1,conv1,norm2,relu2,conv2}
  features.transition{i}.{norm,relu,conv,pool}
  features.norm5
  class_layers.{relu,pool,flatten,out}

``forward(x, train=False, upto=None)`` follows ``get_model_upto_layer``:
every module before the target behaves in full (a dense layer concatenates
its input to its output), the target's own dense layer runs its prefix
without the concat, and a path the network does not have raises KeyError.
In train mode each BatchNorm it runs moves its running statistics.

Init: xavier-uniform convs and the Linear (zero bias), ones/zeros norms — the
reference's ``reset_weights`` over the model (modelv2.py:89-99, 139).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from ..ops import initializers as init_ops
from ..ops.conv import (avg_pool3d, batch_norm3d, conv3d, global_avg_pool3d, max_pool3d,
                        relu)
from ..ops.layers import linear
from ..utils.device import resolve_device

BLOCK_CONFIG_121 = (6, 12, 24, 16)


def _conv(cin: int, cout: int, k: int) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, bias=False)     # DenseNet convs are bias-free


class _DenseLayer(nn.Module):
    def __init__(self, ch: int, growth: int, bn_size: int):
        super().__init__()
        self.layers = nn.Sequential(OrderedDict(
            norm1=nn.BatchNorm3d(ch), relu1=nn.ReLU(), conv1=_conv(ch, bn_size * growth, 1),
            norm2=nn.BatchNorm3d(bn_size * growth), relu2=nn.ReLU(),
            conv2=_conv(bn_size * growth, growth, 3)))


class _Done(Exception):
    """The truncation point produced its output."""

    def __init__(self, value: torch.Tensor):
        self.value = value


def _step(name: str, upto: str | None, value: torch.Tensor) -> torch.Tensor:
    if upto is not None and name == upto:
        raise _Done(value)
    return value


class DenseNet121(nn.Module):
    """``forward(x (N, C, D, H, W), train=False, upto=None)`` → logits
    (N, num_classes), or the output of the module at ``upto``.  ``paths``
    lists every dotted path in forward order and ``out_channels`` the
    channels reaching ``features.norm5`` (516 at growth 16)."""

    def __init__(self, in_channels: int = 1, growth_rate: int = 16,
                 block_config: tuple = BLOCK_CONFIG_121, bn_size: int = 4,
                 init_features: int = 64, num_classes: int = 2,
                 device: str | torch.device = "cuda", generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.block_config = tuple(block_config)
        paths = ["features.conv0", "features.norm0", "features.relu0", "features.pool0"]
        with device:
            feats = OrderedDict(conv0=_conv(in_channels, init_features, 7),
                                norm0=nn.BatchNorm3d(init_features), relu0=nn.ReLU(),
                                pool0=nn.MaxPool3d(3, 2, 1))
            ch = init_features
            for bi, n_layers in enumerate(block_config, start=1):
                block = OrderedDict()
                for li in range(1, n_layers + 1):
                    block[f"denselayer{li}"] = _DenseLayer(ch, growth_rate, bn_size)
                    paths += [f"features.denseblock{bi}.denselayer{li}.layers.{n}" for n in
                              ("norm1", "relu1", "conv1", "norm2", "relu2", "conv2")]
                    ch += growth_rate
                feats[f"denseblock{bi}"] = nn.Sequential(block)
                if bi != len(block_config):
                    feats[f"transition{bi}"] = nn.Sequential(OrderedDict(
                        norm=nn.BatchNorm3d(ch), relu=nn.ReLU(), conv=_conv(ch, ch // 2, 1),
                        pool=nn.AvgPool3d(2, 2)))
                    paths += [f"features.transition{bi}.{n}"
                              for n in ("norm", "relu", "conv", "pool")]
                    ch //= 2
            feats["norm5"] = nn.BatchNorm3d(ch)
            paths.append("features.norm5")
            self.features = nn.Sequential(feats)
            self.class_layers = nn.Sequential(OrderedDict(
                relu=nn.ReLU(), pool=nn.AdaptiveAvgPool3d(1), flatten=nn.Flatten(1),
                out=nn.Linear(ch, num_classes)))
        paths += ["class_layers.relu", "class_layers.pool", "class_layers.flatten",
                  "class_layers.out"]
        self.paths = paths
        self.out_channels = ch
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Conv3d):
                w = mod.weight
                vol = w[0, 0].numel()
                init_ops.xavier_uniform_(w, generator, fan_in=w.shape[1] * vol,
                                         fan_out=w.shape[0] * vol)
            elif isinstance(mod, nn.BatchNorm3d):
                mod.reset_parameters()
            elif isinstance(mod, nn.Linear):
                init_ops.init_linear_(mod, generator)

    def _norm(self, norm: nn.BatchNorm3d, name: str, h: torch.Tensor, train: bool,
              upto: str | None) -> torch.Tensor:
        return _step(name, upto, batch_norm3d(norm, h, train))

    def forward(self, x: torch.Tensor, train: bool = False, upto: str | None = None):
        f = self.features
        try:
            h = _step("features.conv0", upto, conv3d(x, f.conv0.weight, stride=2, padding=3))
            h = self._norm(f.norm0, "features.norm0", h, train, upto)
            h = _step("features.relu0", upto, relu(h))
            h = _step("features.pool0", upto, max_pool3d(h, 3, 2, padding=1))
            for bi in range(1, len(self.block_config) + 1):
                for li, layer in enumerate(getattr(f, f"denseblock{bi}"), start=1):
                    h = self._dense_layer(layer.layers, h, train,
                                          f"features.denseblock{bi}.denselayer{li}.layers", upto)
                if hasattr(f, f"transition{bi}"):
                    t, base = getattr(f, f"transition{bi}"), f"features.transition{bi}"
                    h = self._norm(t.norm, f"{base}.norm", h, train, upto)
                    h = _step(f"{base}.relu", upto, relu(h))
                    h = _step(f"{base}.conv", upto, conv3d(h, t.conv.weight))
                    h = _step(f"{base}.pool", upto, avg_pool3d(h, 2))
            h = self._norm(f.norm5, "features.norm5", h, train, upto)
            h = _step("class_layers.relu", upto, relu(h))
            h = _step("class_layers.pool", upto, global_avg_pool3d(h))
            h = _step("class_layers.flatten", upto, h.reshape(h.shape[0], -1))
            out = self.class_layers.out
            h = _step("class_layers.out", upto, linear(h, out.weight, out.bias))
        except _Done as done:
            return done.value
        if upto is not None:
            raise KeyError(f"layer path {upto!r} not found in DenseNet")
        return h

    def _dense_layer(self, p: nn.Sequential, x: torch.Tensor, train: bool, base: str,
                     upto: str | None) -> torch.Tensor:
        """norm1 → relu1 → conv1 → norm2 → relu2 → conv2, output concat([x, new])."""
        h = self._norm(p.norm1, f"{base}.norm1", x, train, upto)
        h = _step(f"{base}.relu1", upto, relu(h))
        h = _step(f"{base}.conv1", upto, conv3d(h, p.conv1.weight))
        h = self._norm(p.norm2, f"{base}.norm2", h, train, upto)
        h = _step(f"{base}.relu2", upto, relu(h))
        h = _step(f"{base}.conv2", upto, conv3d(h, p.conv2.weight, padding=1))
        return torch.cat([x, h], dim=1)
