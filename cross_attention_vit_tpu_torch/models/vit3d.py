"""ViT3D — CNN-stem ViT with a torch post-norm transformer (legacy family).

Port of ``cross_attention_vit_tpu/models/vit3d.py`` (the reference's
modelv2.py ``ViT3D``) as an ``nn.Module``:

  * the stem is the CNN3DEncoder (modelv2.py:14-58): conv3 (stride 1, pad 1)
    + BatchNorm + ReLU + max-pool twice, then two strided conv3 + BatchNorm
    + ReLU — ÷16 spatially, ``hidden_dim`` channels, widths H/8, H/4, H/2,
    H — or a DenseNet-121 truncated at ``DENSENET_TRUNCATION``
    (``pretrained_cnn``; modelv2.py:131-141).  One stem serves every
    modality, so within one forward the BatchNorm running statistics chain
    across the modalities (JAX :207-218);
  * the tokens are the stem's channels at each spatial site, the modalities'
    sequences concatenated; an optional CLS (``add_cls_token``, default on)
    and a learned positional embedding;
  * ``nn.TransformerEncoderLayer`` semantics (modelv2.py:61-87): post-norm
    layers, fused QKV with bias, dropout on the attention probabilities and
    on both residual branches, a ReLU feed-forward of width 4·H;
  * the CLS, or the mean of the tokens, through the head LayerNorm →
    Linear(H, H/8) → Linear(H/8, classes), two Linears with no activation
    between them, as the reference has it (modelv2.py:168-172);
  * cross-entropy with label smoothing.

Parameter names are the reference modules': ``encoder.conv{i}`` /
``encoder.bn{i}`` (CNN3DEncoder) or ``encoder.features.*`` /
``encoder.class_layers.*`` (MONAI's DenseNet121), ``pos_embed``,
``cls_token``, ``transformer.layers.{i}.self_attn.in_proj_weight``,
``.in_proj_bias``, ``.out_proj.*``, ``.linear1``, ``.linear2``,
``.norm1``, ``.norm2`` (``nn.TransformerEncoderLayer``) and the head
Sequential ``mlp_head.{0,1,2}``.  The attention is the port's own ops, not
``nn.TransformerEncoderLayer``'s forward, so the rounding follows JAX's
``_mha``: the QKV product accumulated in f32, the bias added in f32 and
one cast to ``compute_dtype``.

Parameters stay float32 (f32 masters) and the transformer's GEMM operands are
cast to ``compute_dtype`` on every call, as in the JAX package; the stem's
convolutions run in float32.  BatchNorm makes the model stateful: in train
mode its forward moves the running statistics (the buffers), in eval mode it
reads them.  The attention is plain PyTorch, as JAX's is plain XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import Config
from ..ops import initializers as init_ops
from ..ops.attention import _sdpa
from ..ops.conv import batch_norm3d, conv3d, max_pool3d, relu
from ..ops.layers import dropout, dropout_bits, layernorm, linear, promote_input
from ..ops.losses import cross_entropy
from ..utils.device import resolve_device
from .densenet import DenseNet121

DENSENET_TRUNCATION = "features.denseblock3.denselayer24.layers.conv1"


def _compute_dtype(config: Config) -> torch.dtype | None:
    return None if config.compute_dtype == "float32" else getattr(torch, config.compute_dtype)


class CNN3DEncoder(nn.Module):
    """The four conv + BatchNorm + ReLU stages (modelv2.py:14-58)."""

    def __init__(self, in_channels: int, hidden: int):
        super().__init__()
        chans = [in_channels, hidden // 8, hidden // 4, hidden // 2, hidden]
        for i in range(4):
            self.add_module(f"conv{i + 1}", nn.Conv3d(chans[i], chans[i + 1], 3))
            self.add_module(f"bn{i + 1}", nn.BatchNorm3d(chans[i + 1]))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i, (stride, pool) in enumerate(((1, True), (1, True), (2, False), (2, False)),
                                           start=1):
            conv = getattr(self, f"conv{i}")
            x = conv3d(x, conv.weight, conv.bias, stride=stride, padding=1)
            x = relu(batch_norm3d(getattr(self, f"bn{i}"), x, train))
            if pool:
                x = max_pool3d(x, 2)
        return x                                   # (B, hidden, D/16, H/16, W/16)


class _SelfAttn(nn.Module):
    """``nn.MultiheadAttention``'s parameters: the fused (3H, H) input
    projection with its bias, and the output projection."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


class _EncoderLayer(nn.Module):
    """``nn.TransformerEncoderLayer``'s parameters, feed-forward 4·H."""

    def __init__(self, dim: int):
        super().__init__()
        self.self_attn = _SelfAttn(dim)
        self.linear1 = nn.Linear(dim, 4 * dim)
        self.linear2 = nn.Linear(4 * dim, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)


def _stem_geometry(config: Config, pretrained: bool) -> tuple[int, int]:
    """(tokens per modality, stem channels): ÷16 either way; the DenseNet's
    truncated conv1 emits bn_size (4) × growth channels."""
    D, H, W = config.img_size
    n_tok = (D // 16) * (H // 16) * (W // 16)
    return n_tok, (4 * config.get("growth_rate", 16) if pretrained else config.hidden_dim)


class ViT3D(nn.Module):
    """``forward(img (B, M, C, D, H, W), labels=None, train=False,
    generator=None)`` → logits (B, num_classes) float32, or (logits, loss).

    Config extras: ``num_layers``, ``add_cls_token`` (default True),
    ``pretrained_cnn`` (default False: the CNN3DEncoder), ``growth_rate``,
    ``dropout``, ``label_smoothing``.  Parameters are made on ``device``
    (default CUDA; raises on a host without it) from ``generator``;
    ``master_weights`` is accepted for the Trainer and always holds: the
    parameters are float32."""

    def __init__(self, config: Config, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None, master_weights: bool = True):
        super().__init__()
        device = resolve_device(device)
        H, M = config.hidden_dim, config.num_modalities
        self.pretrained = bool(config.get("pretrained_cnn", False))
        self.add_cls = bool(config.get("add_cls_token", True))
        n_tok, stem_ch = _stem_geometry(config, self.pretrained)
        if stem_ch != H:
            raise ValueError(
                f"transformer width must equal stem output channels: hidden_dim={H} but stem "
                f"emits {stem_ch} ({'DenseNet-trunc' if self.pretrained else 'CNN3DEncoder'})")
        if self.pretrained and M != 1:
            # the reference sizes pos_embed without the modality factor
            # (modelv2.py:154-159): its pretrained path admits one modality
            raise ValueError(f"pretrained_cnn supports num_modalities == 1 (got {M})")
        self.config = config
        self.dropout_bits = config.get("dropout_bits", "auto")   # the masks' width
        self.master_weights = True
        self.compute_dtype = _compute_dtype(config)
        num_tokens = n_tok * (1 if self.pretrained else M) + int(self.add_cls)
        with device:
            if self.pretrained:
                self.encoder = DenseNet121(config.in_channels,
                                           growth_rate=config.get("growth_rate", 16),
                                           num_classes=config.num_classes, device=device,
                                           generator=generator)
            else:
                self.encoder = CNN3DEncoder(config.in_channels, H)
            self.pos_embed = nn.Parameter(torch.empty(1, num_tokens, H))
            self.cls_token = nn.Parameter(torch.empty(1, 1, H)) if self.add_cls else None
            self.transformer = nn.Module()
            self.transformer.layers = nn.ModuleList(_EncoderLayer(H)
                                                    for _ in range(config.num_layers))
            self.mlp_head = nn.Sequential(nn.LayerNorm(H), nn.Linear(H, H // 8),
                                          nn.Linear(H // 8, config.num_classes))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Xavier-uniform stem convs (zero bias) and Linears (zero bias; the
        QKV weight drawn on its (3H, H) shape), ones/zeros norms, N(0, 0.02)
        positional embedding and CLS.  A DenseNet stem initialises itself."""
        if not self.pretrained:
            for mod in self.encoder.modules():
                if isinstance(mod, nn.Conv3d):
                    w = mod.weight
                    init_ops.xavier_uniform_(w, generator, fan_in=w.shape[1] * 27,
                                             fan_out=w.shape[0] * 27)
                    mod.bias.zero_()
                elif isinstance(mod, nn.BatchNorm3d):
                    mod.reset_parameters()
        for layer in self.transformer.layers:
            init_ops.xavier_uniform_(layer.self_attn.in_proj_weight, generator)
            layer.self_attn.in_proj_bias.zero_()
            for lin in (layer.self_attn.out_proj, layer.linear1, layer.linear2):
                init_ops.init_linear_(lin, generator)
            for norm in (layer.norm1, layer.norm2):
                init_ops.init_layernorm_(norm)
        init_ops.init_layernorm_(self.mlp_head[0])
        init_ops.init_linear_(self.mlp_head[1], generator)
        init_ops.init_linear_(self.mlp_head[2], generator)
        init_ops.normal_02_(self.pos_embed, generator)
        if self.cls_token is not None:
            init_ops.normal_02_(self.cls_token, generator)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _mha(self, attn: _SelfAttn, x: torch.Tensor, generator, train: bool) -> torch.Tensor:
        """JAX ``_mha``: QKV with bias (f32 product and bias, one cast to the
        compute dtype), softmax in f32, dropout on the probabilities, the
        output projection back in x's dtype."""
        in_dtype, rate = x.dtype, self.config.get("dropout", 0.0)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        B, N, H = x.shape
        K = self.config.num_heads
        qkv = linear(x, attn.in_proj_weight, attn.in_proj_bias).view(B, N, 3, K, H // K)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))   # (B, K, N, D)
        o = _sdpa(q, k, v, (H // K) ** -0.5, rate, generator, train)
        o = o.transpose(1, 2).reshape(B, N, H)
        return linear(o, attn.out_proj.weight, attn.out_proj.bias, out_dtype=in_dtype)

    def _layer(self, layer: _EncoderLayer, x: torch.Tensor, generator, train: bool):
        """Post-norm: x = norm1(x + drop(attn(x))); x = norm2(x + drop(ff(x)))."""
        rate, cdt = self.config.get("dropout", 0.0), self.compute_dtype
        a = self._mha(layer.self_attn, x, generator, train)
        x = layernorm(x + dropout(a, rate, generator, train), layer.norm1.weight,
                      layer.norm1.bias)
        h = relu(linear(x, layer.linear1.weight, layer.linear1.bias, cdt))
        h = dropout(h, rate, generator, train)
        h = linear(h, layer.linear2.weight, layer.linear2.bias, cdt)
        return layernorm(x + dropout(h, rate, generator, train), layer.norm2.weight,
                         layer.norm2.bias)

    def forward(self, img: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, generator: torch.Generator | None = None):
        cfg = self.config
        if train and cfg.get("dropout", 0.0) and generator is None:
            raise ValueError("train mode with dropout needs a torch.Generator on the model's "
                             "device")
        img = promote_input(img)
        B, M = img.shape[:2]
        tokens = []
        for m in range(M):          # one stem: its BN statistics chain across the streams
            if self.pretrained:
                feat = self.encoder(img[:, m], train, upto=DENSENET_TRUNCATION)
            else:
                feat = self.encoder(img[:, m], train)
            tokens.append(feat.reshape(B, feat.shape[1], -1))
        x = torch.cat(tokens, dim=2).transpose(1, 2)          # (B, N·M, C)
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, x.shape[-1]), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        with dropout_bits(self.dropout_bits):
            for layer in self.transformer.layers:
                x = self._layer(layer, x, generator, train)
        pooled = x[:, 0] if self.cls_token is not None else x.mean(dim=1)
        norm, fc1, fc2 = self.mlp_head
        h = layernorm(pooled, norm.weight, norm.bias)
        h = linear(h, fc1.weight, fc1.bias, self.compute_dtype)
        logits = linear(h, fc2.weight, fc2.bias, self.compute_dtype).float()
        if labels is None:
            return logits
        return logits, cross_entropy(logits, labels, cfg.get("label_smoothing", 0.0))
