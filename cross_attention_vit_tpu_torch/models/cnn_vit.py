"""CNN-stem ViT (v1 legacy family): UNet-style stem, Conv3d patch embed,
pre-norm encoder and a single-logit BCE head.

Port of ``cross_attention_vit_tpu/models/cnn_vit.py`` (the reference's
model.py ``ViT``) as an ``nn.Module``:

  * the CNNEncoder (model.py:55-75): DoubleConv(in → c0), then two Down
    blocks (max-pool 2 + DoubleConv) — ÷4 spatially, ``encoder_channels[2]``
    channels; conv + ReLU only, no BatchNorm, so the model is stateless;
  * the embeddings (model.py:79-104): a Conv3d patch embed with kernel =
    stride = ``patches_grid``, flattened, behind a CLS (zeros at init) with a
    positional embedding (N(0, 1) at init: model.py:89 draws randn);
  * the modalities' embeddings concatenated, the CLS kept from stream 0 only
    (model.py:258);
  * the encoder (model.py:181-214): pre-norm blocks with eps 1e-6
    LayerNorms, separate biased q/k/v projections, a GELU MLP, and a final
    encoder LayerNorm;
  * the head Linear(hidden_size, 1) on the CLS, squeezed, with
    BCEWithLogits (model.py:223, 239, 275, 286).

Parameter names follow the JAX param tree (``stem.{inc,down1,down2}.conv{1,2}``,
``patch_embed``, ``cls_token``, ``pos_embed``,
``blocks.{i}.{attn_norm,q,k,v,out,ffn_norm,fc1,fc2}``, ``encoder_norm``,
``final``), with torch's ``weight`` for a kernel or scale.  Everything runs in
float32, as the JAX model does (it reads no ``compute_dtype``).

Config keys with their defaults: hidden_size (128), patches_grid ((8, 8, 8)),
transformer_num_layers (4), transformer_num_heads (8), transformer_mlp_dim
(512), transformer_dropout_rate (0.0), transformer_attention_dropout_rate
(0.0), encoder_channels, down_factor.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..configs import Config
from ..ops import initializers as init_ops
from ..ops.conv import conv3d, max_pool3d, relu
from ..ops.layers import dropout, dropout_bits, gelu, layernorm, linear, promote_input
from ..ops.losses import bce_with_logits
from ..utils.device import resolve_device


def _defaults(config: Config) -> dict:
    return {"hidden_size": config.get("hidden_size", 128),
            "grid": tuple(config.get("patches_grid", (8, 8, 8))),
            "num_layers": config.get("transformer_num_layers", 4),
            "num_heads": config.get("transformer_num_heads", 8),
            "mlp_dim": config.get("transformer_mlp_dim", 512),
            "drop": config.get("transformer_dropout_rate", 0.0),
            "attn_drop": config.get("transformer_attention_dropout_rate", 0.0)}


class _DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, cout, 3)
        self.conv2 = nn.Conv3d(cout, cout, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = relu(conv3d(x, self.conv1.weight, self.conv1.bias, padding=1))
        return relu(conv3d(x, self.conv2.weight, self.conv2.bias, padding=1))


class _Block(nn.Module):
    def __init__(self, H: int, mlp: int):
        super().__init__()
        self.attn_norm = nn.LayerNorm(H, eps=1e-6)
        self.q, self.k, self.v, self.out = (nn.Linear(H, H) for _ in range(4))
        self.ffn_norm = nn.LayerNorm(H, eps=1e-6)
        self.fc1 = nn.Linear(H, mlp)
        self.fc2 = nn.Linear(mlp, H)


class CNNViT(nn.Module):
    """``forward(img (B, M, C, D, H, W), labels=None, train=False,
    generator=None)`` → logits (B,) float32 (one BCE logit a sample), or
    (logits, loss) with float labels.  Parameters are made on ``device``
    (default CUDA; raises on a host without it) from ``generator``."""

    def __init__(self, config: Config, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        d = self.opts = _defaults(config)
        self.dropout_bits = config.get("dropout_bits", "auto")   # the masks' width
        H, g = d["hidden_size"], d["grid"]
        c0, c1, c2 = config.encoder_channels
        D, Hh, W = config.img_size
        down = 2 ** config.down_factor
        n_patches = (D // (down * g[0])) * (Hh // (down * g[1])) * (W // (down * g[2]))
        with device:
            self.stem = nn.ModuleDict({"inc": _DoubleConv(config.in_channels, c0),
                                       "down1": _DoubleConv(c0, c1),
                                       "down2": _DoubleConv(c1, c2)})
            self.patch_embed = nn.Conv3d(c2, H, g, stride=g)
            self.cls_token = nn.Parameter(torch.empty(1, 1, H))
            self.pos_embed = nn.Parameter(torch.empty(1, n_patches + 1, H))
            self.blocks = nn.ModuleList(_Block(H, d["mlp_dim"]) for _ in range(d["num_layers"]))
            self.encoder_norm = nn.LayerNorm(H, eps=1e-6)
            self.final = nn.Linear(H, 1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Kaiming-normal (fan-out) convs with zero bias, xavier-normal
        Linears with zero bias, ones/zeros norms, a zero CLS and an N(0, 1)
        positional embedding (JAX :103-130)."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv3d):
                init_ops.kaiming_normal_fan_out_(mod.weight, mod.weight[:, 0].numel(), generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                init_ops.xavier_normal_(mod.weight, generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                init_ops.init_layernorm_(mod)
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 1.0, generator=generator)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _embed(self, vol: torch.Tensor) -> torch.Tensor:
        """CNN stem → Conv3d patch embed → CLS + pos (model.py:91-104)."""
        h = self.stem["inc"](vol)
        h = self.stem["down1"](max_pool3d(h, 2))
        h = self.stem["down2"](max_pool3d(h, 2))
        pe = self.patch_embed
        h = conv3d(h, pe.weight, pe.bias, stride=self.opts["grid"])
        B, C = h.shape[:2]
        h = h.reshape(B, C, -1).transpose(1, 2)                 # (B, N, H)
        h = torch.cat([self.cls_token.to(h.dtype).expand(B, 1, C), h], dim=1)
        return h + self.pos_embed.to(h.dtype)

    def _block(self, p: _Block, x: torch.Tensor, generator, train: bool) -> torch.Tensor:
        """Pre-norm attention with separate q/k/v (model.py:124-178, 190-201),
        then the pre-norm GELU MLP."""
        d = self.opts
        heads, drop, attn_drop = d["num_heads"], d["drop"], d["attn_drop"]
        h = layernorm(x, p.attn_norm.weight, p.attn_norm.bias, eps=1e-6)
        B, N, C = h.shape
        hd = C // heads
        q, k, v = (linear(h, lin.weight, lin.bias).view(B, N, heads, hd).transpose(1, 2)
                   for lin in (p.q, p.k, p.v))
        dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        attn = dropout(torch.softmax(dots, dim=-1), attn_drop, generator, train).to(v.dtype)
        o = torch.matmul(attn.float(), v.float()).to(v.dtype)
        o = o.transpose(1, 2).reshape(B, N, C)
        x = x + dropout(linear(o, p.out.weight, p.out.bias), attn_drop, generator, train)
        h = layernorm(x, p.ffn_norm.weight, p.ffn_norm.bias, eps=1e-6)
        h = dropout(gelu(linear(h, p.fc1.weight, p.fc1.bias)), drop, generator, train)
        return x + dropout(linear(h, p.fc2.weight, p.fc2.bias), drop, generator, train)

    def forward(self, img: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, generator: torch.Generator | None = None):
        d = self.opts
        if train and (d["drop"] or d["attn_drop"]) and generator is None:
            raise ValueError("train mode with dropout needs a torch.Generator on the model's "
                             "device")
        img = promote_input(img)
        streams = [self._embed(img[:, m]) for m in range(img.shape[1])]
        # the CLS from stream 0 only; the other streams add their patch tokens
        x = torch.cat([streams[0]] + [s[:, 1:] for s in streams[1:]], dim=1)
        with dropout_bits(self.dropout_bits):
            for blk in self.blocks:
                x = self._block(blk, x, generator, train)
        x = layernorm(x, self.encoder_norm.weight, self.encoder_norm.bias, eps=1e-6)
        logits = linear(x[:, 0], self.final.weight, self.final.bias)[:, 0].float()
        if labels is None:
            return logits
        return logits, bce_with_logits(logits, labels)
