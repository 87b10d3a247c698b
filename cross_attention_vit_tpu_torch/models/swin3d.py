"""SwinViT3D — Swin UNETR's 3-D Swin encoder with a classification head.

Hatamizadeh et al., *Swin UNETR: Swin Transformers for Semantic
Segmentation of Brain Tumors in MRI Images* (arXiv:2201.01266), as MONAI's
``monai.networks.nets.swin_unetr.SwinTransformer`` computes it, with its
parameters under MONAI's ``SwinUNETR`` state-dict names (``swinViT.…``),
but for one split: each block's ``attn.qkv.bias`` is held as its thirds
``attn.q_bias``, ``attn.k_bias`` and ``attn.v_bias`` (MONAI's is their
concatenation; ``attn.qkv`` has no bias of its own).  The key bias adds
q·b_k to a whole row of scores, which the softmax cancels: its gradient is
nought but rounding, and as a leaf of its own it can be told apart from
the query and value biases, which learn:

  * ``patch_embed.proj``: MONAI's stride-2³ Conv3d from the M streams (the
    image's modalities as channels) to ``feature_size`` channels, computed
    as what it is, a non-overlapping 2³ patchify and ``linear``;
  * four stages ``layers{1..4}.0`` of ``depths`` blocks at widths F, 2F,
    4F, 8F with ``swin_heads`` heads: each block is norm1 → shifted-window
    attention with a learned relative-position bias (every second block
    rolled by half the window, with MONAI's region mask) → residual, then
    norm2 → Linear → erf GELU → Linear → residual
    (``ops/window_attention.py``, whose attention runs in the hand-written
    kernels K9 when ``use_flash_attention``);
  * ``PatchMergingV2`` after every stage (``downsample``): the eight 2×2×2
    neighbours concatenated, LayerNorm(8C), Linear(8C → 2C, no bias).

The head is this model's departure from Swin UNETR: in place of the
segmentation decoder (its full-resolution convolutions are left out),
MONAI's ``proj_out`` on the last stage (a LayerNorm over channels without
affine parameters), the mean over its tokens, and ``head`` = Linear(8·2F →
num_classes), trained with cross-entropy: the encoder as an MGMT-status
classifier would use it.

Dropout, attention dropout and drop path are 0, as in MONAI's BraTS
recipe; a configuration asking for dropout is refused.  The model trains
through ``train.trainer.make_train_step`` like ``ModelCross``: f32 master
weights cast per call when ``master_weights=True``, activations in
``activation_dtype``, products in ``compute_dtype``.  Serving, remat and
the parallel modes (mesh axes other than data) are out of its scope.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Config
from ..ops import initializers as init_ops
from ..ops.layers import layernorm, linear
from ..ops.losses import cross_entropy
from ..ops.window_attention import geometry, patch_merge, window_attention
from ..utils.device import resolve_device


class _PatchEmbed(nn.Module):
    def __init__(self, channels: int, features: int, patch):
        super().__init__()
        self.proj = nn.Conv3d(channels, features, tuple(patch), tuple(patch))


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window):
        super().__init__()
        rows = math.prod(2 * w - 1 for w in window)
        self.relative_position_bias_table = nn.Parameter(torch.empty(rows, heads))
        # MONAI's qkv.bias, as its three thirds (see the module docstring)
        self.q_bias = nn.Parameter(torch.empty(dim))
        self.k_bias = nn.Parameter(torch.empty(dim))
        self.v_bias = nn.Parameter(torch.empty(dim))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, window, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _MLP(dim, int(dim * mlp_ratio))


class _Merge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(8 * dim)


class _Stage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(_Block(dim, heads, window, mlp_ratio) for _ in range(depth))
        self.downsample = _Merge(dim)


class _Encoder(nn.Module):
    """MONAI's ``SwinTransformer``: ``patch_embed`` and ``layers1..4``."""

    def __init__(self, config: Config):
        super().__init__()
        F_, window = config.feature_size, tuple(config.window_size)
        channels = config.num_modalities * config.in_channels
        self.patch_embed = _PatchEmbed(channels, F_, config.patch_size)
        self.num_stages = len(config.depths)
        for s, (depth, heads) in enumerate(zip(config.depths, config.swin_heads)):
            stage = _Stage(F_ * 2 ** s, depth, heads, window, config.mlp_ratio)
            self.add_module(f"layers{s + 1}", nn.ModuleList([stage]))

    def stages(self) -> list[_Stage]:
        return [getattr(self, f"layers{s + 1}")[0] for s in range(self.num_stages)]


class SwinViT3D(nn.Module):
    """``forward(img, labels=None, train=False, generator=None)`` takes img
    (B, M, C, D, H, W) and returns logits (B, num_classes) float32, or
    (logits, loss) when labels are given.

    Parameters are made on ``device`` (default CUDA; raises on a host
    without it) from ``generator``: Linear weights and the bias tables
    N(0, 0.02) (MONAI's ``trunc_normal_(std=.02)`` without the truncation),
    the patch embedding Xavier-uniform over the convolution's fans, zero
    biases, LayerNorm ones and zeros."""

    def __init__(self, config: Config, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None, master_weights: bool = False):
        super().__init__()
        device = resolve_device(device)
        if float(config.get("dropout", 0.0)) or float(config.get("drop_path_rate", 0.0)):
            raise ValueError("SwinViT3D trains without dropout and drop path (MONAI's BraTS "
                             "recipe): set dropout=0")
        if len(config.depths) != len(config.swin_heads):
            raise ValueError(f"depths {config.depths} and swin_heads {config.swin_heads} "
                             "differ in length")
        if any(i % p for i, p in zip(config.img_size, config.patch_size)):
            raise ValueError(f"image dimensions {tuple(config.img_size)} must be divisible by "
                             f"the patch size {tuple(config.patch_size)}")
        self.config = config
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.compute_dtype = None if self.compute_dtype == torch.float32 else self.compute_dtype
        self.activation_dtype = getattr(torch, config.get("activation_dtype", "float32"))
        self.impl = "kernel" if config.use_flash_attention else "plain"
        width = config.feature_size * 2 ** len(config.depths)
        with device:
            self.swinViT = _Encoder(config)
            self.head = nn.Linear(width, config.num_classes)
        self.reset_parameters(generator)
        self.master_weights = master_weights
        if self.compute_dtype is not None and not master_weights:
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    mod.weight.data = mod.weight.data.to(self.compute_dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                init_ops.normal_02_(mod.weight, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                init_ops.init_layernorm_(mod)
            elif isinstance(mod, _WindowAttention):
                init_ops.normal_02_(mod.relative_position_bias_table, generator)
                for bias in (mod.q_bias, mod.k_bias, mod.v_bias):
                    bias.zero_()
        proj = self.swinViT.patch_embed.proj
        volume = math.prod(proj.kernel_size)
        init_ops.xavier_uniform_(proj.weight, generator, fan_in=proj.in_channels * volume,
                                 fan_out=proj.out_channels * volume)
        proj.bias.zero_()

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _embed(self, img: torch.Tensor) -> torch.Tensor:
        """(B, M, C, D, H, W) → (B, D/p1, H/p2, W/p3, F): the stride-p Conv3d
        as a patchify in its weight's (channel, p1, p2, p3) order and
        ``linear``."""
        B, M, C, D, H, W = img.shape
        p1, p2, p3 = self.config.patch_size
        x = img.reshape(B, M * C, D // p1, p1, H // p2, p2, W // p3, p3)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, D // p1, H // p2, W // p3, -1)
        proj = self.swinViT.patch_embed.proj
        return linear(x, proj.weight.reshape(proj.out_channels, -1), proj.bias, self.compute_dtype)

    def _block(self, x: torch.Tensor, blk: _Block, heads: int, shifted: bool) -> torch.Tensor:
        cdt = self.compute_dtype
        geom = geometry(x.shape[1:4], tuple(self.config.window_size), shifted)
        a = blk.attn
        x = x + window_attention(layernorm(x, blk.norm1.weight, blk.norm1.bias), a.qkv.weight,
                                 torch.cat((a.q_bias, a.k_bias, a.v_bias)), a.proj,
                                 a.relative_position_bias_table, heads, geom, cdt, self.impl)
        h = layernorm(x, blk.norm2.weight, blk.norm2.bias)
        mlp = blk.mlp
        h = linear(h, mlp.linear1.weight, mlp.linear1.bias, cdt, gelu_approx=False)
        return x + linear(h, mlp.linear2.weight, mlp.linear2.bias, cdt)

    def forward(self, img: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, generator: torch.Generator | None = None):
        cfg = self.config
        img = img.to(self.activation_dtype)   # the one cast of the batch, before patchifying
        if img.shape[1] != cfg.num_modalities:
            raise ValueError(f"img has {img.shape[1]} modalities, the model "
                             f"{cfg.num_modalities}")
        x = self._embed(img)
        for stage, heads in zip(self.swinViT.stages(), cfg.swin_heads):
            for j, blk in enumerate(stage.blocks):
                x = self._block(x, blk, heads, shifted=j % 2 == 1)
            down = stage.downsample
            x = patch_merge(x, down.reduction, down.norm, self.compute_dtype)
        x = F.layer_norm(x.float(), (x.shape[-1],))           # MONAI proj_out, no affine
        logits = linear(x.mean((1, 2, 3)), self.head.weight, self.head.bias, self.compute_dtype,
                        out_dtype=torch.float32)
        if labels is None:
            return logits
        return logits, cross_entropy(logits, labels, float(cfg.get("label_smoothing", 0.0)))
