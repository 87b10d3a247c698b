"""MViTv2 — the improved multiscale vision transformer for video (Li et al.,
*MViTv2: Improved Multiscale Vision Transformers for Classification and
Detection*, arXiv:2112.01526), as PySlowFast's ``MViT`` computes it under
``configs/Kinetics/MViTv2_S_16x4.yaml`` (``mode="conv"``, residual pooling,
spatial and temporal relative positions, no class token, no absolute
position embedding), with its parameters under PySlowFast's names.

For B clips (B, M, C, T, H, W), the M streams being the stem's input
channels (RGB for Kinetics), in this order:

  * **Stem** (``patch_embed.proj``): Conv3d(M·C → E, kernel (3, 7, 7),
    stride (2, 4, 4), padding (1, 3, 3)) with a bias; at 16 × 224² a
    (8, 56, 56) grid of 25,088 tokens of width E = 96, in (t, h, w)
    row-major order.
  * **Blocks** ``blocks.{i}``, i < depth: at the ``dim_mul_blocks`` (1, 3
    and 14 of 16) the width and the head count double, inside the
    attention, so the blocks run at 96/1, 192/2, 384/4 and 768/8
    (width/heads) and every head is 96 wide.  The query stride is
    ``pool_q_stride`` (1, 2, 2) at those blocks and (1, 1, 1) elsewhere; the
    key/value stride starts at ``pool_kv_stride_adaptive`` (1, 8, 8) and is
    divided by the query stride at each transition, floored at 1.  Drop
    path rises linearly from 0 to ``drop_path_rate`` over the blocks.  A
    block, on x (B, N, C_in) over the grid (T, H, W)
    (``ops/pooling_attention.py``):

        xn = LN1(x)
        q, k, v = split(Linear(C_in → 3·C_out)(xn)) per head (B·h, T, H, W, 96)
        q = LN_q(Pool_q(q)),  k = LN_k(Pool_k(k)),  v = LN_v(Pool_v(v))
        Pool = Conv3d(96, 96, 3³, stride s, padding 1, groups 96, no bias),
               one weight each for q, k and v, shared by the heads
        A = softmax((q·96^-½)·kᵀ + B_rel),  o = A·v + q   (residual pooling)
        attn = Linear(C_out → C_out)(o merged over heads)
        x_skip = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))(Linear(C_in →
                 C_out)(xn)) at a transition, else x
        x = x_skip + dp(attn);   x = x + dp(MLP(LN2(x)))

    MLP = Linear(C → 4C), erf GELU, Linear(4C → C).  B_rel[(tq, hq, wq),
    (tk, hk, wk)] = q·Rt[dt] + q·Rh[dh] + q·Rw[dw] with the unscaled pooled
    q, d along an axis with Lq queries and Lk keys = i·rq − j·rk + (Lk −
    1)·rk, rq = max(Lk/Lq, 1), rk = max(Lq/Lk, 1); the tables
    (``attn.rel_pos_{t,h,w}``, per block) have 2·max(Lq, Lk) − 1 rows of 96,
    Lq and Lk the pooled sizes (at the published sizes, which the strides
    divide, PySlowFast's input size over each stride).  The attention runs in
    the hand-written kernels K10 (``kernels/pool_attention.py``) on the
    card, in their plain versions on the CPU.
  * **Head**: ``norm`` (LN(768)), the mean over the last stage's tokens,
    dropout ``dropout`` (0.5), ``head.projection`` = Linear(768 →
    num_classes), trained with cross-entropy.

Every LayerNorm's eps is ``layer_norm_eps`` (1e-6, PySlowFast's).  The
model trains through ``train.trainer.make_train_step`` like ``ModelCross``:
f32 master weights cast per call when ``master_weights=True``, activations
in ``activation_dtype``, products and convolutions in ``compute_dtype``;
drop path and dropout draw from the step's generator in that order, two
drop-path masks a block (attention branch, then MLP) and the head's
dropout.  Serving, remat and the parallel modes (mesh axes other than data)
are out of its scope.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Config
from ..ops import initializers as init_ops
from ..ops.layers import dropout, layernorm, linear, stochastic_depth_row
from ..ops.losses import cross_entropy
from ..ops.pooling_attention import (POOL_KERNEL, pooled_dims, pooling_attention,
                                     table_rows)
from ..utils.device import resolve_device


@dataclass(frozen=True)
class BlockPlan:
    """One block's widths, heads, strides, grids and drop-path rate."""
    dim: int
    dim_out: int
    heads: int
    q_stride: tuple[int, int, int]
    kv_stride: tuple[int, int, int]
    thw: tuple[int, int, int]          # the block's input grid
    q_dims: tuple[int, int, int]       # its pooled queries' grid (its output grid)
    k_dims: tuple[int, int, int]       # its pooled keys' grid
    drop_path: float


def block_plan(config: Config) -> list[BlockPlan]:
    """PySlowFast's per-block schedule (``DIM_MUL_IN_ATT``, adaptive key/value
    stride) for ``config``."""
    thw = tuple((d + 2 * p - k) // s + 1 for d, k, s, p in zip(
        config.img_size, config.patch_kernel, config.patch_stride, config.patch_padding))
    dim, heads = config.embed_dim, config.num_heads
    kv = tuple(config.pool_kv_stride_adaptive)
    depth = config.depth
    out = []
    for i in range(depth):
        q_stride = (tuple(config.pool_q_stride) if i in config.dim_mul_blocks else (1, 1, 1))
        kv = tuple(max(k // s, 1) for k, s in zip(kv, q_stride))
        dim_out = dim * 2 if i in config.dim_mul_blocks else dim
        heads = heads * 2 if i in config.dim_mul_blocks else heads
        q_dims = pooled_dims(thw, q_stride)
        rate = float(config.drop_path_rate) * i / (depth - 1) if depth > 1 else 0.0
        out.append(BlockPlan(dim, dim_out, heads, q_stride, kv, thw, q_dims,
                             pooled_dims(thw, kv), rate))
        dim, thw = dim_out, q_dims
    return out


class _Attention(nn.Module):
    """PySlowFast ``MultiScaleAttention`` (``mode="conv"``)."""

    def __init__(self, plan: BlockPlan, eps: float):
        super().__init__()
        D = plan.dim_out // plan.heads
        self.qkv = nn.Linear(plan.dim, 3 * plan.dim_out)
        self.proj = nn.Linear(plan.dim_out, plan.dim_out)
        for name, stride in (("q", plan.q_stride), ("k", plan.kv_stride), ("v", plan.kv_stride)):
            self.add_module(f"pool_{name}",
                            nn.Conv3d(D, D, POOL_KERNEL, stride, tuple(k // 2 for k in POOL_KERNEL),
                                      groups=D, bias=False))
            self.add_module(f"norm_{name}", nn.LayerNorm(D, eps))
        self.rel_pos_h = nn.Parameter(torch.empty(table_rows(plan.q_dims[1], plan.k_dims[1]), D))
        self.rel_pos_w = nn.Parameter(torch.empty(table_rows(plan.q_dims[2], plan.k_dims[2]), D))
        self.rel_pos_t = nn.Parameter(torch.empty(table_rows(plan.q_dims[0], plan.k_dims[0]), D))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class _Block(nn.Module):
    """PySlowFast ``MultiScaleBlock`` (``dim_mul_in_att``)."""

    def __init__(self, plan: BlockPlan, mlp_ratio: float, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(plan.dim, eps)
        self.attn = _Attention(plan, eps)
        self.norm2 = nn.LayerNorm(plan.dim_out, eps)
        self.mlp = _MLP(plan.dim_out, int(plan.dim_out * mlp_ratio))
        self.proj = nn.Linear(plan.dim, plan.dim_out) if plan.dim != plan.dim_out else None


class _PatchEmbed(nn.Module):
    def __init__(self, config: Config, channels: int):
        super().__init__()
        self.proj = nn.Conv3d(channels, config.embed_dim, tuple(config.patch_kernel),
                              tuple(config.patch_stride), tuple(config.patch_padding))


class _Head(nn.Module):
    """PySlowFast ``TransformerBasicHead``: dropout, then ``projection``."""

    def __init__(self, dim: int, classes: int):
        super().__init__()
        self.projection = nn.Linear(dim, classes)


class MViTv2(nn.Module):
    """``forward(img, labels=None, train=False, generator=None)`` takes img
    (B, M, C, T, H, W) and returns logits (B, num_classes) float32, or
    (logits, loss) when labels are given.

    Parameters are made on ``device`` (default CUDA; raises on a host
    without it) from ``generator``, float32 and cast per call (the model
    trains only: ``master_weights`` is kept for ``make_train_step``): Linear weights and the relative-position
    tables N(0, 0.02) (PySlowFast's ``trunc_normal_(std=.02)`` without the
    truncation), the stem and the pools Xavier-uniform over the
    convolution's fans (in place of PyTorch's default), zero biases,
    LayerNorm ones and zeros."""

    def __init__(self, config: Config, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None, master_weights: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.plan = block_plan(config)
        if any(p.dim_out // p.heads * p.heads != p.dim_out for p in self.plan):
            raise ValueError("every block's width must be a whole number of heads")
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.compute_dtype = None if self.compute_dtype == torch.float32 else self.compute_dtype
        self.activation_dtype = getattr(torch, config.get("activation_dtype", "float32"))
        self.eps = float(config.layer_norm_eps)
        channels = config.num_modalities * config.in_channels
        with device:
            self.patch_embed = _PatchEmbed(config, channels)
            self.blocks = nn.ModuleList(_Block(p, config.mlp_ratio, self.eps) for p in self.plan)
            self.norm = nn.LayerNorm(self.plan[-1].dim_out, self.eps)
            self.head = _Head(self.plan[-1].dim_out, config.num_classes)
        self.reset_parameters(generator)
        self.master_weights = master_weights

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                init_ops.normal_02_(mod.weight, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                init_ops.init_layernorm_(mod)
            elif isinstance(mod, nn.Conv3d):
                w = mod.weight
                volume = math.prod(w.shape[2:])
                init_ops.xavier_uniform_(w, generator, fan_in=w.shape[1] * volume,
                                         fan_out=w.shape[0] * volume)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, _Attention):
                for table in (mod.rel_pos_h, mod.rel_pos_w, mod.rel_pos_t):
                    init_ops.normal_02_(table, generator)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _embed(self, img: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int, int]]:
        """(B, M, C, T, H, W) → (B, T'·H'·W', E) tokens and their grid: the
        stem Conv3d in the compute dtype on the channels-last clip."""
        B = img.shape[0]
        x = img.reshape(B, -1, *img.shape[3:]).contiguous(memory_format=torch.channels_last_3d)
        proj = self.patch_embed.proj
        dtype = self.compute_dtype or x.dtype
        y = F.conv3d(x.to(dtype), proj.weight.to(dtype), proj.bias.to(dtype), proj.stride,
                     proj.padding)
        thw = tuple(y.shape[2:])
        return y.permute(0, 2, 3, 4, 1).reshape(B, -1, y.shape[1]).to(img.dtype), thw

    def _block(self, x: torch.Tensor, thw, blk: _Block, plan: BlockPlan, train: bool,
               generator: torch.Generator | None) -> tuple[torch.Tensor, tuple]:
        cdt = self.compute_dtype
        xn = layernorm(x, blk.norm1.weight, blk.norm1.bias, self.eps)
        attn, skip, thw = pooling_attention(x, xn, thw, blk.attn, blk.proj, plan.heads,
                                            plan.q_stride, plan.kv_stride, self.eps, cdt)
        x = skip + stochastic_depth_row(attn, plan.drop_path, generator, train)
        h = layernorm(x, blk.norm2.weight, blk.norm2.bias, self.eps)
        h = linear(h, blk.mlp.fc1.weight, blk.mlp.fc1.bias, cdt, gelu_approx=False)
        h = linear(h, blk.mlp.fc2.weight, blk.mlp.fc2.bias, cdt)
        return x + stochastic_depth_row(h, plan.drop_path, generator, train), thw

    def forward(self, img: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, generator: torch.Generator | None = None):
        cfg = self.config
        img = img.to(self.activation_dtype)   # the one cast of the batch, before the stem
        if img.shape[1] != cfg.num_modalities:
            raise ValueError(f"img has {img.shape[1]} streams, the model {cfg.num_modalities}")
        x, thw = self._embed(img)
        for blk, plan in zip(self.blocks, self.plan):
            x, thw = self._block(x, thw, blk, plan, train, generator)
        x = layernorm(x, self.norm.weight, self.norm.bias, self.eps).float().mean(1)
        x = dropout(x, float(cfg.dropout), generator, train)
        head = self.head.projection
        logits = linear(x, head.weight, head.bias, self.compute_dtype, out_dtype=torch.float32)
        if labels is None:
            return logits
        return logits, cross_entropy(logits, labels, float(cfg.get("label_smoothing", 0.0)))
