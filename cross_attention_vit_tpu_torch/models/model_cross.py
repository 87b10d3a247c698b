"""ModelCross — multi-stream ViT with CLS-token cross-attention fusion.

Port of ``cross_attention_vit_tpu/models/model_cross.py`` as an
``nn.Module`` whose parameter names are the reference torch state-dict names
(the keys ``cross_attention_vit_tpu/models/convert.export_model_cross``
emits), for example ``transformer.{b}.blocks.{m}.{j}.attn.fn.to_qkv.weight``:

  * one shared patch embedding, CLS token and positional embedding applied to
    every modality stream (reference model_cross.py:167-169, 193-198);
  * ``num_multi_blocks`` multi-scale blocks, each holding per-modality stacks
    of ``num_self_blocks`` pre-norm self-attention blocks plus one CLS-query
    cross-attention block per ``attn_order`` entry (model_cross.py:116-148);
  * in a cross block only the CLS is the query; the attention residual adds
    the CLS slice and the fused CLS is re-concatenated with its own stream's
    patch tokens (model_cross.py:112, 140-142);
  * per-modality LayerNorm + MLP heads on the CLS, logits averaged over
    modalities, cross-entropy with label smoothing (model_cross.py:203-212).

Weights.  The JAX package keeps every parameter in float32 and casts the
GEMM weights to ``config.compute_dtype`` on every call.  A training model
(``master_weights=True``) does the same, so Adam's updates below one bf16 ulp
accumulate in the f32 masters and the gradients reach them through the cast.
An eval or serving model (the default) casts its GEMM weights once when they
are made or loaded, which gives the same forward values.  Biases, LayerNorm
parameters, the CLS token and the positional embedding stay float32 either
way, as in the JAX package.

Train mode (``forward(..., train=True, generator=g)``) drops out at the JAX
sites (rate ``config.dropout``): after the positional embedding, on the
self-attention output projection, on the cross-attention probabilities and
projection, after GELU and after fc2 in every feed-forward, and in the
per-stream heads.  ``g`` is a ``torch.Generator`` on the model's device.
The masks draw ``config.dropout_bits`` random bits an element (JAX's
``DROPOUT_BITS``: 'auto', 8, 16, or Bernoulli; ``ops.layers.dropout_mask``).

Rematerialisation (``config.remat``, ``config.remat_policy``): each
self-block runs under ``ops.remat.checkpoint``, where JAX wraps it in
``jax.checkpoint``; values, masks and the generator's final state are
those of the step without it.

Tensor parallelism (``parallel.shard_params`` over a 'model' axis, JAX's
head-aligned Megatron split): each attention, cross-attention, dense
feed-forward and head holds its rank's heads or MLP columns and its ``tp``
(``parallel/tensor.py``); the ops run f and g around it.

Mixture of experts (``config.moe_experts`` = E > 1, JAX :71-92, :187-208,
:322-330): every ``moe_every``-th self-block FFN of each stream (site index
mb·num_self_blocks + layer) is a GShard MoE (``parallel.moe.MoEFFN``: its
own router and E experts per stream, f32, erf GELU), followed by the block's
dropout; the cross-block FFNs stay dense.  In train mode the loss gains
``moe_balance_weight`` × the mean of the sites' balance losses, and each
forward leaves the sites' balance losses and dispatch fractions in
``moe_aux``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..configs import Config
from ..ops import initializers as init_ops
from ..ops.attention import attention_impl, cross_attention_cls, self_attention
from ..ops import remat
from ..ops.layers import (dropout, dropout_bits, feed_forward, layernorm, linear, mlp_head,
                          promote_input)
from ..ops.losses import cross_entropy
from ..ops.patchify import num_patches, patchify_3d
from ..parallel.moe import MoEFFN
from ..utils.device import resolve_device


def _reject_removed_stacked_streams(config: Config) -> None:
    """``config.stacked_streams`` was removed from the JAX package (measured
    slower than the per-stream loop); configs that still set it fail loudly."""
    if config.get("stacked_streams", False):
        raise ValueError(
            "config.stacked_streams was removed (measured negative twice on "
            "v5e; see docs/PERF_r05.md) — drop the flag: the per-stream "
            "trunk loop IS the fast path")


def _attn_pairs(config: Config) -> list[tuple[int, int]]:
    """Cross-attention routing as (cls_stream, token_stream) pairs, in the
    ascending-stream order the reference iterates (model_cross.py:135-144)."""
    order = config.attn_order
    pairs = []
    for i in range(config.num_modalities):
        if str(i) in order:
            j = int(order[str(i)])
            if not 0 <= j < config.num_modalities:
                raise ValueError(
                    f"attn_order[{i!r}] = {j} is out of range for "
                    f"num_modalities={config.num_modalities}")
            pairs.append((i, j))
    return pairs


def _moe_fields(config: Config) -> tuple[int, int]:
    """(num_experts, every): the MoE is on when num_experts > 1, on every
    ``every``-th trunk layer (JAX ``model_vit._moe_fields``)."""
    return (int(config.get("moe_experts", 0)), max(1, int(config.get("moe_every", 1))))


@dataclass(frozen=True)
class _Opts:
    num_heads: int
    compute_dtype: torch.dtype | None    # None: operands in the activation dtype
    impl: str                            # 'flash', 'xla' or 'ring'
    gelu_approx: bool
    dropout: float
    moe_selected: int = 2
    moe_capacity: float = 1.25
    dropout_bits: object = "auto"                # the keep masks' random bits an element
    remat: tuple[str, ...] | None = None         # the names a remat policy keeps; None: off


def _opts(config: Config) -> _Opts:
    cdt = getattr(torch, config.compute_dtype)
    return _Opts(num_heads=config.num_heads,
                 compute_dtype=None if cdt == torch.float32 else cdt,
                 impl=attention_impl(config),
                 gelu_approx=bool(config.get("gelu_approx", False)),
                 dropout=float(config.get("dropout", 0.0)),
                 moe_selected=int(config.get("moe_num_selected", 2)),
                 moe_capacity=float(config.get("moe_capacity_factor", 1.25)),
                 dropout_bits=config.get("dropout_bits", "auto"),
                 remat=remat.remat_names(config))


class _Run:
    """Per-call training state threaded through the blocks; the MoE sites
    append their aux dicts to ``moe``.  A plain class, not a dataclass: an
    FSDP2 unit's forward hook rebuilds the dataclasses and lists among its
    arguments (``_apply_to_tensors``), and a site would append to a copy."""
    __slots__ = ("train", "generator", "moe")

    def __init__(self, train: bool = False, generator: torch.Generator | None = None):
        self.train, self.generator, self.moe = train, generator, []


def _keep_moe_aux(model: nn.Module, run: _Run) -> None:
    """The forward's MoE sites' balance losses and dispatch fractions, one
    value a site in site order, as ``model.moe_aux``."""
    if run.moe:
        model.moe_aux = {k: torch.stack([a[k] for a in run.moe]).detach()
                         for k in ("balance_loss", "dispatch_fraction")}


def _with_balance(config: Config, loss: torch.Tensor, run: _Run) -> torch.Tensor:
    """In train mode, the loss plus ``moe_balance_weight`` × the mean of the
    MoE sites' balance losses; eval losses stay pure cross-entropy, as in
    JAX."""
    if not (run.train and run.moe):
        return loss
    balance = sum(a["balance_loss"] for a in run.moe)
    return loss + float(config.get("moe_balance_weight", 0.01)) * balance / len(run.moe)


def tp_regions(model: nn.Module) -> list[tuple[str, nn.Module]]:
    """A model's attentions, cross-attentions, dense feed-forwards and heads
    (``mlp_head``, or each ``mlp_head.{m}``), by name."""
    regions = [(name, m) for name, m in model.named_modules()
               if isinstance(m, (_Attention, _CrossAttention, _FeedForward))]
    head = model.mlp_head
    if isinstance(head, nn.ModuleList):
        return regions + [(f"mlp_head.{m}", h) for m, h in enumerate(head)]
    return regions + [("mlp_head", head)]


def _net(first: nn.Linear, second: nn.Linear) -> nn.ModuleDict:
    """The reference's Sequential(Linear, GELU, Dropout, Linear, Dropout):
    only indices 0 and 3 hold parameters."""
    return nn.ModuleDict({"0": first, "3": second})


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        # heads==1 quirk: the reference's to_out is nn.Identity()
        # (model_cross.py:37,45-48), so no parameters and no projection
        self.to_out = nn.ModuleDict({"0": nn.Linear(dim, dim)}) if heads != 1 else None
        self.tp = None      # the 'model' split of its heads (parallel/tensor.py)


class _CrossAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.wq, self.wk, self.wv = nn.Linear(dim, dim), nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.tp = None


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = _net(nn.Linear(dim, hidden), nn.Linear(hidden, dim))
        self.tp = None


class _SelfBlock(nn.Module):
    """Pre-norm self-attention block (reference model_cross.py:64-72); with
    ``config.remat`` a rematerialised region under its policy
    (``ops/remat.py``, JAX ``models/model_cross.py:236-248``)."""

    def __init__(self, dim: int, mlp: int, opts: _Opts, moe_experts: int = 0):
        super().__init__()
        self.opts = opts
        self.attn = _PreNorm(dim, _Attention(dim, opts.num_heads))
        ffn = (MoEFFN(dim, mlp, moe_experts, opts.moe_selected, opts.moe_capacity)
               if moe_experts > 1 else _FeedForward(dim, mlp))
        self.ffn = _PreNorm(dim, ffn)

    def forward(self, x: torch.Tensor, run: _Run) -> torch.Tensor:
        return remat.checkpoint(self._block, self.opts.remat, run.generator, x, run)

    def _block(self, x: torch.Tensor, run: _Run) -> torch.Tensor:
        o, a, f = self.opts, self.attn, self.ffn
        h = layernorm(x, a.norm.weight, a.norm.bias)
        to_out = a.fn.to_out["0"] if a.fn.to_out is not None else None
        x = self_attention(h, a.fn.to_qkv, to_out, o.num_heads, o.compute_dtype, o.impl,
                           o.dropout, run.generator, run.train, a.fn.tp) + x
        h = layernorm(x, f.norm.weight, f.norm.bias)
        if isinstance(f.fn, MoEFFN):
            y, aux = f.fn(h)
            if not remat.replaying():     # the forward recorded this site's terms
                run.moe.append(aux)
            return dropout(y, o.dropout, run.generator, run.train) + x
        net = f.fn.net
        return feed_forward(h, net["0"], net["3"], o.compute_dtype, o.gelu_approx,
                            o.dropout, run.generator, run.train, f.fn.tp) + x


class _CrossBlock(nn.Module):
    """CLS-query cross block; the attention residual is the CLS slice only
    (reference model_cross.py:104-114).  Returns the fused CLS (B, 1, H)."""

    def __init__(self, dim: int, mlp: int, opts: _Opts):
        super().__init__()
        self.opts = opts
        self.attn = _PreNorm(dim, _CrossAttention(dim))
        self.ffn = _PreNorm(dim, _FeedForward(dim, mlp))

    def forward(self, x: torch.Tensor, run: _Run) -> torch.Tensor:
        o, a, f = self.opts, self.attn, self.ffn
        h = layernorm(x, a.norm.weight, a.norm.bias)
        fused = cross_attention_cls(h, a.fn.wq, a.fn.wk, a.fn.wv, a.fn.proj, o.num_heads,
                                    o.compute_dtype, o.dropout, run.generator,
                                    run.train, a.fn.tp) + x[:, 0:1]
        h = layernorm(fused, f.norm.weight, f.norm.bias)
        net = f.fn.net
        return feed_forward(h, net["0"], net["3"], o.compute_dtype, o.gelu_approx,
                            o.dropout, run.generator, run.train, f.fn.tp) + fused


class _MultiScaleBlock(nn.Module):
    """Per-stream self-attention stacks, then attn_order-routed CLS fusion
    (reference model_cross.py:128-148)."""

    def __init__(self, config: Config, opts: _Opts, index: int = 0):
        super().__init__()
        H, mlp = config.hidden_dim, config.mlp_dim
        experts, every = _moe_fields(config)

        def site_experts(layer: int) -> int:
            # the per-stream depth index mb·num_self_blocks + layer
            depth = index * config.num_self_blocks + layer
            return experts if experts > 1 and depth % every == every - 1 else 0

        self.blocks = nn.ModuleList(
            nn.ModuleList(_SelfBlock(H, mlp, opts, site_experts(j))
                          for j in range(config.num_self_blocks))
            for _ in range(config.num_modalities))
        pairs = _attn_pairs(config)
        self.fusion = nn.ModuleList(_CrossBlock(H, mlp, opts) for _ in pairs)
        self.routing = dict(pairs)     # cls_stream -> token_stream

    def forward(self, streams: list[torch.Tensor], run: _Run) -> list[torch.Tensor]:
        attn = []
        for stack, x in zip(self.blocks, streams):
            for blk in stack:
                x = blk(x, run)
            attn.append(x)
        outs = []
        cross = 0
        for i, x in enumerate(attn):
            if i in self.routing:
                tmp = torch.cat([x[:, 0:1], attn[self.routing[i]][:, 1:]], dim=1)
                tmp = self.fusion[cross](tmp, run)
                outs.append(torch.cat([tmp, x[:, 1:]], dim=1))
                cross += 1
            else:
                outs.append(x)
        return outs


class ModelCross(nn.Module):
    """ModelCross.  ``forward(img, labels=None, train=False, generator=None)``
    takes img (B, M, C, D, H, W) and returns logits (B, num_classes) float32,
    or (logits, loss) when labels are given — as the JAX ``apply``.

    Parameters are made on ``device`` (default CUDA; raises on a host without
    it) from ``generator`` with the reference's init distributions.
    ``master_weights=True`` keeps every parameter in float32 (the model to
    train); otherwise GEMM weights are cast once to the compute dtype."""

    def __init__(self, config: Config, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None, master_weights: bool = False):
        super().__init__()
        device = resolve_device(device)
        img, patch = tuple(config.img_size), tuple(config.patch_size)
        if any(i % p for i, p in zip(img, patch)):
            raise ValueError(f"image dimensions {img} must be divisible by the patch size {patch}")
        _reject_removed_stacked_streams(config)
        self.config = config
        H, M = config.hidden_dim, config.num_modalities
        self.opts = opts = _opts(config)
        self.activation_dtype = getattr(torch, config.get("activation_dtype", "float32"))
        n = num_patches(img, patch)
        patch_dim = patch[0] * patch[1] * patch[2] * config.in_channels

        with device:    # allocate every parameter on the target device
            self.pos_embedding = nn.Parameter(torch.empty(1, n + 1, H))
            self.cls_token = nn.Parameter(torch.empty(1, 1, H))
            self.patch_to_embedding = nn.Linear(patch_dim, H)
            self.transformer = nn.ModuleList(_MultiScaleBlock(config, opts, b)
                                             for b in range(config.num_multi_blocks))
            self.norm = nn.ModuleList(nn.LayerNorm(H) for _ in range(M))
            self.mlp_head = nn.ModuleList(_net(nn.Linear(H, config.mlp_dim),
                                               nn.Linear(config.mlp_dim, config.num_classes))
                                          for _ in range(M))
        self.reset_parameters(generator)
        self.moe_aux = None
        self.master_weights = master_weights
        if opts.compute_dtype is not None and not master_weights:
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    mod.weight.data = mod.weight.data.to(opts.compute_dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Xavier-uniform Linears (and MoE experts and routers) with zero
        bias, ones/zeros LayerNorm, N(0, 0.02) pos-embedding and CLS
        (reference model_cross.py:214-241)."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                init_ops.init_linear_(mod, generator)
            elif isinstance(mod, nn.LayerNorm):
                init_ops.init_layernorm_(mod)
            elif isinstance(mod, MoEFFN):
                mod.reset_parameters(generator)
        init_ops.normal_02_(self.pos_embedding, generator)
        init_ops.normal_02_(self.cls_token, generator)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def blocks(self) -> list[nn.Module]:
        """The self- and cross-attention blocks, each called as a module: the
        units FSDP gathers one at a time (``parallel.shard_params``)."""
        return [m for m in self.modules() if isinstance(m, (_SelfBlock, _CrossBlock))]

    def tp_regions(self) -> list[tuple[str, nn.Module]]:
        """The modules tensor parallelism splits, by name
        (``parallel/tensor.py``): every attention, cross-attention and dense
        feed-forward, and the heads."""
        return tp_regions(self)

    def forward(self, img: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, generator: torch.Generator | None = None):
        o = self.opts
        if train and o.dropout and generator is None:
            raise ValueError("train mode with dropout needs a torch.Generator on the "
                             "model's device")
        with dropout_bits(o.dropout_bits):
            return self._forward(img, labels, train, generator)

    def _forward(self, img: torch.Tensor, labels: torch.Tensor | None, train: bool,
                 generator: torch.Generator | None):
        cfg, o = self.config, self.opts
        run = _Run(train, generator)
        img = promote_input(img)   # low-precision transfer batches re-promote at entry
        B, M = img.shape[:2]
        if M != len(self.norm):
            raise ValueError(f"img has {M} modalities, the model {len(self.norm)}")
        emb = self.patch_to_embedding
        streams = []
        for m in range(M):
            x = patchify_3d(img[:, m], tuple(cfg.patch_size)).to(self.activation_dtype)
            x = linear(x, emb.weight, emb.bias, o.compute_dtype)
            cls = self.cls_token.to(x.dtype).expand(B, 1, x.shape[-1])
            x = torch.cat([cls, x], dim=1)
            x = x + self.pos_embedding.to(x.dtype)
            streams.append(dropout(x, o.dropout, generator, train))
        for block in self.transformer:
            streams = block(streams, run)
        per_mod = []
        for x, norm, head in zip(streams, self.norm, self.mlp_head):
            cls = layernorm(x[:, 0], norm.weight, norm.bias)
            per_mod.append(mlp_head(cls, head["0"], head["3"], o.compute_dtype, o.gelu_approx,
                                    o.dropout, generator, train, getattr(head, "tp", None)))
        # jnp.mean of the activation dtype: f32 accumulation, rounded back
        logits = torch.stack(per_mod).float().mean(0).to(per_mod[0].dtype).float()
        _keep_moe_aux(self, run)
        if labels is None:
            return logits
        loss = cross_entropy(logits, labels, cfg.get("label_smoothing", 0.0))
        return logits, _with_balance(cfg, loss, run)
