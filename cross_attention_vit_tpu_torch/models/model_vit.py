"""ModelVIT — single-stream 3D ViT baseline.

Port of ``cross_attention_vit_tpu/models/model_vit.py`` as an ``nn.Module``
whose parameter names are the reference torch state-dict names (the keys
``cross_attention_vit_tpu/models/convert.export_model_vit`` emits):

  * every modality's patch tokens are embedded with one shared Linear and
    concatenated into one sequence behind one CLS token, so the positional
    embedding spans ``num_patches·M + 1`` tokens (model_vit.py:121-129) —
    N = 1025 for the live 2-stream grid, 1537 for three streams, which
    takes the streaming attention kernels (N > 1040);
  * ``num_layers`` pre-norm blocks ``transformer.layers.{i}.0`` (attention)
    and ``.2`` (feed-forward); indices 1 and 3 are the reference's
    row-mode StochasticDepth, which holds no parameters and drops each
    sample's branch at ``config.drop_path_rate`` (model_vit.py:151-160);
  * the head ``mlp_head.{0, 1, 4}`` = LayerNorm → Linear → GELU → Dropout →
    Linear → Dropout on the CLS.  Its GELU is always erf (model_vit.py:189);
    the trunk's follows ``config.gelu_approx``;
  * plain cross-entropy, no label smoothing (model_vit.py:196).

Weights and dtypes work as in ``ModelCross``: f32 masters cast per call when
``master_weights=True`` (the model to train), else GEMM weights cast once to
the compute dtype.  Train mode drops out after the positional embedding, on
the attention output projection, after GELU and after fc2 in every
feed-forward, and twice in the head, with ``config.dropout_bits``'s masks;
``config.remat`` rematerialises each trunk layer, as in ``ModelCross``.
With ``moe_experts`` = E > 1 every ``moe_every``-th trunk FFN is a GShard
MoE (``parallel.moe.MoEFFN``, f32, erf GELU; JAX :27-35, :66-83, :133-149,
:197-205), followed by dropout and
the row stochastic depth as the dense FFN; in train mode the loss gains
``moe_balance_weight`` × the mean of the sites' balance losses, and each
forward leaves the sites' aux values in ``moe_aux``.

Pipeline layout (``pipeline_stages > 1``, JAX :79-88, :168-179): the trunk
runs through ``parallel.pipeline.pipeline_layers`` with
``pipeline_microbatches`` (default ``pipeline_stages``) strided
microbatches and per-(layer, microbatch) dropout generators — serially
without a pipeline mesh, as GPipe stages over the ambient mesh's 'pipe'
axis after ``parallel.shard_params``.  The port keeps its
``transformer.layers.{i}`` modules; JAX's stacked checkpoint leaves are
converted at the checkpoint (``models/convert.py``).  With the MoE it is
rejected as JAX rejects it.  Tensor parallelism splits the attentions,
feed-forwards and head as in ``ModelCross``, and composes with the
pipeline.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import Config
from ..ops import initializers as init_ops
from ..ops import remat
from ..ops.attention import self_attention
from ..ops.layers import (dropout, dropout_bits, feed_forward, gelu, layernorm, linear,
                          linear_layer, stochastic_depth_row)
from ..ops.losses import cross_entropy
from ..ops.patchify import num_patches, patchify_3d
from ..parallel.moe import MoEFFN
from ..parallel.pipeline import pipeline_layers
from ..parallel.tensor import copy_to
from ..utils.device import resolve_device
from .model_cross import (_Attention, _FeedForward, _keep_moe_aux, _moe_fields, _Opts, _opts,
                          _PreNorm, _Run, _with_balance, tp_regions)


class _Layer(nn.Module):
    """One trunk layer: ``layer["0"]`` the attention and ``layer["2"]`` the
    feed-forward (the reference's indices), called as a module
    (``forward`` runs ``ModelVIT._layer_body`` on it, rematerialised under
    ``config.remat``), so that FSDP gathers it as one unit
    (``ModelVIT.blocks``; ``fully_shard`` refuses a ModuleDict)."""

    def __init__(self, attn: nn.Module, ffn: nn.Module):
        super().__init__()
        self.add_module("0", attn)
        self.add_module("2", ffn)

    def __getitem__(self, key: str) -> nn.Module:
        return self._modules[key]

    def forward(self, x: torch.Tensor, model: "ModelVIT", generator: torch.Generator | None,
                train: bool, run: _Run) -> torch.Tensor:
        return remat.checkpoint(lambda h: model._layer_body(self, h, generator, train, run),
                                model.opts.remat, generator, x)


class _Layers(nn.Module):
    """The reference's ``Transformer``: ``layers.{i}.{0, 2}``."""

    def __init__(self, config: Config, opts: _Opts):
        super().__init__()
        H, mlp = config.hidden_dim, config.mlp_dim
        experts, every = _moe_fields(config)

        def ffn(i: int) -> nn.Module:
            if experts > 1 and i % every == every - 1:
                return MoEFFN(H, mlp, experts, opts.moe_selected, opts.moe_capacity)
            return _FeedForward(H, mlp)

        self.layers = nn.ModuleList(
            _Layer(_PreNorm(H, _Attention(H, config.num_heads)), _PreNorm(H, ffn(i)))
            for i in range(config.num_layers))


class ModelVIT(nn.Module):
    """ModelVIT.  ``forward(img, labels=None, train=False, generator=None)``
    takes img (B, M, C, D, H, W) and returns logits (B, num_classes) float32,
    or (logits, loss) when labels are given — as the JAX ``apply``.

    Parameters are made on ``device`` (default CUDA; raises on a host without
    it) from ``generator`` with the reference's init distributions."""

    # the trunk the pipeline splits over 'pipe' (parallel.pipeline.shard_stages)
    PIPELINE_TRUNK = "transformer.layers"

    def __init__(self, config: Config, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None, master_weights: bool = False):
        super().__init__()
        device = resolve_device(device)
        img, patch = tuple(config.img_size), tuple(config.patch_size)
        if any(i % p for i, p in zip(img, patch)):
            raise ValueError(f"image dimensions {img} must be divisible by the patch size {patch}")
        if int(config.get("pipeline_stages", 0)) > 1 and _moe_fields(config)[0] > 1:
            raise ValueError("pipeline_stages does not compose with moe_experts (the GPipe "
                             "schedule does not thread the MoE balance loss)")
        self.config = config
        H = config.hidden_dim
        self.opts = _opts(config)
        self.drop_path = float(config.get("drop_path_rate", 0.0))
        self.activation_dtype = getattr(torch, config.get("activation_dtype", "float32"))
        self.num_modalities = config.num_modalities
        n = num_patches(img, patch) * config.num_modalities
        patch_dim = patch[0] * patch[1] * patch[2] * config.in_channels

        with device:    # allocate every parameter on the target device
            self.pos_embedding = nn.Parameter(torch.empty(1, n + 1, H))
            self.cls_token = nn.Parameter(torch.empty(1, 1, H))
            self.patch_to_embedding = nn.Linear(patch_dim, H)
            self.transformer = _Layers(config, self.opts)
            self.mlp_head = nn.ModuleDict({"0": nn.LayerNorm(H),
                                           "1": nn.Linear(H, config.mlp_dim),
                                           "4": nn.Linear(config.mlp_dim, config.num_classes)})
        self.reset_parameters(generator)
        self.moe_aux = None
        self.master_weights = master_weights
        if self.opts.compute_dtype is not None and not master_weights:
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    mod.weight.data = mod.weight.data.to(self.opts.compute_dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Xavier-uniform Linears (and MoE experts and routers) with zero
        bias, ones/zeros LayerNorm, N(0, 0.02) pos-embedding and CLS."""
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

    def tp_regions(self) -> list[tuple[str, nn.Module]]:
        """The modules tensor parallelism splits (see ``ModelCross``)."""
        return tp_regions(self)

    def blocks(self) -> list[nn.Module]:
        """The trunk layers (this stage's, over a 'pipe' axis: the others
        are empty placeholders), each called as a module: the units FSDP
        gathers one at a time (``parallel.shard_params``), as JAX gathers
        each layer's leaves at their use."""
        return [layer for layer in self.transformer.layers if isinstance(layer, _Layer)]

    def _layer(self, layer: _Layer, x: torch.Tensor, generator: torch.Generator | None,
               train: bool, run: _Run) -> torch.Tensor:
        """One pre-norm trunk layer (JAX ``layer_fn_bal``); with
        ``config.remat`` a rematerialised region (``ops/remat.py``), as JAX
        wraps ``layer_fn_bal`` (:162-165), under the pipeline too."""
        return layer(x, self, generator, train, run)

    def _layer_body(self, layer: nn.Module, x: torch.Tensor,
                    generator: torch.Generator | None, train: bool, run: _Run) -> torch.Tensor:
        o = self.opts
        a, f = layer["0"], layer["2"]
        to_out = a.fn.to_out["0"] if a.fn.to_out is not None else None
        y = self_attention(layernorm(x, a.norm.weight, a.norm.bias), a.fn.to_qkv, to_out,
                           o.num_heads, o.compute_dtype, o.impl, o.dropout, generator, train,
                           a.fn.tp)
        x = stochastic_depth_row(y, self.drop_path, generator, train) + x
        h = layernorm(x, f.norm.weight, f.norm.bias)
        if isinstance(f.fn, MoEFFN):
            y, aux = f.fn(h)
            if not remat.replaying():     # the forward recorded this site's terms
                run.moe.append(aux)
            y = dropout(y, o.dropout, generator, train)
        else:
            net = f.fn.net
            y = feed_forward(h, net["0"], net["3"], o.compute_dtype, o.gelu_approx,
                             o.dropout, generator, train, f.fn.tp)
        return stochastic_depth_row(y, self.drop_path, generator, train) + x

    def forward(self, img: torch.Tensor, labels: torch.Tensor | None = None,
                train: bool = False, generator: torch.Generator | None = None):
        o = self.opts
        if train and (o.dropout or self.drop_path) and generator is None:
            raise ValueError("train mode with dropout or drop path needs a torch.Generator "
                             "on the model's device")
        with dropout_bits(o.dropout_bits):
            return self._forward(img, labels, train, generator)

    def _forward(self, img: torch.Tensor, labels: torch.Tensor | None, train: bool,
                 generator: torch.Generator | None):
        cfg, o = self.config, self.opts
        img = img.to(self.activation_dtype)   # the one cast of the batch, before patchifying
        B, M = img.shape[:2]
        if M != self.num_modalities:
            raise ValueError(f"img has {M} modalities, the model {self.num_modalities}")
        emb = self.patch_to_embedding
        tokens = [linear(patchify_3d(img[:, m], tuple(cfg.patch_size)), emb.weight, emb.bias,
                         o.compute_dtype) for m in range(M)]
        x = torch.cat(tokens, dim=1)
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, x.shape[-1]), x], dim=1)
        x = dropout(x + self.pos_embedding.to(x.dtype), o.dropout, generator, train)
        run = _Run(train, generator)
        stages = int(cfg.get("pipeline_stages", 0))
        if stages > 1:
            layers = self.transformer.layers
            seeds = (torch.randint(0, 2 ** 62, (len(layers),), generator=generator,
                                   device=generator.device).tolist()
                     if train and generator is not None else None)
            x = pipeline_layers(layers, lambda layer, h, g: self._layer(layer, h, g, train, run),
                                x, seeds,
                                num_microbatches=int(cfg.get("pipeline_microbatches", stages)),
                                stage=getattr(self, "stage", None))
        else:
            for layer in self.transformer.layers:
                x = self._layer(layer, x, generator, train, run)
        head = self.mlp_head
        tp = getattr(head, "tp", None)
        h = layernorm(x[:, 0], head["0"].weight, head["0"].bias)
        h = linear_layer(head["1"], copy_to(h, tp), o.compute_dtype)
        h = dropout(gelu(h, approximate=False), o.dropout, generator, train, split=(-1, tp))
        h = linear_layer(head["4"], h, o.compute_dtype, tp)
        logits = dropout(h, o.dropout, generator, train).float()
        _keep_moe_aux(self, run)
        if labels is None:
            return logits
        return logits, _with_balance(cfg, cross_entropy(logits, labels), run)
