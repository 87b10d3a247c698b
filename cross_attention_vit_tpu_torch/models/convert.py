"""JAX param tree ⇄ the port's state dict, for ModelCross and ModelVIT.

The port's parameter names are the reference torch state-dict names, so the
mapping is the JAX package's ``export_model_cross`` / ``import_model_cross``
and ``export_model_vit`` / ``import_model_vit``
(``cross_attention_vit_tpu/models/convert.py:95-253``), of which this module
keeps its own copy on numpy arrays:

  ModelCross state dict                     JAX param tree
  ------------------------------------------------------------------
  pos_embedding / cls_token                 pos_embedding / cls_token
  patch_to_embedding.{weight,bias}          patch_to_embedding (kernel=Wᵀ)
  transformer.{b}.blocks.{m}.{j}.attn.*     multi_blocks[b].self_blocks[m][j]
      .norm.{weight,bias}                     .attn_norm (scale, bias)
      .fn.to_qkv.weight (3H, H)               .attn.qkv.kernel (H,3,K,D)
      .fn.to_out.0.{weight,bias}              .attn.out (K,D,H)
  transformer.{b}.blocks.{m}.{j}.ffn.*        .ffn_norm / .ffn.fc1/.fc2
  a MoE site's ffn.fn.* (the port's names; the reference has no MoE):
      .router.weight (E, H)                   .ffn.router.kernel (H, E)
      .experts.fc1.{weight (E, mlp, H), bias}  .ffn.experts.fc1 (E, H, mlp)
      .experts.fc2.{weight (E, H, mlp), bias}  .ffn.experts.fc2 (E, mlp, H)
  transformer.{b}.fusion.{c}.attn.fn.wq/wk/wv/proj
                                            multi_blocks[b].cross_blocks[c].attn
  norm.{m}.* / mlp_head.{m}.{0,3}.*         norm[m] / mlp_head[m].fc1/.fc2

  ModelVIT state dict                       JAX param tree
  ------------------------------------------------------------------
  transformer.layers.{i}.0.*  (as .attn.*)  layers[i].attn_norm / .attn
  transformer.layers.{i}.2.*  (as .ffn.*)   layers[i].ffn_norm / .ffn
  mlp_head.0 / mlp_head.1 / mlp_head.4      head.norm / head.fc1 / head.fc2

Both directions dispatch on the family: a JAX tree with ``layers`` and a
state dict with ``transformer.layers.*`` keys are ModelVIT's.  A ModelVIT
with ``pipeline_stages > 1`` has JAX's stacked trunk: ``layers`` is one tree
whose leaves carry a leading depth axis (JAX ``model_vit.py:85-88``).  The
port reads stacked and per-layer trees alike and writes a stacked one for
such a config, so JAX restores it against ``init(cfg)``.  A heads==1
model has no ``to_out`` / ``out`` projection (the reference's Identity); the
port skips it both ways, where the JAX ``export_model_cross`` /
``export_model_vit`` raise KeyError.  The heads-axis layouts are reshapes of
the 2-D weights, so the mapping is exact in both directions.

The legacy families (``models/vit3d.py``, ``models/cnn_vit.py``,
``models/densenet.py``; the JAX package has no torch mapping for them) map
path by path: the JAX tree's dotted paths are the port's names, with
``kernel`` → ``weight`` (a Linear's transposed, a Conv3d's OIDHW as is),
``scale`` → ``weight``, and the BatchNorm state ``{"mean", "var"}`` →
``running_mean`` / ``running_var`` (``num_batches_tracked`` is not in JAX's
layout and stays the model's).  ViT3D's renames:

  ViT3D state dict                          JAX param tree
  ------------------------------------------------------------------
  transformer.layers.{i}.self_attn          layers[i]
      .in_proj_weight (3H, H) / _bias (3H)    .qkv.kernel (H,3,K,D) / .bias (3,K,D)
      .out_proj.{weight,bias}                 .out (K,D,H)
  transformer.layers.{i}.linear1/2, norm1/2 layers[i].fc1/fc2, norm1/norm2
  mlp_head.0 / .1 / .2                      head.norm / head.fc1 / head.fc2
  ...denselayer{j}.layers.{norm1,...}       ...denselayer{j}.{norm1,...} (DenseNet)
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..configs import Config
from ..parallel.pipeline import stack_layers, unstack_layers
from ..parallel.sharding import full_tensor, local_tensors, unwrap, whole_tensors
from ..train.checkpoint import flatten, unflatten


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


# -- JAX tree → state dict ---------------------------------------------------

def _exp_linear(p: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _exp_norm(p: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _exp_self_block(blk: dict, p: str, out: dict) -> None:
    _exp_norm(blk["attn_norm"], f"{p}.attn.norm", out)
    q = np.asarray(blk["attn"]["qkv"]["kernel"])
    out[f"{p}.attn.fn.to_qkv.weight"] = _t(q.reshape(q.shape[0], -1))
    if "out" in blk["attn"]:      # absent for heads==1 (the Identity quirk)
        o = np.asarray(blk["attn"]["out"]["kernel"])
        out[f"{p}.attn.fn.to_out.0.weight"] = _t(o.reshape(-1, o.shape[-1]))
        out[f"{p}.attn.fn.to_out.0.bias"] = np.asarray(blk["attn"]["out"]["bias"])
    _exp_norm(blk["ffn_norm"], f"{p}.ffn.norm", out)
    ffn = blk["ffn"]
    if "experts" not in ffn:
        _exp_linear(ffn["fc1"], f"{p}.ffn.fn.net.0", out)
        _exp_linear(ffn["fc2"], f"{p}.ffn.fn.net.3", out)
        return
    out[f"{p}.ffn.fn.router.weight"] = _t(ffn["router"]["kernel"])
    for fc in ("fc1", "fc2"):
        e = ffn["experts"][fc]
        out[f"{p}.ffn.fn.experts.{fc}.weight"] = _swap(e["kernel"])
        out[f"{p}.ffn.fn.experts.{fc}.bias"] = np.asarray(e["bias"])


def _swap(w) -> np.ndarray:
    """(E, in, out) ⇄ (E, out, in): the stacked expert kernels."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(w), 1, 2))


def _is_vit_tree(params: dict) -> bool:
    return "layers" in params


def _is_vit_state_dict(sd: dict) -> bool:
    return any(k.startswith("transformer.layers.") for k in sd)


def _exp_vit(params: dict) -> dict[str, np.ndarray]:
    out = {"pos_embedding": np.asarray(params["pos_embedding"]),
           "cls_token": np.asarray(params["cls_token"])}
    _exp_linear(params["patch_to_embedding"], "patch_to_embedding", out)
    layers = params["layers"]
    for i, blk in enumerate(unstack_layers(layers) if isinstance(layers, dict) else layers):
        p = f"transformer.layers.{i}"
        # the attention block is index 0, the feed-forward block index 2:
        # _exp_self_block writes them as .attn.* and .ffn.*
        layer: dict[str, np.ndarray] = {}
        _exp_self_block(blk, p, layer)
        out.update({k.replace(f"{p}.attn.", f"{p}.0.").replace(f"{p}.ffn.", f"{p}.2."): v
                    for k, v in layer.items()})
    _exp_norm(params["head"]["norm"], "mlp_head.0", out)
    _exp_linear(params["head"]["fc1"], "mlp_head.1", out)
    _exp_linear(params["head"]["fc2"], "mlp_head.4", out)
    return out


def state_dict_from_jax(params: dict, config: Config | None,
                        state: dict | None = None) -> dict[str, np.ndarray]:
    """JAX model_cross, model_vit or legacy param tree (numpy leaves) → the
    port's state dict; a legacy family's BatchNorm ``state`` tree, when
    given, becomes its running statistics."""
    if _legacy_family(params):
        return _legacy_sd(params, state)
    if _is_vit_tree(params):
        return _exp_vit(params)
    out = {
        "pos_embedding": np.asarray(params["pos_embedding"]),
        "cls_token": np.asarray(params["cls_token"]),
    }
    _exp_linear(params["patch_to_embedding"], "patch_to_embedding", out)
    for b, block in enumerate(params["multi_blocks"]):
        for m, stack in enumerate(block["self_blocks"]):
            for j, blk in enumerate(stack):
                _exp_self_block(blk, f"transformer.{b}.blocks.{m}.{j}", out)
        # an empty list has no leaves, so a flat checkpoint may lack the key
        for c, blk in enumerate(block.get("cross_blocks", [])):
            p = f"transformer.{b}.fusion.{c}"
            _exp_norm(blk["attn_norm"], f"{p}.attn.norm", out)
            for name in ("wq", "wk", "wv"):
                k = np.asarray(blk["attn"][name]["kernel"])
                out[f"{p}.attn.fn.{name}.weight"] = _t(k.reshape(k.shape[0], -1))
                out[f"{p}.attn.fn.{name}.bias"] = np.asarray(
                    blk["attn"][name]["bias"]).reshape(-1)
            pk = np.asarray(blk["attn"]["proj"]["kernel"])
            out[f"{p}.attn.fn.proj.weight"] = _t(pk.reshape(-1, pk.shape[-1]))
            out[f"{p}.attn.fn.proj.bias"] = np.asarray(blk["attn"]["proj"]["bias"])
            _exp_norm(blk["ffn_norm"], f"{p}.ffn.norm", out)
            _exp_linear(blk["ffn"]["fc1"], f"{p}.ffn.fn.net.0", out)
            _exp_linear(blk["ffn"]["fc2"], f"{p}.ffn.fn.net.3", out)
    for m, n in enumerate(params["norm"]):
        _exp_norm(n, f"norm.{m}", out)
    for m, head in enumerate(params["mlp_head"]):
        _exp_linear(head["fc1"], f"mlp_head.{m}.0", out)
        _exp_linear(head["fc2"], f"mlp_head.{m}.3", out)
    return out


# -- state dict → JAX tree ---------------------------------------------------

def _linear(sd, prefix: str) -> dict:
    p = {"kernel": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return p


def _norm(sd, prefix: str) -> dict:
    return {"scale": np.asarray(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _split_heads(w, heads: int, *lead: int) -> np.ndarray:
    """torch (out, H) weight → (H, *lead, K, D)."""
    w = np.asarray(w)
    H = w.shape[1]
    return _t(w).reshape(H, *lead, heads, H // heads)


def _head_out(w, heads: int) -> np.ndarray:
    """torch (H, H) weight → (K, D, H) (input axis is the merged heads)."""
    w = np.asarray(w)
    H = w.shape[1]
    return _t(w).reshape(heads, H // heads, H)


def _self_block_from(sd, p: str, heads: int) -> dict:
    attn = {"qkv": {"kernel": _split_heads(sd[f"{p}.attn.fn.to_qkv.weight"], heads, 3)}}
    if f"{p}.attn.fn.to_out.0.weight" in sd:
        attn["out"] = {"kernel": _head_out(sd[f"{p}.attn.fn.to_out.0.weight"], heads),
                       "bias": np.asarray(sd[f"{p}.attn.fn.to_out.0.bias"])}
    f = f"{p}.ffn.fn"
    if f"{f}.router.weight" in sd:
        ffn = {"router": {"kernel": _t(sd[f"{f}.router.weight"])},
               "experts": {fc: {"kernel": _swap(sd[f"{f}.experts.{fc}.weight"]),
                                "bias": np.asarray(sd[f"{f}.experts.{fc}.bias"])}
                           for fc in ("fc1", "fc2")}}
    else:
        ffn = {"fc1": _linear(sd, f"{f}.net.0"), "fc2": _linear(sd, f"{f}.net.3")}
    return {
        "attn_norm": _norm(sd, f"{p}.attn.norm"),
        "attn": attn,
        "ffn_norm": _norm(sd, f"{p}.ffn.norm"),
        "ffn": ffn,
    }


def _vit_from(sd: dict, heads: int) -> dict:
    layers = []
    i = 0
    while f"transformer.layers.{i}.0.norm.weight" in sd:
        p = f"transformer.layers.{i}"
        # _self_block_from reads .attn.* and .ffn.*: the blocks at 0 and 2
        layer = {k.replace(f"{p}.0.", f"{p}.attn.").replace(f"{p}.2.", f"{p}.ffn."): v
                 for k, v in sd.items() if k.startswith(f"{p}.")}
        layers.append(_self_block_from(layer, p, heads))
        i += 1
    return {
        "pos_embedding": np.asarray(sd["pos_embedding"]),
        "cls_token": np.asarray(sd["cls_token"]),
        "patch_to_embedding": _linear(sd, "patch_to_embedding"),
        "layers": layers,
        "head": {"norm": _norm(sd, "mlp_head.0"), "fc1": _linear(sd, "mlp_head.1"),
                 "fc2": _linear(sd, "mlp_head.4")},
    }


def jax_params_from_state_dict(sd: dict, config: Config | None) -> dict:
    """The port's state dict (numpy values) → JAX model_cross, model_vit or
    legacy param tree (buffers left out)."""
    if _legacy_family(sd):
        return _legacy_tree(sd, config.num_heads if config is not None else None, "params")
    heads = config.num_heads
    if _is_vit_state_dict(sd):
        params = _vit_from(sd, heads)
        if int(config.get("pipeline_stages", 0)) > 1:
            params["layers"] = stack_layers(params["layers"])
        return params
    M = config.num_modalities
    params = {
        "pos_embedding": np.asarray(sd["pos_embedding"]),
        "cls_token": np.asarray(sd["cls_token"]),
        "patch_to_embedding": _linear(sd, "patch_to_embedding"),
        "multi_blocks": [],
        "norm": [_norm(sd, f"norm.{m}") for m in range(M)],
        "mlp_head": [{"fc1": _linear(sd, f"mlp_head.{m}.0"),
                      "fc2": _linear(sd, f"mlp_head.{m}.3")}
                     for m in range(M)],
    }
    n_cross = len([k for k in sd if k.startswith("transformer.0.fusion.")
                   and k.endswith("attn.fn.wq.weight")])
    for b in range(config.num_multi_blocks):
        block = {
            "self_blocks": [
                [_self_block_from(sd, f"transformer.{b}.blocks.{m}.{j}", heads)
                 for j in range(config.num_self_blocks)]
                for m in range(M)
            ],
            "cross_blocks": [],
        }
        for c in range(n_cross):
            p = f"transformer.{b}.fusion.{c}"
            block["cross_blocks"].append({
                "attn_norm": _norm(sd, f"{p}.attn.norm"),
                "attn": {
                    **{name: {"kernel": _split_heads(sd[f"{p}.attn.fn.{name}.weight"], heads),
                              "bias": np.asarray(sd[f"{p}.attn.fn.{name}.bias"])
                              .reshape(heads, -1)}
                       for name in ("wq", "wk", "wv")},
                    "proj": {"kernel": _head_out(sd[f"{p}.attn.fn.proj.weight"], heads),
                             "bias": np.asarray(sd[f"{p}.attn.fn.proj.bias"])},
                },
                "ffn_norm": _norm(sd, f"{p}.ffn.norm"),
                "ffn": {"fc1": _linear(sd, f"{p}.ffn.fn.net.0"),
                        "fc2": _linear(sd, f"{p}.ffn.fn.net.3")},
            })
        params["multi_blocks"].append(block)
    return params


# -- the legacy families ------------------------------------------------------

# (JAX dotted path, port name) renames, applied in order; the leaf names after
_TO_PORT = ((r"^layers\.(\d+)\.qkv\.kernel$", r"transformer.layers.\1.self_attn.in_proj_weight"),
            (r"^layers\.(\d+)\.qkv\.bias$", r"transformer.layers.\1.self_attn.in_proj_bias"),
            (r"^layers\.(\d+)\.out\.", r"transformer.layers.\1.self_attn.out_proj."),
            (r"^layers\.(\d+)\.fc([12])\.", r"transformer.layers.\1.linear\2."),
            (r"^layers\.(\d+)\.(norm[12])\.", r"transformer.layers.\1.\2."),
            (r"^head\.norm\.", "mlp_head.0."), (r"^head\.fc1\.", "mlp_head.1."),
            (r"^head\.fc2\.", "mlp_head.2."), (r"(denselayer\d+)\.", r"\1.layers."),
            (r"\.(kernel|scale)$", ".weight"), (r"\.mean$", ".running_mean"),
            (r"\.var$", ".running_var"))
_TO_JAX = ((r"^transformer\.layers\.(\d+)\.self_attn\.in_proj_weight$", r"layers.\1.qkv.kernel"),
           (r"^transformer\.layers\.(\d+)\.self_attn\.in_proj_bias$", r"layers.\1.qkv.bias"),
           (r"^transformer\.layers\.(\d+)\.self_attn\.out_proj\.weight$", r"layers.\1.out.kernel"),
           (r"^transformer\.layers\.(\d+)\.self_attn\.out_proj\.", r"layers.\1.out."),
           (r"^transformer\.layers\.(\d+)\.linear([12])\.", r"layers.\1.fc\2."),
           (r"^transformer\.layers\.(\d+)\.(norm[12])\.", r"layers.\1.\2."),
           (r"^mlp_head\.0\.", "head.norm."), (r"^mlp_head\.1\.", "head.fc1."),
           (r"^mlp_head\.2\.", "head.fc2."), (r"(denselayer\d+)\.layers\.", r"\1."),
           (r"\.running_mean$", ".mean"), (r"\.running_var$", ".var"))


def _legacy_family(keys) -> bool:
    """A ViT3D, CNNViT or DenseNet121 tree (top-level keys) or state dict."""
    keys = set(keys)
    return bool(keys & {"encoder", "stem", "features"}) or any(
        k.startswith(("encoder.", "stem.", "features.")) for k in keys)


def _rename(path: str, rules) -> str:
    for pattern, repl in rules:
        path = re.sub(pattern, repl, path)
    return path


def _legacy_sd(params: dict, state: dict | None) -> dict[str, np.ndarray]:
    out = {}
    for tree in (params, state or {}):
        for path, v in flatten(tree).items():
            name = _rename(path.replace("/", "."), _TO_PORT)
            v = np.asarray(v)
            if name.endswith("in_proj_weight"):          # (H, 3, K, D) → (3H, H)
                v = _t(v.reshape(v.shape[0], -1))
            elif name.endswith("in_proj_bias"):          # (3, K, D) → (3H,)
                v = v.reshape(-1)
            elif name.endswith("out_proj.weight"):       # (K, D, H) → (H, H)
                v = _t(v.reshape(-1, v.shape[-1]))
            elif path.endswith("kernel") and v.ndim == 2:
                v = _t(v)
            out[name] = v
    return out


def _legacy_tree(sd: dict, heads: int | None, which: str) -> dict:
    """The JAX param tree (``which="params"``) or BatchNorm state tree
    (``"state"``) of a legacy family's state dict."""
    flat = {}
    for name, v in sd.items():
        is_state = name.endswith(("running_mean", "running_var"))
        if name.endswith("num_batches_tracked") or is_state != (which == "state"):
            continue
        path = _rename(name, _TO_JAX)
        v = np.asarray(v)
        if name.endswith("in_proj_weight"):
            H = v.shape[1]
            v = _t(v).reshape(H, 3, heads, H // heads)
        elif name.endswith("in_proj_bias"):
            v = v.reshape(3, heads, -1)
        elif name.endswith("out_proj.weight"):
            H = v.shape[1]
            v = _t(v).reshape(heads, H // heads, H)
        elif path.endswith(".weight"):
            path = path[:-len("weight")] + ("scale" if v.ndim == 1 else "kernel")
            if v.ndim == 2:
                v = _t(v)
        flat[path.replace(".", "/")] = v
    return unflatten(flat)


def jax_state_from_state_dict(sd: dict) -> dict:
    """A legacy family's BatchNorm running statistics as JAX's state tree
    (``{"encoder": {"bn1": {"mean", "var"}, ...}}``); {} for a stateless one."""
    return _legacy_tree(sd, None, "state")


# -- checkpoints and modules ---------------------------------------------------

def params_from_flat(flat: dict[str, np.ndarray]) -> dict:
    """The nested param tree from a checkpoint's flat ``params/...`` keys."""
    prefix = "params/"
    return unflatten({k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)})


def load_jax_params(model: torch.nn.Module, params: dict, state: dict | None = None) -> None:
    """Load a JAX param tree into the port's model (strict: every key and
    shape must match).  Values are cast to each parameter's dtype on copy —
    the compute-dtype cast the JAX package makes on every call.  A legacy
    family loads its BatchNorm running statistics from ``state`` (JAX's
    state tree); a model with BatchNorm layers and no ``state`` raises, as
    JAX cannot apply such a model without its state.  A model placed over a mesh
    (``parallel.shard_params``) loads too: each rank reads the whole tree and
    keeps its part of it — its FSDP shard, its experts on an 'expert' axis,
    its stage's layers on 'pipe', its slices on 'model'
    (``parallel.local_tensors``)."""
    model = unwrap(model)
    config = getattr(model, "config", None)
    own = model.state_dict()
    if state is None and any(k.endswith("running_mean") for k in own):
        raise ValueError(f"{type(model).__name__} has BatchNorm layers: load its params "
                         "with JAX's state tree of running statistics")
    sd = {k: torch.as_tensor(np.array(v))
          for k, v in local_tensors(model, state_dict_from_jax(params, config, state)).items()}
    # num_batches_tracked is not in JAX's layout: the model keeps its count
    sd.update({k: v for k, v in own.items() if k.endswith("num_batches_tracked")})
    sharded = {n: p for n, p in model.named_parameters() if isinstance(p, DTensor)}
    if not sharded:
        model.load_state_dict(sd, strict=True)
        return
    # load_state_dict cannot copy a whole tensor into a shard: place the
    # sharded ones here, the rest through it
    with torch.no_grad():
        for name, p in sharded.items():
            whole = sd.pop(name).to(p.device, p.dtype)
            if tuple(whole.shape) != tuple(p.shape):
                raise RuntimeError(f"size mismatch for {name}: copying a param with shape "
                                   f"{tuple(whole.shape)}, the model's is {tuple(p.shape)}")
            p.copy_(distribute_tensor(whole, p.device_mesh, p.placements, src_data_rank=None))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if k not in sharded]
    if missing or unexpected:
        raise RuntimeError(f"state dict mismatch: missing {missing}, unexpected {unexpected}")


def _host_state_dict(model: torch.nn.Module) -> dict[str, np.ndarray]:
    model = unwrap(model)
    sd = whole_tensors(model, {k: full_tensor(v).detach()
                               for k, v in model.state_dict().items()})
    # copies: on the CPU a view would follow the live parameter (and an
    # asynchronous checkpoint write would see the next steps' values)
    return {k: v.to("cpu", torch.float32, copy=True).numpy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def jax_params_from_model(model: torch.nn.Module) -> dict:
    """The port's model → JAX param tree of float32 numpy arrays.  A model
    placed over a mesh gives its whole parameters (a collective when they
    are split: every rank calls it)."""
    return jax_params_from_state_dict(_host_state_dict(model),
                                      getattr(unwrap(model), "config", None))


def jax_state_from_model(model: torch.nn.Module) -> dict:
    """A legacy family's BatchNorm running statistics → JAX's state tree of
    float32 numpy arrays."""
    return jax_state_from_state_dict(_host_state_dict(model))
