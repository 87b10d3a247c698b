"""Checkpoint migration CLI: torch reference checkpoints ⇄ the JAX npz layout.

Port of ``cross_attention_vit_tpu/drivers/convert.py``, on the port's own
mapping (``models/convert.py``: ``jax_params_from_state_dict``,
``state_dict_from_jax``):

  # torch/Lightning checkpoint → npz (+ config JSON beside it)
  python -m cross_attention_vit_tpu_torch.drivers.convert \\
      --torch-ckpt epoch=...ckpt --model cross \\
      --img-types DWI SWI ASL --attn-order 0:1,1:2,2:0 --out migrated.npz

  # npz → reference-shaped torch state dict
  python -m cross_attention_vit_tpu_torch.drivers.convert \\
      --checkpoint runs/checkpoints/cross/epoch=..npz --model cross \\
      --export --out reference_sd.pt

Accepted torch containers: a bare state dict, Lightning's ``{"state_dict":
...}`` (main_mist.py:216) and the legacy trainer's ``{"model_state_dict":
...}`` (other_model.py:341-351); a ``model.`` prefix on every key is
stripped.  The npz holds ``{params, epoch}`` with the config JSON beside it,
so the port's ``drivers.evaluate`` and ``drivers.serve`` (and the JAX
package's) read it directly.  Either direction loads the weights strictly
into the port's model on ``device`` (default CUDA; raises without it), so a
key or shape the model lacks fails the conversion.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import torch

from ..configs import get_mgmt_config, get_mgmt_cross_config, modify_config
from ..models.convert import (jax_params_from_state_dict, load_jax_params, params_from_flat,
                              state_dict_from_jax)
from ..models.model_cross import ModelCross
from ..models.model_vit import ModelVIT
from ..train.checkpoint import load_config_for, restore_flat, save_pytree
from ..utils.device import resolve_device

_FAMILIES = {"cross": (ModelCross, get_mgmt_cross_config),
             "vit": (ModelVIT, get_mgmt_config)}


def _unwrap_state_dict(obj) -> dict[str, np.ndarray]:
    """The known torch checkpoint containers peeled to a flat state dict of
    numpy arrays, a uniform 'model.' prefix stripped."""
    for key in ("state_dict", "model_state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"unrecognized checkpoint container: {type(obj)}")
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in obj.items()}
    if sd and all(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()}
    return sd


def _check_loads(model: str, cfg, params: dict, device: torch.device) -> None:
    load_jax_params(_FAMILIES[model][0](cfg, device=device), params)


def import_torch_checkpoint(torch_ckpt: str | Path, model: str, cfg, out: str | Path,
                            device: str | torch.device = "cuda") -> Path:
    """torch checkpoint file → npz + config JSON; returns the npz path."""
    device = resolve_device(device)
    sd = _unwrap_state_dict(torch.load(torch_ckpt, map_location="cpu", weights_only=False))
    params = jax_params_from_state_dict(sd, cfg)
    _check_loads(model, cfg, params, device)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_pytree(out, {"params": params, "epoch": np.zeros((), np.int32)})
    (out.parent / f"config_{out.stem}.json").write_text(
        json.dumps(cfg.to_dict(), default=str, indent=1))
    return out


def export_torch_checkpoint(checkpoint: str | Path, model: str, cfg, out: str | Path,
                            device: str | torch.device = "cuda") -> Path:
    """npz → reference-shaped torch state dict (``torch.save``)."""
    device = resolve_device(device)
    params = params_from_flat(restore_flat(checkpoint))
    _check_loads(model, cfg, params, device)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in state_dict_from_jax(params, cfg).items()}, out)
    return out


def _parse_attn_order(text: str) -> dict:
    if not text:
        return {}
    return dict(pair.split(":") for pair in text.split(","))


def main(argv=None, device: str = "cuda") -> Path:
    """The JAX CLI's flags; ``device`` is where the strict load runs (a
    keyword for in-process callers, not a flag)."""
    import argparse

    p = argparse.ArgumentParser(description="migrate checkpoints torch ⇄ npz")
    p.add_argument("--model", choices=list(_FAMILIES), default="cross")
    p.add_argument("--torch-ckpt", help="torch/Lightning checkpoint to import")
    p.add_argument("--checkpoint", help="an npz (for --export, or as the config source when "
                                        "its JSON exists)")
    p.add_argument("--export", action="store_true",
                   help="reverse direction: npz → torch state dict")
    p.add_argument("--out", required=True)
    p.add_argument("--img-types", nargs="+", default=["DWI", "SWI", "ASL"])
    p.add_argument("--attn-order", default="")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config overrides, parsed as Python literals")
    args = p.parse_args(argv)
    resolve_device(device)

    cfg = load_config_for(args.checkpoint) if args.checkpoint else None
    if cfg is None:
        cfg = _FAMILIES[args.model][1]()
        modify_config(cfg, dict(num_modalities=len(args.img_types), dropout=0.0, lr=1e-4,
                                weight_decay=0.0, label_smoothing=0.0, img_aug=False,
                                attn_order=_parse_attn_order(args.attn_order),
                                optim_params={"T_max": 1, "eta_min": 0}))
    if args.attn_order:
        modify_config(cfg, {"attn_order": _parse_attn_order(args.attn_order)})
    for kv in args.set:
        key, _, value = kv.partition("=")
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        modify_config(cfg, {key: value})

    if args.export:
        if not args.checkpoint:
            p.error("--export needs --checkpoint")
        out = export_torch_checkpoint(args.checkpoint, args.model, cfg, args.out, device)
        print(f"exported torch state dict: {out}")
    else:
        if not args.torch_ckpt:
            p.error("import needs --torch-ckpt")
        out = import_torch_checkpoint(args.torch_ckpt, args.model, cfg, args.out, device)
        print(f"imported checkpoint: {out} (+ config_{Path(out).stem}.json)")
    return out


if __name__ == "__main__":
    main()
