"""Checkpoint reading and writing, numpy only.

The JAX package writes one npz per checkpoint whose keys are the param tree's
paths joined by "/" — ``params/multi_blocks/0/self_blocks/1/0/attn/qkv/kernel``
— with a ``config*.json`` sidecar beside it
(``cross_attention_vit_tpu/train/checkpoint.py:37-90, 110-116, 194-214``).
This module reads and writes that same layout, so a checkpoint written by the
JAX ``CheckpointManager`` loads in the port and the port can write one.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..configs import Config


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts / lists of arrays → {"a/0/b": array} (the JAX key layout)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def unflatten(flat: dict[str, np.ndarray]):
    """Inverse of ``flatten``: a level whose keys are all integers is a list."""
    root: dict = {}
    for key, value in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def save_pytree(path: str | Path, tree) -> None:
    np.savez(path, **flatten(tree))


def restore_flat(path: str | Path) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_config(dirpath: str | Path, config: Config) -> Path:
    """Write the config sidecar the JAX ``CheckpointManager`` writes."""
    path = Path(dirpath) / "config.json"
    path.write_text(json.dumps(config.to_dict(), default=str, indent=1))
    return path


def load_config_for(checkpoint_path: str | Path) -> Config | None:
    """Find and load the config JSON persisted next to a checkpoint.
    Prefers the config whose run tag appears in the checkpoint filename."""
    path = Path(checkpoint_path)
    candidates = sorted(path.parent.glob("config*.json"))
    best = None
    for c in candidates:
        tag = c.stem[len("config"):].lstrip("_")
        if tag and tag in path.name:
            best = c
            break
        if not tag and best is None:
            best = c
    if best is None and candidates:
        best = candidates[0]
    if best is None:
        return None
    return Config(**json.loads(best.read_text()))
