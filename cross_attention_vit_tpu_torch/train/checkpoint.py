"""Checkpoint reading and writing, numpy only.

The JAX package writes one npz per checkpoint whose keys are the param tree's
paths joined by "/" — ``params/multi_blocks/0/self_blocks/1/0/attn/qkv/kernel``,
``opt/step``, ``opt/mu/...``, ``opt/nu/...``, ``epoch`` — with a
``config*.json`` sidecar beside it
(``cross_attention_vit_tpu/train/checkpoint.py``).  This module reads and
writes that same layout, so a checkpoint written by the JAX
``CheckpointManager`` loads in the port and the port can write one.

``CheckpointManager`` keeps the top k by a monitored metric with JAX's
run-tagged file names and manifest; ``LatestCheckpointer`` keeps the rolling
"latest step" checkpoints for resume.  Either can write on one background
thread (``async_write``): the state is already a host snapshot, the file goes
to a temp name and is renamed into place, and ``wait_for_writes`` blocks until
every queued write is durable.  ``write_seconds()`` totals the time spent in
``np.savez``.
"""

from __future__ import annotations

import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..configs import Config

# One background writer: a full-size state is ~2.9 GB; its snapshot is taken
# synchronously, the file write overlaps the next epoch's compute.
_writer = ThreadPoolExecutor(max_workers=1)
_pending: list = []
_write_seconds = [0.0]


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


def wait_for_writes() -> None:
    """Block until all async checkpoint writes are durable."""
    while _pending:
        _pending.pop().result()


def write_seconds() -> float:
    """Seconds spent writing checkpoint files so far in this process."""
    return _write_seconds[0]


def _savez(path: Path, flat: dict) -> None:
    t0 = time.perf_counter()
    np.savez(path, **flat)
    _write_seconds[0] += time.perf_counter() - t0


def save_pytree(path: str | Path, tree, async_write: bool = False) -> None:
    """Write ``tree`` (nested dicts and lists of arrays, or a flat dict with
    "/" keys) as one npz, inline or on the background writer; an async write
    goes through a temp file and an atomic rename, so a crash mid-write never
    leaves a torn checkpoint."""
    flat = flatten(tree)
    path = Path(path)
    if not async_write:
        _savez(path, flat)
        return

    def write():
        tmp = path.with_suffix(".tmp.npz")
        _savez(tmp, flat)
        os.replace(tmp, path)

    _pending.append(_writer.submit(write))


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


class CheckpointManager:
    """Top-k retention keyed on a monitored metric.

    mode='min' keeps the k smallest (val_loss); file names embed the epoch
    and the metric like the reference's ``{epoch:02d}-{val_loss:.4f}<tag>``,
    and a ``manifest<_tag>.json`` lists the kept files, best first.  The
    config sidecar ``config<_tag>.json`` lets evaluation rebuild the model."""

    def __init__(self, dirpath: str | Path, monitor: str = "val_loss", save_top_k: int = 10,
                 mode: str = "min", tag: str = "", async_write: bool = False, config=None):
        self.dir = Path(dirpath)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.k = save_top_k
        self.mode = mode
        self.tag = tag
        self.async_write = async_write
        suffix = f"_{tag}" if tag else ""
        if config is not None:
            cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config)
            (self.dir / f"config{suffix}.json").write_text(json.dumps(cfg, default=str, indent=1))
        self._manifest_path = self.dir / f"manifest{suffix}.json"
        self._entries: list[dict] = []
        if self._manifest_path.exists():
            seen = set()
            for e in json.loads(self._manifest_path.read_text()):
                if e["file"] not in seen:
                    seen.add(e["file"])
                    self._entries.append(e)

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def save(self, epoch: int, metric_value: float, state) -> Path | None:
        """Write ``state`` if it ranks in the top k; returns the path, or None."""
        if self.k > 0 and len(self._entries) >= self.k:
            if not self._better(metric_value, self._entries[-1]["metric"]):
                return None
        fname = f"epoch={epoch:02d}-{self.monitor}={metric_value:.4f}{self.tag}.npz"
        path = self.dir / fname
        existing = next((e for e in self._entries if e["file"] == fname), None)
        if (existing is not None and existing.get("epoch") == epoch
                and existing["metric"] == float(metric_value) and path.exists()):
            # a resumed run replaying this epoch bit for bit: the durable file
            # already holds these bytes
            return path
        save_pytree(path, state, async_write=self.async_write)
        self._entries = [e for e in self._entries if e["file"] != fname]
        self._entries.append({"epoch": epoch, "metric": float(metric_value), "file": fname})
        self._entries.sort(key=lambda e: e["metric"], reverse=(self.mode != "min"))
        drops = []
        while self.k > 0 and len(self._entries) > self.k:
            drops.append(self.dir / self._entries.pop()["file"])
        if drops:
            if self.async_write:
                # queued behind the pending writes on the one writer thread, so
                # a dropped file is removed only after its own write landed
                _pending.append(_writer.submit(self._remove_files, drops))
            else:
                self._remove_files(drops)
        self._manifest_path.write_text(json.dumps(self._entries, indent=1))
        return path

    @staticmethod
    def _remove_files(paths) -> None:
        for p in paths:
            Path(p).unlink(missing_ok=True)

    def best(self) -> dict | None:
        return self._entries[0] if self._entries else None

    def best_path(self) -> Path | None:
        e = self.best()
        return self.dir / e["file"] if e else None


_LATEST_RE = re.compile(r"step=(\d+)\.npz$")


class LatestCheckpointer:
    """Rolling "latest step" checkpoints for preemption-safe resume; keeps the
    newest ``keep``."""

    def __init__(self, dirpath: str | Path, keep: int = 2, async_write: bool = False):
        self.dir = Path(dirpath)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write

    def save(self, step: int, state) -> Path:
        path = self.dir / f"step={step}.npz"
        save_pytree(path, state, async_write=self.async_write)
        if self.async_write:
            _pending.append(_writer.submit(self._prune))
        else:
            self._prune()
        return path

    def _complete(self) -> list[tuple[int, Path]]:
        """(step, path) of durable saves only: a write killed before its
        rename leaves ``step=N.tmp.npz``, which the glob matches and the
        pattern does not."""
        out = []
        for p in self.dir.glob("step=*.npz"):
            m = _LATEST_RE.search(p.name)
            if m:
                out.append((int(m.group(1)), p))
        return sorted(out)

    def _prune(self) -> None:
        for _, old in self._complete()[:-self.keep]:
            old.unlink()

    def latest_step(self) -> int | None:
        steps = [s for s, _ in self._complete()]
        for p in self.dir.glob("step=*.tmp.npz"):    # partial writes never finish
            p.unlink(missing_ok=True)
        return max(steps) if steps else None

    def restore_latest(self) -> tuple[int | None, dict | None]:
        """(step, flat state) of the newest durable checkpoint, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore_flat(self.dir / f"step={step}.npz")
