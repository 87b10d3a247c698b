"""BrainDataset — UCSF-PDGM NIfTI dataset with the reference's semantics.

Port of ``cross_attention_vit_tpu/data/dataset.py`` (reference
dataset_ucsf.py:73-158): per index, load one ``.nii.gz`` per requested
modality, pad/crop to ``config.img_size`` with constant −1, and return
``(img (M, 1, D, H, W) float32, label int)``.  The host decodes and pads or
crops only; augmentation runs batched on the device inside the train step
(``data/augment.py``).  Decoded volumes can be cached in memory, and on disk
as raw ``.npy`` files written through a unique temp name and an atomic
rename, so later epochs and later runs over the same cohort skip the gunzip.

Rows come from a ``labels.Table``; the sampler draws with numpy's
``default_rng((seed, epoch, host))``, so its draws equal the JAX package's.
"""

from __future__ import annotations

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np

from ..configs import Config
from .labels import Table
from .nifti import read_volume_cropped, volume_path


class BrainDataset:
    """Map-style dataset: ``len(ds)``, ``ds[i] -> (np.ndarray (M,1,D,H,W) f32, int)``."""

    def __init__(self, data: Table, config: Config, types: Sequence[str] = ("T1c", "T2"),
                 is_train: bool = True, folder: str | Path = "ucsf-data", cache: bool = True,
                 decode_workers: int = 0, use_native: bool | None = None,
                 disk_cache: str | Path | None = None):
        self.target = config.target
        self.data = data
        self.types = tuple(types)
        self.is_train = is_train
        self.folder = folder
        self.img_size = tuple(config.img_size)
        self._cache: dict[tuple[str, str], np.ndarray] | None = {} if cache else None
        self._pool = ThreadPoolExecutor(max_workers=decode_workers) if decode_workers > 0 else None
        if use_native is None:
            from . import native
            use_native = native.available()
        self.use_native = use_native
        self._disk_cache = Path(disk_cache) if disk_cache else None
        if self._disk_cache is not None:
            self._disk_cache.mkdir(parents=True, exist_ok=True)
        # without a cache the C++ batch decoder beats per-item Python; with
        # one, per-item (cached) reads win after the first epoch
        self.fast_batch = bool(use_native and self._cache is None and self._disk_cache is None)

    def __len__(self) -> int:
        return len(self.data)

    def _decode(self, case_id: str, mri_type: str) -> np.ndarray:
        path = volume_path(self.folder, case_id, mri_type)
        if self.use_native:
            from . import native
            return native.decode_crop(path, self.img_size, fill=-1.0)
        return read_volume_cropped(path, self.img_size, fill=-1.0)

    def _load_one(self, case_id: str, mri_type: str) -> np.ndarray:
        key = (case_id, mri_type)
        if self._cache is not None and key in self._cache:
            return self._cache[key]
        vol = None
        disk_path = None
        if self._disk_cache is not None:
            size_tag = "x".join(map(str, self.img_size))
            disk_path = self._disk_cache / f"{case_id}_{mri_type}_{size_tag}.npy"
            if disk_path.exists():
                vol = np.load(disk_path)[None]
        if vol is None:
            vol = self._decode(case_id, mri_type)[None]
            if disk_path is not None:
                # a unique temp name: replacement sampling repeats indices, so
                # two loader threads can race the first write of one volume;
                # each writes its own temp file and renames it over the target
                fd, tmp = tempfile.mkstemp(suffix=".tmp.npy", dir=str(disk_path.parent))
                try:
                    with os.fdopen(fd, "wb") as f:
                        np.save(f, vol[0])
                    os.replace(tmp, disk_path)
                except BaseException:
                    Path(tmp).unlink(missing_ok=True)
                    raise
        if self._cache is not None:
            self._cache[key] = vol
        return vol  # (1, D, H, W)

    def __getitem__(self, index: int) -> tuple[np.ndarray, int]:
        case_id = self.data["ID"][index]
        label = int(self.data[self.target][index])
        if self._pool is not None:
            vols = list(self._pool.map(lambda t: self._load_one(case_id, t), self.types))
        else:
            vols = [self._load_one(case_id, t) for t in self.types]
        return np.stack(vols), label  # (M, 1, D, H, W), int

    def batch(self, indices: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        if self.fast_batch:
            return self._batch_native(indices)
        items = [self[i] for i in indices]
        imgs = np.stack([it[0] for it in items])
        labels = np.asarray([it[1] for it in items], dtype=np.int32)
        return imgs, labels

    def _batch_native(self, indices: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        """One C++ call decodes every (sample, modality) volume of the batch
        straight into the batch buffer (native/nifti_decode.cpp batch API)."""
        from . import native

        ids = [self.data["ID"][i] for i in indices]
        paths = [volume_path(self.folder, c, t) for c in ids for t in self.types]
        flat = native.decode_crop_batch(paths, self.img_size, fill=-1.0,
                                        num_threads=min(8, len(paths)))
        imgs = flat.reshape(len(ids), len(self.types), 1, *self.img_size)
        labels = np.asarray([int(self.data[self.target][i]) for i in indices], dtype=np.int32)
        return imgs, labels


def create_sampler_weights(train_df: Table, target: str) -> np.ndarray:
    """Inverse-class-frequency weights (reference main_mist.py:44-53)."""
    y = np.asarray(train_df[target], dtype=np.float64)
    num_negative = int((y == 0).sum())
    num_positive = len(y) - num_negative
    class_weights = 1.0 / np.asarray([num_negative, num_positive], dtype=np.float64)
    return class_weights[y.astype(int)]


class WeightedRandomSampler:
    """Replacement sampling with per-sample weights, per torch's
    WeightedRandomSampler semantics (``num_samples`` indices drawn with
    probability ∝ weight, with replacement), seeded by (seed, epoch, host)."""

    def __init__(self, weights: np.ndarray, num_samples: int, seed: int = 0):
        self.p = np.asarray(weights, dtype=np.float64)
        self.p = self.p / self.p.sum()
        self.num_samples = num_samples
        self.seed = seed

    def epoch_indices(self, epoch: int, host_id: int = 0, num_hosts: int = 1) -> np.ndarray:
        """One epoch's index draw; with several hosts each draws its own
        num_samples/num_hosts indices from a (seed, epoch, host_id) stream."""
        rng = np.random.default_rng((self.seed, epoch, host_id))
        n = self.num_samples // num_hosts if num_hosts > 1 else self.num_samples
        return rng.choice(len(self.p), size=max(n, 1), replace=True, p=self.p)
