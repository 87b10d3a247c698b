"""Legacy RSNA-BraTS DICOM dataset — the reference's earlier-phase ingest.

Port of ``cross_attention_vit_tpu/data/dataset_rsna.py`` (reference dataset.py
``BrainRSNADataset``), numpy only, over a ``labels.Table`` where the JAX
class takes a pandas frame (the card's host has no pandas):

  * per case, slice files sorted naturally by the digits in their names
    (dataset.py:137-142);
  * brain-region crop: bounding box of the > 0 pixels (crop_img,
    dataset.py:49-69), used only to pick the biggest slice;
  * the "biggest slice", the one whose cropped brain area is largest,
    computed once per case and type and cached as JSON, written through a
    temp file and an atomic rename under a lock per cache file;
  * a window of at most ``num_imgs`` slices around the biggest slice (train)
    or the middle slice (eval), bounded at [middle − num_imgs//2,
    middle + num_imgs//2) (dataset.py:178-181); each slice: VOI-LUT
    windowing → optional rotation → resize to (size, size) → min-shift then
    max-divide (dataset.py:212-215); depth zero-padded to ``num_imgs``
    (dataset.py:183-190);
  * multi-type stacking (``mri_types``) with ``filter_missing``.

The resize is bilinear with OpenCV's ``INTER_LINEAR`` geometry (half-pixel
centres, edges clamped), in float32 numpy: the JAX class calls OpenCV when it
is importable, which the card's host is not guaranteed to have.  At the
slice's own size it is the identity, as OpenCV's is; at other sizes the two
agree to float32 rounding of the interpolation, not bit for bit.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from .dicom import apply_voi_lut, read_dicom
from .labels import Table

_DIGITS = re.compile(r"(\d+)")


def natural_sort(paths: Sequence[Path]) -> list[Path]:
    """'Image-9.dcm' < 'Image-10.dcm' (reference dataset.py:137-142)."""

    def key(p: Path):
        return [int(t) if t.isdigit() else t for t in _DIGITS.split(p.name)]

    return sorted(paths, key=key)


def crop_img(img: np.ndarray, threshold: float = 0.0) -> np.ndarray:
    """Bounding-box crop of the > threshold region (dataset.py:49-69); the
    input unchanged when nothing exceeds the threshold."""
    mask = img > threshold
    if not mask.any():
        return img
    rows = np.where(mask.any(axis=1))[0]
    cols = np.where(mask.any(axis=0))[0]
    return img[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]


def cropped_area(img: np.ndarray, threshold: float = 0.0) -> int:
    """Area of the cropped region (extract_cropped_image_size, dataset.py:72-81)."""
    c = crop_img(img, threshold)
    return int(c.shape[0] * c.shape[1])


def _taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One axis of INTER_LINEAR: source index, its neighbour, their weights."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = f - i.astype(np.float32)
    f[i < 0] = 0.0
    i[i < 0] = 0
    edge = i >= src - 1
    f[edge] = 0.0
    i[edge] = src - 1
    return i, np.minimum(i + 1, src - 1), np.float32(1.0) - f, f


def resize(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W) → (size, size) float32, bilinear (see the module docstring)."""
    img = img.astype(np.float32)
    if img.shape == (size, size):
        return img
    x0, x1, wx0, wx1 = _taps(img.shape[1], size)
    rows = img[:, x0] * wx0 + img[:, x1] * wx1
    y0, y1, wy0, wy1 = _taps(img.shape[0], size)
    return rows[y0] * wy0[:, None] + rows[y1] * wy1[:, None]


def rotate(img: np.ndarray, choice: int) -> np.ndarray:
    """The reference's ``rot_choices = [0, ROTATE_90_CLOCKWISE,
    ROTATE_90_COUNTERCLOCKWISE, ROTATE_180]`` behind its ``if rotate > 0``
    guard (dataset.py:204-212): index 0 never rotates; CW = np.rot90 k=-1,
    CCW = k=1, 180 = k=2."""
    if choice <= 0:
        return img
    return np.ascontiguousarray(np.rot90(img, {1: -1, 2: 1, 3: 2}[choice]))


# one lock per resolved cache file: split datasets (train/val) share the
# biggest-slice JSON, and two instances must not interleave read-modify-write
_CACHE_LOCKS: dict[str, threading.Lock] = {}
_CACHE_LOCKS_GUARD = threading.Lock()


def _lock_for(path: Path) -> threading.Lock:
    key = str(Path(path).resolve())
    with _CACHE_LOCKS_GUARD:
        return _CACHE_LOCKS.setdefault(key, threading.Lock())


class RSNADataset:
    """Map-style dataset over DICOM cases laid out as
    ``{folder}/{case_id}/{mri_type}/*.dcm``; ``data`` is a ``labels.Table``
    with an ``ID`` column (zero-padded strings, as the folders are named)
    and the ``target`` column.

    Items: (volume (M, 1, size, size, num_imgs) float32 in [0, 1], label
    int), M = 1 on the single-type path, len(mri_types) in multi-type mode,
    where cases missing any requested type's folder are dropped up front
    (``filter_missing``, default on in multi-type mode: the reference's
    ``clean_data``, dataset.py:99-100).  ``rotate`` indexes the reference's
    rot_choices (0 none, 1 90° CW, 2 90° CCW, 3 180°), applied after VOI-LUT
    and before the resize.  ``batch(indices)`` returns the stacked batch
    and int32 labels, the port loader's contract."""

    def __init__(self, data: Table, mri_type: str = "FLAIR", folder: str | Path = "rsna-data",
                 num_imgs: int = 32, size: int = 256, target: str = "MGMT_value",
                 cache_file: str | Path | None = None, is_train: bool = True,
                 mri_types: Sequence[str] | None = None, rotate: int = 0,
                 filter_missing: bool | None = None):
        self.multi = mri_types is not None
        self.types = tuple(mri_types) if self.multi else (mri_type,)
        self.mri_type = self.types[0]
        self.folder = Path(folder)
        self.num_imgs = num_imgs
        self.size = size
        self.target = target
        self.rotate = rotate
        # eval centres the window on the middle slice (dataset.py:173-176)
        self.is_train = is_train
        if filter_missing is None:
            filter_missing = self.multi
        if filter_missing:
            ok = np.array([all((self.folder / str(c) / t).is_dir() for t in self.types)
                           for c in data["ID"]], dtype=bool)
            data = data.take(ok)
        self.data = data
        # one biggest-slice cache per type (the reference keys one pkl by
        # (case, type), dataset.py:148)
        if cache_file is not None:
            base = Path(cache_file)
            self.cache_paths = ({t: base.with_name(f"{base.stem}_{t}{base.suffix}")
                                 for t in self.types} if self.multi else {self.mri_type: base})
        else:
            self.cache_paths = {t: self.folder / f"biggest_{t}.json" for t in self.types}
        self._biggest: dict[str, dict[str, int]] = {}

    def _case_dir(self, case_id: str, mri_type: str) -> Path:
        return self.folder / str(case_id) / mri_type

    def _slices(self, case_id: str, mri_type: str) -> list[Path]:
        return natural_sort(list(self._case_dir(case_id, mri_type).glob("*.dcm")))

    def _scan_biggest(self, case_id: str, mri_type: str) -> int:
        """Index of the slice with the largest cropped brain area; the middle
        slice when every area is 0 (dataset.py:144-148)."""
        areas = [cropped_area(read_dicom(p).pixel_array.astype(np.float32))
                 for p in self._slices(case_id, mri_type)]
        if not areas:
            raise FileNotFoundError(f"no DICOM slices for case {case_id} under "
                                    f"{self._case_dir(case_id, mri_type)}")
        if not any(areas):
            return len(areas) // 2
        return int(np.argmax(areas))

    def _write_cache_atomic(self, cache_path: Path, biggest: dict[str, int]) -> None:
        """Publish through a temp file and a rename, so a concurrent reader
        never sees a torn file; the file on disk is merged first, so two
        instances appending different cases keep each other's (ours win on
        conflict).  A read-only folder keeps the cache in memory only."""
        try:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            if cache_path.exists():
                try:
                    biggest = {**json.loads(cache_path.read_text()), **biggest}
                except (json.JSONDecodeError, OSError):
                    pass                    # a torn cache from a crashed writer
            fd, tmp = tempfile.mkstemp(suffix=".tmp.json", dir=cache_path.parent)
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(biggest))
            os.replace(tmp, cache_path)
        except OSError:
            pass

    def prepare_biggest_images(self, mri_type: str | None = None) -> dict[str, int]:
        """Per case, the biggest slice's index, from the JSON cache or by a
        scan written to it (dataset.py:122-152); the first touch of a cache
        file holds its lock, and a torn file is rescanned."""
        mri_type = mri_type or self.mri_type
        if mri_type in self._biggest:
            return self._biggest[mri_type]
        cache_path = self.cache_paths[mri_type]
        with _lock_for(cache_path):
            if mri_type in self._biggest:
                return self._biggest[mri_type]
            if cache_path.exists():
                try:
                    self._biggest[mri_type] = json.loads(cache_path.read_text())
                    return self._biggest[mri_type]
                except (json.JSONDecodeError, OSError):
                    pass
            biggest = {str(c): self._scan_biggest(str(c), mri_type) for c in self.data["ID"]}
            self._write_cache_atomic(cache_path, biggest)
            self._biggest[mri_type] = biggest
            return biggest

    def _biggest_for(self, case_id: str, mri_type: str) -> int:
        """Cache lookup, scanning and appending a case another split's cache
        lacks."""
        biggest = self.prepare_biggest_images(mri_type)
        if case_id not in biggest:
            with _lock_for(self.cache_paths[mri_type]):
                if case_id not in biggest:
                    biggest[case_id] = self._scan_biggest(case_id, mri_type)
                    self._write_cache_atomic(self.cache_paths[mri_type], biggest)
        return biggest[case_id]

    def load_volume(self, case_id: str, mri_type: str | None = None) -> np.ndarray:
        """(1, num_imgs, size, size) float32: the window's slices, each
        windowed, rotated, resized and scaled to [0, 1], zero-padded in depth."""
        mri_type = mri_type or self.mri_type
        paths = self._slices(str(case_id), mri_type)
        middle = self._biggest_for(str(case_id), mri_type) if self.is_train else len(paths) // 2
        half = self.num_imgs // 2
        # bounded at both ends (dataset.py:178-181): a window near an end holds
        # fewer slices and is zero-padded below
        window = paths[max(0, middle - half):min(len(paths), middle + half)]
        imgs = []
        for p in window:
            d = read_dicom(p)
            arr = resize(rotate(apply_voi_lut(d.pixel_array, d).astype(np.float32), self.rotate),
                         self.size)
            arr = arr - arr.min()           # min-shift, then max-divide (dataset.py:212-215)
            m = arr.max()
            if m > 0:
                arr = arr / m
            imgs.append(arr)
        vol = np.stack(imgs) if imgs else np.zeros((0, self.size, self.size), np.float32)
        if vol.shape[0] < self.num_imgs:
            pad = np.zeros((self.num_imgs - vol.shape[0], self.size, self.size), np.float32)
            vol = np.concatenate([vol, pad])
        return vol[None]

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> tuple[np.ndarray, int]:
        """(img (M, 1, size, size, num_imgs) float32, label int): the slice
        axis last, matching an img_size of (size, size, num_imgs)."""
        case_id = str(self.data["ID"][index])
        mods = [np.ascontiguousarray(self.load_volume(case_id, t)[0].transpose(1, 2, 0))[None]
                for t in self.types]
        return np.stack(mods), int(float(self.data[self.target][index]))

    def batch(self, indices: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        items = [self[i] for i in indices]
        return (np.stack([it[0] for it in items]),
                np.asarray([it[1] for it in items], dtype=np.int32))
