"""Geometric preprocessing with MONAI-exact semantics (host-side, numpy).

The live pipeline is LoadImaged → EnsureChannelFirstd → ResizeWithPadOrCropd
(img_size, constant −1) → ToTensord (reference dataset_ucsf.py:81-140).  There
is NO intensity normalization in the active path — raw scaled magnitudes flow
to the model.

MONAI conventions (port of ``cross_attention_vit_tpu/data/preprocess.py``):
  * SpatialPad(method='symmetric'): per-dim pad width = max(target−size, 0),
    front gets width//2, back gets the remainder (extra voxel at the back);
  * CenterSpatialCrop: start = max(size//2 − target//2, 0), slice of length
    target (floor conventions; extra voxel trimmed from the back);
  * ResizeWithPadOrCrop = pad-then-crop per dim with constant fill.

For the live shapes (240,240,155)→(128,128,64) this is pure cropping:
x,y: 56:184; z: 45:109.  ``resize_with_pad_or_crop`` does the same on a
tensor on its own device (JAX's jitted version).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _pad_crop_bounds(size: int, target: int) -> tuple[int, int, int, int]:
    """Returns (pad_front, pad_back, crop_start, crop_stop) for one dim."""
    pad = max(target - size, 0)
    pad_front, pad_back = pad // 2, pad - pad // 2
    padded = size + pad
    start = max(padded // 2 - target // 2, 0)
    return pad_front, pad_back, start, start + target


def resize_with_pad_or_crop_np(vol: np.ndarray, target: tuple[int, ...],
                               fill: float = -1.0) -> np.ndarray:
    """vol: (..., *spatial) — target applies to the trailing len(target) dims."""
    nd = len(target)
    lead = vol.ndim - nd
    pads = [(0, 0)] * lead
    slices = [slice(None)] * lead
    for i, tgt in enumerate(target):
        pf, pb, s0, s1 = _pad_crop_bounds(vol.shape[lead + i], tgt)
        pads.append((pf, pb))
        slices.append(slice(s0, s1))
    if any(p != (0, 0) for p in pads):
        vol = np.pad(vol, pads, mode="constant", constant_values=fill)
    return vol[tuple(slices)]


def resize_with_pad_or_crop(vol: torch.Tensor, target: tuple[int, ...],
                            fill: float = -1.0) -> torch.Tensor:
    """``resize_with_pad_or_crop_np`` on a tensor: constant pad, then a
    slice, over the trailing len(target) dims."""
    nd = len(target)
    lead = vol.dim() - nd
    pads, slices = [], [slice(None)] * lead
    for i, tgt in enumerate(target):
        pf, pb, s0, s1 = _pad_crop_bounds(vol.shape[lead + i], tgt)
        pads = [pf, pb] + pads                 # F.pad lists the last dim first
        slices.append(slice(s0, s1))
    if any(pads):
        vol = F.pad(vol, pads, value=fill)
    return vol[tuple(slices)]


def crop_bounds(size: tuple[int, ...], target: tuple[int, ...]):
    """The per-dim (pad_front, pad_back, start, stop) decisions — used by
    ``data.nifti.read_volume_cropped`` to crop during decode."""
    return [_pad_crop_bounds(s, t) for s, t in zip(size, target)]
