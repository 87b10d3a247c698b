"""3D patch extraction with the reference's exact token/feature ordering.

    rearrange(vol, 'b c (d p1) (h p2) (w p3) -> b (h w d) (p1 p2 p3 c)')

Token order is (h, w, d) — h slowest — and the intra-patch flatten order is
(p1, p2, p3, c) (port of ``cross_attention_vit_tpu/ops/patchify.py``).
"""

from __future__ import annotations

import torch


def patchify_3d(vol: torch.Tensor, patch_size: tuple[int, int, int]) -> torch.Tensor:
    """(B, C, D, H, W) → (B, (H/p2)·(W/p3)·(D/p1), p1·p2·p3·C)."""
    p1, p2, p3 = patch_size
    B, C, D, H, W = vol.shape
    if D % p1 or H % p2 or W % p3:
        raise ValueError(f"volume {tuple(vol.shape)} not divisible by patch {tuple(patch_size)}")
    d, h, w = D // p1, H // p2, W // p3
    x = vol.reshape(B, C, d, p1, h, p2, w, p3)
    # target axis order: b, h, w, d, p1, p2, p3, c
    x = x.permute(0, 4, 6, 2, 3, 5, 7, 1)
    return x.reshape(B, h * w * d, p1 * p2 * p3 * C)


def unpatchify_3d(tokens: torch.Tensor, patch_size: tuple[int, int, int],
                  img_size: tuple[int, int, int], channels: int = 1) -> torch.Tensor:
    """Inverse of ``patchify_3d``: (B, N, p1·p2·p3·C) → (B, C, D, H, W)."""
    p1, p2, p3 = patch_size
    D, H, W = img_size
    d, h, w = D // p1, H // p2, W // p3
    x = tokens.reshape(tokens.shape[0], h, w, d, p1, p2, p3, channels)
    x = x.permute(0, 7, 3, 4, 1, 5, 2, 6)     # b, c, d, p1, h, p2, w, p3
    return x.reshape(tokens.shape[0], channels, D, H, W)


def num_patches(img_size: tuple[int, int, int], patch_size: tuple[int, int, int]) -> int:
    D, H, W = img_size
    p1, p2, p3 = patch_size
    return (D // p1) * (H // p2) * (W // p3)
