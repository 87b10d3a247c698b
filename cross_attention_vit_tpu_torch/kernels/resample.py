"""Windowed 1-D affine resample along one axis of a batch of volumes: the
Hopper port of the TPU kernels ``cross_attention_vit_tpu/kernels/resample.py
::_resample_kernel_v2`` (K3, with a per-tile tap window ``span``) and
``_resample_kernel`` (K4, all 2W+2 taps).

For every volume v and output voxel x, with a = ``axis``:

    out[x] = Σ_{d=−W..W+1} max(0, 1 − |rel(x) − d|) · src[x + d·e_a]
    rel(x) = Σ_b cdelta[v, b] · (x_b − center_b)

src is the volume symmetric-padded by (W, W+1) along a (the edge voxel
repeats), accumulation is f32, and the result is cast to the input dtype.
With ``span`` (and span < 2W+2), the output is cut into the TPU kernel's tiles
— a whole, dim 2 whole, the remaining dims of {0, 1} in blocks of 32 — and a
tile sums only the taps d in [d_lo, d_lo + span), with
d_lo = clip(floor(min rel over the tile), −W, W + 2 − span).

``resample_axis_windowed_batched`` is the wrapper.  On a CUDA tensor it
launches the hand-written kernel in ``csrc/resample.cu`` or raises; on a CPU
tensor it runs ``resample_axis_windowed_reference``, the plain PyTorch
version.  A block of the kernel stages one box of the source in shared
memory — the axis whole, a cross-section of the other dims inside one tile
(``box_geometry``) — and reads every tap of the box's voxels from there.
``resample_axis_windowed_batched.launches`` counts kernel launches with a
tap window (K3) and ``.full_launches`` those over all taps (K4).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bytes of source a block's box aims at (8192 voxels of bf16, 4096 of f32):
# several blocks of RING_SLOTS such slots fit on an SM, and the boxes are
# large enough that their fixed costs stay small (4096 bf16 voxels ran a live
# pass 15% slower on an H100)
BOX_BYTES = 16384
# box slots a kernel block keeps (STAGES in csrc/resample.cu)
RING_SLOTS = 3
# dynamic shared memory one block may use on an H100 (227 KB)
SMEM_BYTES = 232_448
_LIB = _build.Library("resample", "resample_error_string", {
    # src, out, cdelta, dtype, V, D, H, W, axis, window, span, b0, b1, center
    # (3), box (e0, e1, cw), pitch
    "resample_axis_windowed": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
    + [ctypes.c_float] * 3 + [ctypes.c_int] * 4})


def _block_size(size: int, want: int = 32) -> int:
    bsz = min(want, size)
    while size % bsz:
        bsz //= 2
    return bsz


def _tiles(shape: tuple[int, int, int], axis: int) -> tuple[int, int]:
    """The v2 tile extents along dims 0 and 1 (dim 2 is never blocked)."""
    D, H, _ = shape
    return (D if axis == 0 else _block_size(D), H if axis == 1 else _block_size(H))


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _largest_divisor(n: int, fits) -> int:
    return max(e for e in range(1, n + 1) if n % e == 0 and (e == 1 or fits(e)))


def box_geometry(shape: tuple[int, int, int], axis: int,
                 itemsize: int) -> tuple[int, int, int, int, int]:
    """A kernel block's box (e0, e1, cw), the pitch of its staged rows and
    the shared memory the block stages it in: e0 × e1 lines of dims 0, 1 by
    cw columns of dim 2, the resample axis whole, inside one tile of
    ``_tiles`` (e0 divides b0, e1 divides b1), about ``BOX_BYTES`` of source.
    The axes 0 and 1 cut dim 2 into columns of a multiple of 8; axis 2 keeps
    it whole, and its staged rows are 16 bytes past a multiple of 128 apart,
    so that the 32 rows a warp reads start in 8 different 4-bank groups.
    Rows are whole 16-byte copies apart.  Shared memory:
    ``RING_SLOTS`` slots of e0·e1 rows of ``pitch`` elements.  Raises
    ValueError where not even the smallest box fits in a block's shared
    memory."""
    n, voxels = shape[axis], BOX_BYTES // itemsize
    cw = shape[2] if axis == 2 else min(_round8(shape[2]), max(8, voxels // n // 8 * 8))
    step = 16 // itemsize                  # elements of one 16-byte copy
    pitch = -(-cw // step) * step
    if axis == 2:
        while pitch * itemsize % 128 != 16:
            pitch += step
    ext = [1, 1]
    if axis < 2:
        ext[axis] = n
    for dim, block in zip((1, 0), reversed(_tiles(shape, axis))):
        if dim != axis:
            other = ext[1 - dim]
            ext[dim] = _largest_divisor(
                block, lambda e: e * other * _round8(cw) <= voxels)
    smem = RING_SLOTS * ext[0] * ext[1] * pitch * itemsize
    if smem > SMEM_BYTES:
        raise ValueError(f"resample along axis {axis} of {tuple(shape)}: a box of "
                         f"{ext[0]}x{ext[1]}x{cw} needs {smem} bytes of shared memory, "
                         f"more than a block's {SMEM_BYTES}")
    return ext[0], ext[1], cw, pitch, smem


def _window_taps(window: int, span: int | None) -> int | None:
    """The per-tile span the call uses, or None for all 2W+2 taps (K4)."""
    return span if span is not None and span < 2 * window + 2 else None


def symmetric_pad_index(n: int, before: int, after: int, device=None) -> torch.Tensor:
    """Source indices of positions −before .. n+after−1 under numpy's
    'symmetric' padding (the edge voxel repeats; periodic with period 2n)."""
    p = torch.remainder(torch.arange(-before, n + after, device=device), 2 * n)
    return torch.where(p >= n, 2 * n - 1 - p, p)


def resample_axis_windowed_reference(vols: torch.Tensor, axis: int, cdelta: torch.Tensor,
                                     center: tuple, window: int,
                                     span: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the tap loop of the TPU kernels
    over a symmetric-padded copy, f32 accumulation in ascending tap order."""
    V, D, H, W = vols.shape
    in_dtype = vols.dtype
    src = vols if in_dtype in _DTYPE_CODES else vols.float()
    dev = vols.device
    cd = cdelta.to(device=dev, dtype=torch.float32)
    g = [torch.arange(s, dtype=torch.float32, device=dev) - float(c)
         for s, c in zip((D, H, W), center)]
    rel = (cd[:, 0, None, None, None] * g[0][None, :, None, None]
           + cd[:, 1, None, None, None] * g[1][None, None, :, None]) \
        + cd[:, 2, None, None, None] * g[2][None, None, None, :]
    span = _window_taps(window, span)
    if span is not None:
        b0, b1 = _tiles((D, H, W), axis)
        tmin = rel.reshape(V, D // b0, b0, H // b1, b1, W).amin(dim=(2, 4, 5))
        d_lo = torch.clamp(torch.floor(tmin), -window, window + 2 - span)
        d_lo = d_lo.repeat_interleave(b0, dim=1).repeat_interleave(b1, dim=2)[..., None]
    n = (D, H, W)[axis]
    padded = src.index_select(1 + axis, symmetric_pad_index(n, window, window + 1, dev))
    acc = torch.zeros(rel.shape, dtype=torch.float32, device=dev)
    for d in range(-window, window + 2):
        shifted = padded.narrow(1 + axis, d + window, n)
        term = torch.clamp(1.0 - torch.abs(rel - float(d)), min=0.0) * shifted
        if span is None:
            acc = acc + term
        else:
            acc = torch.where((d_lo <= d) & (d < d_lo + span), acc + term, acc)
    return acc.to(src.dtype).to(in_dtype)


def resample_axis_windowed_batched(vols: torch.Tensor, axis: int, cdelta: torch.Tensor,
                                   center: tuple, window: int,
                                   span: int | None = None) -> torch.Tensor:
    """vols (V, D, H, W) f32 or bf16 (other float dtypes are computed in f32),
    cdelta (V, 3) = per-volume coefficients − e_axis, static center and
    window.  Returns (V, D, H, W) in the input dtype."""
    if vols.dim() != 4 or not vols.dtype.is_floating_point:
        raise ValueError(f"vols must be a (V, D, H, W) float tensor, got "
                         f"{tuple(vols.shape)} {vols.dtype}")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    if cdelta.shape != (vols.shape[0], 3):
        raise ValueError(f"cdelta must be ({vols.shape[0]}, 3), got {tuple(cdelta.shape)}")
    if window < 0 or len(center) != 3:
        raise ValueError(f"need window >= 0 and three centre coordinates, got {window}, {center}")
    if vols.device.type == "cpu":
        return resample_axis_windowed_reference(vols, axis, cdelta, center, window, span)
    if vols.device.type != "cuda":
        raise ValueError(f"resample runs on cuda or cpu tensors, got {vols.device}")
    if 0 in vols.shape:
        return vols.clone()
    in_dtype = vols.dtype
    src = (vols if in_dtype in _DTYPE_CODES else vols.float()).contiguous()
    cd = cdelta.to(device=vols.device, dtype=torch.float32).contiguous()
    V, D, H, W = src.shape
    taps = _window_taps(window, span)
    b0, b1 = _tiles((D, H, W), axis)
    e0, e1, cw, pitch, _ = box_geometry((D, H, W), axis, src.element_size())
    out = torch.empty_like(src)
    _LIB.launch("resample_axis_windowed", vols.device,
                src.data_ptr(), out.data_ptr(), cd.data_ptr(), _DTYPE_CODES[src.dtype], V, D, H,
                W, axis, window, -1 if taps is None else taps, b0, b1,
                *(float(c) for c in center), e0, e1, cw, pitch)
    if taps is None:
        resample_axis_windowed_batched.full_launches += 1
    else:
        resample_axis_windowed_batched.launches += 1
    return out.to(in_dtype)


resample_axis_windowed_batched.launches = 0
resample_axis_windowed_batched.full_launches = 0

