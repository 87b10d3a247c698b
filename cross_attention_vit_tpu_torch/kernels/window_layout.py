"""Swin's window layout, into a block's windows and out of them, each in
one pass of a hand-written gather (``csrc/window_layout.cu``).

No TPU kernel corresponds: the JAX package has no windowed model.  For a
(B, d, h, w, C) token grid and a block's ``WindowGeometry`` (extent W,
grid G and shift S on each axis, P = G·W the padded extent):

    pack    (B, d, h, w, C) → (B·windows, n, C): window row
            ((b·Gd + gz)·Gh + gy)·Gw + gx, token (iz·W1 + iy)·W2 + ix takes
            x[b, q], q_a = (g_a·W_a + i_a + S_a) mod P_a, or zeros where some
            q_a ≥ dim_a: the zero padding to whole windows, the roll by −S
            and the partition
    unpack  (B·windows, n, C) → (B, d, h, w, C): each real z takes the window
            row and token at p_a = (z_a − S_a) mod P_a: the reverse, the roll
            by +S and the crop

Each is the other's adjoint, so each is the other's backward: the pack's
gradient is the unpack of its cotangent (the padded tokens' gradients
dropped, as ``F.pad``'s backward drops them), the unpack's the pack of its
cotangent (zeros at padded tokens, as the crop's backward gives).  No value
is computed: every result is the chain's bit for bit.

Bound: bytes.  The pack moves (R + P)·C·size for R real and P padded
tokens, the unpack 2R·C·size (it reads only the real tokens' rows): 930
and 805 MB at Swin UNETR's first stage (B = 16, 64³ in 70³ tokens, C = 48,
bf16), 0.28 and 0.24 ms at 3.35 TB/s.  The kernels move rows in 16-byte units, consecutive
threads on consecutive units of the output, and find each token's source
by index arithmetic alone (divisions by the extents as a multiply-high and
a shift), so that stores are coalesced along the row and loads along the
row and the window's x axis; padded tokens are only written.  The PyTorch
chain they replace moved about 9P + 7R rows a block, forward and backward,
and a shifted block's four rolls three passes each over P more.

``window_pack`` and ``window_unpack`` are differentiable.  On a CUDA tensor
each direction launches its kernel or raises; on a CPU tensor it runs its
plain version, the chain (``window_pack_reference``,
``window_unpack_reference``).  ``window_pack.launches`` and
``window_unpack.launches`` count each kernel's launches, forward and
backward alike.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .window_attention import WindowGeometry

_LIB = _build.Library("window_layout", "window_layout_error_string", {
    # src, dst, row_bytes, batch, d, h, w, window (3), grid (3), shift (3)
    "window_layout_pack": [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_int] * 12,
    "window_layout_unpack": [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_int] * 12})


def partition(x: torch.Tensor, geom: WindowGeometry) -> torch.Tensor:
    """(B, Dp, Hp, Wp, C) → (B·windows, n, C), windows and their tokens in
    row-major order (MONAI ``window_partition``)."""
    B, C = x.shape[0], x.shape[-1]
    (gd, gh, gw), (w0, w1, w2) = geom.grid, geom.window
    x = x.view(B, gd, w0, gh, w1, gw, w2, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B * geom.windows, geom.n, C)


def reverse(windows: torch.Tensor, geom: WindowGeometry, batch: int) -> torch.Tensor:
    """``partition``'s inverse (MONAI ``window_reverse``)."""
    C = windows.shape[-1]
    (gd, gh, gw), (w0, w1, w2) = geom.grid, geom.window
    x = windows.view(batch, gd, gh, gw, w0, w1, w2, C).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(batch, gd * w0, gh * w1, gw * w2, C)


def window_pack_reference(x: torch.Tensor, geom: WindowGeometry) -> torch.Tensor:
    """Plain version of the pack: ``F.pad`` to whole windows, ``torch.roll``
    by −shift, ``partition``."""
    d, h, w = x.shape[1:4]
    Dp, Hp, Wp = geom.padded
    x = F.pad(x, (0, 0, 0, Wp - w, 0, Hp - h, 0, Dp - d))
    if geom.shifted:
        x = torch.roll(x, tuple(-s for s in geom.shift), (1, 2, 3))
    return partition(x, geom)


def window_unpack_reference(o: torch.Tensor, geom: WindowGeometry, dims) -> torch.Tensor:
    """Plain version of the unpack: ``reverse``, ``torch.roll`` by +shift,
    the crop to ``dims``."""
    d, h, w = dims
    x = reverse(o, geom, o.shape[0] // geom.windows)
    if geom.shifted:
        x = torch.roll(x, geom.shift, (1, 2, 3))
    return x[:, :d, :h, :w].contiguous()


def _check_geometry(geom: WindowGeometry, dims) -> None:
    if len(dims) != 3 or any(not 0 <= p - d < w for p, d, w in zip(geom.padded, dims,
                                                                   geom.window)):
        raise ValueError(f"a token grid of {tuple(dims)} does not fill the windows "
                         f"{geom.window} × {geom.grid}")


def _check(t: torch.Tensor, rank: int, what: str) -> None:
    if t.dim() != rank:
        raise ValueError(f"{what} must have {rank} axes, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the window layout runs on cuda or cpu tensors, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(fn: str, src: torch.Tensor, dst: torch.Tensor, batch: int, geom: WindowGeometry,
            dims) -> None:
    _LIB.launch(fn, src.device, src.data_ptr(), dst.data_ptr(),
                src.shape[-1] * src.element_size(), batch, *dims, *geom.window, *geom.grid,
                *geom.shift)


def _pack(x: torch.Tensor, geom: WindowGeometry) -> torch.Tensor:
    _check(x, 5, "x (B, d, h, w, C)")
    dims = tuple(x.shape[1:4])
    _check_geometry(geom, dims)
    if x.device.type == "cpu":
        return window_pack_reference(x, geom)
    y = torch.empty((x.shape[0] * geom.windows, geom.n, x.shape[-1]), dtype=x.dtype,
                    device=x.device)
    if y.numel():
        _launch("window_layout_pack", x, y, x.shape[0], geom, dims)
        window_pack.launches += 1
    return y


def _unpack(o: torch.Tensor, geom: WindowGeometry, dims) -> torch.Tensor:
    _check(o, 3, "o (B·windows, n, C)")
    dims = tuple(dims)
    _check_geometry(geom, dims)
    if o.shape[0] % geom.windows or o.shape[1] != geom.n:
        raise ValueError(f"o must be (B·{geom.windows}, {geom.n}, C), got {tuple(o.shape)}")
    if o.device.type == "cpu":
        return window_unpack_reference(o, geom, dims)
    y = torch.empty((o.shape[0] // geom.windows, *dims, o.shape[-1]), dtype=o.dtype,
                    device=o.device)
    if y.numel():
        _launch("window_layout_unpack", o, y, y.shape[0], geom, dims)
        window_unpack.launches += 1
    return y


class _Pack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, geom):
        ctx.geom, ctx.dims = geom, tuple(x.shape[1:4])
        return _pack(x, geom)

    @staticmethod
    def backward(ctx, g):
        return _unpack(g.contiguous(), ctx.geom, ctx.dims), None


class _Unpack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o, geom, dims):
        ctx.geom = geom
        return _unpack(o, geom, dims)

    @staticmethod
    def backward(ctx, g):
        return _pack(g.contiguous(), ctx.geom), None, None


def window_pack(x: torch.Tensor, geom: WindowGeometry) -> torch.Tensor:
    """x (B, d, h, w, C) contiguous → its windows (B·windows, n, C) in x's
    dtype: padded with zeros to whole windows and rolled by −shift."""
    return _Pack.apply(x, geom)


def window_unpack(o: torch.Tensor, geom: WindowGeometry, dims) -> torch.Tensor:
    """Windows o (B·windows, n, C) contiguous → (B, *dims, C) in o's dtype:
    rolled back by +shift and cropped to the real tokens ``dims``."""
    return _Unpack.apply(o, geom, tuple(dims))


window_pack.launches = 0
window_unpack.launches = 0
