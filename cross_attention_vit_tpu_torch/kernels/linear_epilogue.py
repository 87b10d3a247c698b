"""The epilogue of a low-precision linear, forward and backward: the f32
bias, one rounding to the operands' dtype, GELU and dropout in one pass over
the f32 product, and back in one pass to the product's cotangent.

No TPU kernel corresponds: XLA fuses this work into the epilogue of the JAX
``linear``'s dot.  For an f32 product p (M, N), an f32 bias, ``keep`` =
1 − rate and the step's draws r (uint8 or int32, one per element, compared
with ``thresh``):

    forward   y = bf16(p + bias); y = bf16(gelu(y)); y = r < thresh ? bf16(y / keep) : 0
    backward  d = bit ? bf16(g / keep) : 0; d = bf16(gelu'(d, pre)); dbias = Σ_rows f32 d

each step where asked, each in f32 and rounded where the PyTorch chain it
replaces rounds (``ops/layers.py`` ``linear``: the f32 add, ``.to``,
``F.gelu``, ``torch.where(mask, y / keep, 0)``, and their autograd
backwards).  The forward saves the pre-GELU value (with GELU) and the keep
mask packed one bit an element (``pack_mask``), never the draws.

``linear_epilogue`` and ``linear_epilogue_backward`` are the wrappers.  On a
CUDA tensor each launches the hand-written kernels of
``csrc/linear_epilogue.cu`` or raises; on a CPU tensor each runs its plain
PyTorch version (``linear_epilogue_reference``,
``linear_epilogue_backward_reference``), the chain's own ops.
``linear_epilogue.launches`` counts forward launches and
``linear_epilogue.bwd_launches`` backward calls (the elementwise kernel
and, with a bias gradient, its column-sum kernel).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
_DRAW_CODES = {torch.uint8: 1, torch.int32: 2}
# rows whose column sums one block of the backward adds (the partial sums
# the bias-gradient kernel then adds in order)
ROWS_PER_PART = 128
# the grid's height limit, which bounds the number of partial sums
_MAX_PARTS = 65535
_LIB = _build.Library("linear_epilogue", "linear_epilogue_error_string", {
    # p, bias, draws, draw, thresh, keep, out, pre, mask, dtype, gelu, rows, cols
    "linear_epilogue_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int],
    # g, mask, pre, keep, dp, partial, dbias, dtype, gelu, rows, cols, rows_per_part
    "linear_epilogue_bwd": [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2})


def _gelu_code(gelu_approx: bool | None) -> int:
    return 0 if gelu_approx is None else (1 if gelu_approx else 2)


def _approximate(gelu_approx: bool) -> str:
    return "tanh" if gelu_approx else "none"


def pack_mask(keep: torch.Tensor) -> torch.Tensor:
    """(M, N) bool → (M, ceil(N / 8)) uint8: bit k of byte j is column 8j + k."""
    M, N = keep.shape
    padded = keep.new_zeros((M, -(-N // 8) * 8))
    padded[:, :N] = keep
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.int32, device=keep.device)
    return (padded.view(M, -1, 8).to(torch.int32) * weights).sum(-1).to(torch.uint8)


def unpack_mask(packed: torch.Tensor, cols: int) -> torch.Tensor:
    """The (M, cols) bool mask ``pack_mask`` packed."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32).unsqueeze(-1) >> shifts) & 1
    return bits.view(packed.shape[0], -1)[:, :cols].bool()


def linear_epilogue_reference(p: torch.Tensor, bias: torch.Tensor | None,
                              draws: torch.Tensor | None, thresh: int, keep: float,
                              gelu_approx: bool | None, dtype: torch.dtype,
                              save: bool) -> tuple:
    """Plain PyTorch version of the forward kernel: the chain's ops."""
    y = (p if bias is None else p + bias).to(dtype)
    pre = None
    if gelu_approx is not None:
        pre = y if save else None
        y = F.gelu(y, approximate=_approximate(gelu_approx))
    mask = None
    if draws is not None:
        kept = draws < thresh
        y = torch.where(kept, y / keep, torch.zeros((), dtype=y.dtype, device=y.device))
        mask = pack_mask(kept) if save else None
    return y, pre, mask


def linear_epilogue_backward_reference(g: torch.Tensor, mask: torch.Tensor | None,
                                       pre: torch.Tensor | None, keep: float,
                                       gelu_approx: bool | None,
                                       bias_grad: bool) -> tuple:
    """Plain PyTorch version of the backward kernels: the chain's autograd
    backward (``where``, then the division, then ``gelu_backward``), and the
    bias gradient as the f32 sum over rows."""
    d = g
    if mask is not None:
        kept = unpack_mask(mask, g.shape[1])
        d = torch.where(kept, d, torch.zeros((), dtype=d.dtype, device=d.device)) / keep
    if gelu_approx is not None:
        d = torch.ops.aten.gelu_backward(d, pre, approximate=_approximate(gelu_approx))
    return d, (d.float().sum(0) if bias_grad else None)


def _check(p: torch.Tensor, bias, draws, dtype) -> None:
    if p.dim() != 2 or p.dtype != torch.float32:
        raise ValueError(f"the product must be a 2-D float32 tensor, got "
                         f"{tuple(p.shape)} {p.dtype}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the epilogue rounds to bfloat16 or float16, not {dtype}")
    if bias is not None and (bias.shape != (p.shape[1],) or bias.dtype != torch.float32):
        raise ValueError(f"bias must be float32 of shape ({p.shape[1]},), got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if draws is not None and (draws.shape != p.shape or draws.dtype not in _DRAW_CODES):
        raise ValueError(f"draws must be uint8 or int32 of the product's shape "
                         f"{tuple(p.shape)}, got {tuple(draws.shape)} {draws.dtype}")


def linear_epilogue(p: torch.Tensor, bias: torch.Tensor | None, draws: torch.Tensor | None,
                    thresh: int, keep: float, gelu_approx: bool | None, dtype: torch.dtype,
                    save: bool) -> tuple:
    """p (M, N) f32, bias (N,) f32 or None, draws (M, N) uint8 or int32 or
    None (no dropout), kept where below ``thresh``, scaled by 1 / ``keep``;
    ``gelu_approx`` None (no GELU), True (tanh) or False (erf).  Returns
    (out, pre, mask): out (M, N) in ``dtype``; with ``save``, the pre-GELU
    value (with GELU) and the packed keep mask (with draws), else None."""
    _check(p, bias, draws, dtype)
    if p.device.type == "cpu":
        return linear_epilogue_reference(p, bias, draws, thresh, keep, gelu_approx, dtype, save)
    if p.device.type != "cuda":
        raise ValueError(f"the linear epilogue runs on cuda or cpu tensors, got {p.device}")
    p = p.contiguous()
    bias = None if bias is None else bias.contiguous()
    draws = None if draws is None else draws.contiguous()
    M, N = p.shape
    out = torch.empty((M, N), dtype=dtype, device=p.device)
    pre = torch.empty_like(out) if save and gelu_approx is not None else None
    mask = (torch.empty((M, -(-N // 8)), dtype=torch.uint8, device=p.device)
            if save and draws is not None else None)
    _LIB.launch("linear_epilogue_fwd", p.device,
                p.data_ptr(), _ptr(bias), _ptr(draws),
                0 if draws is None else _DRAW_CODES[draws.dtype], thresh, keep, out.data_ptr(),
                _ptr(pre), _ptr(mask), _DTYPE_CODES[dtype], _gelu_code(gelu_approx), M, N)
    linear_epilogue.launches += 1
    return out, pre, mask


def linear_epilogue_backward(g: torch.Tensor, mask: torch.Tensor | None,
                             pre: torch.Tensor | None, keep: float, gelu_approx: bool | None,
                             bias_grad: bool) -> tuple:
    """The cotangent g (M, N) of ``linear_epilogue``'s output, with the mask
    and pre-GELU value it saved.  Returns (dp, dbias): the product's
    cotangent in g's dtype (g itself where the epilogue had neither GELU nor
    dropout), and with ``bias_grad`` the f32 bias gradient, else None."""
    if (gelu_approx is None) != (pre is None):
        raise ValueError("the pre-GELU value is given exactly when the epilogue had GELU")
    if g.device.type == "cpu":
        return linear_epilogue_backward_reference(g, mask, pre, keep, gelu_approx, bias_grad)
    if g.device.type != "cuda":
        raise ValueError(f"the linear epilogue runs on cuda or cpu tensors, got {g.device}")
    if g.dim() != 2 or g.dtype not in _DTYPE_CODES:
        raise ValueError(f"the cotangent must be a 2-D bfloat16 or float16 tensor, got "
                         f"{tuple(g.shape)} {g.dtype}")
    M, N = g.shape
    write = mask is not None or pre is not None
    if M == 0 or not (write or bias_grad):
        return g, (torch.zeros(N, dtype=torch.float32, device=g.device) if bias_grad else None)
    g = g.contiguous()
    dp = torch.empty_like(g) if write else g
    rows_per_part = max(ROWS_PER_PART, -(-M // _MAX_PARTS))
    partial = dbias = None
    if bias_grad:
        partial = torch.empty((-(-M // rows_per_part), N), dtype=torch.float32, device=g.device)
        dbias = torch.empty(N, dtype=torch.float32, device=g.device)
    _LIB.launch("linear_epilogue_bwd", g.device,
                g.data_ptr(), _ptr(mask), _ptr(pre), keep, _ptr(dp if write else None),
                _ptr(partial), _ptr(dbias), _DTYPE_CODES[g.dtype], _gelu_code(gelu_approx), M,
                N, rows_per_part)
    linear_epilogue.bwd_launches += 1
    return dp, dbias


linear_epilogue.launches = 0
linear_epilogue.bwd_launches = 0


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()

