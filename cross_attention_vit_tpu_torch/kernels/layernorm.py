"""LayerNorm over the last axis, forward and backward, each in one pass of a
hand-written kernel: x in its own dtype in and out, the statistics in f32.

No TPU kernel corresponds: XLA fuses the JAX ``layernorm`` (JAX
``ops/layers.py``: mean and centred variance of the f32 upcast, ``rsqrt(var
+ eps)``, scale and bias in f32, one cast back) into the ops around it.  For
a row x of C values, f32 weight w and bias b:

    forward   x̂ = (x − mean)·rsqrt(var + eps),  y = x̂·w + b          rounded once
    backward  g = dy·w,  dx = rstd·(g − mean(g) − x̂·mean(g·x̂))        rounded once
              dweight = Σ_rows dy·x̂,  dbias = Σ_rows dy                  f32

The forward saves nothing beyond x: the backward recomputes the row's mean
and rstd from the x it reads.

``layernorm`` and ``layernorm_backward`` are the wrappers.  On a CUDA
tensor each launches the kernels of ``csrc/layernorm.cu`` or raises; on a
CPU tensor each runs its plain PyTorch version: ``layernorm_reference``, the
f32 chain the port ran before (``F.layer_norm`` of the upcast, then the
cast), and ``layernorm_backward_reference``, the formula above in f32.
``layernorm.launches`` counts forward launches and
``layernorm.bwd_launches`` backward calls (the row kernel and the kernel
that adds its partial column sums).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2, torch.float32: 3}
_LIB = _build.Library("layernorm", "layer_norm_error_string", {
    # x, weight, bias, y, dtype, rows, cols, eps
    "layer_norm_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                ctypes.c_float],
    # dy, x, weight, dx, partial, parts, sums, dtype, rows, cols, eps
    "layer_norm_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                                ctypes.c_longlong, ctypes.c_int, ctypes.c_float]},
    functions={
        # rows, cols, dtype, device → the partial sums' rows, or minus a CUDA error
        "layer_norm_bwd_parts": ([ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int],
                                 ctypes.c_longlong),
        # cols → lanes, iters, slabs
        "layer_norm_layout": ([ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3, None)})


def layernorm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: PyTorch's f32 LayerNorm
    of the upcast, cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def layernorm_backward_reference(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                                 eps: float = 1e-5) -> tuple:
    """Plain PyTorch version of the backward kernels, in f32: (dx in x's
    dtype, dweight and dbias in the weight's dtype)."""
    C = x.shape[-1]
    x32, dy32 = x.float().reshape(-1, C), dy.float().reshape(-1, C)
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (x32 - mean) * rstd
    g = dy32 * weight.float()
    dx = rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    return (dx.to(x.dtype).reshape(x.shape), (dy32 * xhat).sum(0).to(weight.dtype),
            dy32.sum(0).to(weight.dtype))


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> None:
    if x.dim() == 0 or x.shape[-1] == 0 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"LayerNorm takes a bfloat16, float16 or float32 tensor with a "
                         f"last axis, got {tuple(x.shape)} {x.dtype}")
    C = x.shape[-1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p is None:
            continue
        if p.shape != (C,) or not p.is_floating_point():
            raise ValueError(f"{name} must be a floating tensor of shape ({C},), got "
                             f"{tuple(p.shape)} {p.dtype}")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"LayerNorm runs on cuda or cpu tensors, got {x.device}")


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """x (..., C) in bf16, f16 or f32, weight and bias (C,): LayerNorm over
    the last axis in x's dtype, its statistics in f32."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return layernorm_reference(x, weight, bias, eps)
    C = x.shape[-1]
    x = x.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // C
    if rows == 0:
        return y
    w, b = weight.float().contiguous(), bias.float().contiguous()
    _LIB.launch("layer_norm_fwd", x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                y.data_ptr(), _DTYPE_CODES[x.dtype], rows, C, eps)
    layernorm.launches += 1
    return y


def layernorm_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-5) -> tuple:
    """The cotangent dy of ``layernorm``'s output at input x.  Returns (dx
    in x's dtype, dweight and dbias in the weight's dtype), the parameters'
    gradients added over the rows in f32 in a fixed order."""
    _check(x, weight, None)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x ({tuple(x.shape)} {x.dtype} on {x.device}), got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if x.device.type == "cpu":
        return layernorm_backward_reference(dy, x, weight, eps)
    C = x.shape[-1]
    rows = x.numel() // C
    if rows == 0:
        zeros = torch.zeros(C, dtype=weight.dtype, device=x.device)
        return torch.empty_like(x), zeros, zeros.clone()
    x, dy = x.contiguous(), dy.contiguous()
    w = weight.float().contiguous()
    code = _DTYPE_CODES[x.dtype]
    parts = _LIB.layer_norm_bwd_parts(rows, C, code, x.device.index)
    if parts <= 0:
        raise RuntimeError(f"layer_norm_bwd_parts failed: CUDA error {-parts} "
                           f"({_LIB.message(-parts)})")
    dx = torch.empty_like(x)
    partial = torch.empty((parts, 2, C), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, C), dtype=torch.float32, device=x.device)
    _LIB.launch("layer_norm_bwd", x.device, dy.data_ptr(), x.data_ptr(), w.data_ptr(),
                dx.data_ptr(), partial.data_ptr(), parts, sums.data_ptr(), code, rows, C, eps)
    layernorm.bwd_launches += 1
    return dx, sums[0].to(weight.dtype), sums[1].to(weight.dtype)


layernorm.launches = 0
layernorm.bwd_launches = 0


def layout(cols: int) -> tuple[int, int, int]:
    """(lanes a row, chunks of 8 columns a lane, slabs) that the kernels
    take at this width."""
    out = [ctypes.c_int() for _ in range(3)]
    _LIB.layer_norm_layout(cols, *(ctypes.byref(v) for v in out))
    return tuple(v.value for v in out)

