"""Fused self-attention, forward and backward: the Hopper port of the TPU
kernels ``cross_attention_vit_tpu/kernels/flash_attention.py::
_attn_kernel_qkv_tn`` (K1, forward) and ``_attn_bwd_kernel_qkv_tn`` (K2, its
backward with the saved output).

``flash_attention_qkv`` is the differentiable entry point: a
``torch.autograd.Function`` whose forward is K1 (it saves qkv and the output)
and whose backward is K2 (it returns the stacked dqkv).  The raw wrappers are
``flash_attention_qkv_fwd`` and ``flash_attention_qkv_bwd``.  On a CUDA
tensor each launches its hand-written kernel (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version of the same function (``flash_attention_qkv_reference``,
``flash_attention_qkv_bwd_reference``), which the CPU tests hold against the
JAX kernels and ``chip_smoke.py`` holds the CUDA kernels against on the card.

``flash_attention_qkv.launches`` counts K1 launches and
``flash_attention_qkv_bwd.launches`` K2 launches (never plain calls), so a run
can show that its main path went through the kernels.

The kernels read qkv in the layout the QKV projection produces,
(B, N, 3, K, D); the output and its cotangent are (B, N, K, D) and K2 writes
dqkv as (B, N, 3, K, D).  ``fused_qkv_attention`` keeps the JAX signature and
value — (B, N, H) x, (H, 3, K, D) w → (B, K, D, N) — and returns that result
as a permuted view of the kernel's output.  Its backward is JAX's unfused
rule: K2, then dx = dqkv·Wᵀ and dW = xᵀ·dqkv as plain GEMMs (autograd of the
projection's ``torch.matmul``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_HEAD_DIM = 64     # the kernels' compile-time head dim (all repo configurations)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def flash_attention_qkv_reference(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of K1: (B, N, 3, K, D) → (B, N, K, D).

    Follows the TPU kernel's rounding (``_tn_fwd_math``), not ``_sdpa``'s:
    the already-rounded operands are upcast to f32 before each product (the
    TPU's preferred_element_type=f32, up to summation order), e = exp(s − m)
    is cast to the operand dtype before the AV product, and the row
    normalisation multiplies the f32 AV result."""
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3).float() for i in range(3))  # (B,K,N,D)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    out = torch.matmul(e.to(qkv.dtype).float(), v) * r
    return out.to(qkv.dtype).permute(0, 2, 1, 3)


def flash_attention_qkv_bwd_reference(qkv: torch.Tensor, out: torch.Tensor,
                                      dout: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of K2: the stacked dqkv (B, N, 3, K, D) from the
    saved qkv (B, N, 3, K, D), the saved output and its cotangent (B, N, K, D).

    Follows ``_tn_bwd_math`` with the saved O: p is recomputed from the row
    max m and r = 1/Σe; e cast to the operand dtype feeds dv through
    do_r = (do·r) cast to the operand dtype; delta = rowsum(do⊙o) in f32;
    ds = (e·((dp − delta)·(r·scale))) cast to the operand dtype feeds dq and
    dk.  Every product takes the rounded operands upcast to f32."""
    dt = qkv.dtype
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3).float() for i in range(3))  # (B,K,N,D)
    o = out.permute(0, 2, 1, 3).float()
    do = dout.permute(0, 2, 1, 3).float()
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / e.sum(dim=-1, keepdim=True)                      # (B,K,N,1)
    eb = e.to(dt).float()
    delta = (do * o).sum(dim=-1, keepdim=True)
    do_r = (do * r).to(dt).float()
    dv = torch.matmul(eb.transpose(-1, -2), do_r)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (e * ((dp - delta) * (r * scale))).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return torch.stack([dq, dk, dv], dim=2).to(dt).permute(0, 3, 2, 1, 4)


def _check(qkv: torch.Tensor) -> None:
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, K, D), got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv dtype must be bfloat16 or float32, got {qkv.dtype}")
    if 0 in qkv.shape:
        raise ValueError(f"qkv has an empty dimension: {tuple(qkv.shape)}")


def _check_cuda(qkv: torch.Tensor, name: str, scale: float) -> None:
    """What both CUDA kernels need beyond ``_check``."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {qkv.device}")
    B, N, _, K, D = qkv.shape
    if D != _HEAD_DIM:
        raise ValueError(f"the CUDA kernels are built for head dim {_HEAD_DIM}, got D={D}")
    if not scale > 0:
        # the bf16 kernels take row maxima of the unscaled scores
        raise ValueError(f"the CUDA kernels need a positive scale, got {scale}")
    if B > _MAX_GRID_YZ or K > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or heads {K} exceed the launch grid ({_MAX_GRID_YZ})")


def _rows_16b_aligned(t: torch.Tensor) -> bool:
    """Unit head-dim stride, every row start on 16 bytes (8 bf16 elements)."""
    *outer, sd = t.stride()
    return sd == 1 and all(s % 8 == 0 for s in outer) and t.data_ptr() % 16 == 0


def flash_attention_qkv_fwd(qkv: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """K1: softmax attention per (batch, head) on a stacked (B, N, 3, K, D)
    qkv; returns (B, N, K, D) in qkv's dtype.  scale defaults to D^-0.5."""
    _check(qkv)
    B, N, _, K, D = qkv.shape
    scale = D ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_reference(qkv, scale)
    _check_cuda(qkv, "flash_attention_qkv", scale)
    if qkv.dtype == torch.bfloat16 and not _rows_16b_aligned(qkv):
        raise ValueError("the bf16 kernel moves 16-byte chunks: qkv needs a unit head-dim "
                         f"stride and strides that are multiples of 8, got {qkv.stride()}")
    out = torch.empty((B, N, K, D), dtype=qkv.dtype, device=qkv.device)
    lib = _library("flash_attention_fwd")
    err = lib.flash_attention_qkv_fwd(
        qkv.data_ptr(), out.data_ptr(), _DTYPE_CODES[qkv.dtype], B, N, K, D,
        *qkv.stride(), *out.stride(), scale,
        torch.cuda.current_stream(qkv.device).cuda_stream, qkv.device.index)
    _raise_on(lib, err, "flash_attention_qkv_fwd")
    flash_attention_qkv.launches += 1
    return out


def flash_attention_qkv_bwd(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                            scale: float | None = None) -> torch.Tensor:
    """K2: the stacked gradient dqkv (B, N, 3, K, D) of K1 from the saved qkv,
    the saved output ``out`` and its cotangent ``dout`` (both (B, N, K, D))."""
    _check(qkv)
    B, N, _, K, D = qkv.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (B, N, K, D) or t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(f"{name} must be {(B, N, K, D)} {qkv.dtype} on {qkv.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    scale = D ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_bwd_reference(qkv, out, dout, scale)
    _check_cuda(qkv, "flash_attention_qkv_bwd", scale)
    if qkv.dtype == torch.bfloat16 and not all(map(_rows_16b_aligned, (qkv, out, dout))):
        raise ValueError("the bf16 kernel moves 16-byte chunks: qkv, out and dout need a "
                         "unit head-dim stride and strides that are multiples of 8")
    dqkv = torch.empty((B, N, 3, K, D), dtype=qkv.dtype, device=qkv.device)
    # per-row softmax statistics, written by the dq kernel for the dk/dv kernel
    stats = torch.empty((3, B, K, N), dtype=torch.float32, device=qkv.device)
    lib = _library("flash_attention_bwd")
    err = lib.flash_attention_qkv_bwd(
        qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        _DTYPE_CODES[qkv.dtype], B, N, K, D, *qkv.stride(), *out.stride(), *dout.stride(),
        scale, torch.cuda.current_stream(qkv.device).cuda_stream, qkv.device.index)
    _raise_on(lib, err, "flash_attention_qkv_bwd")
    flash_attention_qkv_bwd.launches += 1
    return dqkv


flash_attention_qkv_bwd.launches = 0


class _FlashAttentionQKV(torch.autograd.Function):
    """K1 forward, saving (qkv, out); K2 backward returning the stacked dqkv."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, scale: float) -> torch.Tensor:
        out = flash_attention_qkv_fwd(qkv, scale)
        ctx.save_for_backward(qkv, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, out = ctx.saved_tensors
        return flash_attention_qkv_bwd(qkv, out, dout.contiguous(), ctx.scale), None


def flash_attention_qkv(qkv: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Differentiable softmax attention on a stacked (B, N, 3, K, D) qkv;
    returns (B, N, K, D) in qkv's dtype.  scale defaults to D^-0.5.  The
    forward is K1, the backward K2."""
    _check(qkv)
    scale = qkv.shape[-1] ** -0.5 if scale is None else float(scale)
    return _FlashAttentionQKV.apply(qkv, scale)


flash_attention_qkv.launches = 0


def _raise_on(lib: ctypes.CDLL, err: int, fn: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


_ARGTYPES = {
    # qkv, out, dtype, B, N, K, D, 5 qkv strides, 4 out strides, scale, stream, device
    "flash_attention_fwd": ("flash_attention_qkv_fwd",
                            [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
                            + [ctypes.c_longlong] * 9
                            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]),
    # qkv, out, dout, dqkv, stats, dtype, B, N, K, D, 5 qkv, 4 out, 4 dout
    # strides, scale, stream, device
    "flash_attention_bwd": ("flash_attention_qkv_bwd",
                            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                            + [ctypes.c_longlong] * 13
                            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]),
}


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn_name, argtypes = _ARGTYPES[name]
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def fused_qkv_attention(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """QKV projection + fused SDPA: (B, N, H) x, (H, 3, K, D) w → (B, K, D, N).

    Same signature and value as the JAX ``fused_qkv_attention``.  The result
    is a permuted view of the kernel's (B, N, K, D) output: permute it back
    (``out.permute(0, 3, 1, 2)``) to feed the output projection without a
    copy.  Differentiable: K2 gives dqkv, and the projection's autograd gives
    dx = dqkv·Wᵀ and dW = xᵀ·dqkv in x's dtype with f32 accumulation (the JAX
    unfused backward, ``kernels/flash_attention.py:1016-1023``)."""
    B, N, H = x.shape
    _, _, K, D = w.shape
    qkv = torch.matmul(x, w.reshape(H, 3 * K * D).to(x.dtype)).view(B, N, 3, K, D)
    return flash_attention_qkv(qkv, D ** -0.5).permute(0, 2, 3, 1)
