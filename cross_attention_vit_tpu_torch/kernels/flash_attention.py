"""Fused self-attention forward: the Hopper port of the TPU kernel
``cross_attention_vit_tpu/kernels/flash_attention.py::_attn_kernel_qkv_tn``.

``flash_attention_qkv`` is the wrapper.  On a CUDA tensor it launches the
hand-written kernel in ``csrc/flash_attention_fwd.cu`` or raises; on a CPU
tensor it runs ``flash_attention_qkv_reference``, the plain PyTorch version
of the same function, which the CPU tests hold against the JAX kernel and
``chip_smoke.py`` holds the CUDA kernel against on the card.

``flash_attention_qkv.launches`` counts kernel launches (never plain calls),
so a run can show that its main path went through the kernel.

The kernel reads qkv in the layout the QKV projection produces,
(B, N, 3, K, D), and writes (B, N, K, D).  ``fused_qkv_attention`` keeps the
JAX signature and value — (B, N, H) x, (H, 3, K, D) w → (B, K, D, N) — and
returns that result as a permuted view of the kernel's output.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_HEAD_DIM = 64     # the kernel's compile-time head dim (all repo configurations)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def flash_attention_qkv_reference(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, 3, K, D) → (B, N, K, D).

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


def _check(qkv: torch.Tensor) -> None:
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, K, D), got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv dtype must be bfloat16 or float32, got {qkv.dtype}")
    if 0 in qkv.shape:
        raise ValueError(f"qkv has an empty dimension: {tuple(qkv.shape)}")


def _rows_16b_aligned(qkv: torch.Tensor) -> bool:
    """Unit head-dim stride, every (b, n, s, h) row start on 16 bytes."""
    *outer, sd = qkv.stride()
    return sd == 1 and all(s % 8 == 0 for s in outer) and qkv.data_ptr() % 16 == 0


def flash_attention_qkv(qkv: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Softmax attention per (batch, head) on a stacked (B, N, 3, K, D) qkv;
    returns (B, N, K, D) in qkv's dtype.  scale defaults to D^-0.5."""
    _check(qkv)
    B, N, _, K, D = qkv.shape
    scale = D ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_reference(qkv, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv runs on cuda or cpu tensors, got {qkv.device}")
    if D != _HEAD_DIM:
        raise ValueError(f"the CUDA kernel is built for head dim {_HEAD_DIM}, got D={D}")
    if not scale > 0:
        # the bf16 kernel takes row maxima of the unscaled scores
        raise ValueError(f"the CUDA kernel needs a positive scale, got {scale}")
    if B > _MAX_GRID_YZ or K > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or heads {K} exceed the launch grid ({_MAX_GRID_YZ})")
    if qkv.dtype == torch.bfloat16 and not _rows_16b_aligned(qkv):
        raise ValueError("the bf16 kernel moves 16-byte chunks: qkv needs a unit head-dim "
                         f"stride and strides that are multiples of 8, got {qkv.stride()}")
    out = torch.empty((B, N, K, D), dtype=qkv.dtype, device=qkv.device)
    lib = _library()
    err = lib.flash_attention_qkv_fwd(
        qkv.data_ptr(), out.data_ptr(), _DTYPE_CODES[qkv.dtype], B, N, K, D,
        *qkv.stride(), *out.stride(), scale,
        torch.cuda.current_stream(qkv.device).cuda_stream, qkv.device.index)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_qkv_fwd failed: CUDA error {err} ({msg})")
    flash_attention_qkv.launches += 1
    return out


flash_attention_qkv.launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_qkv_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def fused_qkv_attention(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """QKV projection + fused SDPA: (B, N, H) x, (H, 3, K, D) w → (B, K, D, N).

    Same signature and value as the JAX ``fused_qkv_attention``.  The result
    is a permuted view of the kernel's (B, N, K, D) output: permute it back
    (``out.permute(0, 3, 1, 2)``) to feed the output projection without a
    copy."""
    B, N, H = x.shape
    _, _, K, D = w.shape
    qkv = torch.matmul(x, w.reshape(H, 3 * K * D).to(x.dtype)).view(B, N, 3, K, D)
    return flash_attention_qkv(qkv, D ** -0.5).permute(0, 2, 3, 1)
