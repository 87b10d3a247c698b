"""3-D convolution ops for the legacy CNN-stem model families.

Port of ``cross_attention_vit_tpu/ops/conv.py`` (torch semantics throughout,
reference model.py:23-75, modelv2.py:14-58):

  * ``conv3d``: NCDHW activations, OIDHW kernels, zero padding, optional
    stride; the kernel is cast to the activation's dtype, so the stems run
    in float32 whatever ``compute_dtype`` says (JAX :24-38);
  * ``max_pool3d``: window k, stride s, −inf padding, floor division output;
  * ``batch_norm3d``: train mode normalises with the batch's biased variance
    and updates the running statistics with momentum 0.1 from the unbiased
    one (n/(n−1)); eval mode reads the running statistics; eps 1e-5;
  * ``avg_pool3d`` and ``global_avg_pool3d`` for the DenseNet transitions
    and head.

The JAX package computes these through XLA, not through Pallas, so the port
runs PyTorch's own convolution, batch norm and pooling.

Convolutions never run TF32, and no process-wide flag is set for that
(so concurrent callers cannot see one changed).  ``conv3d`` is an autograd
Function with three products: on a card the forward and the input gradient
are each one ATen cuDNN call that takes ``allow_tf32`` as an argument
(``cudnn_convolution``, ``cudnn_convolution_transpose``), given False; the
weight gradient is batched f32 GEMMs over the input's windows (im2col), its
reduction over batch and output positions split into chunks of at most
``_CHUNK`` summed at the end — cuBLAS, like every GEMM of the port, without
TF32 unless ``torch.backends.cuda.matmul.allow_tf32`` is set (off by
default).  Off the card (the CPU; the meta device of a shape trace) the
same products run through ``F.conv3d`` / ``F.conv_transpose3d`` and the
same GEMMs.

Over a data-parallel mesh JAX normalises over the global batch (SyncBatchNorm
semantics, JAX :13-16, where GSPMD inserts the cross-device mean).  The port
does the same where ``parallel.shard_params`` gave a BatchNorm layer its data
line's group (``sync_group``): in train mode each rank's per-channel count,
mean and sum of squared deviations (f32) cross one all-reduce and merge into
the global batch's mean and biased variance; the running variance takes the
unbiased estimate at the global count; the backward all-reduces the two
per-channel gradient sums, as ``nn.SyncBatchNorm`` does.  Without a group
the path is ``F.batch_norm``'s.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

_ONES = (1, 1, 1)


def _triple(v: int | tuple) -> tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def _conv(x, w, stride, padding):
    """x ⋆ w without TF32, no bias."""
    if x.device.type != "cuda":
        return F.conv3d(x, w, None, stride, padding)
    cudnn = torch.backends.cudnn
    return torch.ops.aten.cudnn_convolution(
        x.contiguous(), w.contiguous(), list(padding), list(stride), list(_ONES), 1,
        cudnn.benchmark, cudnn.deterministic, False)


def _conv_transpose(g, w, stride, padding, output_padding):
    """The adjoint of ``_conv`` in its first operand, without TF32."""
    if g.device.type != "cuda":
        return F.conv_transpose3d(g, w, None, stride, padding, output_padding)
    cudnn = torch.backends.cudnn
    return torch.ops.aten.cudnn_convolution_transpose(
        g.contiguous(), w.contiguous(), list(padding), list(output_padding), list(stride),
        list(_ONES), 1, cudnn.benchmark, cudnn.deterministic, False)


# the weight gradient's reduction chunk (output positions) and the most
# bytes of input windows one batch of its GEMMs copies out
_CHUNK = 4096
_WINDOW_BYTES = 1 << 31


def _weight_grad(x, grad, k, stride, padding):
    """dw[o, c, t] = Σ_n,i grad[n, o, i] · x[n, c, i·s + t − p]: the windows
    of x copied out as (positions, c·t) rows, a sample group at a time, and
    one batched GEMM of the gradient's chunks of ``_CHUNK`` positions
    against them; the chunks' products summed in f32."""
    N, C = x.shape[:2]
    O, out = grad.shape[1], grad.shape[2:]
    K, cols = out.numel(), C * k[0] * k[1] * k[2]
    L = min(K, _CHUNK)
    pad_k = -K % L
    xp = F.pad(x, (padding[2],) * 2 + (padding[1],) * 2 + (padding[0],) * 2)
    _, sc, sd, sh, sw = xp.stride()
    group = max(1, _WINDOW_BYTES // ((K + pad_k) * cols * x.element_size()))
    dw = None
    for n0 in range(0, N, group):
        xs = xp[n0:n0 + group]
        G = xs.shape[0]
        win = xs.as_strided((G, *out, C, *k), (xs.stride(0), sd * stride[0], sh * stride[1],
                                               sw * stride[2], sc, sd, sh, sw))
        win = win.reshape(G, K, cols)
        g = grad[n0:n0 + G].reshape(G, O, K)
        if pad_k:
            win, g = F.pad(win, (0, 0, 0, pad_k)), F.pad(g, (0, pad_k))
        c = (K + pad_k) // L
        a = g.view(G, O, c, L).transpose(1, 2).reshape(G * c, O, L)
        part = torch.bmm(a, win.reshape(G * c, L, cols)).sum(0)
        dw = part if dw is None else dw + part
    return dw.view(O, C, *k)


class _Conv3d(torch.autograd.Function):
    """conv3d with a hand-written backward of the same no-TF32 products
    (autograd's own would follow the process-wide flag)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, bias is not None)
        y = _conv(x, weight, stride, padding)
        return y if bias is None else y.add_(bias.view(1, -1, 1, 1, 1))

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, has_bias = ctx.conf
        k = weight.shape[2:]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # the rows the forward's floor division dropped at the far edge
            extra = [x.shape[2 + i] + 2 * padding[i] - k[i] - (grad.shape[2 + i] - 1) * stride[i]
                     for i in range(3)]
            dx = _conv_transpose(grad, weight, stride, padding, extra)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(x, grad, k, stride, padding)
        if has_bias and ctx.needs_input_grad[2]:
            db = grad.sum(dim=(0, 2, 3, 4))
        return dx, dw, db, None, None


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride: int | tuple = 1, padding: int | tuple = 0) -> torch.Tensor:
    """x (N, C, D, H, W), weight (O, I, kd, kh, kw), bias (O,): the kernel and
    bias cast to x's dtype, f32 products without TF32."""
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    return _Conv3d.apply(x, weight, bias, _triple(stride), _triple(padding))


def max_pool3d(x: torch.Tensor, kernel: int = 2, stride: int | None = None,
               padding: int = 0) -> torch.Tensor:
    return F.max_pool3d(x, kernel, stride or kernel, padding)


def avg_pool3d(x: torch.Tensor, kernel: int = 2, stride: int | None = None) -> torch.Tensor:
    return F.avg_pool3d(x, kernel, stride or kernel)


def global_avg_pool3d(x: torch.Tensor) -> torch.Tensor:
    """(N, C, D, H, W) → (N, C): AdaptiveAvgPool3d(1) and flatten."""
    return x.mean(dim=(2, 3, 4))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the group's global batch: returns y and
    the global (mean, biased variance, count) of each channel."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        n = x.numel() // c
        mean = xf.mean(dim=dims)
        m2 = (xf - mean.view(1, c, *[1] * (x.dim() - 2))).square().sum(dim=dims)
        # every rank's (count, mean, M2) in its own row, one all-reduce
        rows = xf.new_zeros((dist.get_world_size(group), 1 + 2 * c))
        rows[dist.get_rank(group)] = torch.cat([mean.new_tensor([float(n)]), mean, m2])
        dist.all_reduce(rows, group=group)
        counts, means, m2s = rows[:, :1], rows[:, 1:1 + c], rows[:, 1 + c:]
        total = counts.sum()
        g_mean = (counts * means).sum(0) / total
        g_var = (m2s.sum(0) + (counts * (means - g_mean).square()).sum(0)) / total
        shape = (1, c) + (1,) * (x.dim() - 2)
        invstd = torch.rsqrt(g_var + eps)
        xhat = (xf - g_mean.view(shape)) * invstd.view(shape)
        y = xhat * weight.float().view(shape) + bias.float().view(shape)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.group, ctx.total = group, total
        ctx.mark_non_differentiable(g_mean, g_var)
        return y.to(x.dtype), g_mean, g_var, total

    @staticmethod
    def backward(ctx, dy, _mean, _var, _total):
        xhat, invstd, weight = ctx.saved_tensors
        c = xhat.shape[1]
        dims = [0] + list(range(2, xhat.dim()))
        shape = (1, c) + (1,) * (xhat.dim() - 2)
        dyf = dy.float()
        sums = torch.stack([dyf.sum(dim=dims), (dyf * xhat).sum(dim=dims)])
        d_bias, d_weight = sums[0].clone(), sums[1].clone()
        dist.all_reduce(sums, group=ctx.group)
        mean_dy, mean_dy_xhat = (sums / ctx.total).unbind(0)
        dx = (weight.float() * invstd).view(shape) * (
            dyf - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape))
        return (dx.to(dy.dtype), d_weight.to(weight.dtype), d_bias.to(weight.dtype),
                None, None)


def batch_norm3d(norm: nn.BatchNorm3d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """BatchNorm3d with ``norm``'s affine parameters and running statistics:
    in train mode the batch statistics normalise and the running mean and
    variance move by ``norm.momentum`` (0.1) in place, the variance by its
    unbiased estimate; in eval mode the running statistics normalise.  With
    ``norm.sync_group`` (set by ``parallel.shard_params`` over a data axis)
    the train-mode statistics are the group's global batch's."""
    if train:
        norm.num_batches_tracked.add_(1)
    group = getattr(norm, "sync_group", None)
    if train and group is not None:
        y, mean, var, total = _SyncBatchNorm.apply(x, norm.weight, norm.bias, norm.eps, group)
        with torch.no_grad():
            m = norm.momentum
            unbiased = var * (total / torch.clamp(total - 1, min=1))
            norm.running_mean.mul_(1 - m).add_(mean.to(norm.running_mean.dtype), alpha=m)
            norm.running_var.mul_(1 - m).add_(unbiased.to(norm.running_var.dtype), alpha=m)
        return y
    return F.batch_norm(x, norm.running_mean, norm.running_var, norm.weight, norm.bias,
                        train, norm.momentum, norm.eps)
