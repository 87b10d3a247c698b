"""Layers as plain functions on tensors.

Port of ``cross_attention_vit_tpu/ops/layers.py``.  Weights are in torch's
(out_features, in_features) layout — the reference state-dict layout the
port's modules hold.

Rounding: the JAX ``linear`` takes the operands in the compute dtype,
accumulates in f32, adds the f32 bias and casts once.  ``linear`` does the
same: on low-precision operands the product comes out in f32
(``matmul_f32``), so the result is rounded once, after the bias.  The exit
of a tensor-parallel region (``tp``, ``parallel/tensor.py``) sums the f32
partial products over the 'model' group before that bias and that cast.

Dropout inside a tensor-parallel region (the FFN's hidden units, the
cross-attention's probabilities on this rank's heads) draws the mask of the
whole width and keeps this rank's slice: the mask is the one-process mask
at the same generator state, and every rank's generator stays in step.

Mask width (JAX ``DROPOUT_BITS``, set from ``config.dropout_bits`` by
``apply_config_knobs``): the models read ``config.dropout_bits`` when they
are built and run their forward under ``dropout_bits(...)``, so the value
holds for that model's calls only and never outlives them.  JAX's other
two dropout knobs, ``tie_key_mode`` and ``dropout_rng_impl``, choose how
its keys are tied to the data and which RNG implementation draws them;
``torch.Generator`` has neither choice, so the port accepts both fields and
they change nothing.

Inside a rematerialised block (``ops/remat.py``) the keep masks are named
``dropout_mask`` and fc2's input ``ffn_hidden``.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from ..parallel.tensor import TP, copy_to, reduce_from, split_slice
from .quant import QuantLinear, qlinear
from .remat import kept, kept_value


class _MatmulF32(torch.autograd.Function):
    """a @ b of two same-dtype low-precision 2-D operands, returned in f32.

    Forward: on CUDA ``torch.mm(..., out_dtype=torch.float32)`` (f32
    accumulation, no rounding of the product); on the CPU the operands,
    already rounded, are upcast to f32 (bf16×bf16 products are exact in f32).
    Backward: JAX's transposes of a preferred_element_type=f32 dot — f32
    accumulation, each gradient rounded once to its operand's dtype.  When
    the caller rounds the result to the operand dtype (``lowp_backward``),
    the incoming f32 cotangent holds operand-dtype values, so the two GEMMs
    run in that dtype without loss; otherwise they run in f32."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor, lowp_backward: bool) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        ctx.lowp_backward = lowp_backward
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a.float(), b.float())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        a, b = ctx.saved_tensors
        if ctx.lowp_backward:
            g, a_, b_ = grad.to(a.dtype), a, b
        else:
            g, a_, b_ = grad, a.float(), b.float()
        da = torch.mm(g, b_.t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = torch.mm(a_.t(), g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db, None


def matmul_f32(a: torch.Tensor, b: torch.Tensor, lowp_backward: bool = False) -> torch.Tensor:
    """(..., K) @ (K, N) in f32: the exact product of the operands as given,
    accumulated in f32 (JAX's dot with preferred_element_type=f32).
    ``lowp_backward``: the caller rounds the result to the operand dtype
    (see ``_MatmulF32``)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    lead = a.shape[:-1]
    return _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b, lowp_backward).reshape(
        *lead, b.shape[-1])


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           compute_dtype: torch.dtype | None = None,
           out_dtype: torch.dtype | None = None, tp: TP | None = None) -> torch.Tensor:
    """x @ weightᵀ + bias.  Operands go to ``compute_dtype`` when given, else
    x.dtype; the product is f32, the bias is added in f32 and the result is
    cast once to ``out_dtype`` (default x.dtype).  ``tp``: a row-split
    weight, whose f32 partial products are summed over the 'model' group
    before the bias."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    op_dtype = compute_dtype if compute_dtype is not None else x.dtype
    y = reduce_from(matmul_f32(x.to(op_dtype), weight.to(op_dtype).t(), out_dtype == op_dtype),
                    tp)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def linear_layer(lin: torch.nn.Module, x: torch.Tensor,
                 compute_dtype: torch.dtype | None = None, tp: TP | None = None) -> torch.Tensor:
    """``linear`` with a module's weight and bias, or, for a layer that
    ``models/quantize`` rewrote into int8 form, the w8a8 ``qlinear`` (which
    returns x's dtype and ignores ``compute_dtype``, as the JAX ``linear``
    dispatch does; int8 layers are never split, ``parallel/tensor.py``)."""
    if isinstance(lin, QuantLinear):
        return qlinear(x, lin)
    return linear(x, lin.weight, lin.bias, compute_dtype, tp=tp)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU — exact erf by default (torch nn.GELU); tanh when ``approximate``.

    The JAX package keeps this knob as the module global ``GELU_APPROX`` set
    from ``config.gelu_approx``; the port reads the same config field and
    passes it explicitly."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def promote_input(img: torch.Tensor) -> torch.Tensor:
    """Re-promote a low-precision transfer batch (bf16/f16) to float32 at
    model entry, so every downstream dtype decision is the f32 path's."""
    if img.dtype in (torch.bfloat16, torch.float16):
        return img.float()
    return img


# the mask width of the calls in scope (``dropout_bits``): 'auto', 8, 16, or
# anything else for exact-probability Bernoulli masks
_DROPOUT_BITS: contextvars.ContextVar = contextvars.ContextVar("dropout_bits", default="auto")


@contextlib.contextmanager
def dropout_bits(bits):
    """The keep masks drawn in this block use ``bits`` (``config.dropout_bits``;
    'auto' outside any such block)."""
    token = _DROPOUT_BITS.set(bits)
    try:
        yield
    finally:
        _DROPOUT_BITS.reset(token)


def mask_bits(keep: float, bits="auto"):
    """The random bits a keep mask draws per element (JAX ``_mask_bits``):
    'auto' picks 8 when keep·2^8 is an integer (the threshold is then exact:
    the live dropout 0.25 → 192/256) and 16 otherwise; any other value is
    returned as given (8, 16, or None and the rest: Bernoulli)."""
    if bits == "auto":
        return 8 if keep * 256 == int(keep * 256) else 16
    return bits


def dropout_mask(shape, keep: float, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Boolean keep mask (JAX ``_mask``): with 8 or 16 bits (``mask_bits`` of
    the width in scope, ``dropout_bits``), that many random bits per element
    against round(keep·2^bits); otherwise, or where that threshold rounds up
    to 2^bits, an exact-probability Bernoulli (a uniform f32 against keep)."""
    b = mask_bits(keep, _DROPOUT_BITS.get())
    if b in (8, 16):
        thresh = int(round(keep * (1 << b)))
        if thresh < (1 << b):      # keep ≈ 1 would wrap to all-False
            dtype = torch.uint8 if b == 8 else torch.int32
            r = torch.randint(0, 1 << b, shape, generator=generator, device=device,
                              dtype=dtype)
            return r < thresh
    return torch.rand(shape, generator=generator, device=device) < keep


def _drop(x: torch.Tensor, rate: float, generator: torch.Generator | None, train: bool,
          mask_shape: tuple, split: tuple[int, TP] | None = None) -> torch.Tensor:
    """Keep with probability 1 − rate (``dropout_mask`` on ``mask_shape``,
    broadcast over x) and scale kept values by 1/(1 − rate).  ``split`` =
    (dim, tp): x is this rank's slice of dim, the mask is drawn whole and
    sliced alike."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout and stochastic depth in train mode need a torch.Generator")
    keep = 1.0 - rate

    def draw() -> torch.Tensor:
        if split is not None and split[1] is not None:
            dim, tp = split
            shape = list(mask_shape)
            shape[dim] *= tp.size
            return split_slice(dropout_mask(tuple(shape), keep, generator, x.device), dim, 1,
                               tp.rank, tp.size)
        return dropout_mask(mask_shape, keep, generator, x.device)

    mask = kept("dropout_mask", draw)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            train: bool, split: tuple[int, TP | None] | None = None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 − rate and
    scale kept elements by 1/(1 − rate); the identity in eval mode or at
    rate 0.  ``generator`` lives on x's device.  ``split`` = (dim, tp): x
    is this rank's slice of ``dim`` in a tensor-parallel region."""
    return _drop(x, rate, generator, train, x.shape, split)


def stochastic_depth_row(x: torch.Tensor, rate: float, generator: torch.Generator | None,
                         train: bool) -> torch.Tensor:
    """torchvision StochasticDepth(mode='row'): keep each sample's whole
    branch with probability 1 − rate, scaled by 1/(1 − rate), or zero it
    (JAX ``ops/layers.py:271-279``): dropout's keep mask on a (B, 1, ..., 1)
    shape.  The identity in eval mode or at rate 0."""
    return _drop(x, rate, generator, train, (x.shape[0],) + (1,) * (x.dim() - 1))


def feed_forward(x: torch.Tensor, fc1: torch.nn.Linear, fc2: torch.nn.Linear,
                 compute_dtype: torch.dtype | None = None, gelu_approx: bool = False,
                 rate: float = 0.0, generator: torch.Generator | None = None,
                 train: bool = False, tp: TP | None = None) -> torch.Tensor:
    """Linear→GELU→Dropout→Linear→Dropout (reference model_cross.py:19-31);
    either Linear may be in int8 form (``linear_layer``).  ``tp``: fc1's
    rows and fc2's columns are this rank's slice of the MLP width."""
    h = linear_layer(fc1, copy_to(x, tp), compute_dtype)
    h = dropout(gelu(h, gelu_approx), rate, generator, train, split=(-1, tp))
    h = linear_layer(fc2, kept_value("ffn_hidden", h), compute_dtype, tp)
    return dropout(h, rate, generator, train)


def mlp_head(x: torch.Tensor, fc1: torch.nn.Linear, fc2: torch.nn.Linear,
             compute_dtype: torch.dtype | None = None, gelu_approx: bool = False,
             rate: float = 0.0, generator: torch.Generator | None = None,
             train: bool = False, tp: TP | None = None) -> torch.Tensor:
    """Linear(H→mlp)→GELU→Dropout→Linear(mlp→classes)→Dropout — the
    per-stream classification head; its logits are dropped out too
    (reference model_cross.py:176-183)."""
    return feed_forward(x, fc1, fc2, compute_dtype, gelu_approx, rate, generator, train, tp)
