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

The epilogue.  ``linear`` also applies the GELU and the dropout that follow
a projection where the caller asks (``gelu_approx``, ``rate``).  On CUDA,
with bf16 or f16 operands whose result keeps their dtype, no tensor-parallel
split and no mask or a mask of 8- or 16-bit draws, everything after the f32
product runs in one hand-written kernel each way
(``kernels/linear_epilogue.py``): the same rounding points, the same draws
from the same generator (what ``dropout_mask`` compares, kept under the
name ``dropout_mask`` as drawn).  Everywhere else the ops run one by one.

LayerNorm.  ``layernorm`` computes in f32 and rounds once to x's dtype, as
the JAX ``layernorm``.  On CUDA it is one hand-written kernel each way
(``kernels/layernorm.py``), which reads and writes x's dtype and keeps the
f32 statistics in registers; elsewhere the f32 chain (upcast,
``F.layer_norm``, cast back).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from ..kernels import layernorm as ln
from ..kernels.linear_epilogue import linear_epilogue, linear_epilogue_backward
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


class _LinearLowp(torch.autograd.Function):
    """a @ b (+ bias) of two same-dtype bf16 or f16 2-D operands, rounded
    once to their dtype, then GELU and dropout where asked: the f32 product
    (``torch.mm(..., out_dtype=torch.float32)``; on the CPU the upcast
    operands), then ``linear_epilogue``.  Backward: ``linear_epilogue_backward``
    gives the product's cotangent in the operands' dtype and the bias's f32
    gradient, then ``_MatmulF32``'s two GEMMs in that dtype."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None,
                draws: torch.Tensor | None, thresh: int, keep: float,
                gelu_approx: bool | None) -> torch.Tensor:
        p = (torch.mm(a, b, out_dtype=torch.float32) if a.is_cuda
             else torch.mm(a.float(), b.float()))
        save = any(ctx.needs_input_grad[:3])
        y, pre, mask = linear_epilogue(p, bias, draws, thresh, keep, gelu_approx, a.dtype, save)
        ctx.save_for_backward(a, b, pre, mask)
        ctx.keep, ctx.gelu_approx = keep, gelu_approx
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        a, b, pre, mask = ctx.saved_tensors
        g, dbias = linear_epilogue_backward(grad, mask, pre, ctx.keep, ctx.gelu_approx,
                                            ctx.needs_input_grad[2])
        da = torch.mm(g, b.t()) if ctx.needs_input_grad[0] else None
        db = torch.mm(a.t(), g) if ctx.needs_input_grad[1] else None
        return da, db, dbias, None, None, None, None


def _epilogue(y: torch.Tensor, gelu_approx: bool | None, rate: float,
              generator: torch.Generator | None, train: bool,
              split: tuple[int, TP | None] | None) -> torch.Tensor:
    """GELU where asked (``gelu_approx`` not None), then ``dropout``."""
    if gelu_approx is not None:
        y = gelu(y, gelu_approx)
    return dropout(y, rate, generator, train, split)


def takes_epilogue_kernel(device: torch.device, op_dtype: torch.dtype, out_dtype: torch.dtype,
                          tp: TP | None, split: tuple[int, TP | None] | None, drop: bool,
                          drawn: tuple[int, int] | None) -> bool:
    """Whether ``linear`` runs its epilogue in the hand-written kernels: on
    CUDA, bf16 or f16 operands whose result keeps their dtype, no
    tensor-parallel reduction or mask slice, and no dropout or a mask of 8-
    or 16-bit draws (``drawn``, from ``_draw_threshold``)."""
    return (device.type == "cuda" and op_dtype in (torch.bfloat16, torch.float16)
            and out_dtype == op_dtype and tp is None and (split is None or split[1] is None)
            and (not drop or drawn is not None))


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           compute_dtype: torch.dtype | None = None,
           out_dtype: torch.dtype | None = None, tp: TP | None = None, *,
           gelu_approx: bool | None = None, rate: float = 0.0,
           generator: torch.Generator | None = None, train: bool = False,
           split: tuple[int, TP | None] | None = None) -> torch.Tensor:
    """x @ weightᵀ + bias.  Operands go to ``compute_dtype`` when given, else
    x.dtype; the product is f32, the bias is added in f32 and the result is
    cast once to ``out_dtype`` (default x.dtype).  ``tp``: a row-split
    weight, whose f32 partial products are summed over the 'model' group
    before the bias.  Then ``gelu`` where ``gelu_approx`` is not None, and
    ``dropout(·, rate, generator, train, split)``; on CUDA bf16/f16 one
    kernel each way does all of it after the product (module docstring)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    op_dtype = compute_dtype if compute_dtype is not None else x.dtype
    drop = train and rate != 0.0
    drawn = _draw_threshold(1.0 - rate) if drop else None
    if takes_epilogue_kernel(x.device, op_dtype, out_dtype, tp, split, drop, drawn):
        return _linear_lowp(x.to(op_dtype), weight.to(op_dtype), bias, drawn, rate, generator,
                            gelu_approx)
    y = reduce_from(matmul_f32(x.to(op_dtype), weight.to(op_dtype).t(), out_dtype == op_dtype),
                    tp)
    if bias is not None:
        y = y + bias.float()
    return _epilogue(y.to(out_dtype), gelu_approx, rate, generator, train, split)


def _linear_lowp(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                 drawn: tuple[int, int] | None, rate: float,
                 generator: torch.Generator | None,
                 gelu_approx: bool | None) -> torch.Tensor:
    """``linear``'s route through ``_LinearLowp``; ``drawn`` = (bits,
    threshold) of the keep mask, or None for no dropout."""
    lead, cols = x.shape[:-1], weight.shape[0]
    draws, thresh = None, 0
    if drawn is not None:
        if generator is None:
            raise ValueError("dropout and stochastic depth in train mode need a torch.Generator")
        bits, thresh = drawn
        draws = kept("dropout_mask",
                     lambda: _draw(lead + (cols,), bits, generator, x.device)).reshape(-1, cols)
    y = _LinearLowp.apply(x.reshape(-1, x.shape[-1]), weight.t(),
                          None if bias is None else bias.float(), draws, thresh, 1.0 - rate,
                          gelu_approx)
    return y.reshape(*lead, cols)


def linear_layer(lin: torch.nn.Module, x: torch.Tensor,
                 compute_dtype: torch.dtype | None = None, tp: TP | None = None, *,
                 gelu_approx: bool | None = None, rate: float = 0.0,
                 generator: torch.Generator | None = None, train: bool = False,
                 split: tuple[int, TP | None] | None = None) -> torch.Tensor:
    """``linear`` with a module's weight and bias, or, for a layer that
    ``models/quantize`` rewrote into int8 form, the w8a8 ``qlinear`` (which
    returns x's dtype and ignores ``compute_dtype``, as the JAX ``linear``
    dispatch does; int8 layers are never split, ``parallel/tensor.py``);
    then GELU and dropout as ``linear`` applies them."""
    if isinstance(lin, QuantLinear):
        return _epilogue(qlinear(x, lin), gelu_approx, rate, generator, train, split)
    return linear(x, lin.weight, lin.bias, compute_dtype, tp=tp, gelu_approx=gelu_approx,
                  rate=rate, generator=generator, train=train, split=split)


class _LayerNorm(torch.autograd.Function):
    """LayerNorm over the last axis in x's dtype, its statistics in f32:
    ``kernels/layernorm.py``'s forward kernel, and its backward kernels for
    dx, dweight and dbias.  Saves x and the weight only."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return ln.layernorm(x, weight, bias, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor):
        x, weight = ctx.saved_tensors
        dx, dweight, dbias = ln.layernorm_backward(dy, x, weight, ctx.eps)
        return dx, dweight, dbias.to(ctx.bias_dtype), None


def takes_layernorm_kernel(device: torch.device) -> bool:
    """Whether ``layernorm`` runs the hand-written kernels: on CUDA."""
    return device.type == "cuda"


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32: on CUDA
    ``_LayerNorm``, one hand-written kernel each way; elsewhere (the CPU,
    the meta device of a shape trace) the f32 chain,
    ``ln.layernorm_reference``, with autograd through it."""
    if takes_layernorm_kernel(x.device):
        return _LayerNorm.apply(x, weight, bias, eps)
    return ln.layernorm_reference(x, weight, bias, eps)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU — exact erf by default (torch nn.GELU); tanh when ``approximate``.

    The JAX package keeps this knob as the module global ``GELU_APPROX`` set
    from ``config.gelu_approx``; the port reads the same config field and
    passes it explicitly."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


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


def _draw_threshold(keep: float) -> tuple[int, int] | None:
    """(bits, threshold) of the integer draws a keep mask of the width in
    scope (``dropout_bits``) compares, or None for a Bernoulli mask: widths
    other than 8 and 16, and a threshold that rounds up to 2^bits (keep ≈ 1
    would wrap to all-False)."""
    b = mask_bits(keep, _DROPOUT_BITS.get())
    if b in (8, 16):
        thresh = int(round(keep * (1 << b)))
        if thresh < (1 << b):
            return b, thresh
    return None


def _draw(shape, bits: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """``bits`` random bits per element: uint8 for 8, int32 for 16."""
    dtype = torch.uint8 if bits == 8 else torch.int32
    return torch.randint(0, 1 << bits, shape, generator=generator, device=device, dtype=dtype)


def dropout_mask(shape, keep: float, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Boolean keep mask (JAX ``_mask``): with 8 or 16 bits (``mask_bits`` of
    the width in scope, ``dropout_bits``), that many random bits per element
    against round(keep·2^bits); otherwise, or where that threshold rounds up
    to 2^bits, an exact-probability Bernoulli (a uniform f32 against keep)."""
    drawn = _draw_threshold(keep)
    if drawn is not None:
        bits, thresh = drawn
        return _draw(shape, bits, generator, device) < thresh
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
    h = linear_layer(fc1, copy_to(x, tp), compute_dtype, gelu_approx=gelu_approx, rate=rate,
                     generator=generator, train=train, split=(-1, tp))
    return linear_layer(fc2, kept_value("ffn_hidden", h), compute_dtype, tp, rate=rate,
                        generator=generator, train=train)


def mlp_head(x: torch.Tensor, fc1: torch.nn.Linear, fc2: torch.nn.Linear,
             compute_dtype: torch.dtype | None = None, gelu_approx: bool = False,
             rate: float = 0.0, generator: torch.Generator | None = None,
             train: bool = False, tp: TP | None = None) -> torch.Tensor:
    """Linear(H→mlp)→GELU→Dropout→Linear(mlp→classes)→Dropout — the
    per-stream classification head; its logits are dropped out too
    (reference model_cross.py:176-183)."""
    return feed_forward(x, fc1, fc2, compute_dtype, gelu_approx, rate, generator, train, tp)
