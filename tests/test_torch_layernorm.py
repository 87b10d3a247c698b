"""LayerNorm (``kernels/layernorm.py`` and ``ops/layers.py`` ``layernorm``)
on the CPU, where both wrappers run their plain versions: the forward is
the f32 chain the port always ran, held to the JAX ``layernorm``; the
backward's plain version, the f32 formula the kernels compute, is held to
autograd through that chain.  The CUDA kernels are held to the same plain
versions on the card (``chip_smoke.py``, phase kernels_layernorm).

Widths: Swin UNETR's block norms (48, 96) and merges (384, 3072), and the
ViTs' 1024.  bf16 results round once from f32 on both sides, so an element
differs by at most one bf16 ulp, at most 2^-7 of max |want|; f32 ones
differ by summation order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.ops import layers as jl
from cross_attention_vit_tpu_torch.kernels import layernorm as ln
from cross_attention_vit_tpu_torch.ops import layers as tl

BF16 = torch.bfloat16
WIDTHS = (48, 96, 384, 1024, 3072)
DTYPES = (BF16, torch.float32)
# by max |Δ| / max |want|: one bf16 ulp; f32 summation order
TOL = {BF16: 2.0 ** -7, torch.float32: 1e-5}


def _operands(C: int, dtype: torch.dtype, seed: int, rows: tuple = (2, 3)):
    """x with a per-row offset and scale (as a residual stream has), dy,
    and f32 weight and bias near the initial 1 and 0."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(*rows, C, generator=g) * (1 + 3 * torch.rand(*rows, 1, generator=g))
         + torch.randn(*rows, 1, generator=g)).to(dtype)
    dy = torch.randn(*rows, C, generator=g).to(dtype)
    weight = 1 + 0.1 * torch.randn(C, generator=g)
    bias = 0.1 * torch.randn(C, generator=g)
    return x, dy, weight, bias


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("C", WIDTHS)
def test_plain_forward_equals_the_jax_layernorm(C, dtype):
    x, _, weight, bias = _operands(C, dtype, seed=C)
    got = ln.layernorm_reference(x, weight, bias)
    params = {"scale": jnp.asarray(weight.numpy()), "bias": jnp.asarray(bias.numpy())}
    x_j = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == BF16 else jnp.float32)
    want = torch.from_numpy(np.array(jl.layernorm(params, x_j).astype(jnp.float32)))
    assert got.dtype == dtype and got.shape == x.shape
    assert _err(got, want) <= TOL[dtype]
    # the CPU route of ops.layers is this chain
    assert torch.equal(tl.layernorm(x, weight, bias), got)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("C", WIDTHS)
def test_plain_backward_equals_autograd_through_the_chain(C, dtype):
    x, dy, weight, bias = _operands(C, dtype, seed=100 + C)
    xa, wa, ba = (t.clone().requires_grad_(True) for t in (x, weight, bias))
    tl.layernorm(xa, wa, ba).backward(dy)
    dx, dw, db = ln.layernorm_backward(dy, x, weight)
    assert dx.dtype == dtype and dx.shape == x.shape
    assert dw.dtype == db.dtype == torch.float32
    assert _err(dx, xa.grad) <= TOL[dtype]
    assert _err(dw, wa.grad) <= 1e-5 and _err(db, ba.grad) <= 1e-5


def test_cpu_layernorm_launches_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(tl._LayerNorm, "apply", lambda *a: calls.append(a))
    before = (ln.layernorm.launches, ln.layernorm.bwd_launches)
    x, dy, weight, bias = _operands(96, BF16, seed=1)
    xa = x.clone().requires_grad_(True)
    y = tl.layernorm(xa, weight, bias)
    y.backward(dy)
    ln.layernorm(x, weight, bias)
    ln.layernorm_backward(dy, x, weight)
    assert not calls and y.dtype == BF16 and xa.grad is not None
    assert (ln.layernorm.launches, ln.layernorm.bwd_launches) == before


@pytest.mark.parametrize("device,takes", [("cuda", True), ("cpu", False), ("meta", False)])
def test_the_kernel_route_follows_the_device(device, takes):
    assert tl.takes_layernorm_kernel(torch.device(device)) is takes


def test_the_function_route_saves_x_and_the_weight_and_matches_the_chain(monkeypatch):
    """``_LayerNorm`` (the CUDA route), run here on the CPU, where its two
    wrappers run their plain versions: the chain's output, the chain's
    gradients, and only x and the weight saved for the backward."""
    monkeypatch.setattr(tl, "takes_layernorm_kernel", lambda device: True)
    applied = []
    apply = tl._LayerNorm.apply
    monkeypatch.setattr(tl._LayerNorm, "apply", lambda *a: applied.append(a) or apply(*a))
    x, dy, weight, bias = _operands(384, BF16, seed=3)
    xa, wa, ba = (t.clone().requires_grad_(True) for t in (x, weight, bias))
    got = tl.layernorm(xa, wa, ba)
    assert len(applied) == 1 and applied[0][3] == 1e-5
    assert [tuple(t.shape) for t in got.grad_fn.saved_tensors] == [x.shape, weight.shape]
    got.backward(dy)
    xc, wc, bc = (t.clone().requires_grad_(True) for t in (x, weight, bias))
    want = ln.layernorm_reference(xc, wc, bc)
    want.backward(dy)
    assert torch.equal(got, want)
    assert _err(xa.grad, xc.grad) <= TOL[BF16] and xa.grad.dtype == BF16
    assert _err(wa.grad, wc.grad) <= 1e-5 and _err(ba.grad, bc.grad) <= 1e-5


def test_a_meta_tensor_traces_the_chain():
    """A shape trace on the meta device runs the chain, which computes
    nothing; the kernels' wrapper itself refuses the device."""
    x, _, weight, bias = (t.to("meta") for t in _operands(48, BF16, seed=2))
    y = tl.layernorm(x, weight, bias)
    assert y.device.type == "meta" and y.shape == x.shape and y.dtype == BF16
    with pytest.raises(ValueError, match="cuda or cpu"):
        ln.layernorm(x, weight, bias)


@pytest.mark.parametrize("kwargs,match", [
    (dict(x=torch.zeros((), dtype=BF16)), "last axis"),
    (dict(x=torch.zeros(2, 0, dtype=BF16)), "last axis"),
    (dict(x=torch.zeros(2, 8, dtype=torch.int32)), "bfloat16, float16 or float32"),
    (dict(weight=torch.ones(7)), "weight"),
    (dict(bias=torch.zeros(8, 1)), "bias"),
    (dict(weight=torch.ones(8, dtype=torch.int64)), "weight"),
    (dict(bias=torch.zeros(8, device="meta")), "bias is on meta"),
])
def test_bad_layernorm_inputs_raise(kwargs, match):
    args = dict(x=torch.zeros(2, 8, dtype=BF16), weight=torch.ones(8), bias=torch.zeros(8))
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        ln.layernorm(**args)


@pytest.mark.parametrize("dy", [torch.zeros(2, 7, dtype=BF16), torch.zeros(2, 8),
                                torch.zeros(3, 8, dtype=BF16)], ids=["width", "dtype", "rows"])
def test_backward_refuses_a_cotangent_unlike_x(dy):
    with pytest.raises(ValueError, match="dy must match x"):
        ln.layernorm_backward(dy, torch.zeros(2, 8, dtype=BF16), torch.ones(8))
