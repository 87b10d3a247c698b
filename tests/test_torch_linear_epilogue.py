"""The low-precision linear's epilogue (``kernels/linear_epilogue.py`` and
``ops/layers.py`` ``_LinearLowp``) against the chain of PyTorch ops it
replaces, on the CPU, where the Function runs the epilogue's plain version.

The chain (``_chain`` below) is ``linear`` as it ran op by op: the f32
product of ``matmul_f32``, ``+ bias.float()``, ``.to(bf16)``, ``F.gelu``,
then ``dropout``'s ``torch.where(mask, x / keep, 0)`` on ``dropout_mask``'s
draws.  Forward output, the saved pre-GELU value and mask, the product's
cotangent and the operands' gradients must equal it bit for bit; the bias
gradient, an f32 sum over rows, to f32 summation order.  The CUDA kernels
are held to the same plain version on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cross_attention_vit_tpu_torch.kernels import linear_epilogue as le
from cross_attention_vit_tpu_torch.ops import layers as tl

BF16 = torch.bfloat16


def _operands(rows: tuple, k: int, n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*rows, k, generator=g).to(BF16)
    w = (torch.randn(n, k, generator=g) * k ** -0.5)          # f32 masters
    b = torch.randn(n, generator=g)
    gy = torch.randn(*rows, n, generator=g).to(BF16)          # the output's cotangent
    return x, w, b, gy


def _chain(x, w, b, gelu_approx, rate, train, gen):
    """The op-by-op chain; returns (output, f32 product leaf, gelu input, mask)."""
    p = tl.matmul_f32(x, w.to(BF16).t(), True).detach().requires_grad_(True)
    y = (p + b.float()).to(BF16)
    pre, mask = y, None
    if gelu_approx is not None:
        y = F.gelu(y, approximate="tanh" if gelu_approx else "none")
    if train and rate:
        keep = 1.0 - rate
        mask = tl.dropout_mask(y.shape, keep, gen, y.device)
        y = torch.where(mask, y / keep, torch.zeros((), dtype=y.dtype))
    return y, p, pre, mask


CASES = [(gelu, rate, train) for gelu in (True, False, None) for rate in (0.25, 0.1, 0.0)
         for train in (True, False)]


def _ids(case):
    gelu, rate, train = case
    return (f"{ {True: 'tanh', False: 'erf', None: 'nogelu'}[gelu]}-rate{rate}-"
            f"{'train' if train else 'eval'}")


@pytest.mark.parametrize("case", CASES + [(True, 0.25, True, 2), (None, 0.1, True, 2),
                                          (False, 0.25, False, 2)],
                         ids=[_ids(c) for c in CASES] + ["width2-tanh-rate0.25-train",
                                                         "width2-nogelu-rate0.1-train",
                                                         "width2-erf-eval"])
def test_fused_linear_equals_the_chain_bit_for_bit(case):
    gelu_approx, rate, train = case[:3]
    n = case[3] if len(case) > 3 else 40
    x, w, b, gy = _operands((3, 7), 24, n, seed=17 + n)
    keep = 1.0 - rate
    drop = train and rate != 0.0

    g_chain = torch.Generator().manual_seed(11)
    xc, wc, bc = (t.clone().requires_grad_(True) for t in (x, w, b))
    want, p, pre, mask = _chain(xc, wc, bc, gelu_approx, rate, train, g_chain)
    want.backward(gy)
    # the chain's operand gradients run through matmul_f32's autograd
    xc2, wc2, bc2 = (t.clone().requires_grad_(True) for t in (x, w, b))
    chain_y = (tl.matmul_f32(xc2, wc2.to(BF16).t(), True) + bc2.float()).to(BF16)
    if gelu_approx is not None:
        chain_y = F.gelu(chain_y, approximate="tanh" if gelu_approx else "none")
    chain_y = tl.dropout(chain_y, rate, torch.Generator().manual_seed(11), train)
    chain_y.backward(gy)

    g_fused = torch.Generator().manual_seed(11)
    xf, wf, bf = (t.clone().requires_grad_(True) for t in (x, w, b))
    drawn = tl._draw_threshold(keep) if drop else None
    got = tl._linear_lowp(xf, wf.to(BF16), bf, drawn, rate, g_fused, gelu_approx)
    got.backward(gy)

    assert got.dtype == BF16 and torch.equal(got, want)
    assert torch.equal(chain_y, want)
    assert torch.equal(g_fused.get_state(), g_chain.get_state())
    assert torch.equal(xf.grad, xc2.grad) and xf.grad.dtype == BF16
    assert torch.equal(wf.grad, wc2.grad) and wf.grad.dtype == torch.float32
    # the bias gradient: f32 sums of the same bf16 cotangent, in another order
    torch.testing.assert_close(bf.grad, bc2.grad, rtol=1e-6,
                               atol=1e-6 * bc2.grad.abs().max().item())

    # the epilogue alone: its saved values and the product's cotangent
    draws = None
    if drop:
        bits, thresh = drawn
        draws = tl._draw(gy.shape, bits, torch.Generator().manual_seed(11), "cpu").reshape(-1, n)
    else:
        thresh = 0
    out, saved_pre, saved_mask = le.linear_epilogue(
        p.detach().reshape(-1, n), b, draws, thresh, keep, gelu_approx, BF16, True)
    assert torch.equal(out, want.reshape(-1, n))
    if gelu_approx is None:
        assert saved_pre is None
    else:
        assert torch.equal(saved_pre, pre.reshape(-1, n))
    if drop:
        assert saved_mask.dtype == torch.uint8 and saved_mask.shape == (21, -(-n // 8))
        assert torch.equal(le.unpack_mask(saved_mask, n), mask.reshape(-1, n))
    else:
        assert saved_mask is None
    dp, dbias = le.linear_epilogue_backward(gy.reshape(-1, n), saved_mask, saved_pre, keep,
                                            gelu_approx, True)
    assert dp.dtype == BF16 and torch.equal(dp.float(), p.grad.reshape(-1, n))
    torch.testing.assert_close(dbias, p.grad.reshape(-1, n).sum(0), rtol=1e-6,
                               atol=1e-6 * dbias.abs().max().item())


@pytest.mark.parametrize("keep", [0.75, 0.9])
def test_reciprocal_product_rounds_as_the_quotient_over_every_bf16(keep):
    """The kernels scale by the f32 reciprocal of keep, as torch computes
    ``x / keep`` on CUDA; over every finite bf16 value that rounds to the
    bf16 of the f32 quotient the CPU computes, at the models' keeps."""
    x = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(BF16)
    x = x[torch.isfinite(x)].float()
    k = torch.tensor(keep, dtype=torch.float32)
    assert torch.equal((x / k).to(BF16), (x * (1.0 / k)).to(BF16))


@pytest.mark.parametrize("shape", [(5, 2), (3, 8), (4, 13), (1, 1)])
def test_mask_packs_one_bit_an_element(shape):
    g = torch.Generator().manual_seed(shape[1])
    mask = torch.rand(shape, generator=g) < 0.5
    packed = le.pack_mask(mask)
    assert packed.dtype == torch.uint8 and packed.shape == (shape[0], -(-shape[1] // 8))
    assert torch.equal(le.unpack_mask(packed, shape[1]), mask)
    # bit k of byte j is column 8j + k
    col = shape[1] - 1
    assert bool((int(packed[0, col // 8]) >> (col % 8)) & 1) == bool(mask[0, col])


@pytest.mark.parametrize("device,op,out,tp,split,drop,drawn,takes", [
    ("cuda", BF16, BF16, None, None, True, (8, 192), True),
    ("cuda", torch.float16, torch.float16, None, (-1, None), True, (16, 58982), True),
    ("cuda", BF16, BF16, None, None, False, None, True),
    ("cpu", BF16, BF16, None, None, False, None, False),
    ("cuda", torch.float32, torch.float32, None, None, False, None, False),   # MoE experts
    ("cuda", BF16, torch.float32, None, None, False, None, False),
    ("cuda", BF16, BF16, "tp", None, False, None, False),                     # TP exit
    ("cuda", BF16, BF16, None, (-1, "tp"), True, (8, 192), False),            # TP mask slice
    ("cuda", BF16, BF16, None, None, True, None, False),                      # Bernoulli
])
def test_the_kernel_route_follows_the_input(device, op, out, tp, split, drop, drawn, takes):
    tp = object() if tp else None            # a TP region: only its presence matters
    if split is not None and split[1]:
        split = (split[0], object())
    assert tl.takes_epilogue_kernel(torch.device(device), op, out, tp, split, drop,
                                    drawn) is takes


@pytest.mark.parametrize("bits,keep,want", [("auto", 0.75, (8, 192)), ("auto", 0.9, (16, 58982)),
                                            (None, 0.75, None), (8, 0.999, None)])
def test_draw_threshold_matches_dropout_mask(bits, keep, want):
    with tl.dropout_bits(bits):
        assert tl._draw_threshold(keep) == want
        g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
        mask = tl.dropout_mask((4, 9), keep, g1, "cpu")
        if want is not None:
            assert torch.equal(mask, tl._draw((4, 9), want[0], g2, "cpu") < want[1])


def test_cpu_linear_takes_the_chain_and_launches_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(tl._LinearLowp, "apply", lambda *a: calls.append(a))
    before = (le.linear_epilogue.launches, le.linear_epilogue.bwd_launches)
    x, w, b, _ = _operands((2, 3), 16, 8, seed=1)
    y = tl.linear(x, w, b, gelu_approx=True, rate=0.25, generator=torch.Generator(), train=True)
    assert y.dtype == BF16 and not calls
    le.linear_epilogue(torch.zeros(2, 8), None, None, 0, 1.0, None, BF16, False)
    assert (le.linear_epilogue.launches, le.linear_epilogue.bwd_launches) == before


@pytest.mark.parametrize("kwargs,match", [
    (dict(p=torch.zeros(2, 8, dtype=BF16)), "float32"),
    (dict(dtype=torch.float32), "bfloat16 or float16"),
    (dict(bias=torch.zeros(7)), "bias"),
    (dict(draws=torch.zeros(2, 8, dtype=torch.int64)), "draws"),
])
def test_bad_epilogue_inputs_raise(kwargs, match):
    args = dict(p=torch.zeros(2, 8), bias=None, draws=None, thresh=0, keep=1.0,
                gelu_approx=None, dtype=BF16, save=False)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        le.linear_epilogue(**args)


def test_generator_advances_once_per_fused_dropout():
    """The fused route draws once per call, at the output's shape, as the
    chain's ``dropout`` does: two calls from one generator give the chain's
    two masks."""
    x, w, b, _ = _operands((2, 4), 16, 24, seed=5)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    wb = w.to(BF16)
    fused = [tl._linear_lowp(x, wb, b, (8, 192), 0.25, g1, None) for _ in range(2)]
    chain = [tl.dropout((tl.matmul_f32(x, wb.t(), True) + b).to(BF16), 0.25, g2, True)
             for _ in range(2)]
    assert all(torch.equal(f, c) for f, c in zip(fused, chain))
    assert not torch.equal(fused[0], fused[1])
    assert np.array_equal(g1.get_state().numpy(), g2.get_state().numpy())
