"""PyTorch port ops against the JAX package's ops on the same numpy inputs
(float32, CPU).  Tolerance: atol 1e-5 — both sides compute in f32; the gap
is summation order."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.ops import layers as jl
from cross_attention_vit_tpu.ops import losses as jlosses
from cross_attention_vit_tpu.ops import patchify as jpatch
from cross_attention_vit_tpu_torch.ops import layers as tl
from cross_attention_vit_tpu_torch.ops import losses as tlosses
from cross_attention_vit_tpu_torch.ops import patchify as tpatch

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape,patch", [((2, 1, 16, 32, 24), (8, 16, 8)),
                                         ((1, 2, 8, 8, 16), (4, 4, 8))])
def test_patchify_matches_jax(shape, patch):
    vol = _rng().normal(size=shape).astype(np.float32)
    want = np.asarray(jpatch.patchify_3d(jnp.asarray(vol), patch))
    got = tpatch.patchify_3d(torch.from_numpy(vol), patch).numpy()
    np.testing.assert_array_equal(got, want)
    assert tpatch.num_patches(shape[2:], patch) == jpatch.num_patches(shape[2:], patch)


def test_patchify_rejects_non_divisible():
    with pytest.raises(ValueError):
        tpatch.patchify_3d(torch.zeros(1, 1, 9, 8, 8), (8, 8, 8))


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_jax(bias):
    r = _rng(1)
    x = r.normal(size=(3, 5, 24)).astype(np.float32)
    kernel = r.normal(size=(24, 40)).astype(np.float32)   # JAX (in, out)
    b = r.normal(size=(40,)).astype(np.float32)
    params = {"kernel": jnp.asarray(kernel)}
    if bias:
        params["bias"] = jnp.asarray(b)
    want = np.asarray(jl.linear(params, jnp.asarray(x)))
    got = tl.linear(torch.from_numpy(x), torch.from_numpy(kernel.T.copy()),
                    torch.from_numpy(b) if bias else None).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_layernorm_matches_jax():
    r = _rng(2)
    x = (r.normal(size=(2, 7, 32)) * 3 + 1).astype(np.float32)
    scale = r.normal(size=(32,)).astype(np.float32)
    bias = r.normal(size=(32,)).astype(np.float32)
    want = np.asarray(jl.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                   jnp.asarray(x)))
    got = tl.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                       torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("approx", [False, True])
def test_gelu_matches_jax(approx, monkeypatch):
    # the JAX package keeps the flavour in a module global; the port takes it
    # as an argument read from config.gelu_approx
    monkeypatch.setattr(jl, "GELU_APPROX", approx)
    x = (_rng(3).normal(size=(4, 64)) * 3).astype(np.float32)
    want = np.asarray(jl.gelu(jnp.asarray(x)))
    got = tl.gelu(torch.from_numpy(x), approximate=approx).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_feed_forward_matches_jax(monkeypatch):
    monkeypatch.setattr(jl, "GELU_APPROX", True)
    r = _rng(4)
    x = r.normal(size=(2, 3, 16)).astype(np.float32)
    w1, b1 = r.normal(size=(16, 32)).astype(np.float32), r.normal(size=(32,)).astype(np.float32)
    w2, b2 = r.normal(size=(32, 16)).astype(np.float32), r.normal(size=(16,)).astype(np.float32)
    params = {"fc1": {"kernel": jnp.asarray(w1), "bias": jnp.asarray(b1)},
              "fc2": {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)}}
    want = np.asarray(jl.feed_forward(params, jnp.asarray(x), 0.0, jl.RngStream(None), False))

    def lin(w, b):
        m = torch.nn.Linear(*w.shape)
        m.weight.data = torch.from_numpy(w.T.copy())
        m.bias.data = torch.from_numpy(b)
        return m

    got = tl.feed_forward(torch.from_numpy(x), lin(w1, b1), lin(w2, b2),
                          gelu_approx=True).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    r = _rng(5)
    logits = (r.normal(size=(6, 3)) * 2).astype(np.float32)
    labels = np.array([0, 2, 1, 1, 0, 2])
    want = float(jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = float(tlosses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                      smoothing))
    assert abs(got - want) <= ATOL
    # and torch's own definition
    ref = float(torch.nn.functional.cross_entropy(torch.from_numpy(logits),
                                                  torch.from_numpy(labels),
                                                  label_smoothing=smoothing))
    assert abs(got - ref) <= ATOL


def test_linear_bf16_rounds_once_like_jax():
    """bf16 operands: the f32 product plus the f32 bias, rounded once to bf16
    (JAX ``linear``).  Rounding the product to bf16 before the bias add, as
    a bf16 matmul does, changes about a quarter of the outputs; rounding
    once leaves only the elements where the f32 sums, taken in another
    order, fall on either side of a bf16 rounding boundary: at most 0.1% of
    the elements, each by at most one bf16 ulp (2^-7 relative)."""
    r = _rng(6)
    x = r.normal(size=(64, 256)).astype(np.float32)
    w = (r.normal(size=(256, 512)) * 256 ** -0.5).astype(np.float32)   # JAX (in, out)
    b = r.normal(size=(512,)).astype(np.float32)
    want = np.asarray(jl.linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                                jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tl.linear(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w.T.copy()),
                    torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.mean(got != want) <= 1e-3
    np.testing.assert_array_less(np.abs(got - want), 2 ** -7 * np.abs(want) + 1e-30)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_linear_bf16_gradients_match_jax(out_dtype):
    """The backward of the bf16 product: dx and dW in bf16 with f32
    accumulation when the result is bf16, in f32 when it is f32 — JAX's
    transposes of the preferred_element_type=f32 dot."""
    import jax

    r = _rng(7)
    x = r.normal(size=(8, 32)).astype(np.float32)
    w = (r.normal(size=(32, 16)) * 32 ** -0.5).astype(np.float32)
    g = r.normal(size=(8, 16)).astype(np.float32)
    jdt = jnp.bfloat16 if out_dtype == torch.bfloat16 else jnp.float32

    def f(x_, w_):
        return jl.linear({"kernel": w_}, x_.astype(jdt), compute_dtype=jnp.bfloat16)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    y = tl.linear(tx.to(out_dtype), tw, compute_dtype=torch.bfloat16)
    assert y.dtype == out_dtype
    y.backward(torch.from_numpy(g).to(out_dtype))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), atol=2e-2, rtol=2 ** -7)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw).T, atol=2e-2, rtol=2 ** -7)


def test_promote_input():
    for dt in (torch.bfloat16, torch.float16):
        assert tl.promote_input(torch.ones(2, dtype=dt)).dtype == torch.float32
    x = torch.ones(2)
    assert tl.promote_input(x) is x


@pytest.mark.parametrize("rate", [0.25, 0.1])
def test_dropout_keep_fraction_and_scaling(rate):
    """keep 0.75 is exact in 8 random bits (192/256), 0.9 is drawn from 16
    bits; kept elements are scaled by exactly 1/keep.  The keep fraction of
    10^6 draws lies within 5 binomial standard deviations of 1 − rate."""
    x = torch.full((1000, 1000), 3.0)
    g = torch.Generator().manual_seed(0)
    y = tl.dropout(x, rate, g, train=True)
    kept = y != 0
    keep = 1.0 - rate
    sd = (keep * rate / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - keep) < 5 * sd
    assert torch.equal(y[kept], (x / keep)[kept])


def test_dropout_mask_draws_8_bits_when_exact():
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    mask = tl.dropout_mask((4096,), 0.75, g1, torch.device("cpu"))
    bits = torch.randint(0, 256, (4096,), generator=g2, dtype=torch.uint8)
    assert torch.equal(mask, bits < 192)


def test_dropout_identity_in_eval_and_at_rate_zero_and_needs_a_generator():
    x = torch.randn(5, 5)
    assert tl.dropout(x, 0.25, None, train=False) is x
    assert tl.dropout(x, 0.0, None, train=True) is x
    with pytest.raises(ValueError, match="Generator"):
        tl.dropout(x, 0.25, None, train=True)


def test_dropout_is_deterministic_under_a_seed():
    x = torch.randn(64, 64)
    a = tl.dropout(x, 0.25, torch.Generator().manual_seed(3), True)
    b = tl.dropout(x, 0.25, torch.Generator().manual_seed(3), True)
    c = tl.dropout(x, 0.25, torch.Generator().manual_seed(4), True)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_feed_forward_train_mode_drops_after_gelu_and_after_fc2():
    """At rate 0 train mode is the eval computation; at rate 0.5 the output
    has zeros where fc2's dropout fell, and differs from eval elsewhere
    because of the hidden dropout."""
    r = _rng(8)
    fc1, fc2 = torch.nn.Linear(16, 32), torch.nn.Linear(32, 16)
    x = torch.from_numpy(r.normal(size=(4, 16)).astype(np.float32))
    with torch.no_grad():
        ev = tl.feed_forward(x, fc1, fc2)
        tr0 = tl.feed_forward(x, fc1, fc2, rate=0.0, generator=None, train=True)
        tr = tl.feed_forward(x, fc1, fc2, rate=0.5, generator=torch.Generator().manual_seed(0),
                             train=True)
    assert torch.equal(ev, tr0)
    zeros = tr == 0
    assert zeros.any() and not torch.allclose(tr[~zeros], 2 * ev[~zeros])
