"""The port's 3-D conv ops (``ops/conv.py``) against the JAX package's, f32,
within 1e-5: conv3d (strides, paddings, with and without bias, and its
gradients), max/avg/global pooling, and BatchNorm3d in train mode (batch
statistics, the running mean and the n/(n−1) running variance moved with
momentum 0.1) and eval mode (the running statistics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.ops import conv as jconv
from cross_attention_vit_tpu_torch.ops import conv as tconv

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,padding,bias", [(1, 0, True), (1, 1, False), (2, 1, True),
                                                 ((1, 2, 1), (0, 1, 1), True)])
def test_conv3d_matches_jax(stride, padding, bias):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 8, 9, 10)).astype(np.float32)
    w = rng.normal(size=(5, 3, 3, 3, 3)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    p = {"kernel": jnp.asarray(w), **({"bias": jnp.asarray(b)} if bias else {})}
    want = np.asarray(jconv.conv3d(p, jnp.asarray(x), stride=stride, padding=padding))
    got = tconv.conv3d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b) if bias else None, stride, padding)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv3d_gradients_match_jax():
    """The custom backward (aten.convolution_backward without TF32) against
    JAX's autodiff of the same conv."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 2, 6, 7, 5)).astype(np.float32)
    w = rng.normal(size=(4, 2, 3, 3, 3)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    g = rng.normal(size=(2, 4, 3, 4, 3)).astype(np.float32)

    def f(x, w, b):
        return jnp.sum(jconv.conv3d({"kernel": w, "bias": b}, x, stride=2, padding=1) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(x, w, b)
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    tconv.conv3d(xs[0], xs[1], xs[2], 2, 1).backward(torch.from_numpy(g))
    for t, j in zip(xs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5, atol=1e-4)


def test_conv3d_casts_the_kernel_to_the_input_dtype():
    x = torch.randn(1, 2, 4, 4, 4, dtype=torch.float64)
    w = torch.randn(3, 2, 3, 3, 3)
    assert tconv.conv3d(x, w, torch.zeros(3), padding=1).dtype == torch.float64


@pytest.mark.parametrize("kernel,stride,padding", [(2, None, 0), (3, 2, 1), (2, 1, 0)])
def test_max_pool3d_matches_jax(kernel, stride, padding):
    x = np.random.default_rng(2).normal(size=(1, 2, 8, 7, 9)).astype(np.float32)
    want = np.asarray(jconv.max_pool3d(jnp.asarray(x), kernel, stride, padding))
    got = tconv.max_pool3d(torch.from_numpy(x), kernel, stride, padding).numpy()
    np.testing.assert_array_equal(got, want)


def test_avg_and_global_pool_match_jax():
    x = np.random.default_rng(3).normal(size=(2, 4, 8, 6, 10)).astype(np.float32)
    np.testing.assert_allclose(tconv.avg_pool3d(torch.from_numpy(x), 2).numpy(),
                               np.asarray(jconv.avg_pool3d(jnp.asarray(x), 2)), **TOL)
    np.testing.assert_allclose(tconv.global_avg_pool3d(torch.from_numpy(x)).numpy(),
                               np.asarray(jconv.global_avg_pool3d(jnp.asarray(x))), **TOL)
    np.testing.assert_array_equal(tconv.relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jconv.relu(jnp.asarray(x))))


def _norms(C: int, rng):
    scale = rng.normal(size=(C,)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    mean = rng.normal(size=(C,)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=(C,)).astype(np.float32)
    bn = torch.nn.BatchNorm3d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    return {"scale": scale, "bias": bias}, {"mean": mean, "var": var}, bn


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm3d_matches_jax(train):
    rng = np.random.default_rng(4)
    C = 3
    x = (rng.normal(size=(2, C, 4, 5, 3)) * 3 + 1).astype(np.float32)
    p, s, bn = _norms(C, rng)
    want, want_state = jconv.batch_norm3d(p, s, jnp.asarray(x), train)
    got = tconv.batch_norm3d(bn, torch.from_numpy(x), train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want_state["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want_state["var"]), **TOL)
    assert int(bn.num_batches_tracked) == int(train)
    if not train:       # eval reads the running statistics and leaves them as they were
        np.testing.assert_array_equal(bn.running_mean.numpy(), s["mean"])


def test_batch_norm3d_running_variance_is_unbiased():
    """n/(n−1) into the running variance, the biased variance to normalise."""
    x = torch.arange(2 * 1 * 2 * 2 * 2, dtype=torch.float32).reshape(2, 1, 2, 2, 2)
    bn = torch.nn.BatchNorm3d(1)
    tconv.batch_norm3d(bn, x, True)
    n = x.numel()
    assert bn.running_var.item() == pytest.approx(0.9 + 0.1 * x.var(unbiased=True).item(),
                                                  rel=1e-6)
    assert bn.running_mean.item() == pytest.approx(0.1 * x.mean().item(), rel=1e-6)
    assert x.var(unbiased=True).item() == pytest.approx(x.var(unbiased=False).item()
                                                        * n / (n - 1))


@pytest.mark.parametrize("shape,kernel,stride,padding", [
    ((2, 3, 8, 9, 10), 3, 1, 1), ((2, 3, 9, 8, 7), 3, 2, 1), ((1, 4, 7, 6, 5), 1, 1, 0),
    ((2, 2, 10, 7, 9), 3, (1, 2, 3), (0, 1, 2)), ((1, 2, 9, 9, 9), 2, 2, 0)])
def test_conv3d_backward_products_match_jax(shape, kernel, stride, padding):
    """The backward's two products (the input gradient as a transposed conv
    with the far-edge rows the forward dropped; the weight gradient as a conv
    of the input with the output gradient, stride as dilation, cropped)
    against JAX's autodiff, over strides that leave a remainder and 1³ and
    2³ kernels."""
    _backward_products_match_jax(shape, kernel, stride, padding)


@pytest.mark.parametrize("window_bytes", [1 << 12, 1 << 20], ids=["a_sample", "all"])
@pytest.mark.parametrize("shape,kernel,stride,padding", [
    ((3, 2, 9, 10, 7), 3, (2, 1, 1), 1), ((3, 4, 8, 8, 6), 1, 1, 0)], ids=["3x3x3", "1x1x1"])
def test_conv3d_weight_gradient_chunks_and_groups(monkeypatch, window_bytes, shape, kernel,
                                                  stride, padding):
    """The weight gradient's reduction in chunks of 64 positions (the last
    one zero-padded where they do not divide) and its windows copied a
    sample at a time or all at once give the same gradients; a 1³ kernel's
    windows are the input itself, a view rather than a copy."""
    monkeypatch.setattr(tconv, "_CHUNK", 64)
    monkeypatch.setattr(tconv, "_WINDOW_BYTES", window_bytes)
    _backward_products_match_jax(shape, kernel, stride, padding)


def _backward_products_match_jax(shape, kernel, stride, padding):
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(5, shape[1], *(kernel,) * 3)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)

    def conv(x, w, b):
        return jconv.conv3d({"kernel": w, "bias": b}, x, stride=stride, padding=padding)

    g = rng.normal(size=jax.eval_shape(conv, x, w, b).shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(conv(*a) * g), argnums=(0, 1, 2))(x, w, b)
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    tconv.conv3d(xs[0], xs[1], xs[2], stride, padding).backward(torch.from_numpy(g))
    for t, j in zip(xs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5, atol=1e-4)
