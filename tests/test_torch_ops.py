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
