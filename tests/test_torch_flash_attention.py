"""The port's fused-QKV attention (kernel K1's plain version, which the
wrapper runs for CPU tensors) against the JAX package's
``flash_attention_qkv_tn``, which runs here in Pallas interpret mode.

Tolerances: f32 atol 5e-5, rtol 1e-4 (those of
tests/test_flash_attention.py::test_flash_qkv_tn_matches_reference — both
sides compute in f32; the gap is summation order).  bf16: max error
normalised by max |reference| ≤ 2e-2, the on-chip bf16 tolerance of
tests_tpu/test_kernels_onchip.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.kernels import flash_attention as jfa
from cross_attention_vit_tpu_torch.kernels import flash_attention as tfa


def _qkv(B, K, D, N, seed):
    """The same numbers in both layouts: JAX (3, B, K, D, N), port (B, N, 3, K, D)."""
    qkv = np.random.default_rng(seed).normal(size=(3, B, K, D, N)).astype(np.float32)
    return qkv, np.ascontiguousarray(qkv.transpose(1, 4, 0, 2, 3))


@pytest.mark.parametrize("B,K,D,N", [(1, 2, 64, 9), (2, 4, 64, 65), (1, 2, 64, 513)])
def test_plain_k1_matches_jax_f32(B, K, D, N):
    jq, tq = _qkv(B, K, D, N, seed=N)
    want = np.asarray(jfa.flash_attention_qkv_tn(jnp.asarray(jq), D ** -0.5))  # (B,K,D,N)
    got = tfa.flash_attention_qkv(torch.from_numpy(tq), D ** -0.5).numpy()       # (B,N,K,D)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=5e-5, rtol=1e-4)


def test_plain_k1_matches_jax_bf16():
    B, K, D, N = 2, 2, 64, 65
    jq, tq = _qkv(B, K, D, N, seed=7)
    want = np.asarray(jfa.flash_attention_qkv_tn(jnp.asarray(jq, jnp.bfloat16), D ** -0.5)
                      .astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = tfa.flash_attention_qkv(torch.from_numpy(tq).to(torch.bfloat16), D ** -0.5)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2, err


def test_plain_k1_is_the_reference_function():
    _, tq = _qkv(1, 2, 64, 33, seed=3)
    x = torch.from_numpy(tq)
    torch.testing.assert_close(tfa.flash_attention_qkv(x),
                               tfa.flash_attention_qkv_reference(x, 64 ** -0.5),
                               rtol=0, atol=0)


def test_fused_qkv_attention_matches_jax():
    B, N, H, K = 2, 17, 64, 4
    r = np.random.default_rng(11)
    x = r.normal(size=(B, N, H)).astype(np.float32)
    w = (r.normal(size=(H, 3, K, H // K)) * H ** -0.5).astype(np.float32)
    want = np.asarray(jfa.fused_qkv_attention(jnp.asarray(x), jnp.asarray(w)))
    got = tfa.fused_qkv_attention(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (B, K, H // K, N)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


def test_cpu_calls_do_not_count_as_launches():
    before = tfa.flash_attention_qkv.launches
    _, tq = _qkv(1, 2, 64, 9, seed=1)
    tfa.flash_attention_qkv(torch.from_numpy(tq))
    tfa.fused_qkv_attention(torch.zeros(1, 5, 64), torch.zeros(64, 3, 1, 64))
    assert tfa.flash_attention_qkv.launches == before == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_unsupported_dtype_raises(dtype):
    with pytest.raises(TypeError):
        tfa.flash_attention_qkv(torch.zeros(1, 4, 3, 2, 64, dtype=dtype))


@pytest.mark.parametrize("shape", [(1, 4, 2, 2, 64), (4, 3, 2, 64), (1, 0, 3, 2, 64)])
def test_bad_shape_raises(shape):
    with pytest.raises(ValueError):
        tfa.flash_attention_qkv(torch.zeros(shape))


def test_other_devices_raise_instead_of_falling_back():
    with pytest.raises(ValueError):
        tfa.flash_attention_qkv(torch.zeros(1, 4, 3, 2, 64, device="meta"))
