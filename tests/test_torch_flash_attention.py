"""The port's fused-QKV attention — K1 (forward) and K2 (backward): their
plain versions, which the wrappers run for CPU tensors, and the autograd
Function built from them — against the JAX package's
``flash_attention_qkv_tn`` and ``fused_qkv_attention``, which run here in
Pallas interpret mode.

Tolerances: f32 atol 5e-5, rtol 1e-4 (those of
tests/test_flash_attention.py::test_flash_qkv_tn_matches_reference — both
sides compute in f32; the gap is summation order).  bf16: max error
normalised by max |reference| ≤ 2e-2, the on-chip bf16 tolerance of
tests_tpu/test_kernels_onchip.py."""

import numpy as np
import pytest

import jax
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


# --- K2: the backward ---------------------------------------------------------
#
# The port's K2 plain version (``flash_attention_qkv_bwd``, which the wrapper
# runs for CPU tensors) against ``jax.vjp`` of ``flash_attention_qkv_tn``,
# whose backward is the Pallas kernel ``_attn_bwd_kernel_qkv_tn`` run here in
# interpret mode.  Tolerances: f32 atol 5e-5, rtol 1e-4 (as the forward);
# bf16: max error normalised by max |reference| ≤ 2e-2 for each of dq, dk
# and dv.


def _jax_bwd(jq, g, D):
    out, vjp = jax.vjp(lambda x: jfa.flash_attention_qkv_tn(x, D ** -0.5), jq)
    (dqkv,) = vjp(g)
    return out, dqkv


def _port_layout(a):
    """(B, K, D, N) → (B, N, K, D) and (3, B, K, D, N) → (B, N, 3, K, D)."""
    a = np.asarray(a.astype(jnp.float32))
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2) if a.ndim == 4
                                else a.transpose(1, 4, 0, 2, 3))


@pytest.mark.parametrize("B,K,D,N", [(1, 2, 64, 9), (2, 2, 64, 65), (1, 2, 64, 513)])
def test_plain_k2_matches_jax_f32(B, K, D, N):
    jq, tq = _qkv(B, K, D, N, seed=N + 1)
    g = np.random.default_rng(N).normal(size=(B, K, D, N)).astype(np.float32)
    out, dqkv = _jax_bwd(jnp.asarray(jq), jnp.asarray(g), D)
    got = tfa.flash_attention_qkv_bwd(torch.from_numpy(tq), torch.from_numpy(_port_layout(out)),
                                      torch.from_numpy(_port_layout(jnp.asarray(g))))
    assert got.shape == (B, N, 3, K, D)
    np.testing.assert_allclose(got.numpy(), _port_layout(dqkv), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("N", [9, 65, 513])
def test_plain_k2_matches_jax_bf16(N):
    B, K, D = 1, 2, 64
    jq, tq = _qkv(B, K, D, N, seed=N + 2)
    g = np.random.default_rng(N + 3).normal(size=(B, K, D, N)).astype(np.float32)
    out, dqkv = _jax_bwd(jnp.asarray(jq, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), D)
    bf = torch.bfloat16
    got = tfa.flash_attention_qkv_bwd(
        torch.from_numpy(tq).to(bf), torch.from_numpy(_port_layout(out)).to(bf),
        torch.from_numpy(_port_layout(jnp.asarray(g))).to(bf))
    assert got.dtype == bf
    want = _port_layout(dqkv)
    for s in range(3):
        w = want[:, :, s]
        err = np.abs(got[:, :, s].float().numpy() - w).max() / np.abs(w).max()
        assert err <= 2e-2, (s, err)


def test_autograd_function_matches_autograd_through_the_plain_forward():
    """The Function's backward (K2) against autograd through K1's plain
    version, at f32 (where K1's rounding steps are the identity)."""
    _, tq = _qkv(2, 2, 64, 33, seed=12)
    g = torch.from_numpy(np.random.default_rng(13).normal(size=(2, 33, 2, 64)).astype(np.float32))
    a = torch.from_numpy(tq).requires_grad_()
    b = torch.from_numpy(tq).requires_grad_()
    (tfa.flash_attention_qkv(a) * g).sum().backward()
    (tfa.flash_attention_qkv_reference(b, 64 ** -0.5) * g).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)


def test_fused_qkv_attention_gradients_match_jax():
    """dx and dW of the projection + attention: JAX's unfused custom_vjp rule
    (K2 then the two einsums) against the port's autograd (K2 then the
    projection's matmul backward), f32, atol 5e-5, rtol 1e-4."""
    B, N, H, K = 2, 17, 64, 4
    r = np.random.default_rng(14)
    x = r.normal(size=(B, N, H)).astype(np.float32)
    w = (r.normal(size=(H, 3, K, H // K)) * H ** -0.5).astype(np.float32)
    g = r.normal(size=(B, K, H // K, N)).astype(np.float32)
    _, vjp = jax.vjp(jfa.fused_qkv_attention, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (tfa.fused_qkv_attention(tx, tw) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), atol=5e-5, rtol=1e-4)


def test_cpu_backward_does_not_count_as_a_launch():
    _, tq = _qkv(1, 2, 64, 9, seed=15)
    x = torch.from_numpy(tq).requires_grad_()
    tfa.flash_attention_qkv(x).sum().backward()
    assert tfa.flash_attention_qkv_bwd.launches == 0 == tfa.flash_attention_qkv.launches


@pytest.mark.parametrize("which", ["out_shape", "dout_dtype", "dout_device"])
def test_k2_bad_inputs_raise(which):
    qkv = torch.zeros(1, 4, 3, 2, 64)
    out, dout = torch.zeros(1, 4, 2, 64), torch.zeros(1, 4, 2, 64)
    if which == "out_shape":
        out = torch.zeros(1, 5, 2, 64)
    elif which == "dout_dtype":
        dout = dout.to(torch.bfloat16)
    else:
        dout = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention_qkv_bwd(qkv, out, dout)
