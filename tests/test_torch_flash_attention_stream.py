"""The port's streaming attention (K7) — the plain versions of the forward
with its logsumexp and of the blocked backward, which the wrappers run for
CPU tensors — against the JAX package's ``flash_attention`` (streaming
Pallas kernels ``_attn_kernel_stream``, ``_bwd_dkv_kernel``,
``_bwd_dq_kernel``, run here in interpret mode), and the switch of the
fused-QKV entry point from K1/K2 to K7 above N = 1040.

Tolerances: f32 forward atol 5e-5, rtol 1e-4 (those of the K1 tests: both
sides compute in f32, the gap is summation order); the f32 lse within 1e-5;
the f32 backward atol and rtol 1e-4 (its sums run over N = 1041 rows).  bf16:
max error normalised by max |reference| ≤ 8e-3 for the forward (two bf16
roundings: of p before the AV product and of the output) and ≤ 2e-2 for
each of dq, dk, dv (the on-chip bf16 tolerance of
tests_tpu/test_kernels_onchip.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.kernels import flash_attention as jfa
from cross_attention_vit_tpu_torch.kernels import flash_attention as tfa

D = 64
SCALE = D ** -0.5


def _operands(B, K, N, seed, n=3):
    """n arrays (B, K, N, D) from one numpy seed, as numpy f32."""
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, K, N, D)).astype(np.float32) for _ in range(n)]


def _norm_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("N", [1041, 1600])
def test_plain_k7_forward_matches_jax_f32(N):
    q, k, v = _operands(1, 2, N, seed=N)
    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)), SCALE))
    out, lse = tfa.flash_attention_stream_fwd(*map(torch.from_numpy, (q, k, v)), SCALE)
    assert out.shape == (1, 2, N, D) and lse.shape == (1, 2, N) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("N", [1041, 1600])
def test_plain_k7_forward_matches_jax_bf16(N):
    q, k, v = _operands(1, 2, N, seed=N + 1)
    want = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), SCALE)
    out, _ = tfa.flash_attention_stream_fwd(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), SCALE)
    assert out.dtype == torch.bfloat16
    err = _norm_err(out.float().numpy(), want.astype(jnp.float32))
    assert err <= 8e-3, err


@pytest.mark.parametrize("N", [1041, 1600])
def test_plain_k7_lse_matches_jax(N):
    q, k, v = _operands(1, 2, N, seed=N + 2)
    _, want = jfa._flash_forward(*map(jnp.asarray, (q, k, v)), SCALE, with_lse=True)
    _, lse = tfa.flash_attention_stream_fwd(*map(torch.from_numpy, (q, k, v)), SCALE)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _jax_grads(q, k, v, g, dtype):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, SCALE), *args)
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g, dtype))]


def _port_grads(q, k, v, g, dtype):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, g)]
    out, lse = tfa.flash_attention_stream_fwd(*t[:3], SCALE)
    return tfa.flash_attention_stream_bwd(*t[:3], out, lse, t[3], SCALE)


def test_plain_k7_backward_matches_jax_f32():
    q, k, v, g = _operands(1, 2, 1041, seed=5, n=4)
    want = _jax_grads(q, k, v, g, jnp.float32)
    got = _port_grads(q, k, v, g, torch.float32)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4, err_msg=name)


def test_plain_k7_backward_matches_jax_bf16():
    q, k, v, g = _operands(1, 2, 1041, seed=6, n=4)
    want = _jax_grads(q, k, v, g, jnp.bfloat16)
    got = _port_grads(q, k, v, g, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        err = _norm_err(a.float().numpy(), b)
        assert err <= 2e-2, (name, err)


def test_k7_backward_is_not_k2s_rounding():
    """K7 rounds the normalised p, K2 rounds e and dO·r: on the same bf16
    inputs the two plain backwards differ, which is why K7 has its own."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16) for x in _operands(1, 2, 1041, 7, 4))
    out, lse = tfa.flash_attention_stream_fwd(q, k, v, SCALE)
    k7 = tfa.flash_attention_blocked_bwd_reference(q, k, v, out, lse, g, SCALE)
    qkv = torch.stack([q, k, v], dim=2).permute(0, 3, 2, 1, 4)       # (B, N, 3, K, D)
    k2 = tfa.flash_attention_qkv_bwd_reference(qkv, out.transpose(1, 2), g.transpose(1, 2), SCALE)
    assert not torch.equal(k7[2], k2[:, :, 2].transpose(1, 2))


def test_public_op_runs_k7_on_cpu_at_any_n_and_differentiates():
    """Above N = 1040 the public op is K7 on a CPU tensor too (below it K5:
    tests/test_torch_flash_attention_single.py)."""
    q, k, v, g = (torch.from_numpy(x).requires_grad_(i < 3)
                  for i, x in enumerate(_operands(1, 2, 1041, seed=8, n=4)))
    out = tfa.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionStreamBackward"
    want = torch.softmax(q @ k.transpose(-1, -2) * SCALE, -1) @ v
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    (out * g).sum().backward()
    a, b, c = (x.detach().clone().requires_grad_() for x in (q, k, v))
    (torch.softmax(a @ b.transpose(-1, -2) * SCALE, -1) @ c * g).sum().backward()
    for got, ref in ((q, a), (k, b), (v, c)):
        torch.testing.assert_close(got.grad, ref.grad, atol=1e-5, rtol=1e-5)


def test_backward_writes_into_the_given_gradients():
    q, k, v, g = (torch.from_numpy(x) for x in _operands(1, 2, 40, seed=9, n=4))
    out, lse = tfa.flash_attention_stream_fwd(q, k, v)
    dqkv = torch.zeros(1, 40, 3, 2, D)
    views = tfa._stream_views(dqkv)
    got = tfa.flash_attention_stream_bwd(q, k, v, out, lse, g, grads=views)
    want = tfa.flash_attention_blocked_bwd_reference(q, k, v, out, lse, g, SCALE)
    for i in range(3):
        assert got[i] is views[i]
        torch.testing.assert_close(dqkv[:, :, i].transpose(1, 2), want[i], rtol=0, atol=0)


# --- the stacked-qkv entry point switches at N = 1040 ---------------------------

def _fused_inputs(N, seed, H=128, K=2):
    r = np.random.default_rng(seed)
    x = r.normal(size=(1, N, H)).astype(np.float32)
    w = (r.normal(size=(H, 3, K, H // K)) * H ** -0.5).astype(np.float32)
    g = r.normal(size=(1, K, H // K, N)).astype(np.float32)
    return x, w, g


def test_fused_qkv_attention_at_1041_matches_jax():
    """Forward, dx and dW of the projection + attention above the switch:
    JAX's streaming forward and blocked backward (then its einsums) against
    the port's K7 plain versions (then the projection's autograd), f32."""
    x, w, g = _fused_inputs(1041, seed=10)
    out, vjp = jax.vjp(jfa.fused_qkv_attention, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    got = tfa.fused_qkv_attention(tx, tw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=5e-5, rtol=1e-4)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("N,path", [(1040, "K1/K2"), (1041, "K7")])
def test_qkv_path_switches_above_1040(N, path, monkeypatch):
    """Which plain versions ran, forward and backward, at the last N of the
    single-block path and the first of the streaming one."""
    ran = []
    for name in ("flash_attention_qkv_reference", "flash_attention_qkv_bwd_reference",
                 "flash_attention_stream_reference", "flash_attention_blocked_bwd_reference"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _n=name: ran.append(_n) or _fn(*a))
    qkv = torch.randn(1, N, 3, 1, D, generator=torch.Generator().manual_seed(N),
                      requires_grad=True)
    out = tfa.flash_attention_qkv(qkv)
    out.sum().backward()
    assert qkv.grad.shape == qkv.shape
    if path == "K7":
        assert ran == ["flash_attention_stream_reference",
                       "flash_attention_blocked_bwd_reference"]
        assert type(out.grad_fn).__name__ == "_FlashAttentionStreamQKVBackward"
    else:
        assert ran == ["flash_attention_qkv_reference", "flash_attention_qkv_bwd_reference"]
        assert type(out.grad_fn).__name__ == "_FlashAttentionQKVBackward"


def test_cpu_calls_do_not_count_as_launches():
    q, k, v, g = (torch.from_numpy(x) for x in _operands(1, 1, 17, seed=11, n=4))
    out, lse = tfa.flash_attention_stream_fwd(q, k, v)
    tfa.flash_attention_stream_bwd(q, k, v, out, lse, g)
    qkv = torch.zeros(1, 1041, 3, 1, D, requires_grad=True)
    tfa.flash_attention_qkv(qkv).sum().backward()
    assert tfa.flash_attention_stream_fwd.launches == 0
    assert tfa.flash_attention_stream_bwd.dq_launches == 0 == \
        tfa.flash_attention_stream_bwd.dkdv_launches


@pytest.mark.parametrize("which", ["q_rank", "k_shape", "v_dtype", "lse_dtype", "dout_device",
                                   "grads_shape"])
def test_k7_bad_inputs_raise(which):
    q, k, v = torch.zeros(1, 2, 5, D), torch.zeros(1, 2, 5, D), torch.zeros(1, 2, 5, D)
    out, lse, dout = torch.zeros(1, 2, 5, D), torch.zeros(1, 2, 5), torch.zeros(1, 2, 5, D)
    grads = None
    if which == "q_rank":
        q = torch.zeros(2, 5, D)
    elif which == "k_shape":
        k = torch.zeros(1, 2, 6, D)
    elif which == "v_dtype":
        v = v.to(torch.bfloat16)
    elif which == "lse_dtype":
        lse = lse.to(torch.bfloat16)
    elif which == "dout_device":
        dout = torch.zeros(1, 2, 5, D, device="meta")
    else:
        grads = (torch.zeros(1, 2, 5, D),) * 2 + (torch.zeros(1, 2, 4, D),)
    with pytest.raises(ValueError):
        tfa.flash_attention_stream_bwd(q, k, v, out, lse, dout, grads=grads)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_k7_unsupported_dtype_raises(dtype):
    x = torch.zeros(1, 1, 4, D, dtype=dtype)
    with pytest.raises(TypeError):
        tfa.flash_attention_stream_fwd(x, x, x)


def test_k7_other_devices_raise_instead_of_falling_back():
    x = torch.zeros(1, 1, 1100, D, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention_stream_fwd(x, x, x)
