"""The port's ``fused_qkv_attention`` and its backward rule against the JAX
package's, with ``FUSED_QKV_GRADS`` off (K2, then dx = dqkv·Wᵀ and
dW = xᵀ·dqkv as plain GEMMs) and on (the fused backward K8, whose plain
version the wrapper runs for CPU tensors): the JAX op runs its Pallas
kernels in interpret mode, its flag flipped at run time as
tests/test_flash_attention.py:288-361 does.  Also the dispatch: the flag on,
bf16 and N ≤ 1040 call ``fused_qkv_bwd``; f32, N > 1040 or the flag off do
not.

Tolerances: dx and dW max error normalised by max |JAX|, f32 ≤ 1e-5 (f32
throughout; summation order), bf16 ≤ 2e-2 (both sides round dqkv to bf16 and
accumulate in f32; torch's bf16 GEMM on the CPU rounds its f32 sum once)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.kernels import flash_attention as jfa
from cross_attention_vit_tpu_torch.kernels import flash_attention as tfa

B, H, K, D = 2, 64, 4, 16
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(N, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, N, H)).astype(np.float32),
            (r.normal(size=(H, 3, K, D)) * 0.1).astype(np.float32),
            r.normal(size=(B, K, D, N)).astype(np.float32))


def _norm_err(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def flags():
    """Set FUSED_QKV_GRADS in both packages; restore both afterwards."""
    saved = jfa.FUSED_QKV_GRADS, tfa.FUSED_QKV_GRADS

    def set_(on: bool):
        jfa.FUSED_QKV_GRADS = tfa.FUSED_QKV_GRADS = on

    yield set_
    jfa.FUSED_QKV_GRADS, tfa.FUSED_QKV_GRADS = saved


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_qkv_attention_matches_jax(dtype, fused, flags):
    flags(fused)
    x, w, g = _inputs(N=37, seed=1)
    jout, vjp = jax.vjp(jfa.fused_qkv_attention, jnp.asarray(x, JDT[dtype]),
                        jnp.asarray(w, JDT[dtype]))
    jdx, jdw = vjp(jnp.asarray(g, JDT[dtype]))
    tx, tw = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (x, w))
    out = tfa.fused_qkv_attention(tx, tw)
    out.backward(torch.from_numpy(g).to(dtype))
    assert out.shape == (B, K, D, 37) and tx.grad.dtype == dtype and tw.grad.dtype == dtype
    for name, got, want in (("out", out, jout), ("dx", tx.grad, jdx), ("dW", tw.grad, jdw)):
        assert _norm_err(got, want) <= TOL[dtype], (name, _norm_err(got, want))


def test_fused_backward_plain_version_matches_jax_megakernel():
    """``fused_qkv_bwd`` (CPU: its plain version) against the JAX
    megakernel ``_fused_qkv_bwd`` on the same saved residuals."""
    x, w, g = _inputs(N=40, seed=2)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    qkv = jfa._qkv_project_tn(xb, wb)                       # (3, B, K, D, N)
    out = jfa.flash_attention_qkv_tn(qkv, D ** -0.5)        # (B, K, D, N)
    jdx, jdw = jfa._fused_qkv_bwd(xb, wb, qkv, out, jnp.asarray(g, jnp.bfloat16), D ** -0.5)

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()

    tqkv = t(qkv).permute(1, 4, 0, 2, 3)                    # (B, N, 3, K, D)
    tout, tg = (t(a).permute(0, 3, 1, 2) for a in (out, jnp.asarray(g, jnp.bfloat16)))
    dx, dw = tfa.fused_qkv_bwd(t(xb), t(wb), tqkv, tout, tg)
    assert dx.shape == (B, 40, H) and dw.shape == (H, 3, K, D)
    assert _norm_err(dx, jdx) <= TOL[torch.bfloat16]
    assert _norm_err(dw, jdw) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("on,dtype,N,expected", [
    (True, torch.bfloat16, 33, True),      # the gate: bf16, N ≤ 1040, D % 8 == 0
    (True, torch.float32, 33, False),      # f32 takes the unfused rule
    (True, torch.bfloat16, 1041, False),   # so does N > 1040 (K7)
    (False, torch.bfloat16, 33, False),    # the default
])
def test_fused_backward_dispatch(on, dtype, N, expected, flags, monkeypatch):
    flags(on)
    called = []
    real = tfa.fused_qkv_bwd
    monkeypatch.setattr(tfa, "fused_qkv_bwd", lambda *a, **kw: called.append(1) or real(*a, **kw))
    x = torch.zeros((1, N, 8), dtype=dtype, requires_grad=True)
    w = torch.zeros((8, 3, 1, 8), dtype=dtype, requires_grad=True)
    tfa.fused_qkv_attention(x, w).float().pow(2).sum().backward()
    assert bool(called) == expected
    assert x.grad.shape == x.shape and w.grad.shape == w.shape


def test_unfused_rule_accumulates_dw_in_f32_for_an_f32_weight():
    """bf16 x with an f32 w: dW = xᵀ·dqkv accumulated in f32 and returned in
    w's dtype, as JAX's ``preferred_element_type=f32 .astype(w.dtype)``."""
    x, w, g = _inputs(N=21, seed=3)
    jout, vjp = jax.vjp(jfa.fused_qkv_attention, jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tfa.fused_qkv_attention(tx, tw).backward(torch.from_numpy(g).bfloat16())
    assert tw.grad.dtype == torch.float32 and jdw.dtype == jnp.float32
    assert _norm_err(tw.grad, jdw) <= 1e-5
    assert _norm_err(tx.grad, jdx) <= TOL[torch.bfloat16]
