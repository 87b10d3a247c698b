"""The port's public "tn" attention (K6) — the plain versions of the forward
and of the backward with o recomputed, which the wrappers run for CPU
tensors — against the JAX package's ``flash_attention_tn`` at N ≤ 1040
(Pallas ``_attn_kernel_tn`` and ``_attn_bwd_kernel_tn``, run here in
interpret mode), for (B, K, D, N) operands laid out contiguous and as
D-minor views, and the public op's switch to K7 above N = 1040.

Tolerances: f32 max error normalised by max |JAX| ≤ 1e-5 (both sides compute
in f32; the gap is summation order and exp's last bits); bf16 ≤ 2e-2 (the
on-chip bf16 tolerance of tests_tpu/test_kernels_onchip.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.kernels import flash_attention as jfa
from cross_attention_vit_tpu_torch.kernels import flash_attention as tfa

D = 64
SCALE = D ** -0.5
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _operands(B, K, N, seed):
    """q, k, v, g (B, K, D, N) from one numpy seed, as numpy f32."""
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, K, D, N)).astype(np.float32) for _ in range(4)]


def _norm_err(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax(q, k, v, g, dtype):
    """JAX flash_attention_tn's output and its vjp on g, as f32 numpy."""
    args = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_tn(a, b, c, SCALE), *args)
    grads = vjp(jnp.asarray(g, JDT[dtype]))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch(x, dtype, layout):
    """(B, K, D, N) numpy → a torch tensor of that shape: contiguous, or a
    D-minor view of a contiguous (B, K, N, D) tensor."""
    t = torch.from_numpy(x).to(dtype)
    return t if layout == "contiguous" else t.transpose(-1, -2).contiguous().transpose(-1, -2)


@pytest.mark.parametrize("layout", ["contiguous", "dminor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [17, 100])
def test_plain_k6_matches_jax(N, dtype, layout):
    q, k, v, g = _operands(2, 2, N, seed=N)
    want = _jax(q, k, v, g, dtype)
    t = [_torch(x, dtype, layout) for x in (q, k, v, g)]
    out = tfa.flash_attention_tn_fwd(*t[:3], SCALE)
    grads = tfa.flash_attention_tn_bwd(*t, SCALE)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), want):
        assert got.dtype == dtype and got.shape == (2, 2, D, N)
        assert _norm_err(got, ref) <= TOL[dtype], (name, _norm_err(got, ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_public_tn_op_autograd_matches_jax(dtype):
    """The differentiable op at N ≤ 1040: K6's forward and backward through
    autograd, value and gradients."""
    q, k, v, g = _operands(1, 2, 33, seed=3)
    want = _jax(q, k, v, g, dtype)
    xs = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention_tn(*xs, SCALE)
    out.backward(torch.from_numpy(g).to(dtype))
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *(x.grad for x in xs)), want):
        assert _norm_err(got.detach(), ref) <= TOL[dtype], name


def test_k6_differs_from_k2_rounding_only_in_delta():
    """K6 takes delta from o recomputed in f32; K2 from the saved, rounded
    output.  With that output in f32 (no rounding) the two agree exactly."""
    q, k, v, g = (torch.from_numpy(x) for x in _operands(1, 2, 40, seed=4))
    tn = tfa.flash_attention_tn_bwd(q, k, v, g, SCALE)
    qkv = torch.stack([x.transpose(-1, -2) for x in (q, k, v)], dim=2).permute(0, 3, 2, 1, 4)
    out = tfa.flash_attention_qkv_reference(qkv, SCALE)
    k2 = tfa.flash_attention_qkv_bwd_reference(qkv, out, g.permute(0, 3, 1, 2), SCALE)
    for j, got in enumerate(tn):
        want = k2[:, :, j].permute(0, 2, 3, 1)
        assert _norm_err(got, want.numpy()) <= 1e-6


@pytest.mark.parametrize("N,expected", [(1040, "K6"), (1041, "K7")])
def test_public_tn_op_switches_at_1040(N, expected, monkeypatch):
    """Up to N = 1040 the op runs K6 (forward and backward); above it K7 on
    (B, K, N, D) copies — the JAX switch (:1038, :1052)."""
    calls = []
    for name in ("flash_attention_tn_fwd", "flash_attention_tn_bwd",
                 "flash_attention_stream_fwd", "flash_attention_stream_bwd"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    r = np.random.default_rng(5)
    xs = [torch.from_numpy(r.normal(size=(1, 1, 8, N)).astype(np.float32)).requires_grad_()
          for _ in range(3)]
    out = tfa.flash_attention_tn(*xs)
    out.sum().backward()
    assert out.shape == (1, 1, 8, N)
    if expected == "K6":
        assert calls == ["flash_attention_tn_fwd", "flash_attention_tn_bwd"]
    else:
        assert calls == ["flash_attention_stream_fwd", "flash_attention_stream_bwd"]
        want = tfa.flash_attention_tn_reference(*(x.detach() for x in xs), 8 ** -0.5)
        assert _norm_err(out.detach(), want.numpy()) <= 1e-5


def test_tn_wrappers_reject_bad_operands():
    q = torch.zeros(1, 1, 64, 8)
    with pytest.raises(ValueError, match="must be"):
        tfa.flash_attention_tn_fwd(q, q, torch.zeros(1, 1, 64, 9))
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention_tn_fwd(*(torch.zeros(1, 1, 64, 8, dtype=torch.float16),) * 3)
    with pytest.raises(ValueError, match="must be"):
        tfa.flash_attention_tn_bwd(q, q, q, torch.zeros(1, 1, 8, 64))
