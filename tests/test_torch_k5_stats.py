"""The row-statistics contract of the port's single-block attention (K5, the
public ``flash_attention`` at N ≤ 1040): its forward returns each row's max m
and r = 1/Σ exp(s − m) of the f32 scores s = q·kᵀ·scale as a (2, B, K, N) f32
tensor in K1's units, and its recompute-form backward reads them instead of
finding them again.  The plain versions define the units; the CUDA kernels
write and read the same ones (chip_smoke.py holds them against these on the
card).

The inputs are made with numpy and go through the JAX package's
single-block Pallas backward ``_flash_backward_pallas`` as well (interpret
mode).  Tolerances: the statistics
atol 1e-6 times the largest |m| for m (the max of the same f32 scores, up to
summation order in q·kᵀ) and rtol 1e-5 for r (a sum of at most 513 f32
terms); the plain backward on the forward's statistics against the one that
finds them, f32 atol 1e-6 times the largest |gradient| (both recompute the
same f32 scores); gradients against JAX's as
tests/test_torch_flash_attention_single.py: f32 max error normalised by max
|JAX| ≤ 1e-5, bf16 ≤ 2e-2."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.kernels import flash_attention as jfa
from cross_attention_vit_tpu_torch.kernels import flash_attention as tfa

D = 64
SCALE = D ** -0.5
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _operands(B, K, N, seed):
    """q, k, v, dO (B, K, N, D) from one numpy seed, as numpy f32."""
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, K, N, D)).astype(np.float32) for _ in range(4)]


def _norm_err(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("B,K,N", [(1, 1, 7), (2, 2, 100), (1, 2, 513)])
def test_plain_k5_stats_are_the_row_max_and_reciprocal_sum(B, K, N):
    q, k, v, _ = _operands(B, K, N, seed=N + K)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out, stats = tfa.flash_attention_single_fwd(*t, SCALE, stats=True)
    assert stats.shape == (2, B, K, N) and stats.dtype == torch.float32
    # _row_stats' units of the same f32 scores, bit for bit
    m, _, r = tfa._row_stats(torch.matmul(t[0], t[1].transpose(-1, -2)) * SCALE)
    assert torch.equal(stats[0], m[..., 0]) and torch.equal(stats[1], r[..., 0])
    s = np.einsum("bkid,bkjd->bkij", q.astype(np.float64), k.astype(np.float64)) * SCALE
    m64 = s.max(axis=-1)
    r64 = 1.0 / np.exp(s - m64[..., None]).sum(axis=-1)
    np.testing.assert_allclose(stats[0].numpy(), m64, atol=1e-6 * np.abs(m64).max(), rtol=0)
    np.testing.assert_allclose(stats[1].numpy(), r64, rtol=1e-5, atol=0)
    # the statistics change nothing in the output
    assert torch.equal(out, tfa.flash_attention_single_fwd(*t, SCALE))


def _jax_grads(q, k, v, g, dtype):
    """JAX's single-block Pallas backward (interpret mode) as f32 numpy."""
    args = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v, g)]
    return [np.asarray(x.astype(jnp.float32)) for x in jfa._flash_backward_pallas(*args, SCALE)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [7, 100, 513])
def test_plain_k5_bwd_on_forward_stats_equals_finding_them_and_jax(N, dtype):
    q, k, v, g = _operands(1, 2, N, seed=3 * N)
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, g)]
    _, stats = tfa.flash_attention_single_fwd(*t[:3], SCALE, stats=True)
    got = tfa.flash_attention_single_bwd(*t, SCALE, stats)
    found = tfa.flash_attention_single_bwd(*t, SCALE)
    for a, b in zip(got, found):
        assert a.dtype == dtype and a.shape == (1, 2, N, D)
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * b.abs().max().item())
    for name, a, ref in zip(("dq", "dk", "dv"), got, _jax_grads(q, k, v, g, dtype)):
        assert _norm_err(a, ref) <= TOL[dtype], (name, _norm_err(a, ref))


def test_plain_k5_bwd_reads_the_stats_it_is_given():
    """Statistics that differ from the scores' own change the gradient: the
    backward reads them and does not find them again."""
    q, k, v, g = (torch.from_numpy(x) for x in _operands(1, 2, 17, seed=5))
    _, stats = tfa.flash_attention_single_fwd(q, k, v, SCALE, stats=True)
    shifted = stats.clone()
    shifted[1] *= 2.0
    a = tfa.flash_attention_single_bwd(q, k, v, g, SCALE, stats)
    b = tfa.flash_attention_single_bwd(q, k, v, g, SCALE, shifted)
    assert not torch.equal(a[0], b[0]) and not torch.equal(a[2], b[2])


def _recording(monkeypatch):
    """Records the with_stats argument of each call of K5's plain forward."""
    calls, fn = [], tfa.flash_attention_single_reference

    def wrapped(*args):
        calls.append(len(args) > 4 and bool(args[4]))
        return fn(*args)
    monkeypatch.setattr(tfa, "flash_attention_single_reference", wrapped)
    return calls


def test_public_op_writes_stats_only_when_a_backward_follows(monkeypatch):
    calls = _recording(monkeypatch)
    q, k, v = (torch.from_numpy(x) for x in _operands(1, 2, 100, seed=8)[:3])
    with torch.no_grad():
        tfa.flash_attention(q.clone().requires_grad_(), k, v)
    tfa.flash_attention(q, k, v)
    assert calls == [False, False]
    out = tfa.flash_attention(q, k.clone().requires_grad_(), v)
    assert calls == [False, False, True]
    saved = out.grad_fn.saved_tensors
    assert saved[3].shape == (2, 1, 2, 100) and saved[3].dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_public_op_gradient_on_saved_stats_matches_jax(dtype):
    """Autograd through the public op at N ≤ 1040 saves the forward's
    statistics and hands them to K5's backward: the gradient equals the
    plain backward given them, and JAX's."""
    q, k, v, g = _operands(2, 2, 100, seed=9)
    xs = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    tg = torch.from_numpy(g).to(dtype)
    out = tfa.flash_attention(*xs)
    stats = out.grad_fn.saved_tensors[3]
    (out.float() * tg.float()).sum().backward()
    want = tfa.flash_attention_single_bwd(*(x.detach() for x in xs), tg, SCALE, stats)
    for x, ref in zip(xs, want):
        assert torch.equal(x.grad, ref)
    for name, x, ref in zip(("dq", "dk", "dv"), xs, _jax_grads(q, k, v, g, dtype)):
        assert _norm_err(x.grad, ref) <= TOL[dtype], (name, _norm_err(x.grad, ref))


@pytest.mark.parametrize("bad", ["missing", "non_contiguous", "shape", "dtype"])
def test_k5_backward_refuses_missing_or_malformed_stats(bad):
    """Statistics of another shape or dtype are refused everywhere; off the
    CPU, where the kernels read them, a call without them or with a
    non-contiguous tensor raises before any launch (meta tensors stand for
    the card's here)."""
    device = "meta" if bad in ("missing", "non_contiguous") else "cpu"
    q, k, v, dout = (torch.zeros(1, 2, 9, D, device=device) for _ in range(4))
    stats = {"missing": None,
             "non_contiguous": torch.zeros(1, 2, 9, 2, device=device).permute(3, 0, 1, 2),
             "shape": torch.zeros(3, 1, 2, 9),
             "dtype": torch.zeros(2, 1, 2, 9, dtype=torch.float64)}[bad]
    with pytest.raises(ValueError, match="stats"):
        tfa.flash_attention_single_bwd(q, k, v, dout, SCALE, stats)
