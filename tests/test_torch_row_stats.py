"""The row-statistics contract of the port's attention kernels: K1 (and K6's
forward) returns each row's max m and r = 1/Σ exp(s − m) of the f32 scores
s = q·kᵀ·scale as a (2, B, K, N) f32 tensor, and K2 (K6's backward, K8)
reads them instead of finding them again.  The plain versions define the
units; the CUDA kernels write and read the same ones (chip_smoke.py holds
them against these on the card).

The inputs are made with numpy and go through the JAX package as well: its
``flash_attention_qkv_tn`` (Pallas interpret mode) and the ``jax.vjp`` of it
(``_qkv_tn_bwd``).  Tolerances: the statistics atol 1e-6 times the largest
|m| for m (both sides take the max of the same f32 scores, up to summation
order in q·kᵀ) and rtol 1e-5 for r (a sum of at most 65 f32 terms); outputs
and gradients as tests/test_torch_flash_attention.py: f32 atol 5e-5 /
rtol 1e-4, bf16 max error normalised by max |reference| ≤ 2e-2."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.kernels import flash_attention as jfa
from cross_attention_vit_tpu_torch.kernels import flash_attention as tfa

D = 64
SCALE = D ** -0.5


def _qkv(B, K, N, seed):
    """The same numbers in both layouts: JAX (3, B, K, D, N), port (B, N, 3, K, D)."""
    qkv = np.random.default_rng(seed).normal(size=(3, B, K, D, N)).astype(np.float32)
    return qkv, np.ascontiguousarray(qkv.transpose(1, 4, 0, 2, 3))


def _scores(jq):
    """f64 scores (B, K, N, N) of the JAX-layout qkv, q·kᵀ·scale."""
    q, k = jq[0].astype(np.float64), jq[1].astype(np.float64)
    return np.einsum("bkdi,bkdj->bkij", q, k) * SCALE


def _port_layout(a):
    """(B, K, D, N) → (B, N, K, D) and (3, B, K, D, N) → (B, N, 3, K, D)."""
    a = np.asarray(a.astype(jnp.float32))
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2) if a.ndim == 4
                                else a.transpose(1, 4, 0, 2, 3))


@pytest.mark.parametrize("B,K,N", [(1, 1, 17), (2, 2, 17), (1, 2, 65), (2, 1, 65)])
def test_plain_k1_stats_are_the_row_max_and_reciprocal_sum(B, K, N):
    jq, tq = _qkv(B, K, N, seed=N + K)
    out, stats = tfa.flash_attention_qkv_reference(torch.from_numpy(tq), SCALE, True)
    assert stats.shape == (2, B, K, N) and stats.dtype == torch.float32
    s = _scores(jq)
    m = s.max(axis=-1)
    r = 1.0 / np.exp(s - m[..., None]).sum(axis=-1)
    np.testing.assert_allclose(stats[0].numpy(), m, atol=1e-6 * np.abs(m).max(), rtol=0)
    np.testing.assert_allclose(stats[1].numpy(), r, rtol=1e-5, atol=0)
    # the JAX kernel's output is (e·v)·r with these statistics, e = exp(s − m)
    want = np.asarray(jfa.flash_attention_qkv_tn(jnp.asarray(jq), SCALE))      # (B,K,D,N)
    e = np.exp(s - stats[0].numpy()[..., None].astype(np.float64))
    rebuilt = np.einsum("bkij,bkdj->bkdi", e, jq[2].astype(np.float64))
    rebuilt *= stats[1].numpy()[:, :, None, :]
    np.testing.assert_allclose(rebuilt, want, atol=5e-5, rtol=1e-4)
    np.testing.assert_array_equal(out.numpy(),
                                  tfa.flash_attention_qkv_reference(torch.from_numpy(tq), SCALE))


def _k2_case(N, dtype, seed):
    """Port operands (qkv, out, dout in ``dtype``), K1's plain stats, and JAX's
    dqkv in the port layout."""
    jq, tq = _qkv(1, 2, N, seed)
    g = np.random.default_rng(seed + 1).normal(size=(1, 2, D, N)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out, vjp = jax.vjp(lambda x: jfa.flash_attention_qkv_tn(x, SCALE), jnp.asarray(jq, jdt))
    (dqkv,) = vjp(jnp.asarray(g, jdt))
    qkv = torch.from_numpy(tq).to(dtype)
    _, stats = tfa.flash_attention_qkv_reference(qkv, SCALE, True)
    return (qkv, torch.from_numpy(_port_layout(out)).to(dtype),
            torch.from_numpy(_port_layout(jnp.asarray(g))).to(dtype), stats, _port_layout(dqkv))


@pytest.mark.parametrize("N", [17, 65])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_k2_on_k1_stats_equals_k2_that_finds_them_and_jax(N, dtype):
    qkv, out, dout, stats, want = _k2_case(N, dtype, seed=3 * N)
    got = tfa.flash_attention_qkv_bwd(qkv, out, dout, SCALE, stats)
    torch.testing.assert_close(got, tfa.flash_attention_qkv_bwd(qkv, out, dout, SCALE),
                               rtol=0, atol=0)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    else:
        for s in range(3):
            w = want[:, :, s]
            err = np.abs(got[:, :, s].float().numpy() - w).max() / np.abs(w).max()
            assert err <= 2e-2, (s, err)


def test_plain_k2_reads_the_stats_it_is_given():
    """Stats that differ from the scores' own change the gradient: K2 reads
    them and does not find them again."""
    qkv, out, dout, stats, _ = _k2_case(17, torch.float32, seed=5)
    shifted = stats.clone()
    shifted[1] *= 2.0
    a = tfa.flash_attention_qkv_bwd(qkv, out, dout, SCALE, stats)
    b = tfa.flash_attention_qkv_bwd(qkv, out, dout, SCALE, shifted)
    assert not torch.equal(a, b)


def _recording(monkeypatch):
    """Records the with_stats argument of each call of K1's plain version."""
    calls, fn = [], tfa.flash_attention_qkv_reference

    def wrapped(*args):
        calls.append(len(args) > 2 and bool(args[2]))
        return fn(*args)
    monkeypatch.setattr(tfa, "flash_attention_qkv_reference", wrapped)
    return calls


def test_k1_writes_stats_only_when_a_backward_follows(monkeypatch):
    calls = _recording(monkeypatch)
    r = np.random.default_rng(8)
    x = torch.from_numpy(r.normal(size=(1, 9, 64)).astype(np.float32))
    w = torch.from_numpy((r.normal(size=(64, 3, 1, 64)) * 0.125).astype(np.float32))
    with torch.no_grad():
        tfa.fused_qkv_attention(x, w.requires_grad_())
    tfa.fused_qkv_attention(x, w.detach())
    assert calls == [False, False]
    tfa.fused_qkv_attention(x, w.requires_grad_()).sum().backward()
    tfa.flash_attention_qkv(torch.from_numpy(_qkv(1, 1, 9, 2)[1]).requires_grad_())
    assert calls == [False, False, True, True]


def test_fused_qkv_attention_saves_k1_stats_for_its_backward():
    """The autograd graph keeps K1's stats in the slot of JAX's lse, and the
    backward (K2, or K8's plain version with the flag on) gives the same
    gradients as the plain versions that find the statistics again."""
    r = np.random.default_rng(9)
    x = r.normal(size=(2, 17, 64)).astype(np.float32)
    w = (r.normal(size=(64, 3, 2, 32)) * 0.125).astype(np.float32)
    g = torch.from_numpy(r.normal(size=(2, 2, 32, 17)).astype(np.float32))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = tfa.fused_qkv_attention(tx, tw)
    saved = out.grad_fn.saved_tensors
    assert saved[-1].shape == (2, 2, 2, 17) and saved[-1].dtype == torch.float32
    (out * g).sum().backward()
    qkv, o, stats = saved[2], saved[3], saved[4]
    dout = g.permute(0, 3, 1, 2).contiguous()
    dqkv = tfa.flash_attention_qkv_bwd_reference(qkv, o, dout, 32 ** -0.5)
    dx, dw = tfa._qkv_grads_plain(torch.from_numpy(x), torch.from_numpy(w), dqkv)
    torch.testing.assert_close(tx.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(tw.grad, dw, rtol=0, atol=0)
    fdx, fdw = tfa.fused_qkv_bwd(torch.from_numpy(x), torch.from_numpy(w), qkv, o, dout,
                                 32 ** -0.5, stats)
    want_dx, want_dw = tfa.fused_qkv_bwd_reference(torch.from_numpy(x), torch.from_numpy(w), qkv,
                                                   o, dout, 32 ** -0.5)
    torch.testing.assert_close(fdx, want_dx, rtol=0, atol=0)
    torch.testing.assert_close(fdw, want_dw, rtol=0, atol=0)


@pytest.mark.parametrize("N", [17, 65])
def test_k6_forward_stats_feed_its_backward(N):
    """K6's plain forward returns K1's units on (B, K, D, N) operands; its
    backward on them equals the backward that finds them again, and autograd
    through flash_attention_tn saves them."""
    r = np.random.default_rng(N)
    q, k, v, do = (torch.from_numpy(r.normal(size=(1, 2, D, N)).astype(np.float32))
                   for _ in range(4))
    out, stats = tfa.flash_attention_tn_fwd(q, k, v, None, True)
    qkv = torch.stack([q, k, v], dim=1).permute(0, 4, 1, 2, 3).contiguous()  # (B,N,3,K,D)
    _, k1_stats = tfa.flash_attention_qkv_reference(qkv, SCALE, True)
    torch.testing.assert_close(stats, k1_stats, rtol=0, atol=0)
    got = tfa.flash_attention_tn_bwd(q, k, v, do, None, stats)
    want = tfa.flash_attention_tn_bwd(q, k, v, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    y = tfa.flash_attention_tn(*xs)
    torch.testing.assert_close(y.grad_fn.saved_tensors[3], stats, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["missing", "shape", "dtype"])
def test_backward_kernels_refuse_missing_or_malformed_stats(bad):
    """On the card the backward kernels read the statistics: a call without
    them, or with another shape or dtype, raises before any launch."""
    stats = {"missing": None, "shape": torch.zeros(3, 1, 2, 9),
             "dtype": torch.zeros(2, 1, 2, 9, dtype=torch.float64)}[bad]
    with pytest.raises(ValueError):
        tfa._check_stats("flash_attention_qkv_bwd", stats, 1, 2, 9, torch.device("cpu"))
