"""K7's blocked backward under the lse rule: the form K2's backward kernels
compute when they read K7's logsumexp as the row max m with r ≡ 1, against
the plain version the card holds them to (``flash_attention_blocked_bwd_
reference``) and against JAX's ``_flash_backward_blocked`` (its Pallas
kernels in interpret mode).

The form (``_lse_rule``) is ``_tn_bwd_math``'s, one matrix per (b, h): the
SAVED forward output o, p = exp(s − lse) (already normalised) rounded to the
operand dtype before dv = bf16(p)ᵀ·dO with dO unscaled (K5's rule), and
ds = (p·(dp − delta))·scale, the TPU kernel's order, rounded.  With
``tile`` it is what the kernels see: rows padded to a multiple of the 64-row
tile with zeros (the copies' zero fill, lse included) and p masked to key
and query indices < N.

Tolerances: against the 512-key blocked reference, which differs only in
its f32 summation order, f32 within 1e-6 of the gradient's maximum and bf16
within one bf16 ulp of it; against JAX, those of
tests/test_torch_flash_attention_stream.py (f32 1e-5 normalised, bf16
2e-2)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.kernels import flash_attention as jfa
from cross_attention_vit_tpu_torch.kernels import flash_attention as tfa

D = 64
SCALE = D ** -0.5
TILE = 64


def _inputs(B, K, N, seed, dtype, scale=SCALE):
    """q, k, v, dO (B, K, N, D) from one numpy seed in ``dtype``, and the
    port's forward out and lse on them."""
    r = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(r.normal(size=(B, K, N, D)).astype(np.float32)).to(dtype)
                  for _ in range(4))
    out, lse = tfa.flash_attention_stream_fwd(q, k, v, scale)
    return q, k, v, out, lse, g


def _lse_rule(q, k, v, out, lse, dout, scale, tile=None, mask_queries=True):
    """(dq, dk, dv) in q's dtype, and the f32 p and rounded ds (B, K, n, n)
    over the padded rows: the lse rule on one matrix per (b, h).  p is
    masked to key indices < N and, with ``mask_queries``, query indices < N
    (the dk/dv kernel's mask; the dq kernel never stores a padded row)."""
    dt = q.dtype
    N = q.shape[2]
    n = N if tile is None else -(-N // tile) * tile
    pad = [0, 0, 0, n - N]
    qf, kf, vf, of, do = (torch.nn.functional.pad(t.float(), pad)
                          for t in (q, k, v, out, dout))
    m = torch.nn.functional.pad(lse, [0, n - N])            # padded rows: 0
    live = torch.arange(n) < N
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mask = (live[:, None] if mask_queries else True) & live[None, :]
    p = torch.where(mask, torch.exp(s - m.unsqueeze(-1)), 0.0)
    delta = (do * of).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dt).float()
    grads = (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf), dv)
    return tuple(t[:, :, :N].to(dt) for t in grads), p, ds


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _norm_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1041, 1100])
def test_lse_rule_is_the_blocked_reference(N, dtype):
    q, k, v, out, lse, g = _inputs(2, 2, N, seed=N, dtype=dtype)
    got, _, _ = _lse_rule(q, k, v, out, lse, g, SCALE)
    want = tfa.flash_attention_blocked_bwd_reference(q, k, v, out, lse, g, SCALE)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        big = b.float().abs().max().item()
        limit = 1e-6 * big if dtype == torch.float32 else _bf16_ulp(big)
        err = (a.float() - b.float()).abs().max().item()
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1041, 1100])
def test_lse_rule_and_blocked_reference_match_jax(N, dtype):
    """Both against JAX's blocked backward on the same saved out and lse."""
    q, k, v, out, lse, g = _inputs(1, 2, N, seed=N + 1, dtype=dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def j(t):
        return jnp.asarray(t.float().numpy(), jdt)

    want = jfa._flash_backward_blocked(j(q), j(k), j(v), j(out), jnp.asarray(lse.numpy()),
                                       j(g), SCALE)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    ours = _lse_rule(q, k, v, out, lse, g, SCALE)[0]
    blocked = tfa.flash_attention_blocked_bwd_reference(q, k, v, out, lse, g, SCALE)
    for grads in (ours, blocked):
        for name, a, b in zip(("dq", "dk", "dv"), grads, want):
            err = _norm_err(a.float().numpy(), np.asarray(b.astype(jnp.float32)))
            assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1041, 1100])
def test_padded_query_rows_give_zero_p_and_ds(N, dtype):
    """Rows past N in the last 64-row tile: the copies fill q, dO, o and lse
    with zeros and the mask on the query index zeroes p, so p and ds are 0
    there and the gradients are those of the unpadded form.  Without that
    mask p would be exp(0 − 0) = 1 on a padded row's live keys, and ds still
    exactly 0 (dp = delta = 0 on a zero dO row): the same gradients, bit for
    bit, so nothing of a padded row reaches dk or dv either way."""
    q, k, v, out, lse, g = _inputs(1, 2, N, seed=N + 2, dtype=dtype)
    assert N % TILE
    tiled, p, ds = _lse_rule(q, k, v, out, lse, g, SCALE, tile=TILE)
    assert p.shape[-1] == -(-N // TILE) * TILE
    for t in (p, ds):
        assert not t[:, :, N:].any() and not t[:, :, :, N:].any()
        assert t[:, :, :N, :N].any()
    plain, _, _ = _lse_rule(q, k, v, out, lse, g, SCALE)
    for a, b in zip(tiled, plain):
        big = b.float().abs().max().item()
        limit = 1e-6 * big if dtype == torch.float32 else _bf16_ulp(big)
        assert (a.float() - b.float()).abs().max().item() <= limit
    unmasked, p1, ds1 = _lse_rule(q, k, v, out, lse, g, SCALE, tile=TILE, mask_queries=False)
    assert torch.equal(p1[:, :, N:, :N], torch.ones_like(p1[:, :, N:, :N]))
    assert not ds1[:, :, N:].any() and torch.equal(ds1, ds)
    for a, b in zip(unmasked, tiled):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scale", [SCALE, 0.1])
def test_k2s_math_fed_lse_differs_only_in_ds_order(scale):
    """K2's rounding fed (m, r) = (lse, 1): e = p and do·r = dO, so dv is the
    lse rule's bit for bit, and ds = e·((dp − delta)·scale) differs from the
    TPU order (p·(dp − delta))·scale only in f32 rounding.  At D = 64 the
    scale is 2^-3, exact in either order, so every bit agrees; at another
    scale some bf16 ds values flip, each by one ulp, which moves no gradient
    by a bf16 ulp of its maximum."""
    q, k, v, out, lse, g = _inputs(1, 2, 1041, seed=3, dtype=torch.bfloat16, scale=scale)
    ours, p, ds = _lse_rule(q, k, v, out, lse, g, scale)
    stats = torch.stack([lse, torch.ones_like(lse)])
    k2 = [t.to(torch.bfloat16) for t in tfa._tn_bwd_math(
        q.float(), k.float(), v.float(), g.float(), scale, torch.bfloat16, out.float(), stats)]
    assert torch.equal(k2[2], ours[2])
    do, of = g.float(), out.float()
    delta = (do * of).sum(dim=-1, keepdim=True)
    dp = do @ v.float().transpose(-1, -2)
    ds_k2 = (p * ((dp - delta) * (1.0 * scale))).to(torch.bfloat16).float()
    flips = ds_k2 != ds
    if scale == SCALE:
        assert not flips.any()
        assert all(torch.equal(a, b) for a, b in zip(k2, ours))
        return
    assert 0 < flips.sum().item() < 1e-2 * flips.numel()
    ulp = 2.0 ** (torch.floor(torch.log2(ds.abs().clamp_min(2.0 ** -126))) - 7)
    assert ((ds_k2 - ds).abs()[flips] <= ulp[flips]).all()
    for a, b in zip(k2, ours):
        assert (a.float() - b.float()).abs().max().item() \
            <= _bf16_ulp(b.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_writes_into_stacked_views(dtype):
    """The wrapper with ``grads=`` (views of a stacked dqkv, as the training
    path passes them) writes the plain version's values there and returns
    the views themselves."""
    B, K, N = 2, 2, 1041
    q, k, v, out, lse, g = _inputs(B, K, N, seed=4, dtype=dtype)
    dqkv = torch.full((B, N, 3, K, D), float("nan"), dtype=dtype)
    views = tfa._stream_views(dqkv)
    got = tfa.flash_attention_stream_bwd(q, k, v, out, lse, g, SCALE, grads=views)
    want = tfa.flash_attention_blocked_bwd_reference(q, k, v, out, lse, g, SCALE)
    for i in range(3):
        assert got[i] is views[i]
        assert torch.equal(dqkv[:, :, i].transpose(1, 2), want[i])
