"""The plain versions behind the redesigned K7 forward and K8 products,
against the JAX package (its Pallas kernels in interpret mode).

- K7's plain forward takes the key-block width of its online softmax
  (``block``): JAX's 512 by default, the CUDA kernel's 64 on the card.  At
  either width it matches JAX's streaming ``flash_attention`` within the
  tolerances of tests/test_torch_flash_attention_stream.py (f32 atol 5e-5,
  rtol 1e-4: summation order; bf16 ≤ 8e-3 normalised: two bf16 roundings,
  p's with another running max; lse ≤ 1e-5).  The default is bit for bit
  the call without it.
- K8's products have a plain version of their own,
  ``fused_qkv_products_reference(x, w, dqkv)``; ``fused_qkv_bwd_reference``
  is K2's plain version followed by it, bit for bit.  The port's K8 matches
  JAX's ``_fused_qkv_bwd`` at a ragged M = B·N = 111 within 2e-2 normalised
  in bf16 (both round dqkv to bf16 and accumulate in f32), with W as the
  transposed view of a (3H, H) Linear weight (the model's) and contiguous.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.kernels import flash_attention as jfa
from cross_attention_vit_tpu_torch.kernels import flash_attention as tfa

D = 64
SCALE = D ** -0.5
BF16_TOL = 8e-3


def _operands(N, seed, B=1, K=2):
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, K, N, D)).astype(np.float32) for _ in range(3)]


def _norm_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("block", [64, 512])
@pytest.mark.parametrize("N", [1041, 1100])
def test_plain_k7_forward_at_block_matches_jax_f32(N, block):
    q, k, v = _operands(N, seed=N + block)
    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)), SCALE))
    out, _ = tfa.flash_attention_stream_reference(*map(torch.from_numpy, (q, k, v)), SCALE,
                                                  block=block)
    np.testing.assert_allclose(out.numpy(), want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("block", [64, 512])
@pytest.mark.parametrize("N", [1041, 1100])
def test_plain_k7_forward_at_block_matches_jax_bf16(N, block):
    q, k, v = _operands(N, seed=N + block + 1)
    want = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), SCALE)
    out, lse = tfa.flash_attention_stream_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), SCALE, block=block)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _norm_err(out.float().numpy(), want.astype(jnp.float32)) <= BF16_TOL


@pytest.mark.parametrize("block", [64, 512])
@pytest.mark.parametrize("N", [1041, 1100])
def test_plain_k7_lse_at_block_matches_jax(N, block):
    q, k, v = _operands(N, seed=N + block + 2)
    _, want = jfa._flash_forward(*map(jnp.asarray, (q, k, v)), SCALE, with_lse=True)
    _, lse = tfa.flash_attention_stream_reference(*map(torch.from_numpy, (q, k, v)), SCALE,
                                                  block=block)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_k7_default_block_is_the_call_without_it(dtype):
    """The default is JAX's 512 keys, bit for bit: the CPU wrapper (which
    runs the plain version) and an explicit block=512 give the same bits."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _operands(1100, seed=7))
    out, lse = tfa.flash_attention_stream_reference(q, k, v, SCALE)
    for got_out, got_lse in (tfa.flash_attention_stream_reference(q, k, v, SCALE, block=512),
                             tfa.flash_attention_stream_fwd(q, k, v, SCALE)):
        assert torch.equal(got_out, out) and torch.equal(got_lse, lse)
    assert tfa._STREAM_BLOCK == jfa._BLOCK_KV == 512


def test_plain_k7_block_changes_only_the_rounding_of_p():
    """In f32 the block width is only a summation order; in bf16 it moves
    the running max that rounds p, so the two widths differ, within the
    bf16 tolerance of each other."""
    q, k, v = (torch.from_numpy(x) for x in _operands(1100, seed=8))
    f64, f512 = (tfa.flash_attention_stream_reference(q, k, v, SCALE, block=b)[0]
                 for b in (64, 512))
    torch.testing.assert_close(f64, f512, atol=5e-6, rtol=1e-5)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    b64, b512 = (tfa.flash_attention_stream_reference(qb, kb, vb, SCALE, block=b)[0]
                 for b in (64, 512))
    assert not torch.equal(b64, b512)
    assert _norm_err(b64.float(), b512.float()) <= BF16_TOL


# --- K8: the products' plain version, and the port against JAX's megakernel ---

B8, N8, H8, K8, D8 = 3, 37, 64, 4, 16     # M = B·N = 111: ragged


def _k8_inputs(seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B8, N8, H8)).astype(np.float32),
            (r.normal(size=(H8, 3, K8, D8)) * 0.1).astype(np.float32),
            r.normal(size=(B8, K8, D8, N8)).astype(np.float32))


def _as_linear_view(w: torch.Tensor) -> torch.Tensor:
    """w (H, 3, K, D) as the model passes it: the transpose of a contiguous
    (3·K·D, H) Linear weight, viewed as (H, 3, K, D)."""
    H = w.shape[0]
    weight = w.reshape(H, -1).t().contiguous()
    view = weight.t().reshape(w.shape)
    assert view.stride(0) == 1 and torch.equal(view, w)
    return view


def _k8_residuals(x, w, g):
    """The JAX forward's saved qkv (3, B, K, D, N) and output (B, K, D, N),
    bf16, and the port's (B, N, 3, K, D) / (B, N, K, D) views of them."""
    xb, wb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))
    qkv = jfa._qkv_project_tn(xb, wb)
    out = jfa.flash_attention_qkv_tn(qkv, D8 ** -0.5)

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()

    return (xb, wb, qkv, out, gb), (t(xb), t(wb), t(qkv).permute(1, 4, 0, 2, 3),
                                    *(t(a).permute(0, 3, 1, 2) for a in (out, gb)))


@pytest.mark.parametrize("layout", ["linear_view", "contiguous"])
def test_k8_matches_jax_megakernel_at_ragged_m(layout):
    x, w, g = _k8_inputs(seed=21)
    jargs, (tx, tw, tqkv, tout, tg) = _k8_residuals(x, w, g)
    jdx, jdw = jfa._fused_qkv_bwd(*jargs, D8 ** -0.5)
    if layout == "linear_view":
        tw = _as_linear_view(tw)
    else:
        assert tw.is_contiguous()
    dx, dw = tfa.fused_qkv_bwd(tx, tw, tqkv, tout, tg)
    assert dx.shape == (B8, N8, H8) and dw.shape == (H8, 3, K8, D8)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert _norm_err(dx.float(), jdx.astype(jnp.float32)) <= 2e-2
    assert _norm_err(dw.float(), jdw.astype(jnp.float32)) <= 2e-2


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
def test_k8_plain_version_is_k2_then_the_products(w_dtype):
    """fused_qkv_bwd_reference = the products' plain version on K2's plain
    dqkv, bit for bit (dW cast to w's dtype)."""
    x, w, g = _k8_inputs(seed=22)
    _, (tx, tw, tqkv, tout, tg) = _k8_residuals(x, w, g)
    tw = tw.to(w_dtype)
    dqkv = tfa.flash_attention_qkv_bwd_reference(tqkv, tout, tg, D8 ** -0.5)
    px, pw = tfa.fused_qkv_products_reference(tx, tw, dqkv)
    assert pw.dtype == torch.float32 and px.dtype == tx.dtype
    dx, dw = tfa.fused_qkv_bwd_reference(tx, tw, tqkv, tout, tg, D8 ** -0.5)
    assert torch.equal(dx, px) and torch.equal(dw, pw.to(w_dtype))


@pytest.mark.parametrize("layout", ["linear_view", "contiguous"])
def test_k8_products_on_cpu_are_their_plain_version(layout):
    """``fused_qkv_products`` runs the plain version for CPU tensors, with W
    in either layout, and counts no launch."""
    x, w, g = _k8_inputs(seed=23)
    _, (tx, tw, tqkv, tout, tg) = _k8_residuals(x, w, g)
    if layout == "linear_view":
        tw = _as_linear_view(tw)
    dqkv = tfa.flash_attention_qkv_bwd_reference(tqkv, tout, tg, D8 ** -0.5)
    before = tfa.fused_qkv_bwd.dx_launches, tfa.fused_qkv_bwd.dw_launches
    dx, dw = tfa.fused_qkv_products(tx, tw, dqkv)
    px, pw = tfa.fused_qkv_products_reference(tx, tw.contiguous(), dqkv)
    assert torch.equal(dx, px) and torch.equal(dw, pw)
    assert (tfa.fused_qkv_bwd.dx_launches, tfa.fused_qkv_bwd.dw_launches) == before


@pytest.mark.parametrize("bad", ["w_rows", "dqkv_shape"])
def test_k8_products_reject_disagreeing_shapes(bad):
    x = torch.zeros(2, 5, 16, dtype=torch.bfloat16)
    w = torch.zeros(16, 3, 2, 8, dtype=torch.bfloat16)
    dqkv = torch.zeros(2, 5, 3, 2, 8, dtype=torch.bfloat16)
    if bad == "w_rows":
        w = torch.zeros(8, 3, 2, 8, dtype=torch.bfloat16)
    else:
        dqkv = torch.zeros(2, 4, 3, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="disagree"):
        tfa.fused_qkv_products(x, w, dqkv)
