"""The port's single-block attention (K5) — the plain versions of the forward
and of the recompute-form backward, which the wrappers run for CPU tensors —
against the JAX package's public ``flash_attention`` at N ≤ 1040 (Pallas
``_attn_kernel`` and ``_attn_bwd_kernel``, run here in interpret mode), and
the public op's switch from K5 to K7 above N = 1040.

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


def _operands(B, K, N, seed, n=4):
    """n arrays (B, K, N, D) from one numpy seed, as numpy f32."""
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, K, N, D)).astype(np.float32) for _ in range(n)]


def _norm_err(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax(q, k, v, g, dtype):
    """JAX flash_attention's output and its vjp on g, as f32 numpy."""
    args = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, SCALE), *args)
    grads = vjp(jnp.asarray(g, JDT[dtype]))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


# N = 16 fills its sublane blocks exactly; 17 and 100 are ragged (the JAX
# kernel pads them to 24 and 104 rows and masks the rest)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [16, 17, 100])
def test_plain_k5_matches_jax(N, dtype):
    q, k, v, g = _operands(2, 2, N, seed=N)
    want = _jax(q, k, v, g, dtype)
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, g)]
    out = tfa.flash_attention_single_fwd(*t[:3], SCALE)
    grads = tfa.flash_attention_single_bwd(*t, SCALE)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), want):
        assert got.dtype == dtype and got.shape == (2, 2, N, D)
        assert _norm_err(got, ref) <= TOL[dtype], (name, _norm_err(got, ref))


def test_public_op_is_k5_below_the_switch_and_differentiates():
    """The public op's autograd at N ≤ 1040 is K5's: its gradient equals the
    K5 plain backward exactly, and both match JAX's vjp."""
    q, k, v, g = _operands(1, 2, 33, seed=3)
    t = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(i < 3)
         for i, x in enumerate((q, k, v, g))]
    out = tfa.flash_attention(*t[:3])
    assert type(out.grad_fn).__name__ == "_FlashAttentionSingleBackward"
    (out.float() * t[3].float()).sum().backward()
    want = tfa.flash_attention_single_bwd_reference(*(x.detach() for x in t), SCALE)
    for x, ref in zip(t[:3], want):
        assert torch.equal(x.grad, ref)
    for got, ref in zip((out.detach(), *(x.grad for x in t[:3])),
                        _jax(q, k, v, g, torch.bfloat16)):
        assert _norm_err(got, ref) <= 2e-2


@pytest.mark.parametrize("N,path", [(1040, "K5"), (1041, "K7")])
def test_public_op_switches_above_1040(N, path, monkeypatch):
    """Which plain versions ran, forward and backward, at the last N of the
    single-block path and the first of the streaming one."""
    ran = []
    for name in ("flash_attention_single_reference", "flash_attention_single_bwd_reference",
                 "flash_attention_stream_reference", "flash_attention_blocked_bwd_reference"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _n=name: ran.append(_n) or _fn(*a))
    gen = torch.Generator().manual_seed(N)
    q, k, v = (torch.randn(1, 1, N, 8, generator=gen, requires_grad=True) for _ in range(3))
    tfa.flash_attention(q, k, v).sum().backward()
    assert q.grad.shape == q.shape
    if path == "K5":
        assert ran == ["flash_attention_single_reference", "flash_attention_single_bwd_reference"]
    else:
        assert ran == ["flash_attention_stream_reference", "flash_attention_blocked_bwd_reference"]


def test_k5_is_not_k7s_rounding_and_the_public_op_now_follows_jax():
    """The repaired fault: at N ≤ 1040 the public op ran K7's plain version,
    which rounds p with the running max and takes delta from the rounded
    output.  On the same bf16 inputs K5's and K7's plain versions differ, and
    the public op now sits nearer the JAX op than K7's plain version does,
    forward and backward."""
    q, k, v, g = _operands(1, 2, 100, seed=4)
    want = _jax(q, k, v, g, torch.bfloat16)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g)]
    k7_out, lse = tfa.flash_attention_stream_reference(*t[:3], SCALE)
    k7 = (k7_out, *tfa.flash_attention_blocked_bwd_reference(*t[:3], k7_out, lse, t[3], SCALE))
    xs = [x.clone().requires_grad_() for x in t[:3]]
    out = tfa.flash_attention(*xs)
    (out.float() * t[3].float()).sum().backward()
    port = (out.detach(), *(x.grad for x in xs))
    assert torch.equal(port[0], tfa.flash_attention_single_reference(*t[:3], SCALE))
    assert not torch.equal(port[0], k7[0])
    errs = {name: (_norm_err(p, ref), _norm_err(s, ref))
            for name, p, s, ref in zip(("out", "dq", "dk", "dv"), port, k7, want)}
    # dv = bf16(p)ᵀ·dO may round alike in both; out and ds do not
    assert all(mine <= theirs for mine, theirs in errs.values()), errs
    assert errs["out"][0] < errs["out"][1] and errs["dq"][0] < errs["dq"][1], errs


def test_strided_views_equal_contiguous_operands():
    """q, k, v as views of a stacked (B, N, 3, K, D) tensor — the int8 qkv
    layout — give what contiguous copies give."""
    qkv = torch.randn(2, 40, 3, 2, D, generator=torch.Generator().manual_seed(5))
    views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    g = torch.randn(2, 2, 40, D, generator=torch.Generator().manual_seed(6))
    conts = [x.contiguous() for x in views]
    assert torch.equal(tfa.flash_attention_single_fwd(*views), tfa.flash_attention_single_fwd(*conts))
    for a, b in zip(tfa.flash_attention_single_bwd(*views, g), tfa.flash_attention_single_bwd(*conts, g)):
        assert torch.equal(a, b)


def test_cpu_calls_do_not_count_as_launches():
    q, k, v, g = (torch.from_numpy(x) for x in _operands(1, 1, 17, seed=7))
    tfa.flash_attention_single_fwd(q, k, v)
    tfa.flash_attention_single_bwd(q, k, v, g)
    tfa.flash_attention(*(x.clone().requires_grad_() for x in (q, k, v))).sum().backward()
    assert tfa.flash_attention_single_fwd.launches == 0
    assert tfa.flash_attention_single_bwd.dq_launches == 0 == \
        tfa.flash_attention_single_bwd.dkdv_launches


@pytest.mark.parametrize("which", ["q_rank", "k_shape", "v_dtype", "dout_shape", "device"])
def test_k5_bad_inputs_raise(which):
    q, k, v, dout = (torch.zeros(1, 2, 5, D) for _ in range(4))
    if which == "q_rank":
        q = torch.zeros(2, 5, D)
    elif which == "k_shape":
        k = torch.zeros(1, 2, 6, D)
    elif which == "v_dtype":
        v = v.to(torch.bfloat16)
    elif which == "dout_shape":
        dout = torch.zeros(1, 2, 4, D)
    else:       # neither cpu nor cuda: raise instead of falling back
        q, k, v, dout = (torch.zeros(1, 2, 5, D, device="meta") for _ in range(4))
    with pytest.raises(ValueError):
        tfa.flash_attention_single_bwd(q, k, v, dout)
    if which not in ("dout_shape",):
        with pytest.raises(ValueError):
            tfa.flash_attention_single_fwd(q, k, v)
