"""Fused self-attention, forward and backward: the Hopper port of the TPU
kernels in ``cross_attention_vit_tpu/kernels/flash_attention.py``:

  K1  ``_attn_kernel_qkv_tn``      forward on a stacked qkv, N ≤ 1040
  K2  ``_attn_bwd_kernel_qkv_tn``  its backward with the saved output
  K5  ``_attn_kernel``             single-block forward on separate q, k, v
                                   (the public op), N ≤ 1040
      ``_attn_bwd_kernel``         its recompute-form backward
  K6  ``_attn_kernel_tn``          K1's forward on separate (B, K, D, N)
                                   q, k, v (the public "tn" op), N ≤ 1040
      ``_attn_bwd_kernel_tn``      K2's backward with o recomputed
  K7  ``_attn_kernel_stream``      streaming (online-softmax) forward that
                                   also writes the row logsumexp, N > 1040
      ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``
                                   its blocked backward from (out, lse)
  K8  ``_fused_qkv_bwd_kernel``    the fused QKV-projection backward: K2's
                                   dq/dk/dv, then dx and dW

``flash_attention_qkv`` is the differentiable entry point on a stacked qkv.
Like the JAX ``flash_attention_qkv_tn`` / ``_qkv_tn_bwd`` it switches on the
sequence length at ``_SINGLE_BLOCK_MAX = 1040``: up to it the forward is K1
(it saves qkv, the output and its row statistics) and the backward K2 (it
returns the stacked dqkv); above it the forward is K7's streaming kernel on
strided views of the stacked qkv (it saves qkv, the output and the
logsumexp) and the backward K7's two blocked kernels, which write the same
stacked dqkv.  The JAX
backward re-runs the streaming forward to get the logsumexp; the port keeps
it from its one forward (same values, one launch fewer per layer).

``fused_qkv_attention`` (the model's flash path) is the JAX custom VJP over
(x, w): the projection, then K1 (K7); its backward follows
``_fused_qkv_bwd_rule`` — K8 when ``FUSED_QKV_GRADS`` is on and the operands
are bf16 with N ≤ 1040, otherwise K2 (K7) and two plain GEMMs.

``flash_attention`` is the public op on (B, K, N, D) operands (JAX
``flash_attention``, which the int8+attn serving path calls).  It switches
at the same N as the JAX ``_fwd`` / ``_bwd``: up to 1040 the forward is K5
(it saves q, k, v and, when a backward follows, its row statistics) and the
backward K5's recompute-form kernels; above it K7's streaming forward and
blocked backward.  K5 normalises p before rounding it and takes delta from
the unrounded o = pb·v, so at N ≤ 1040 it agrees with K7 only to bf16
rounding.  K5's kernels are K1's and K2's (K6's recompute form) under K5's
rounding rule; K7's backward kernels are K2's (with the saved output) under
the same rule, reading the logsumexp as the row max with r ≡ 1.
``flash_attention_tn``
is the public op on (B, K, D, N) operands: K6 up to 1040, K7 on
(B, K, N, D) copies above.

Raw wrappers: ``flash_attention_qkv_fwd`` / ``flash_attention_qkv_bwd`` (K1,
K2), ``flash_attention_single_fwd`` / ``flash_attention_single_bwd`` (K5),
``flash_attention_tn_fwd`` / ``flash_attention_tn_bwd`` (K6),
``flash_attention_stream_fwd`` / ``flash_attention_stream_bwd`` (K7) and
``fused_qkv_bwd`` (K8).  On a CUDA tensor each launches its hand-written
kernel (``csrc/*.cu``) or raises; on a CPU tensor it runs the plain PyTorch
version of the same function (``*_reference``), which the CPU tests hold
against the JAX kernels and ``chip_smoke.py`` holds the CUDA kernels against
on the card.  Launch counts (never plain calls), so that a run can show that
its main path went through the kernels: ``flash_attention_qkv.launches``
(K1), ``flash_attention_qkv_bwd.launches`` (K2),
``flash_attention_single_fwd.launches`` and
``flash_attention_single_bwd.dq_launches`` / ``.dkdv_launches`` (K5),
``flash_attention_tn_fwd.launches`` and ``flash_attention_tn_bwd.dq_launches``
/ ``.dkdv_launches`` (K6), ``flash_attention_stream_fwd.launches`` and
``flash_attention_stream_bwd.dq_launches`` / ``.dkdv_launches`` (K7), and
``fused_qkv_bwd.launches`` (K8 calls) with ``.dq_launches``,
``.dkdv_launches``, ``.dx_launches``, ``.dw_launches`` (its four kernels).

The K1/K2 kernels read qkv in the layout the QKV projection produces,
(B, N, 3, K, D); the output and its cotangent are (B, N, K, D) and K2 writes
dqkv as (B, N, 3, K, D).  The K5, K6 and K7 kernels take each operand as a
(B, K, N, D) view of any strides, so they read and write views of the
stacked tensors without a copy; bf16 operands without a unit head-dim
stride and 16-byte rows (a contiguous (B, K, D, N) operand) are copied to
(B, K, N, D) by K6's wrapper and rejected by K5 and K7.

Row statistics.  K1 (and K5's and K6's forwards) finds each row's max m of
the f32 scores s = q·kᵀ·scale and r = 1/Σ exp(s − m); with ``stats=True``
it returns them as a (2, B, K, N) f32 tensor (``_row_stats`` defines the
units), and K2, K5's and K6's backwards and K8 read them (``stats=``)
instead of finding them again — on the card they require them.  The autograd
Functions ask for them only when a backward will follow
(``_backward_follows``), so serving writes none.
"""


from __future__ import annotations

import ctypes

import torch

from . import _build

_HEAD_DIM = 64     # the kernels' compile-time head dim (all repo configurations)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
# Above this sequence length the JAX package switches from the single-block
# kernels (K1/K2, K5, K6) to the streaming ones (K7) — its _SINGLE_BLOCK_MAX
# (kernels/flash_attention.py:187); the port switches at the same N.
_SINGLE_BLOCK_MAX = 1040
# K7's key block in the plain versions: the TPU kernels' 512-key tiles
# (_BLOCK_KV), so the running max and the rescaling round as there
_STREAM_BLOCK = 512


def _row_stats(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward's row statistics of f32 scores s (B, K, N, N): the row max
    m, e = exp(s − m) and r = 1/Σe (m and r (B, K, N, 1)).  These are the
    units of the (2, B, K, N) ``stats`` tensor that K1 and K6's forward write
    and the backwards read: stats[0] = m, stats[1] = r."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return m, e, 1.0 / e.sum(dim=-1, keepdim=True)


def flash_attention_qkv_reference(qkv: torch.Tensor, scale: float, with_stats: bool = False):
    """Plain PyTorch version of K1: (B, N, 3, K, D) → (B, N, K, D), and with
    ``with_stats`` also the row statistics it used, a (2, B, K, N) f32 tensor
    (``_row_stats``).

    Follows the TPU kernel's rounding (``_tn_fwd_math``), not ``_sdpa``'s:
    the already-rounded operands are upcast to f32 before each product (the
    TPU's preferred_element_type=f32, up to summation order), e = exp(s − m)
    is cast to the operand dtype before the AV product, and the row
    normalisation multiplies the f32 AV result."""
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3).float() for i in range(3))  # (B,K,N,D)
    m, e, r = _row_stats(torch.matmul(q, k.transpose(-1, -2)) * scale)
    out = (torch.matmul(e.to(qkv.dtype).float(), v) * r).to(qkv.dtype).permute(0, 2, 1, 3)
    return (out, torch.cat([m, r], dim=-1).permute(3, 0, 1, 2)) if with_stats else out


def _tn_bwd_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                 scale: float, dt: torch.dtype, o: torch.Tensor | None = None,
                 stats: torch.Tensor | None = None):
    """``_tn_bwd_math`` on f32 (B, K, N, D) operands holding ``dt`` values:
    (dq, dk, dv) in f32.  p is recomputed from the row max m and r = 1/Σe,
    both read from the forward's ``stats`` (2, B, K, N) when given, else
    found again; e cast to ``dt`` feeds dv through do_r = (do·r) cast to
    ``dt``; delta = rowsum(do⊙o) in f32, with o the saved output (K2) or, when
    ``o`` is None, recomputed as (eb·v)·r in f32 and never rounded (K6);
    ds = (e·((dp − delta)·(r·scale))) cast to ``dt`` feeds dq and dk.  Every
    product takes the rounded operands upcast to f32."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if stats is None:
        _, e, r = _row_stats(s)                                # r (B,K,N,1)
    else:
        e = torch.exp(s - stats[0].unsqueeze(-1))
        r = stats[1].unsqueeze(-1)
    eb = e.to(dt).float()
    if o is None:
        o = torch.matmul(eb, v) * r
    delta = (do * o).sum(dim=-1, keepdim=True)
    do_r = (do * r).to(dt).float()
    dv = torch.matmul(eb.transpose(-1, -2), do_r)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (e * ((dp - delta) * (r * scale))).to(dt).float()
    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv


def flash_attention_qkv_bwd_reference(qkv: torch.Tensor, out: torch.Tensor,
                                      dout: torch.Tensor, scale: float,
                                      stats: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K2: the stacked dqkv (B, N, 3, K, D) from the
    saved qkv (B, N, 3, K, D), the saved output and its cotangent (B, N, K, D)
    and K1's row statistics (2, B, K, N) (found again when None):
    ``_tn_bwd_math`` with the saved O."""
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3).float() for i in range(3))  # (B,K,N,D)
    o = out.permute(0, 2, 1, 3).float()
    do = dout.permute(0, 2, 1, 3).float()
    dq, dk, dv = _tn_bwd_math(q, k, v, do, scale, qkv.dtype, o, stats)
    return torch.stack([dq, dk, dv], dim=2).to(qkv.dtype).permute(0, 3, 2, 1, 4)


def flash_attention_single_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     scale: float, with_stats: bool = False):
    """Plain PyTorch version of K5's forward (``_attn_kernel``): q, k, v
    (B, K, N, D) → out (B, K, N, D) in q's dtype, and with ``with_stats``
    also the row statistics of its f32 scores, (2, B, K, N) f32
    (``_row_stats``, K1's units), which K5's backward reads.

    Follows the TPU kernel rounding for rounding: f32 scores from the
    operands upcast; p = exp(s − rowmax) / Σ in f32 (a division, as
    ``jax.nn.softmax``); p cast to v's dtype; out = p·v in f32, cast.  (K1
    rounds the unnormalised e and multiplies after AV; K7 rounds p with the
    running max.)"""
    m, e, r = _row_stats(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale)
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return (out, torch.cat([m, r], dim=-1).permute(3, 0, 1, 2)) if with_stats else out


def flash_attention_single_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                         dout: torch.Tensor, scale: float,
                                         stats: torch.Tensor | None = None):
    """Plain PyTorch version of K5's backward (``_attn_bwd_kernel``): (dq,
    dk, dv), each (B, K, N, D) in q's dtype, from q, k, v, out's cotangent
    and the forward's row statistics (2, B, K, N) (found again when None).

    Recompute form: p = exp(s − m)·r in f32 (the softmax, within 2 ulp of
    its division) and pb = p cast to the operand dtype; o = pb·v in f32,
    never rounded; delta = Σ_d f32(dO)·o; dv = pbᵀ·dO with dO unscaled;
    dp = dO·vᵀ; ds = p·(dp − delta)·scale with the f32 p, cast to the
    operand dtype; dq = ds·k, dk = dsᵀ·q.  Neither K2's rounding nor K7's
    (which takes delta from the rounded output)."""
    dt = q.dtype
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if stats is None:
        _, e, r = _row_stats(s)
    else:
        e = torch.exp(s - stats[0].unsqueeze(-1))
        r = stats[1].unsqueeze(-1)
    p = e * r
    pb = p.to(dt).float()
    delta = (do * torch.matmul(pb, vf)).sum(dim=-1, keepdim=True)
    dv = torch.matmul(pb.transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dt).float()
    return (torch.matmul(ds, kf).to(dt), torch.matmul(ds.transpose(-1, -2), qf).to(dt),
            dv.to(dt))


def flash_attention_stream_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     scale: float, block: int = _STREAM_BLOCK
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7's forward (``_attn_kernel_stream``): q, k,
    v (B, K, N, D) → out (B, K, N, D) in q's dtype and the row logsumexp lse
    (B, K, N) f32.

    Follows the TPU kernel rounding for rounding, over key blocks of
    ``block`` keys (JAX's 512 by default; the CUDA kernel walks 64): a
    running row max m; p = exp(s − m_new) in f32, cast to the operand dtype
    before the AV product; acc·alpha + p·v and l·alpha + Σp in f32;
    out = acc / l, cast; lse = m + log l.  (K1 instead casts e with the final
    row max and multiplies by 1/l.)  The ragged last block is short instead
    of padded with −inf columns, which is the same arithmetic."""
    dt = q.dtype
    qf = q.float()
    B, K, N, _ = q.shape
    m = torch.full((B, K, N, 1), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, N, block):
        kb = k[:, :, k0:k0 + block].float()
        vb = v[:, :, k0:k0 + block]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # a row with no valid key yet keeps m = −inf: guard −inf − −inf
        m_safe = torch.where(m_new == -torch.inf, 0.0, m_new)
        p = torch.exp(s - m_safe)
        alpha = torch.exp(m - m_safe)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(dt).float(), vb.float())
        m = m_new
    return (acc / l).to(dt), (m + torch.log(l)).squeeze(-1)


def _stream_bwd_common(q, out, dout):
    """f32 q and dO, and delta = Σ_d f32(dO)·f32(O) from the rounded forward
    output (``_flash_backward_blocked``)."""
    do = dout.float()
    return q.float(), do, (do * out.float()).sum(dim=-1, keepdim=True)


def _stream_ds(qf, kb, vb, do, lse, delta, scale, dt):
    """p = exp(s − lse) (the saved lse already normalises it) and
    ds = p·(dp − delta)·scale cast to the operand dtype, for the keys of one
    block and every query row."""
    s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(do, vb.transpose(-1, -2))
    return p, (p * (dp - delta) * scale).to(dt).float()


def flash_attention_stream_bwd_dq_reference(q, k, v, out, lse, dout, scale) -> torch.Tensor:
    """Plain PyTorch version of ``_bwd_dq_kernel``: dq (B, K, N, D) in q's
    dtype, accumulated in f32 over the 512-key blocks (dq += ds·k)."""
    qf, do, delta = _stream_bwd_common(q, out, dout)
    dq = torch.zeros_like(qf)
    for k0 in range(0, q.shape[2], _STREAM_BLOCK):
        kb = k[:, :, k0:k0 + _STREAM_BLOCK].float()
        vb = v[:, :, k0:k0 + _STREAM_BLOCK].float()
        _, ds = _stream_ds(qf, kb, vb, do, lse, delta, scale, q.dtype)
        dq = dq + torch.matmul(ds, kb)
    return dq.to(q.dtype)


def flash_attention_stream_bwd_dkdv_reference(q, k, v, out, lse, dout,
                                              scale) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``_bwd_dkv_kernel``: (dk, dv), each
    (B, K, N, D) in q's dtype.  dv = Σ bf16(p)ᵀ·dO with dO not scaled,
    dk = dsᵀ·q, both over every query row in f32."""
    qf, do, delta = _stream_bwd_common(q, out, dout)
    dks, dvs = [], []
    for k0 in range(0, q.shape[2], _STREAM_BLOCK):
        kb = k[:, :, k0:k0 + _STREAM_BLOCK].float()
        vb = v[:, :, k0:k0 + _STREAM_BLOCK].float()
        p, ds = _stream_ds(qf, kb, vb, do, lse, delta, scale, q.dtype)
        dvs.append(torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do))
        dks.append(torch.matmul(ds.transpose(-1, -2), qf))
    return torch.cat(dks, dim=2).to(q.dtype), torch.cat(dvs, dim=2).to(q.dtype)


def flash_attention_blocked_bwd_reference(q, k, v, out, lse, dout, scale):
    """Plain PyTorch version of K7's backward (``_flash_backward_blocked``):
    (dq, dk, dv) from q, k, v, the forward's out, its lse and dout, all
    (B, K, N, D) but lse (B, K, N).  Not K2's rounding: K2 rounds e and
    dO·r, this rounds the already normalised p."""
    dk, dv = flash_attention_stream_bwd_dkdv_reference(q, k, v, out, lse, dout, scale)
    return flash_attention_stream_bwd_dq_reference(q, k, v, out, lse, dout, scale), dk, dv


def _check(qkv: torch.Tensor) -> None:
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, K, D), got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv dtype must be bfloat16 or float32, got {qkv.dtype}")
    if 0 in qkv.shape:
        raise ValueError(f"qkv has an empty dimension: {tuple(qkv.shape)}")


def _check_cuda(device: torch.device, B: int, K: int, D: int, name: str,
                scale: float) -> None:
    """What every CUDA kernel here needs beyond the shape and dtype checks."""
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {device}")
    if D != _HEAD_DIM:
        raise ValueError(f"the CUDA kernels are built for head dim {_HEAD_DIM}, got D={D}")
    if not scale > 0:
        # the bf16 kernels take row maxima of the unscaled scores
        raise ValueError(f"the CUDA kernels need a positive scale, got {scale}")
    if B > _MAX_GRID_YZ or K > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or heads {K} exceed the launch grid ({_MAX_GRID_YZ})")


def _rows_16b_aligned(t: torch.Tensor) -> bool:
    """Unit head-dim stride, every row start on 16 bytes (8 bf16 elements)."""
    *outer, sd = t.stride()
    return sd == 1 and all(s % 8 == 0 for s in outer) and t.data_ptr() % 16 == 0


def _new_stats(B: int, K: int, N: int, device: torch.device, rows: int = 2) -> torch.Tensor:
    """A (rows, B, K, N) f32 tensor: the forward's row statistics (m, r), or
    with rows=1 the backward's delta scratch."""
    return torch.empty((rows, B, K, N), dtype=torch.float32, device=device)


def _check_stats(name: str, stats: torch.Tensor | None, B: int, K: int, N: int,
                 device: torch.device) -> None:
    """The forward's row statistics as a backward kernel reads them."""
    if stats is None:
        raise ValueError(f"{name}: the kernels read the forward's row statistics: pass the "
                         "stats the forward returned")
    _check_operands(name, (2, B, K, N), torch.float32, device, stats=stats)
    if not stats.is_contiguous():
        raise ValueError(f"{name}: stats must be contiguous")


def flash_attention_qkv_fwd(qkv: torch.Tensor, scale: float | None = None,
                            stats: bool = False):
    """K1: softmax attention per (batch, head) on a stacked (B, N, 3, K, D)
    qkv; returns (B, N, K, D) in qkv's dtype and, with ``stats``, also the
    row statistics (m, r) a backward reads, (2, B, K, N) f32.  scale
    defaults to D^-0.5."""
    _check(qkv)
    B, N, _, K, D = qkv.shape
    scale = D ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_reference(qkv, scale, stats)
    _check_cuda(qkv.device, B, K, D, "flash_attention_qkv", scale)
    if qkv.dtype == torch.bfloat16 and not _rows_16b_aligned(qkv):
        raise ValueError("the bf16 kernel moves 16-byte chunks: qkv needs a unit head-dim "
                         f"stride and strides that are multiples of 8, got {qkv.stride()}")
    out = torch.empty((B, N, K, D), dtype=qkv.dtype, device=qkv.device)
    row_stats = _new_stats(B, K, N, qkv.device) if stats else None
    lib = _library("flash_attention_fwd")
    err = lib.flash_attention_qkv_fwd(
        qkv.data_ptr(), out.data_ptr(), row_stats.data_ptr() if stats else None,
        _DTYPE_CODES[qkv.dtype], B, N, K, D, *qkv.stride(), *out.stride(), scale,
        torch.cuda.current_stream(qkv.device).cuda_stream, qkv.device.index)
    _raise_on(lib, err, "flash_attention_qkv_fwd")
    flash_attention_qkv.launches += 1
    return (out, row_stats) if stats else out


def flash_attention_qkv_bwd(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                            scale: float | None = None,
                            stats: torch.Tensor | None = None) -> torch.Tensor:
    """K2: the stacked gradient dqkv (B, N, 3, K, D) of K1 from the saved qkv,
    the saved output ``out`` and its cotangent ``dout`` (both (B, N, K, D))
    and the row statistics K1 returned with ``stats=True`` (2, B, K, N).  The
    kernels read the statistics and never find them again, so a CUDA call
    needs them; the plain version finds them when they are not given."""
    _check(qkv)
    B, N, _, K, D = qkv.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (B, N, K, D) or t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(f"{name} must be {(B, N, K, D)} {qkv.dtype} on {qkv.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    scale = D ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_bwd_reference(qkv, out, dout, scale, stats)
    _check_cuda(qkv.device, B, K, D, "flash_attention_qkv_bwd", scale)
    _check_stats("flash_attention_qkv_bwd", stats, B, K, N, qkv.device)
    if qkv.dtype == torch.bfloat16 and not all(map(_rows_16b_aligned, (qkv, out, dout))):
        raise ValueError("the bf16 kernel moves 16-byte chunks: qkv, out and dout need a "
                         "unit head-dim stride and strides that are multiples of 8")
    dqkv = torch.empty((B, N, 3, K, D), dtype=qkv.dtype, device=qkv.device)
    delta = _new_stats(B, K, N, qkv.device, rows=1)   # the dq kernel's, for the dk/dv kernel
    lib = _library("flash_attention_bwd")
    err = lib.flash_attention_qkv_bwd(
        qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        delta.data_ptr(), _DTYPE_CODES[qkv.dtype], B, N, K, D, *qkv.stride(), *out.stride(),
        *dout.stride(), scale, torch.cuda.current_stream(qkv.device).cuda_stream,
        qkv.device.index)
    _raise_on(lib, err, "flash_attention_qkv_bwd")
    flash_attention_qkv_bwd.launches += 1
    return dqkv


flash_attention_qkv_bwd.launches = 0


def _backward_follows(*tensors: torch.Tensor) -> bool:
    """Whether autograd will call a Function's backward: grad mode is on and
    an input requires its gradient.  Only then do the forwards write the
    row statistics."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttentionQKV(torch.autograd.Function):
    """K1 forward, saving (qkv, out, K1's row statistics); K2 backward
    returning the stacked dqkv."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, scale: float, with_stats: bool) -> torch.Tensor:
        out, stats = (flash_attention_qkv_fwd(qkv, scale, True) if with_stats
                      else (flash_attention_qkv_fwd(qkv, scale), None))
        ctx.save_for_backward(qkv, out, stats)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, out, stats = ctx.saved_tensors
        return flash_attention_qkv_bwd(qkv, out, dout.contiguous(), ctx.scale, stats), None, None


def _stream_views(qkv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v of a stacked (B, N, 3, K, D) tensor as (B, K, N, D) views."""
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _stream_qkv_fwd(qkv: torch.Tensor, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's forward on views of a stacked qkv: out (B, N, K, D) and lse."""
    out, lse = flash_attention_stream_fwd(*_stream_views(qkv), scale)
    return out.transpose(1, 2), lse


def _stream_qkv_bwd(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                    dout: torch.Tensor, scale: float) -> torch.Tensor:
    """K7's blocked backward writing the stacked dqkv (B, N, 3, K, D); out and
    dout are (B, N, K, D)."""
    dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    flash_attention_stream_bwd(*_stream_views(qkv), out.transpose(1, 2), lse,
                               dout.contiguous().transpose(1, 2), scale,
                               grads=_stream_views(dqkv))
    return dqkv


class _FlashAttentionStreamQKV(torch.autograd.Function):
    """K7 on views of a stacked qkv: the streaming forward, saving (qkv, out,
    lse); the blocked backward writing the stacked dqkv (B, N, 3, K, D)."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, scale: float) -> torch.Tensor:
        out, lse = _stream_qkv_fwd(qkv, scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, out, lse = ctx.saved_tensors
        return _stream_qkv_bwd(qkv, out, lse, dout, ctx.scale), None


def flash_attention_qkv(qkv: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Differentiable softmax attention on a stacked (B, N, 3, K, D) qkv;
    returns (B, N, K, D) in qkv's dtype.  scale defaults to D^-0.5.  Up to
    N = ``_SINGLE_BLOCK_MAX`` the forward is K1 and the backward K2; above
    it K7's streaming forward and blocked backward, on views of qkv — the
    switch of the JAX ``flash_attention_qkv_tn`` (:784) and ``_qkv_tn_bwd``
    (:823)."""
    _check(qkv)
    scale = qkv.shape[-1] ** -0.5 if scale is None else float(scale)
    if qkv.shape[1] > _SINGLE_BLOCK_MAX:
        return _FlashAttentionStreamQKV.apply(qkv, scale)
    return _FlashAttentionQKV.apply(qkv, scale, _backward_follows(qkv))


flash_attention_qkv.launches = 0


# --- K7: the streaming kernels on (B, K, N, D) operands ------------------------

def _check_operands(name: str, want: tuple, dtype: torch.dtype, device: torch.device,
                    **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        if tuple(t.shape) != want or t.dtype != dtype or t.device != device:
            raise ValueError(f"{name}: {key} must be {want} {dtype} on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str) -> None:
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, K, N, D), got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype must be bfloat16 or float32, got {q.dtype}")
    if 0 in q.shape:
        raise ValueError(f"{name}: q has an empty dimension: {tuple(q.shape)}")
    _check_operands(name, tuple(q.shape), q.dtype, q.device, k=k, v=v)


def _strides(*tensors: torch.Tensor) -> list[int]:
    return [s for t in tensors for s in t.stride()]


def _stream_cuda(name: str, scale: float, *tensors: torch.Tensor) -> None:
    """What K7's kernels need on the card: ``_check_cuda``, and for bf16
    16-byte rows (unit head-dim stride, strides in multiples of 8)."""
    B, K, _, D = tensors[0].shape
    _check_cuda(tensors[0].device, B, K, D, name, scale)
    if tensors[0].dtype == torch.bfloat16 and not all(map(_rows_16b_aligned, tensors)):
        raise ValueError(f"{name}: the bf16 kernels move 16-byte chunks: every operand "
                         "needs a unit head-dim stride and strides that are multiples of 8, "
                         f"got {[t.stride() for t in tensors]}")


def flash_attention_stream_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's forward: q, k, v (B, K, N, D), any strides → (out, lse).  out is
    (B, K, N, D) in q's dtype, a view of a contiguous (B, N, K, D) tensor
    (the output projection's input layout); lse is (B, K, N) f32.  One pass
    over the keys with an online softmax (``csrc/flash_attention_stream.cu``)."""
    _check_stream(q, k, v, "flash_attention_stream_fwd")
    B, K, N, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_stream_reference(q, k, v, scale)
    _stream_cuda("flash_attention_stream_fwd", scale, q, k, v)
    out = torch.empty((B, N, K, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, K, N), dtype=torch.float32, device=q.device)
    lib = _library("flash_attention_stream")
    err = lib.flash_attention_stream_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODES[q.dtype], B, N, K, D, *_strides(q, k, v, out), scale,
        torch.cuda.current_stream(q.device).cuda_stream, q.device.index)
    _raise_on(lib, err, "flash_attention_stream_fwd")
    flash_attention_stream_fwd.launches += 1
    return out, lse


flash_attention_stream_fwd.launches = 0


def flash_attention_stream_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                               scale: float | None = None,
                               grads: tuple[torch.Tensor, ...] | None = None):
    """K7's backward: (dq, dk, dv) from q, k, v, the forward's out and lse
    and out's cotangent dout, all (B, K, N, D) of any strides but lse
    (B, K, N) f32 contiguous.  ``grads``: three (B, K, N, D) tensors to write
    dq, dk, dv into (views of a stacked dqkv, say); by default they are made.

    Two kernels (``csrc/flash_attention_bwd.cu``: K2's, with the saved
    output, under K5's rounding rule, reading lse as the row max with r ≡ 1):
    the dq kernel, one block per query tile, which also writes delta =
    Σ_d dO·O to a (B, K, N) scratch; then the dk/dv kernel, one block per
    key tile, which reads it."""
    name = "flash_attention_stream_bwd"
    _check_stream(q, k, v, name)
    B, K, N, D = q.shape
    _check_operands(name, (B, K, N, D), q.dtype, q.device, out=out, dout=dout)
    _check_operands(name, (B, K, N), torch.float32, q.device, lse=lse)
    if grads is not None:
        _check_operands(name, (B, K, N, D), q.dtype, q.device,
                        **dict(zip(("dq", "dk", "dv"), grads)))
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        result = flash_attention_blocked_bwd_reference(q, k, v, out, lse, dout, scale)
        if grads is None:
            return result
        for dst, src in zip(grads, result):
            dst.copy_(src)
        return tuple(grads)
    if grads is None:
        grads = tuple(torch.empty((B, N, K, D), dtype=q.dtype, device=q.device).transpose(1, 2)
                      for _ in range(3))
    _stream_cuda(name, scale, q, k, v, out, dout, *grads)
    if not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be contiguous")
    delta = torch.empty((B, K, N), dtype=torch.float32, device=q.device)
    dq, dk, dv = grads
    lib = _library("flash_attention_bwd")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODES[q.dtype], B, N, K, D, *_strides(q, k, v, out, dout, dq, dk, dv),
            scale, torch.cuda.current_stream(q.device).cuda_stream, q.device.index)
    _raise_on(lib, lib.flash_attention_stream_bwd_dq(*args), f"{name} (dq)")
    flash_attention_stream_bwd.dq_launches += 1
    _raise_on(lib, lib.flash_attention_stream_bwd_dkdv(*args), f"{name} (dk/dv)")
    flash_attention_stream_bwd.dkdv_launches += 1
    return dq, dk, dv


flash_attention_stream_bwd.dq_launches = 0
flash_attention_stream_bwd.dkdv_launches = 0


class _FlashAttentionStream(torch.autograd.Function):
    """K7 forward saving (q, k, v, out, lse); K7 backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = flash_attention_stream_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        # a cotangent of another layout (the transposed one flash_attention_tn
        # passes on) is copied to the unit head-dim stride the kernels need
        return (*flash_attention_stream_bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale),
                None)


# --- K5: the single-block kernels of the public op, N ≤ 1040 -------------------

def flash_attention_single_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float | None = None, stats: bool = False):
    """K5's forward: q, k, v (B, K, N, D), any strides → out (B, K, N, D) in
    q's dtype, a view of a contiguous (B, N, K, D) tensor (the output
    projection's input layout), and with ``stats`` also the row statistics
    (m, r) its backward reads, (2, B, K, N) f32.  K1's kernel under K5's
    rounding rule (``csrc/flash_attention_fwd.cu``): two passes over the
    keys, the first keeping each row's max and sum, the second rounding
    p = e·r before p·v."""
    name = "flash_attention_single_fwd"
    _check_stream(q, k, v, name)
    B, K, N, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_single_reference(q, k, v, scale, stats)
    _stream_cuda(name, scale, q, k, v)
    out = torch.empty((B, N, K, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    row_stats = _new_stats(B, K, N, q.device) if stats else None
    lib = _library("flash_attention_fwd")
    err = lib.flash_attention_single_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        row_stats.data_ptr() if stats else None, _DTYPE_CODES[q.dtype], B, N, K, D,
        *_strides(q, k, v, out), scale, torch.cuda.current_stream(q.device).cuda_stream,
        q.device.index)
    _raise_on(lib, err, name)
    flash_attention_single_fwd.launches += 1
    return (out, row_stats) if stats else out


flash_attention_single_fwd.launches = 0


def flash_attention_single_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               dout: torch.Tensor, scale: float | None = None,
                               stats: torch.Tensor | None = None):
    """K5's backward: (dq, dk, dv), each (B, K, N, D) in q's dtype (views of
    contiguous (B, N, K, D) tensors on the card), from q, k, v and out's
    cotangent dout, all (B, K, N, D) of any strides, and the row statistics
    K5's forward returned with ``stats=True`` (2, B, K, N).  p and o are
    recomputed from them; the kernels never find them again, so a CUDA call
    needs them, and the plain version finds them when they are not given.

    Two kernels (``csrc/flash_attention_bwd.cu``, K6's under K5's rounding
    rule): the dq kernel, one block per query tile, which writes delta to a
    (B, K, N) scratch; then the dk/dv kernel, one block per key tile, which
    reads it."""
    name = "flash_attention_single_bwd"
    _check_stream(q, k, v, name)
    B, K, N, D = q.shape
    _check_operands(name, (B, K, N, D), q.dtype, q.device, dout=dout)
    if stats is not None:
        _check_operands(name, (2, B, K, N), torch.float32, q.device, stats=stats)
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_single_bwd_reference(q, k, v, dout, scale, stats)
    _check_stats(name, stats, B, K, N, q.device)
    _stream_cuda(name, scale, q, k, v, dout)
    grads = tuple(torch.empty((B, N, K, D), dtype=q.dtype, device=q.device).transpose(1, 2)
                  for _ in range(3))
    delta = _new_stats(B, K, N, q.device, rows=1)   # the dq kernel's, for the dk/dv kernel
    dq, dk, dv = grads
    lib = _library("flash_attention_bwd")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODES[q.dtype], B, N, K, D, *_strides(q, k, v, dout, dq, dk, dv), scale,
            torch.cuda.current_stream(q.device).cuda_stream, q.device.index)
    _raise_on(lib, lib.flash_attention_single_bwd_dq(*args), f"{name} (dq)")
    flash_attention_single_bwd.dq_launches += 1
    _raise_on(lib, lib.flash_attention_single_bwd_dkdv(*args), f"{name} (dk/dv)")
    flash_attention_single_bwd.dkdv_launches += 1
    return dq, dk, dv


flash_attention_single_bwd.dq_launches = 0
flash_attention_single_bwd.dkdv_launches = 0


class _FlashAttentionSingle(torch.autograd.Function):
    """K5 forward saving (q, k, v), as the JAX ``_fwd`` at short N, and its
    row statistics; K5's recompute-form backward on them."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, with_stats: bool):
        out, stats = (flash_attention_single_fwd(q, k, v, scale, True) if with_stats
                      else (flash_attention_single_fwd(q, k, v, scale), None))
        ctx.save_for_backward(q, k, v, stats)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, stats = ctx.saved_tensors
        return (*flash_attention_single_bwd(q, k, v, dout.contiguous(), ctx.scale, stats),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Differentiable softmax attention on (B, K, N, D) q, k, v of any
    strides (the JAX public ``flash_attention``); returns (B, K, N, D).  Up to
    N = ``_SINGLE_BLOCK_MAX`` the forward is K5 and the backward K5's
    recompute-form kernels; above it K7's streaming forward and blocked
    backward — the switch of the JAX ``_fwd`` (:1084) and ``_bwd`` (:1103),
    on CPU and CUDA tensors alike."""
    _check_stream(q, k, v, "flash_attention")
    N, D = q.shape[2:]
    scale = D ** -0.5 if scale is None else float(scale)
    if N <= _SINGLE_BLOCK_MAX:
        return _FlashAttentionSingle.apply(q, k, v, scale, _backward_follows(q, k, v))
    return _FlashAttentionStream.apply(q, k, v, scale)


# --- K6: the public "tn" op on (B, K, D, N) operands, N ≤ 1040 -------------

def _nd(t: torch.Tensor) -> torch.Tensor:
    """A (B, K, D, N) operand as the (B, K, N, D) view the kernels index."""
    return t.transpose(-1, -2)


def flash_attention_tn_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: float, with_stats: bool = False):
    """Plain PyTorch version of K6's forward (``_attn_kernel_tn``): q, k, v
    (B, K, D, N) → out (B, K, D, N) in q's dtype, and with ``with_stats``
    the row statistics (2, B, K, N) (``_row_stats``).  K1's arithmetic
    (``_tn_fwd_math``) on three separate operands: f32 scores, e = exp(s −
    rowmax) cast to the operand dtype before AV, out = (e·v)·(1/Σe) in f32,
    then cast."""
    qn, kn, vn = (_nd(t).float() for t in (q, k, v))
    m, e, r = _row_stats(torch.matmul(qn, kn.transpose(-1, -2)) * scale)
    out = _nd((torch.matmul(e.to(q.dtype).float(), vn) * r).to(q.dtype))
    return (out, torch.cat([m, r], dim=-1).permute(3, 0, 1, 2)) if with_stats else out


def flash_attention_tn_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     dout: torch.Tensor, scale: float,
                                     stats: torch.Tensor | None = None):
    """Plain PyTorch version of K6's backward (``_attn_bwd_kernel_tn``):
    (dq, dk, dv), each (B, K, D, N) in q's dtype, from q, k, v and out's
    cotangent, all (B, K, D, N), and the forward's row statistics (found
    again when None): ``_tn_bwd_math`` with o=None — o = (eb·v)·r
    recomputed in f32 and never rounded, delta = Σ_d f32(dO)·o.  Neither K2's
    rounding (delta from the saved, rounded output) nor K5's (p divided before
    it is rounded, dv = bf16(p)ᵀ·dO)."""
    grads = _tn_bwd_math(*(_nd(t).float() for t in (q, k, v, dout)), scale, q.dtype, None, stats)
    return tuple(_nd(t.to(q.dtype)) for t in grads)


def _check_tn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str) -> None:
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, K, D, N), got {tuple(q.shape)}")
    _check_stream(q, k, v, name)


def _kernel_views(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """(B, K, D, N) operands as the (B, K, N, D) views the kernels index.  The
    bf16 kernels copy 16-byte chunks: an operand without a unit head-dim
    stride and 16-byte rows (a contiguous (B, K, D, N) tensor, contiguous
    along N) becomes a contiguous (B, K, N, D) copy."""
    views = [_nd(t) for t in tensors]
    if tensors[0].dtype != torch.bfloat16:
        return views
    return [t if _rows_16b_aligned(t) else t.contiguous() for t in views]


def _new_tn(q: torch.Tensor) -> torch.Tensor:
    """An output for (B, K, D, N) operands: a view of a contiguous (B, K, N, D)
    tensor, whose unit head-dim stride the kernels' row stores need."""
    B, K, D, N = q.shape
    return _nd(torch.empty((B, K, N, D), dtype=q.dtype, device=q.device))


def flash_attention_tn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float | None = None, stats: bool = False):
    """K6's forward: q, k, v (B, K, D, N) of any strides, N ≤ 1040 → out
    (B, K, D, N) in q's dtype, a view of a contiguous (B, K, N, D) tensor,
    and with ``stats`` the row statistics (2, B, K, N) its backward reads.
    K1's kernel on three operands (``csrc/flash_attention_fwd.cu``); bf16
    operands without 16-byte rows are copied (``_kernel_views``)."""
    name = "flash_attention_tn_fwd"
    _check_tn(q, k, v, name)
    B, K, D, N = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_tn_reference(q, k, v, scale, stats)
    _check_cuda(q.device, B, K, D, name, scale)
    out = _new_tn(q)
    row_stats = _new_stats(B, K, N, q.device) if stats else None
    ops = _kernel_views(q, k, v)
    lib = _library("flash_attention_fwd")
    err = lib.flash_attention_tn_fwd(
        *(t.data_ptr() for t in ops), out.data_ptr(), row_stats.data_ptr() if stats else None,
        _DTYPE_CODES[q.dtype], B, N, K, D, *_strides(*ops, _nd(out)), scale,
        torch.cuda.current_stream(q.device).cuda_stream, q.device.index)
    _raise_on(lib, err, name)
    flash_attention_tn_fwd.launches += 1
    return (out, row_stats) if stats else out


flash_attention_tn_fwd.launches = 0


def flash_attention_tn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, scale: float | None = None,
                           stats: torch.Tensor | None = None):
    """K6's backward: (dq, dk, dv), each (B, K, D, N) in q's dtype (views of
    contiguous (B, K, N, D) tensors on the card), from q, k, v and out's
    cotangent, all (B, K, D, N) of any strides, and the row statistics K6's
    forward returned with ``stats=True`` (needed on the card).  Two kernels
    (``csrc/flash_attention_bwd.cu``, K2's with o recomputed): the dq
    kernel, one block per query tile, which writes delta to a (B, K, N)
    scratch; then the dk/dv kernel, one block per key tile, which reads it."""
    name = "flash_attention_tn_bwd"
    _check_tn(q, k, v, name)
    B, K, D, N = q.shape
    _check_operands(name, (B, K, D, N), q.dtype, q.device, dout=dout)
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_tn_bwd_reference(q, k, v, dout, scale, stats)
    _check_cuda(q.device, B, K, D, name, scale)
    _check_stats(name, stats, B, K, N, q.device)
    dq, dk, dv = (_new_tn(q) for _ in range(3))
    delta = _new_stats(B, K, N, q.device, rows=1)
    ops = _kernel_views(q, k, v, dout)
    lib = _library("flash_attention_bwd")
    args = (*(t.data_ptr() for t in ops), stats.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype], B, N, K, D,
            *_strides(*ops, *map(_nd, (dq, dk, dv))), scale,
            torch.cuda.current_stream(q.device).cuda_stream, q.device.index)
    _raise_on(lib, lib.flash_attention_tn_bwd_dq(*args), f"{name} (dq)")
    flash_attention_tn_bwd.dq_launches += 1
    _raise_on(lib, lib.flash_attention_tn_bwd_dkdv(*args), f"{name} (dk/dv)")
    flash_attention_tn_bwd.dkdv_launches += 1
    return dq, dk, dv


flash_attention_tn_bwd.dq_launches = 0
flash_attention_tn_bwd.dkdv_launches = 0


class _FlashAttentionTN(torch.autograd.Function):
    """K6 forward saving (q, k, v) and its row statistics (the JAX ``_tn_fwd``
    saves q, k, v); K6's backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, with_stats: bool):
        out, stats = (flash_attention_tn_fwd(q, k, v, scale, True) if with_stats
                      else (flash_attention_tn_fwd(q, k, v, scale), None))
        ctx.save_for_backward(q, k, v, stats)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, stats = ctx.saved_tensors
        return (*flash_attention_tn_bwd(q, k, v, dout, ctx.scale, stats), None, None)


def flash_attention_tn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float | None = None) -> torch.Tensor:
    """Differentiable softmax attention on TRANSPOSED (B, K, D, N) q, k, v of
    any strides (the JAX public ``flash_attention_tn``); returns (B, K, D, N).
    Up to N = ``_SINGLE_BLOCK_MAX`` the forward is K6 and the backward K6's
    two kernels, with no layout copy; above it the public
    ``flash_attention`` (K7) on (B, K, N, D) copies, transposed back — the
    switch of the JAX ``flash_attention_tn`` (:1038) and ``_tn_bwd`` (:1052),
    which transposes there too."""
    _check_tn(q, k, v, "flash_attention_tn")
    D, N = q.shape[2:]
    scale = D ** -0.5 if scale is None else float(scale)
    if N <= _SINGLE_BLOCK_MAX:
        return _FlashAttentionTN.apply(q, k, v, scale, _backward_follows(q, k, v))
    return _nd(flash_attention(*(_nd(t).contiguous() for t in (q, k, v)), scale))


def _raise_on(lib: ctypes.CDLL, err: int, fn: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


_ARGTYPES = {
    # K1: qkv, out, stats (or null), dtype, B, N, K, D, 5 qkv strides, 4 out
    # strides, scale, stream, device; K6 and K5: q, k, v, out, stats, dtype,
    # B, N, K, D, 4 strides each of q, k, v, out, scale, stream, device
    "flash_attention_fwd": {"flash_attention_qkv_fwd":
                            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                            + [ctypes.c_longlong] * 9
                            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int],
                            **{fn: [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                               + [ctypes.c_longlong] * 16
                               + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
                               for fn in ("flash_attention_tn_fwd",
                                          "flash_attention_single_fwd")}},
    # qkv, out, dout, dqkv, stats, delta, dtype, B, N, K, D, 5 qkv, 4 out, 4
    # dout strides, scale, stream, device
    # K6's and K5's two kernels: q, k, v, dout, stats, delta, dq, dk, dv,
    # dtype, B, N, K, D, 4 strides each of q, k, v, dout, dq, dk, dv, scale,
    # stream, device
    # K7's two kernels: q, k, v, out, dout, lse, delta, dq, dk, dv, dtype, B,
    # N, K, D, 4 strides each of q, k, v, out, dout, dq, dk, dv, scale,
    # stream, device
    "flash_attention_bwd": {"flash_attention_qkv_bwd":
                            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                            + [ctypes.c_longlong] * 13
                            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int],
                            **{fn: [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                               + [ctypes.c_longlong] * 28
                               + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
                               for fn in ("flash_attention_tn_bwd_dq",
                                          "flash_attention_tn_bwd_dkdv",
                                          "flash_attention_single_bwd_dq",
                                          "flash_attention_single_bwd_dkdv")},
                            **{fn: [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                               + [ctypes.c_longlong] * 32
                               + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
                               for fn in ("flash_attention_stream_bwd_dq",
                                          "flash_attention_stream_bwd_dkdv")}},
    # q, k, v, out, lse, dtype, B, N, K, D, 4 strides each of q, k, v, out,
    # scale, stream, device
    "flash_attention_stream": {"flash_attention_stream_fwd":
                               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                               + [ctypes.c_longlong] * 16
                               + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]},
    # K8: its dq and dk/dv kernels take K2's arguments without the dtype;
    # dx: dqkv, w, dx, M, H, J, 2 w strides, stream, device; dW: x, dqkv, dW,
    # M, H, J, x's row stride, stream, device
    "fused_qkv_bwd": {
        **{fn: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 13
           + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
           for fn in ("fused_qkv_bwd_dq", "fused_qkv_bwd_dkdv")},
        "fused_qkv_bwd_dx": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p, ctypes.c_int],
        "fused_qkv_bwd_dw": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]},
}


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    if lib.flash_attention_error_string.restype is not ctypes.c_char_p:
        for fn_name, argtypes in _ARGTYPES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


# --- K8: the fused QKV projection + attention backward ----------------------

# The JAX package's switch (kernels/flash_attention.py:982), same default and
# same gate: with it on, the backward of fused_qkv_attention runs K8 when the
# operands are bf16, N ≤ 1040 and D % 8 == 0; otherwise K2 (K7) and two plain
# GEMMs.  The JAX package measured the fused kernel slower on its TPU and
# left it off; the port keeps the default and measures its own in PERF.md.
FUSED_QKV_GRADS = False


def _qkv_matrices(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x as a (B·N, H) matrix and w, cast to x's dtype, as an (H, 3·K·D) one
    (views where the strides allow)."""
    return x.reshape(-1, x.shape[-1]), w.to(x.dtype).reshape(w.shape[0], -1)


def _qkv_grads_plain(x: torch.Tensor, w: torch.Tensor, dqkv: torch.Tensor):
    """The two contractions of the unfused rule on a (B, N, 3, K, D) dqkv in
    x's dtype: dx = dqkv·Wᵀ cast to x's dtype, dW = xᵀ·dqkv cast to w's dtype,
    both accumulated in f32 (a product of two bf16 operands accumulates in f32
    and rounds once; an f32 result takes the f32 product of the upcast
    operands)."""
    x2, w2 = _qkv_matrices(x, w)
    d2 = dqkv.reshape(x2.shape[0], -1)
    dx = torch.matmul(d2, w2.t()).view(x.shape)
    if w.dtype == x.dtype:
        dw = torch.matmul(x2.t(), d2)
    else:
        dw = torch.matmul(x2.t().float(), d2.float()).to(w.dtype)
    return dx, dw.view(w.shape)


def fused_qkv_products_reference(x: torch.Tensor, w: torch.Tensor, dqkv: torch.Tensor):
    """Plain PyTorch version of K8's two products on a given (B, N, 3, K, D)
    dqkv: dx = dqkv·Wᵀ (B, N, H) cast once to x's dtype, and dW = xᵀ·dqkv
    (H, 3, K, D) in f32, as the kernel writes it (``fused_qkv_bwd`` casts it
    to w's dtype); both are f32 products of the upcast operands."""
    x2, w2 = (t.float() for t in _qkv_matrices(x, w))
    d2 = dqkv.float().reshape(x2.shape[0], -1)
    return (torch.matmul(d2, w2.t()).to(x.dtype).view(x.shape),
            torch.matmul(x2.t(), d2).view(w.shape))


def fused_qkv_bwd_reference(x: torch.Tensor, w: torch.Tensor, qkv: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor, scale: float,
                            stats: torch.Tensor | None = None):
    """Plain PyTorch version of K8 (``_fused_qkv_bwd``): (dx (B, N, H) in x's
    dtype, dW (H, 3, K, D) in w's dtype) from x, w, the saved qkv
    (B, N, 3, K, D) and output (B, N, K, D) and the output's cotangent.  K2's
    plain version gives dq, dk, dv rounded to the operand dtype (``dsb``);
    ``fused_qkv_products_reference`` gives dx = Σ dqkv·Wᵀ and dW = Σ xᵀ·dqkv
    from them in f32, each cast once.  ``stats``: K1's row statistics, found
    again when None."""
    dqkv = flash_attention_qkv_bwd_reference(qkv, out, dout, scale, stats)
    dx, dw = fused_qkv_products_reference(x, w, dqkv)
    return dx, dw.to(w.dtype)


def fused_qkv_products(x: torch.Tensor, w: torch.Tensor, dqkv: torch.Tensor):
    """K8's kernels 3 and 4 alone on a given dqkv: (dx (B, N, H) bf16,
    dW (H, 3, K, D) f32) from x (B, N, H), w (H, 3, K, D) and dqkv
    (B, N, 3, K, D), x and dqkv bf16 — ``fused_qkv_bwd``'s products, callable on
    the dqkv bits of another kernel so that they can be held against
    ``fused_qkv_products_reference`` on the same input.  They count in
    ``fused_qkv_bwd.dx_launches`` and ``.dw_launches``."""
    B, N, H = x.shape
    _, _, K, D = w.shape
    if tuple(w.shape[:2]) != (H, 3) or tuple(dqkv.shape) != (B, N, 3, K, D):
        raise ValueError(f"fused_qkv_products: x (B, N, H), w (H, 3, K, D) and dqkv "
                         f"(B, N, 3, K, D) disagree: {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(dqkv.shape)}")
    if x.device.type == "cpu":
        return fused_qkv_products_reference(x, w, dqkv)
    return _qkv_products_cuda(x, w, dqkv.contiguous())


def _qkv_products_cuda(x: torch.Tensor, w: torch.Tensor, dqkv: torch.Tensor):
    """Kernels 3 and 4 on a contiguous bf16 dqkv and bf16 x; w is cast to
    bf16.  Copies x or w only where their strides are not the kernels'."""
    if not x.dtype == dqkv.dtype == torch.bfloat16:
        raise ValueError(f"fused_qkv_bwd's products run bf16 x and dqkv, got {x.dtype} and "
                         f"{dqkv.dtype}")
    B, N, H = x.shape
    J = w[0].numel()
    x2, w2 = _qkv_matrices(x, w)
    if x2.stride(1) != 1 or not _rows_16b_aligned(x2):
        x2 = x2.contiguous()
    if 1 not in w2.stride() or not all(s % 8 == 0 for s in w2.stride() if s != 1) \
            or w2.data_ptr() % 16:
        w2 = w2.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dx = torch.empty((B, N, H), dtype=x.dtype, device=x.device)
    dw = torch.empty((H, J), dtype=torch.float32, device=x.device)
    lib = _library("fused_qkv_bwd")
    _raise_on(lib, lib.fused_qkv_bwd_dx(dqkv.data_ptr(), w2.data_ptr(), dx.data_ptr(), B * N, H,
                                        J, *w2.stride(), stream, x.device.index),
              "fused_qkv_bwd (dx)")
    fused_qkv_bwd.dx_launches += 1
    _raise_on(lib, lib.fused_qkv_bwd_dw(x2.data_ptr(), dqkv.data_ptr(), dw.data_ptr(), B * N, H,
                                        J, x2.stride(0), stream, x.device.index),
              "fused_qkv_bwd (dW)")
    fused_qkv_bwd.dw_launches += 1
    return dx, dw.view(w.shape)


def fused_qkv_bwd(x: torch.Tensor, w: torch.Tensor, qkv: torch.Tensor, out: torch.Tensor,
                  dout: torch.Tensor, scale: float | None = None,
                  stats: torch.Tensor | None = None):
    """K8: (dx, dW) of fused_qkv_attention from x (B, N, H), w (H, 3, K, D),
    the saved qkv (B, N, 3, K, D) and output (B, N, K, D), the output's
    cotangent (B, N, K, D) and K1's row statistics (2, B, K, N; needed on the
    card).  bf16 only, N ≤ 1040.

    Four kernels (``csrc/fused_qkv_bwd.cu``): K2's dq and dk/dv kernels,
    which write dq, dk, dv rounded to bf16 into a (B, N, 3, K, D) scratch,
    then the products dx = dqkv·Wᵀ (bf16, f32 accumulation) and
    dW = xᵀ·dqkv (f32), each output tile summed by one block in a fixed
    order: two identical calls give identical bits.  dW is returned in w's
    dtype.  Counts: ``launches`` per call and ``dq_launches``,
    ``dkdv_launches``, ``dx_launches``, ``dw_launches`` per kernel."""
    name = "fused_qkv_bwd"
    _check(qkv)
    B, N, _, K, D = qkv.shape
    H = x.shape[-1]
    if tuple(x.shape) != (B, N, H) or tuple(w.shape) != (H, 3, K, D):
        raise ValueError(f"{name}: x must be {(B, N, H)} and w {(H, 3, K, D)}, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    _check_operands(name, (B, N, K, D), qkv.dtype, qkv.device, out=out, dout=dout)
    scale = D ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return fused_qkv_bwd_reference(x, w, qkv, out, dout, scale, stats)
    if qkv.dtype != torch.bfloat16 or x.dtype != torch.bfloat16 or N > _SINGLE_BLOCK_MAX:
        raise ValueError(f"{name} runs bf16 operands at N <= {_SINGLE_BLOCK_MAX}, "
                         f"got {qkv.dtype} x {x.dtype}, N={N}")
    _check_cuda(qkv.device, B, K, D, name, scale)
    _check_stats(name, stats, B, K, N, qkv.device)
    if not all(map(_rows_16b_aligned, (qkv, out, dout))):
        raise ValueError(f"{name}: qkv, out and dout need a unit head-dim stride and strides "
                         "that are multiples of 8")
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    dqkv = torch.empty((B, N, 3, K, D), dtype=qkv.dtype, device=qkv.device)
    delta = _new_stats(B, K, N, qkv.device, rows=1)
    lib = _library("fused_qkv_bwd")
    args = (qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            delta.data_ptr(), B, N, K, D, *qkv.stride(), *out.stride(), *dout.stride(), scale,
            stream, qkv.device.index)
    _raise_on(lib, lib.fused_qkv_bwd_dq(*args), f"{name} (dq)")
    fused_qkv_bwd.dq_launches += 1
    _raise_on(lib, lib.fused_qkv_bwd_dkdv(*args), f"{name} (dk/dv)")
    fused_qkv_bwd.dkdv_launches += 1
    dx, dw = _qkv_products_cuda(x, w, dqkv)
    fused_qkv_bwd.launches += 1
    return dx, dw.to(w.dtype)


fused_qkv_bwd.launches = 0
fused_qkv_bwd.dq_launches = 0
fused_qkv_bwd.dkdv_launches = 0
fused_qkv_bwd.dx_launches = 0
fused_qkv_bwd.dw_launches = 0


def _use_fused_grads(qkv: torch.Tensor) -> bool:
    """The JAX rule's gate (``_fused_qkv_bwd_rule``, :1011-1013)."""
    return (FUSED_QKV_GRADS and qkv.dtype == torch.bfloat16
            and qkv.shape[1] <= _SINGLE_BLOCK_MAX and qkv.shape[-1] % 8 == 0)


class _FusedQKVAttention(torch.autograd.Function):
    """The JAX ``fused_qkv_attention`` custom VJP: the forward is the QKV
    projection, then K1 (K7 above ``_SINGLE_BLOCK_MAX``), saving
    (x, w, qkv, out) and K1's row statistics (K7's logsumexp) — the slot of
    JAX's lse, None at short N; the backward follows ``_fused_qkv_bwd_rule``
    and hands them to K2 or K8 (K7)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, with_stats: bool):
        B, N, H = x.shape
        _, _, K, D = w.shape
        x2, w2 = _qkv_matrices(x, w)
        qkv = torch.matmul(x2, w2).view(B, N, 3, K, D)
        scale = D ** -0.5
        if N > _SINGLE_BLOCK_MAX:
            out, stats = _stream_qkv_fwd(qkv, scale)   # (B, N, K, D), lse
        elif with_stats:
            out, stats = flash_attention_qkv_fwd(qkv, scale, True)
        else:
            out, stats = flash_attention_qkv_fwd(qkv, scale), None
        ctx.save_for_backward(x, w, qkv, out, stats)
        ctx.scale = scale
        return out.permute(0, 2, 3, 1)                # (B, K, D, N)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w, qkv, out, stats = ctx.saved_tensors
        dout = g.permute(0, 3, 1, 2).contiguous()     # (B, N, K, D)
        if _use_fused_grads(qkv):
            return (*fused_qkv_bwd(x, w, qkv, out, dout, ctx.scale, stats), None)
        if qkv.shape[1] <= _SINGLE_BLOCK_MAX:
            dqkv = flash_attention_qkv_bwd(qkv, out, dout, ctx.scale, stats)
        else:
            dqkv = _stream_qkv_bwd(qkv, out, stats, dout, ctx.scale)
        return (*_qkv_grads_plain(x, w, dqkv), None)


def fused_qkv_attention(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """QKV projection + fused SDPA: (B, N, H) x, (H, 3, K, D) w → (B, K, D, N).

    Same signature, value and backward rule as the JAX
    ``fused_qkv_attention``.  The result is a permuted view of the kernel's
    (B, N, K, D) output: permute it back (``out.permute(0, 3, 1, 2)``) to feed
    the output projection without a copy.  w is cast to x's dtype inside.
    Backward: with ``FUSED_QKV_GRADS`` on, bf16 and N ≤ 1040, K8
    (``fused_qkv_bwd``); otherwise K2 (K7 above ``_SINGLE_BLOCK_MAX``) for
    dqkv, then dx = dqkv·Wᵀ and dW = xᵀ·dqkv as plain GEMMs, f32 accumulation,
    cast to x's and w's dtypes (``kernels/flash_attention.py:1016-1023``)."""
    return _FusedQKVAttention.apply(x, w, _backward_follows(x, w))
