"""The port's ring attention (``cross_attention_vit_tpu_torch/parallel/ring.py``)
against the JAX package's ``parallel/ring.py`` — the counterpart of
``tests/test_ring.py`` — over gloo ranks (``tests/torch_mesh_workers.py``):
a 'seq' line of 2 and of 4 ranks, and (data 2 × seq 2).

Forward and gradients (the port's backward ring, which JAX derives by AD)
within 1e-5 of the dense attention and of JAX's ring on its 8 virtual CPU
devices (f32); bf16 operands keep f32 statistics; at one rank the ring is
``_sdpa`` unless forced; the mesh puts the axes in JAX's order.
``test_ring_composes_with_head_sharded_tp`` has no counterpart: tensor
parallelism is ROADMAP Queue 1 item 13.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.parallel import make_mesh as jax_mesh
from cross_attention_vit_tpu.parallel import ring_sdpa as jax_ring_sdpa
from cross_attention_vit_tpu_torch.ops.attention import _sdpa
from cross_attention_vit_tpu_torch.parallel import ring_attention
from torch_mesh_workers import load, ring_inputs, spawn

TOL = 1e-5


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    for world in (2, 4):
        spawn("ring", tmp, world)
    return tmp, {w: load(tmp, f"ring_w{w}", w) for w in (2, 4)}


def _dense(qkv, scale=None):
    q, k, v = (torch.from_numpy(a) for a in qkv)
    return _sdpa(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)


def _dense_grads(qkv, fn=None):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv)
    out = fn(q, k, v) if fn else _sdpa(q, k, v, q.shape[-1] ** -0.5)
    torch.tanh(out).sum().backward()
    return np.stack([q.grad.numpy(), k.grad.numpy(), v.grad.numpy()])


@pytest.mark.parametrize("seq", [2, 4])
def test_ring_matches_dense_forward(rings, seq):
    """Every rank of the line holds the whole output: the dense attention's,
    and JAX's ring's over (data 8/seq, seq)."""
    qkv = ring_inputs()
    want = _dense(qkv).numpy()
    jax_out = np.asarray(jax_ring_sdpa(jax_mesh(data=8 // seq, seq=seq), "seq")(
        *(jnp.asarray(a) for a in qkv)))
    for got in rings[1][seq]:
        np.testing.assert_allclose(got["fwd"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got["fwd"], jax_out, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mesh", ["seq2", "seq4", "data2_seq2"])
def test_ring_matches_dense_gradient(rings, mesh):
    """dq, dk, dv of Σ tanh(ring(q, k, v)) on every rank: the dense
    attention's and JAX's (AD through its ring over (data 2, seq 4))."""
    qkv = ring_inputs(n=32, heads=2, d=8)
    want = _dense_grads(qkv)

    def jloss(q, k, v):
        return jnp.sum(jnp.tanh(jax_ring_sdpa(jax_mesh(data=2, seq=4), "seq")(q, k, v)))

    jgrads = np.stack(jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in qkv)))
    ranks, key = {"seq2": (rings[1][2], "grad"), "seq4": (rings[1][4], "grad"),
                  "data2_seq2": (rings[1][4], "grad_data2_seq2")}[mesh]
    for got in ranks:
        np.testing.assert_allclose(got[key], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[key], jgrads, atol=TOL, rtol=TOL)


def test_ring_bf16_inputs_f32_statistics(rings):
    """bf16 operands, f32 softmax statistics: close to the dense bf16
    attention (the tolerance of the JAX test) and to JAX's ring."""
    qkv = ring_inputs()
    bf = [torch.from_numpy(a).bfloat16() for a in qkv]
    want = _sdpa(*bf, qkv.shape[-1] ** -0.5).float().numpy()
    jax_out = np.asarray(jax_ring_sdpa(jax_mesh(data=1, seq=8), "seq")(
        *(jnp.asarray(a, jnp.bfloat16) for a in qkv)), np.float32)
    for got in rings[1][4]:
        np.testing.assert_allclose(got["fwd_bf16"], want, atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(got["fwd_bf16"], jax_out, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("seq", [2, 4])
def test_ring_attention_per_rank_slices(rings, seq):
    """The per-rank body on each rank's slice of the sequence returns that
    slice's rows of the dense attention."""
    qkv = ring_inputs()
    want = _dense(qkv).numpy()
    n = want.shape[2] // seq
    for r, got in enumerate(rings[1][seq]):
        np.testing.assert_allclose(got["local"], want[:, :, r * n:(r + 1) * n], atol=TOL,
                                   rtol=TOL)


def test_ring_attention_axis_size_one_is_dense():
    """Alone the ring is ``_sdpa`` bit for bit; forced, its own arithmetic
    and backward give the dense values (and JAX's forced ring's)."""
    qkv = ring_inputs(n=16, heads=2, d=8)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    scale = 8 ** -0.5
    torch.testing.assert_close(ring_attention(q, k, v, scale=scale), _sdpa(q, k, v, scale),
                               atol=0, rtol=0)
    forced = ring_attention(q, k, v, scale=scale, force_ring=True)
    torch.testing.assert_close(forced, _sdpa(q, k, v, scale), atol=TOL, rtol=TOL)
    from cross_attention_vit_tpu.parallel import ring_attention as jax_ring

    # the vmap binds the size-1 'seq' axis that JAX's ring body indexes
    jout = jax.vmap(lambda q, k, v: jax_ring(q, k, v, scale=scale, axis_name="seq", axis_size=1,
                                             force_ring=True),
                    axis_name="seq")(*(jnp.asarray(a)[None] for a in qkv))[0]
    np.testing.assert_allclose(forced.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    got = _dense_grads(qkv, lambda q, k, v: ring_attention(q, k, v, scale=scale,
                                                           force_ring=True))
    np.testing.assert_allclose(got, _dense_grads(qkv), atol=TOL, rtol=TOL)


def test_make_mesh_seq_axis_layout(rings):
    """Axes in JAX's order with the size-1 ones left out ('data' kept), and
    a mesh that does not fill the world refused."""
    tmp, _ = rings
    for r in range(4):
        layout = json.loads((tmp / f"layout_{r}.json").read_text())
        assert layout["grid"] == [["data", "seq"], [2, 2]]
        assert layout["line"] == [["data", "seq"], [1, 4]]
        assert all("world size 4" in e for e in layout["errors"])
    assert tuple(jax_mesh(data=2, seq=2).axis_names) == ("data", "seq", "model")
