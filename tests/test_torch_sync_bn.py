"""A stateful (BatchNorm) model over a data mesh in the port — the counterpart
of JAX's ``make_stateful_train_step(..., mesh=make_mesh(D))``, whose
BatchNorm statistics GSPMD takes over the global batch (SyncBatchNorm
semantics, ``ops/conv.py:13-16``).

* Over two gloo ranks (``tests/torch_mesh_workers.py``, mode sync_bn), data
  2, 4 volumes a rank, the tiny ViT3D (CNN3DEncoder stem, four BatchNorms)
  through the stateful ``Trainer``: two steps' running means and variances
  equal the one-process batch-8 step's and JAX's own step over its (data 2)
  mesh within 1e-5 relative; the loss and probs within 1e-5; the first
  step's gradients within 2e-4 normalised (max |diff| / max |ref|) of the
  one-process step's (the stem's conv biases, whose gradient is zero in
  exact arithmetic, held at 1e-6 absolute instead); the parameters after
  Adam within 2.5·lr of both (JAX's bound,
  ``tests/test_parallel.py:170-175``); the eval step over the
  mesh equals the one-process one; the two ranks' results, running
  statistics included, are bit-equal; the checkpoint carries the whole
  ``model_state``.
* ``batch_norm3d`` without a group is ``F.batch_norm`` bit for bit; its
  synchronised form over a one-rank group gives ``F.batch_norm``'s output,
  statistics and gradients within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cross_attention_vit_tpu import parallel as jpar
from cross_attention_vit_tpu.configs import get_mgmt_config as jax_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.models import vit3d as jvit3d
from cross_attention_vit_tpu.train import optim as joptim
from cross_attention_vit_tpu.train.trainer import make_stateful_train_step
from cross_attention_vit_tpu_torch.models import convert as tconvert
from cross_attention_vit_tpu_torch.models.vit3d import ViT3D
from cross_attention_vit_tpu_torch.ops.conv import batch_norm3d
from cross_attention_vit_tpu_torch.train.checkpoint import flatten, save_pytree
from torch_mesh_workers import (BN_TINY, LR, STEPS, bn_batches, bn_config, bn_steps, bn_trainer,
                                free_port, load, spawn)

TOL = 1e-5
GRAD_TOL = 2e-4
# the stem's conv biases each feed a BatchNorm: zero gradient in exact arithmetic
ZERO_GRAD = {f"grad/encoder.conv{i}.bias" for i in range(1, 5)}


def _init():
    """Weights and BatchNorm state from a seed, the stem's conv biases at 1
    (a conv bias feeding a BatchNorm has a zero gradient in exact
    arithmetic; see test_torch_legacy_train.py)."""
    model = ViT3D(bn_config(), device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i in range(1, 5):
            getattr(model.encoder, f"conv{i}").bias.fill_(1.0)
    return tconvert.jax_params_from_model(model), tconvert.jax_state_from_model(model)


def _jax_mesh_steps(params: dict, state: dict) -> dict:
    """JAX's stateful step over its (data 2) mesh: loss, parameters and
    running statistics after each step."""
    cfg = jax_config()
    jax_modify(cfg, BN_TINY)
    mesh = jpar.make_mesh(2)
    p = jpar.shard_params(jax.tree.map(jnp.asarray, params), mesh)
    st = jax.device_put(jax.tree.map(jnp.asarray, state), jpar.replicated(mesh))
    opt = joptim.init(p)
    step = make_stateful_train_step(jvit3d.apply, cfg, donate=False, mesh=mesh)
    out = {}
    for s, (img, lab) in enumerate(bn_batches()):
        img, lab = jpar.shard_batch((img, lab.astype(np.int32)), mesh)
        p, st, opt, aux = step(p, st, opt, img, lab, jnp.asarray(LR, jnp.float32),
                               jax.random.key(s))
        out[f"loss/{s}"] = float(aux["loss"])
        out.update({f"params{s}/{k}": v for k, v in flatten(jax.tree.map(np.asarray, p)).items()})
        out.update({f"state{s}/{k}": v
                    for k, v in flatten(jax.tree.map(np.asarray, st)).items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync_bn")
    params, state = _init()
    save_pytree(tmp / "bn_init.npz", {"params": params, "state": state})
    one = bn_steps(bn_trainer(params, state))
    spawn("sync_bn", tmp, 2)
    return load(tmp, "sync_bn", 2), one, _jax_mesh_steps(params, state)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("step", range(STEPS))
def test_running_statistics_are_the_global_batchs(runs, step):
    """Each BatchNorm's running mean and variance after the step: the
    one-process batch-8 step's and JAX's mesh step's within 1e-5 relative."""
    ranks, one, jax_ref = runs
    keys = [k for k in one if k.startswith(f"state{step}/")]
    assert len(keys) == 8       # 4 BatchNorms × (mean, var)
    for k in keys:
        got = ranks[0][k]
        assert _rel(got, one[k]) <= TOL, (k, _rel(got, one[k]))
        assert _rel(got, jax_ref[k]) <= TOL, (k, _rel(got, jax_ref[k]))


def test_step_matches_one_process(runs):
    """Loss and probs within 1e-5, the first step's gradients within 2e-4
    normalised, the parameters after each Adam step within 2.5·lr, and the
    eval step, of the one-process batch-8 run."""
    ranks, one, _ = runs
    got = ranks[0]
    for s in range(STEPS):
        assert float(got[f"loss/{s}"]) == pytest.approx(float(one[f"loss/{s}"]), rel=TOL)
        np.testing.assert_allclose(got[f"probs/{s}"], one[f"probs/{s}"], atol=TOL)
        for k in (k for k in one if k.startswith(f"params{s}/")):
            np.testing.assert_allclose(got[k], one[k], atol=2.5 * LR, rtol=0, err_msg=k)
    grads = [k for k in one if k.startswith("grad/")]
    assert grads and set(grads) == {k for k in got if k.startswith("grad/")}
    for k in grads:
        if k in ZERO_GRAD:      # rounding noise on both sides
            assert np.abs(got[k]).max() <= 1e-6 and np.abs(one[k]).max() <= 1e-6, k
            continue
        assert _rel(got[k], one[k]) <= GRAD_TOL, (k, _rel(got[k], one[k]))
    np.testing.assert_allclose(got["eval/probs"], one["eval/probs"], atol=TOL)
    assert float(got["eval/loss"]) == pytest.approx(float(one["eval/loss"]), rel=TOL)


def test_step_matches_jax_mesh_step(runs):
    """The loss and the parameters after each step against JAX's stateful
    step over its own (data 2) mesh."""
    ranks, _, jax_ref = runs
    got = ranks[0]
    for s in range(STEPS):
        assert float(got[f"loss/{s}"]) == pytest.approx(jax_ref[f"loss/{s}"], rel=TOL)
        keys = [k for k in jax_ref if k.startswith(f"params{s}/")]
        assert keys and set(keys) == {k for k in got if k.startswith(f"params{s}/")}
        for k in keys:
            np.testing.assert_allclose(got[k], jax_ref[k], atol=2.5 * LR, rtol=0, err_msg=k)


def test_ranks_are_bit_equal_and_every_norm_is_synchronised(runs):
    """Both ranks' results, running statistics included, bit for bit; all
    four BatchNorms carry the data group; the checkpoint holds the whole
    model_state."""
    (r0, r1), one, _ = runs
    assert set(r0) == set(r1)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert int(r0["sync_groups"]) == 4
    state = {k: v for k, v in r0.items() if k.startswith("ckpt/model_state/")}
    assert len(state) == 8
    for k, v in state.items():
        assert _rel(v, one[k]) <= TOL, k


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def _norm(c: int) -> torch.nn.BatchNorm3d:
    norm = torch.nn.BatchNorm3d(c)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        norm.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
    return norm


def _x(seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(3, 5, 4, 6, 2, generator=g) * 7 + 40).requires_grad_()


def test_batch_norm_without_a_group_is_f_batch_norm_bit_for_bit():
    a, b = _norm(5), _norm(5)
    x = _x()
    y = batch_norm3d(a, x, True)
    want = F.batch_norm(x, b.running_mean, b.running_var, b.weight, b.bias, True, b.momentum,
                        b.eps)
    assert torch.equal(y, want)
    assert torch.equal(a.running_mean, b.running_mean)
    assert torch.equal(a.running_var, b.running_var)


def test_synchronised_batch_norm_over_one_rank_matches_f_batch_norm():
    """The synchronised form over a one-rank gloo group: output, running
    statistics and the input, weight and bias gradients within 1e-6 of
    ``F.batch_norm``'s (another summation order)."""
    import torch.distributed as dist

    from cross_attention_vit_tpu_torch.parallel import multihost_init

    multihost_init(f"127.0.0.1:{free_port()}", 1, 0, device="cpu", timeout_s=30)
    try:
        a, b = _norm(5), _norm(5)
        a.sync_group = dist.group.WORLD
        xa, xb = _x(), _x()
        dy = torch.randn(3, 5, 4, 6, 2, generator=torch.Generator().manual_seed(3))
        ya = batch_norm3d(a, xa, True)
        yb = F.batch_norm(xb, b.running_mean, b.running_var, b.weight, b.bias, True, b.momentum,
                          b.eps)
        (ya * dy).sum().backward()
        (yb * dy).sum().backward()
        torch.testing.assert_close(ya, yb, atol=1e-6, rtol=1e-6)
        for ta, tb in ((a.running_mean, b.running_mean), (a.running_var, b.running_var),
                       (xa.grad, xb.grad), (a.weight.grad, b.weight.grad),
                       (a.bias.grad, b.bias.grad)):
            torch.testing.assert_close(ta, tb, atol=1e-6, rtol=1e-6)
        assert int(a.num_batches_tracked) == 1
    finally:
        dist.destroy_process_group()
