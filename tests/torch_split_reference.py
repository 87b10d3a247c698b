"""The JAX-side references and the comparisons of the port's tensor- and
pipeline-parallel tests (``tests/test_torch_tensor_parallel.py``,
``test_torch_pipeline.py``): JAX's single-device steps on the batches of
``torch_mesh_workers``, and the one-process port run of each case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cross_attention_vit_tpu.configs import get_mgmt_config as jax_vit_config
from cross_attention_vit_tpu.configs import get_mgmt_cross_config as jax_cross_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.models import model_cross as jmc
from cross_attention_vit_tpu.models import model_vit as jmv
from cross_attention_vit_tpu.train import optim as joptim
from cross_attention_vit_tpu.train.trainer import make_train_step as jax_train_step
from cross_attention_vit_tpu_torch.train.checkpoint import flatten, save_pytree
from torch_mesh_workers import (CROSS, LR, STEPS, VIT, load, model_batches, port_trainer,
                                spawn, split_steps)

TOL = 1e-5
JAX_ATOL, JAX_RTOL = 1e-5, 1e-4            # JAX's test_sharded_train_step tolerance
ZERO_GRAD = ("wk", "bias")                 # cross-attention key biases (JAX :77-91)
_JAX = {"cross": jmc, "vit": jmv}


def jax_config(family: str, **fields):
    """JAX's config of the same fields, its dense attention (the Pallas
    kernels' interpret mode is slow on the CPU; at f32 both agree far inside
    the tolerances)."""
    cfg = jax_cross_config() if family == "cross" else jax_vit_config()
    jax_modify(cfg, {**(CROSS if family == "cross" else VIT), **fields,
                     "use_flash_attention": False})
    return cfg


def jax_init(family: str, seed: int = 0, **fields) -> dict:
    params = _JAX[family].init(jax.random.key(seed), jax_config(family, **fields))
    return jax.tree.map(lambda a: np.array(a, np.float32), params)


def jax_step(family: str, params: dict, **fields) -> tuple[np.ndarray, dict]:
    """JAX's logits and its single-device train step's parameters on the
    first global batch."""
    cfg = jax_config(family, **fields)
    img, lab = model_batches(family)[0]
    params = jax.tree.map(jnp.asarray, params)
    logits = _JAX[family].apply(params, cfg, img)
    step = jax_train_step(_JAX[family].apply, cfg, donate=False)
    new, _, _ = step(params, joptim.init(params), img, lab.astype(np.int32),
                     jnp.asarray(LR, jnp.float32), jax.random.key(9))
    return np.asarray(logits), flatten(jax.tree.map(np.asarray, new))


def jax_mesh_step(family: str, params: dict, axes: dict, fsdp: bool = False,
                  **fields) -> tuple[np.ndarray, dict]:
    """JAX's train step over its own mesh of the same axes on the CPU's
    virtual devices, set up as JAX's ``Trainer`` sets it up (parameters by
    ``shard_params(..., fsdp, pipeline)``, the ambient pipeline, seq and
    expert meshes): the loss and the parameters after one step on the first
    global batch."""
    from cross_attention_vit_tpu import parallel as jpar
    from cross_attention_vit_tpu.parallel import moe as jmoe
    from cross_attention_vit_tpu.parallel import pipeline as jpipe
    from cross_attention_vit_tpu.parallel import ring as jring

    cfg = jax_config(family, **fields)
    mesh = jpar.make_mesh(axes.get("data", -1) if "data" in axes else 1, axes.get("model", 1),
                          pipe=axes.get("pipe", 1), seq=axes.get("seq", 1),
                          expert=axes.get("expert", 1))
    pipeline = int(fields.get("pipeline_stages", 0)) > 1
    jpipe.set_pipeline_mesh(mesh if pipeline else None)
    jring.set_seq_mesh(mesh if int(fields.get("seq_parallel", 0)) > 1 else None)
    jmoe.set_expert_mesh(mesh if axes.get("expert", 1) > 1 else None)
    try:
        placed = jpar.shard_params(jax.tree.map(jnp.asarray, params), mesh, fsdp=fsdp,
                                   pipeline=pipeline)
        img, lab = model_batches(family)[0]
        img, lab = jpar.shard_batch((img, lab.astype(np.int32)), mesh)
        step = jax_train_step(_JAX[family].apply, cfg, donate=False, mesh=mesh)
        new, _, aux = step(placed, joptim.init(placed), img, lab,
                           jnp.asarray(LR, jnp.float32), jax.random.key(9))
        return float(aux["loss"]), flatten(jax.tree.map(np.asarray, new))
    finally:
        jpipe.set_pipeline_mesh(None)
        jring.set_seq_mesh(None)
        jmoe.set_expert_mesh(None)


def run_cases(tmp, cases: dict) -> tuple[dict, dict]:
    """Each case over its gloo ranks and its one-process reference (which
    also writes its state after step 0 for the ranks to resume from)."""
    refs = {}
    for name, (family, fields, *_) in cases.items():
        params = jax_init(family, seed=len(name), **fields)
        save_pytree(tmp / f"init_{name}.npz", {"params": params})
        refs[name] = split_steps(port_trainer(family, fields, params=params), family,
                                 save_first=tmp / f"one_ckpt_{name}.npz")
    (tmp / "cases").write_text(" ".join(cases))
    for world in sorted({case[3] for case in cases.values()}):
        spawn("split", tmp, world)
    return {name: load(tmp, name, case[3]) for name, case in cases.items()}, refs


def assert_matches_one_process(ranks: list[dict], ref: dict) -> None:
    """Every rank's steps against the one-process run's; the ranks agree."""
    got = ranks[0]
    for s in range(STEPS):
        assert float(got[f"loss/{s}"]) == pytest.approx(float(ref[f"loss/{s}"]), rel=TOL,
                                                        abs=TOL)
        np.testing.assert_allclose(got[f"probs/{s}"], ref[f"probs/{s}"], atol=TOL, rtol=TOL)
        keys = [k for k in ref if k.startswith(f"params{s}/")]
        assert keys and set(keys) == {k for k in got if k.startswith(f"params{s}/")}
        for k in keys:
            np.testing.assert_allclose(got[k], ref[k], atol=2.5 * LR, rtol=0, err_msg=k)
    names = [k for k in ref if k.startswith("grad/")]
    assert names and set(names) == {k for k in got if k.startswith("grad/")}
    for k in names:
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=TOL, err_msg=k)
    np.testing.assert_allclose(got["eval/probs"], ref["eval/probs"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got["logits0"], ref["logits0"], atol=TOL, rtol=TOL)
    for other in ranks[1:]:
        for k in got:
            if not k.startswith("local/"):
                np.testing.assert_array_equal(other[k], got[k], err_msg=k)


def assert_adam_step_matches(got: dict, init: dict, new: dict) -> None:
    """One Adam step's parameters (``got``, flat) against JAX's (``new``)
    from ``init``: within JAX's atol=1e-5, rtol=1e-4, the cross-attention
    key biases left out as JAX's test leaves them out.  Adam's first update
    is lr·g/(|g| + 1e-8) with g the gradient plus the weight decay: where
    JAX's update falls short of lr by more than 1% (|g| < 1e-6, a sum that
    cancels to below its own f32 rounding noise), ulp-level differences of
    the summation order move it by up to lr — those elements are held at
    2.5·lr instead, and must be under 0.1% of them all."""
    short, total = 0, 0
    flat_init = flatten(init)
    for k, v in new.items():
        if tuple(k.split("/")[-2:]) == ZERO_GRAD:
            continue
        ill = np.abs(v - flat_init[k]) < 0.99 * LR
        short, total = short + int(ill.sum()), total + v.size
        np.testing.assert_allclose(got[k][~ill], v[~ill], atol=JAX_ATOL, rtol=JAX_RTOL,
                                   err_msg=k)
        np.testing.assert_allclose(got[k][ill], v[ill], atol=2.5 * LR, rtol=0, err_msg=k)
    assert short <= 1e-3 * total, (short, total)
