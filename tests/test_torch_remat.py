"""Rematerialisation in the port (``config.remat``, ``config.remat_policy``;
``cross_attention_vit_tpu_torch/ops/remat.py``).

* Against the port without remat, f32, dropout 0.25 and drop path 0.1:
  for ModelCross and ModelVIT under each of the five policies, one train
  forward and backward gives the same loss, every gradient and the dropout
  generator's final state bit for bit (the recompute replays the forward's
  draws and puts the generator back).  The attention's forward runs once a
  layer where the policy keeps ``attn_out`` and twice where it does not;
  its backward once a layer (the counts ``chip_smoke.py`` gates K1 and K2
  at).  The same on the plain attention path, under the pipeline's serial
  schedule, and with the MoE, whose balance terms the recompute must not
  record twice.
* Against JAX's ``apply`` with ``remat=True`` at dropout 0: loss within
  1e-5, every gradient within 1e-4 of its largest JAX value (the parity
  tolerances of tests/test_torch_train.py and test_torch_model_vit.py).

Geometry: hidden 32, 4 heads, 2 streams of (16, 16, 8) in (8, 8, 8) patches
(N = 5 tokens a stream for ModelCross, 9 for ModelVIT), 2 self-blocks or
layers, batch 4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.configs import get_mgmt_config as jax_vit_config
from cross_attention_vit_tpu.configs import get_mgmt_cross_config as jax_cross_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.models import model_cross as jmc
from cross_attention_vit_tpu.models import model_vit as jmv
from cross_attention_vit_tpu_torch.configs import (get_mgmt_config, get_mgmt_cross_config,
                                                   modify_config)
from cross_attention_vit_tpu_torch.kernels import flash_attention as fa
from cross_attention_vit_tpu_torch.models import convert as tconvert
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.ops.remat import REMAT_SAVE_NAMES, remat_names

POLICIES = [*REMAT_SAVE_NAMES, "full"]
FIELDS = dict(hidden_dim=32, mlp_dim=64, num_heads=4, num_multi_blocks=1, num_self_blocks=2,
              num_layers=2, img_size=(16, 16, 8), patch_size=(8, 8, 8), num_modalities=2,
              attn_order={"0": "1", "1": "0"}, dropout=0.25, drop_path_rate=0.1,
              use_flash_attention=True, label_smoothing=0.0, lr=1e-3, weight_decay=5e-4,
              img_aug=False, optim_params={"T_max": 10, "eta_min": 1e-6})
# self-attention layers a forward runs: 2 streams x 2 self-blocks, or 2 layers
SITES = {"cross": 4, "vit": 2}


def _config(family: str, **fields):
    cfg = get_mgmt_cross_config() if family == "cross" else get_mgmt_config()
    modify_config(cfg, {**FIELDS, **fields})
    return cfg


def _batch(seed: int = 0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(4, 2, 1, 16, 16, 8)).astype(np.float32),
            np.array([0, 1, 0, 1], np.int64))


def _step(family: str, **fields) -> dict:
    """One train forward and backward of a seeded model: loss, gradients,
    the dropout generator's state after it, MoE aux and the attention
    forwards and backwards it ran (calls of K1's and K2's wrappers)."""
    cfg = _config(family, **fields)
    cls = ModelCross if family == "cross" else ModelVIT
    model = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                master_weights=True)
    img, labels = _batch()
    g = torch.Generator().manual_seed(5)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_qkv_fwd, fa.flash_attention_qkv_bwd

    def count(key, fn):
        def counted(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return counted

    fa.flash_attention_qkv_fwd, fa.flash_attention_qkv_bwd = count("fwd", fwd), count("bwd", bwd)
    try:
        _, loss = model(torch.from_numpy(img), torch.from_numpy(labels), train=True, generator=g)
        loss.backward()
    finally:
        fa.flash_attention_qkv_fwd, fa.flash_attention_qkv_bwd = fwd, bwd
    return {"loss": loss.detach(), "grads": {n: p.grad for n, p in model.named_parameters()},
            "state": g.get_state(), "calls": calls, "moe_aux": model.moe_aux}


def _assert_same_step(got: dict, want: dict) -> None:
    assert torch.equal(got["loss"], want["loss"])
    assert got["grads"].keys() == want["grads"].keys()
    for name, g in want["grads"].items():
        assert torch.equal(got["grads"][name], g), name
    assert torch.equal(got["state"], want["state"])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", ["cross", "vit"])
def test_remat_step_equals_the_step_without_it(family, policy):
    want = _step(family)
    got = _step(family, remat=True, remat_policy=policy)
    _assert_same_step(got, want)
    sites = SITES[family]
    assert want["calls"] == {"fwd": sites, "bwd": sites}
    kept = "attn_out" in remat_names(_config(family, remat=True, remat_policy=policy))
    assert got["calls"] == {"fwd": sites if kept else 2 * sites, "bwd": sites}


@pytest.mark.parametrize("policy", ["save_attn_masks_ffn_qkv", "full"])
@pytest.mark.parametrize("family", ["cross", "vit"])
def test_remat_on_the_plain_attention_path(family, policy):
    """``use_flash_attention=False``: the plain ``_sdpa`` path keeps its
    named tensors as values and still equals the step without remat."""
    want = _step(family, use_flash_attention=False)
    got = _step(family, use_flash_attention=False, remat=True, remat_policy=policy)
    _assert_same_step(got, want)
    assert got["calls"] == {"fwd": 0, "bwd": 0}


def test_remat_names_follow_jax_table():
    """JAX's ``_REMAT_SAVE_NAMES.get``: 'save_attn' by default, nothing kept
    for 'full', None or an unknown name, and no remat when ``remat`` is off."""
    from cross_attention_vit_tpu.ops.layers import _REMAT_SAVE_NAMES

    assert REMAT_SAVE_NAMES == _REMAT_SAVE_NAMES
    assert remat_names(_config("cross")) is None
    assert remat_names(_config("cross", remat=True)) == ("attn_out",)
    for policy in ("full", None, "no_such_policy"):
        assert remat_names(_config("cross", remat=True, remat_policy=policy)) == ()


def test_remat_composes_with_the_pipeline_schedule():
    """ModelVIT with ``pipeline_stages`` 2 (the serial schedule: per-(layer,
    microbatch) generators) under remat equals it without."""
    pp = {"pipeline_stages": 2, "pipeline_microbatches": 2}
    want = _step("vit", **pp)
    got = _step("vit", **pp, remat=True, remat_policy="save_attn")
    _assert_same_step(got, want)


@pytest.mark.parametrize("family", ["cross", "vit"])
def test_remat_records_the_moe_balance_terms_once(family):
    """With the MoE (``moe_experts`` 4) every site's balance term enters the
    loss once: loss, gradients, the generator and ``moe_aux`` equal the step
    without remat."""
    want = _step(family, moe_experts=4)
    got = _step(family, moe_experts=4, remat=True, remat_policy="full")
    _assert_same_step(got, want)
    for key, value in want["moe_aux"].items():
        assert torch.equal(got["moe_aux"][key], value), key


def test_remat_without_grad_is_the_plain_forward():
    """Serving a remat config (no autograd) runs no checkpoint and gives the
    same logits."""
    img, _ = _batch()
    logits = []
    for fields in ({}, {"remat": True, "remat_policy": "full"}):
        model = ModelCross(_config("cross", **fields), device="cpu",
                           generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            logits.append(model(torch.from_numpy(img)))
    assert torch.equal(*logits)


def _jax_pair(family: str, **fields):
    jc = jax_cross_config() if family == "cross" else jax_vit_config()
    f = {**FIELDS, "dropout": 0.0, "drop_path_rate": 0.0, **fields}
    jax_modify(jc, f)
    init = jmc.init if family == "cross" else jmv.init
    return jc, _config(family, **f), jax.tree.map(np.asarray, init(jax.random.key(0), jc))


@pytest.mark.parametrize("policy", ["save_attn", "full"])
@pytest.mark.parametrize("family", ["cross", "vit"])
def test_remat_matches_jax_remat(family, policy):
    """The port's remat step against JAX's ``apply`` under ``jax.checkpoint``
    with the same policy, at dropout 0 on the same weights and batch."""
    jc, tc, params = _jax_pair(family, remat=True, remat_policy=policy)
    img, labels = _batch(seed=3)
    apply = jmc.apply if family == "cross" else jmv.apply

    def loss_fn(p):
        return apply(p, jc, jnp.asarray(img), jnp.asarray(labels.astype(np.int32)), train=True,
                     rng=jax.random.key(1))[1]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = (ModelCross if family == "cross" else ModelVIT)(tc, device="cpu",
                                                            master_weights=True)
    tconvert.load_jax_params(model, params)
    _, loss = model(torch.from_numpy(img), torch.from_numpy(labels), train=True)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    grads = tconvert.state_dict_from_jax(jax.tree.map(np.asarray, want_grads), tc)
    for name, p in model.named_parameters():
        w, g = grads[name], p.grad.numpy()
        if name.endswith("wk.bias"):       # zero in exact arithmetic (test_torch_train.py)
            assert np.abs(g).max() <= 1e-6 and np.abs(w).max() <= 1e-6, name
            continue
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)
