"""Sequence parallelism (ring attention) and expert parallelism (the MoE FFN)
through the port's models, ``Trainer``, checkpoints, CLIs and server — the
counterpart of ``tests/test_sp_ep_models.py``.

* ``config.seq_parallel = P`` routes ModelCross's and ModelVIT's
  self-attention through the padded, masked ring (the streams' N = 5 and 9
  are ragged at P = 2 and 4); without a seq mesh it is the dense ``_sdpa``
  bit for bit.
* ``config.moe_experts = E`` makes the self-block FFNs (ModelCross: per
  stream) or trunk FFNs (ModelVIT) GShard MoEs; the balance term enters the
  train loss only; PP with MoE is refused.
* Over gloo ranks (``tests/torch_mesh_workers.py``): (seq 2), (expert 2),
  (data 2 × expert 2), (data 2) with the MoE under FSDP, (seq 4) for both
  models, (data 2 × seq 2 under FSDP) and (seq 2 × expert 2), each a ``Trainer`` from JAX-initialised parameters: the loss,
  the probs and every gradient equal the one-process step's on the global
  batch within 1e-5, the parameters after Adam within 2.5·lr (the
  cross-attention key biases' gradients are zero in exact arithmetic, and
  Adam's first update is about lr·sign(g)), and the ranks of a data
  coordinate agree exactly.  The one-process step's gradients equal JAX's
  within 1e-5, its logits within 1e-4.
* ``Trainer.fit`` over (expert 2) and (seq 2), ``experiments.main --ep 2
  --set moe_experts=4`` and ``--sp 2`` over two processes, a MoE
  checkpoint crossing JAX ⇄ port both ways, and a MoE checkpoint served on
  one device.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.configs import get_mgmt_config as jax_vit_config
from cross_attention_vit_tpu.configs import get_mgmt_cross_config as jax_cross_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.models import model_cross as jmc
from cross_attention_vit_tpu.models import model_vit as jmv
from cross_attention_vit_tpu.ops.attention import _sdpa as jax_sdpa
from cross_attention_vit_tpu.parallel import make_mesh as jax_mesh
from cross_attention_vit_tpu.parallel import sharded_ring_sdpa as jax_sharded_ring_sdpa
from cross_attention_vit_tpu_torch.models.convert import load_jax_params, state_dict_from_jax
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.ops.attention import _sdpa
from cross_attention_vit_tpu_torch.parallel import sharded_ring_sdpa
from cross_attention_vit_tpu_torch.train import trainer as ttrainer
from cross_attention_vit_tpu_torch.train.checkpoint import flatten, save_pytree
from torch_mesh_workers import (CROSS, FIT_CASES, LR, MODEL_CASES, SHARDED_NS, STEPS, VIT,
                                fit_loaders, fit_trainer, load, model_batches,
                                port_config, ring_grads, ring_inputs, spawn, write_cohort)

TOL = 1e-5
LOGIT_TOL = 1e-4
_MODELS = {"cross": (ModelCross, jmc), "vit": (ModelVIT, jmv)}


def _jax_config(family: str, **fields):
    """JAX's config of the same fields, with its dense attention (the
    Pallas kernels' interpret mode is slow on the CPU; in f32 the two agree
    far inside the tolerances here)."""
    cfg = jax_cross_config() if family == "cross" else jax_vit_config()
    jax_modify(cfg, {**(CROSS if family == "cross" else VIT), **fields,
                     "use_flash_attention": False})
    return cfg


def _jax_init(family: str, seed: int = 0, **fields) -> dict:
    params = _MODELS[family][1].init(jax.random.key(seed), _jax_config(family, **fields))
    return jax.tree.map(lambda a: np.array(a, np.float32), params)


def _port(family: str, params: dict, **fields):
    model = _MODELS[family][0](port_config(family, **fields), device="cpu",
                               master_weights=True)
    load_jax_params(model, params)
    return model


def _one_process(family: str, fields: dict, params: dict) -> dict:
    """The port without a mesh on the global batches: loss, probs, the first
    step's gradients, the parameters after each step, one eval step."""
    t = ttrainer.Trainer(_MODELS[family][0], port_config(family, **fields), max_epochs=1,
                         device="cpu").init_state(params)
    out = {}
    for s, (img, lab) in enumerate(model_batches(family)):
        aux = t.train_step(torch.from_numpy(img), torch.from_numpy(lab), LR,
                           ttrainer._step_generator(0, 0, s))
        out[f"loss/{s}"], out[f"probs/{s}"] = float(aux["loss"]), aux["probs"].numpy()
        if s == 0:
            out.update({f"grad/{n}": p.grad.numpy().copy()
                        for n, p in t.model.named_parameters()})
        out.update({f"params{s}/{k}": v for k, v in flatten(t.params).items()})
    img, lab = model_batches(family)[0]
    aux = t.eval_step(torch.from_numpy(img), torch.from_numpy(lab))
    out["eval/probs"], out["eval/loss"] = aux["probs"].numpy(), float(aux["loss"])
    if t.model.moe_aux is not None:
        out.update({f"moe/{k}": v.numpy() for k, v in t.model.moe_aux.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every MODEL_CASES case over its gloo ranks, and its one-process
    reference."""
    tmp = tmp_path_factory.mktemp("sp_ep")
    refs = {}
    for name, (family, fields, _, _, _) in MODEL_CASES.items():
        params = _jax_init(family, seed=len(name), **fields)
        save_pytree(tmp / f"init_{name}.npz", {"params": params})
        refs[name] = _one_process(family, fields, params)
    for world in (2, 4):
        spawn("models", tmp, world)
    got = {name: load(tmp, name, case[4]) for name, case in MODEL_CASES.items()}
    return tmp, got, refs


def _assert_step_matches(got: dict, ref: dict) -> None:
    for s in range(STEPS):
        assert float(got[f"loss/{s}"]) == pytest.approx(ref[f"loss/{s}"], rel=TOL, abs=TOL)
        np.testing.assert_allclose(got[f"probs/{s}"], ref[f"probs/{s}"], atol=TOL, rtol=TOL)
        keys = [k for k in ref if k.startswith(f"params{s}/")]
        assert keys and set(keys) == {k for k in got if k.startswith(f"params{s}/")}
        for k in keys:
            np.testing.assert_allclose(got[k], ref[k], atol=2.5 * LR, rtol=0, err_msg=k)
    names = [k for k in ref if k.startswith("grad/")]
    assert names and set(names) == {k for k in got if k.startswith("grad/")}
    for k in names:
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=TOL, err_msg=k)


def _check_case(runs, name: str) -> None:
    _, got, refs = runs
    ranks = got[name]
    _assert_step_matches(ranks[0], refs[name])
    for other in ranks[1:]:
        for k in ranks[0]:
            if not k.startswith("refused/"):
                np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)


# ---------------------------------------------------------------------------
# sharded_ring_sdpa — the padded, masked drop-in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SHARDED_NS)
def test_sharded_ring_sdpa_matches_dense(runs, n):
    """Over (seq 2): ragged N padded, the padded keys masked; forward and
    gradients equal the dense attention and JAX's ring over (data 2, seq 4)."""
    tmp = runs[0]
    qkv = ring_inputs(b=2, heads=2, n=n, d=8, seed=n)
    scale = 8 ** -0.5
    want = _sdpa(*(torch.from_numpy(a) for a in qkv), scale).numpy()
    want_grad = ring_grads(qkv, lambda q, k, v: _sdpa(q, k, v, scale))
    mesh = jax_mesh(2, seq=4)
    jout = jax.jit(lambda q, k, v: jax_sharded_ring_sdpa(q, k, v, scale, mesh=mesh))(
        *(jnp.asarray(a) for a in qkv))
    for r in range(2):
        got = dict(np.load(tmp / f"sharded_sdpa_{r}.npz"))
        np.testing.assert_allclose(got[f"out{n}"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[f"out{n}"], np.asarray(jout), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[f"grad{n}"], want_grad, atol=TOL, rtol=TOL)


def test_sharded_ring_sdpa_no_mesh_is_dense():
    """No seq mesh: ``_sdpa`` itself, bit for bit (and JAX's fallback)."""
    qkv = ring_inputs(b=2, heads=2, n=11, d=8, seed=1)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    got = sharded_ring_sdpa(q, k, v, 0.5)
    torch.testing.assert_close(got, _sdpa(q, k, v, 0.5), atol=0, rtol=0)
    jgot = jax_sharded_ring_sdpa(*(jnp.asarray(a) for a in qkv), 0.5, mesh=None)
    np.testing.assert_array_equal(np.asarray(jgot),
                                  np.asarray(jax_sdpa(*(jnp.asarray(a) for a in qkv), 0.5)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# seq_parallel through the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["vit", "cross"])
def test_model_seq_parallel_matches_dense(runs, family):
    """seq_parallel 2 over (seq 2): the eval step's probs and loss equal the
    one-process dense port's, whose logits equal JAX's; the train-mode step
    (dropout 0.1, the same masks on every rank) equals the one-process
    step."""
    _, got, refs = runs
    name = f"{family}_sp2"
    ref = refs[name]
    for rank in got[name]:
        np.testing.assert_allclose(rank["eval/probs"], ref["eval/probs"], atol=TOL, rtol=TOL)
        assert float(rank["eval/loss"]) == pytest.approx(ref["eval/loss"], rel=TOL)
    fields = MODEL_CASES[name][1]
    params = _jax_init(family, seed=len(name), **fields)
    img, lab = model_batches(family)[0]
    jlogits, _ = _MODELS[family][1].apply(params, _jax_config(family, **fields), img,
                                          lab.astype(np.int32))
    with torch.no_grad():
        logits = _port(family, params, **fields)(torch.from_numpy(img))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL, rtol=0)
    _check_case(runs, name)


@pytest.mark.parametrize("name", ["vit_sp2", "vit_sp4"])
def test_model_vit_seq_parallel_train_step_matches(runs, name):
    """Two Adam steps of ModelVIT over a seq line of 2 and of 4 (dropout and
    drop path on): loss, probs, gradients and parameters equal the
    one-process step's; every rank agrees."""
    _check_case(runs, name)


@pytest.mark.parametrize("name", ["cross_sp2", "cross_sp4", "cross_dp2_sp2_fsdp"])
def test_model_cross_seq_parallel_train_step_matches(runs, name):
    """ModelCross over (seq 2), (seq 4) and (data 2 × seq 2) under FSDP
    (which shards over the data axis only)."""
    _check_case(runs, name)


@pytest.mark.parametrize("family", ["vit", "cross"])
def test_seq_parallel_config_without_mesh_is_dense(family):
    """seq_parallel set but no seq mesh (one device): the dense path, bit
    for bit the model with use_flash_attention=False."""
    params = _jax_init(family)
    img = torch.from_numpy(model_batches(family)[0][0])
    with torch.no_grad():
        ref = _port(family, params, use_flash_attention=False)(img)
        got = _port(family, params, seq_parallel=2)(img)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the one-process MoE and SP steps against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,fields", [("cross", {"moe_experts": 4}),
                                           ("vit", {"moe_experts": 4}),
                                           ("cross", {"seq_parallel": 2}),
                                           ("vit", {"seq_parallel": 2})],
                         ids=["cross_moe", "vit_moe", "cross_sp", "vit_sp"])
def test_serial_step_matches_jax(family, fields):
    """The port's train-mode loss and every gradient (dropout 0, the
    balance term included) against ``jax.grad`` of JAX's apply on the same
    weights and batch."""
    params = _jax_init(family, **fields)
    img, lab = model_batches(family)[0]
    jcfg = _jax_config(family, **fields)
    module = _MODELS[family][1]

    def loss(p):
        return module.apply(p, jcfg, img, lab.astype(np.int32), train=True,
                            rng=jax.random.key(0))[1]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), port_config(family, **fields))
    model = _port(family, params, **fields)
    _, got = model(torch.from_numpy(img), torch.from_numpy(lab), train=True,
                   generator=torch.Generator())
    got.backward()
    assert float(got.detach()) == pytest.approx(float(jloss), rel=TOL)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for n in want:
        np.testing.assert_allclose(grads[n], want[n], atol=TOL, rtol=TOL, err_msg=n)


# ---------------------------------------------------------------------------
# moe_experts through ModelVIT
# ---------------------------------------------------------------------------

def test_model_vit_moe_init_structure():
    """Every trunk FFN a MoE (E stacked experts in the port's (out, in)
    layout, the JAX tree's names through convert); moe_every=2 converts the
    second layer only."""
    model = ModelVIT(port_config("vit", moe_experts=4), device="cpu")
    sd = model.state_dict()
    for i in range(2):
        assert sd[f"transformer.layers.{i}.2.fn.experts.fc1.weight"].shape == (4, 64, 32)
        assert sd[f"transformer.layers.{i}.2.fn.router.weight"].dtype == torch.float32
    every2 = ModelVIT(port_config("vit", moe_experts=4, moe_every=2), device="cpu").state_dict()
    assert "transformer.layers.0.2.fn.net.0.weight" in every2
    assert "transformer.layers.1.2.fn.router.weight" in every2
    jtree = _jax_init("vit", moe_experts=4, moe_every=2)
    assert set(state_dict_from_jax(jtree, port_config("vit"))) == set(every2)


@pytest.mark.parametrize("family", ["vit", "cross"])
def test_moe_eval_loss_is_pure_ce(family):
    """The balance term enters the train loss only: with dropout off, train
    and eval logits agree and the train loss exceeds the eval loss by
    0.01 × the mean of the sites' balance losses — JAX's gap."""
    params = _jax_init(family, seed=1, moe_experts=4)
    model = _port(family, params, moe_experts=4)
    img, lab = (torch.from_numpy(a) for a in model_batches(family)[0])
    with torch.no_grad():
        le, loss_e = model(img, lab)
        lt, loss_t = model(img, lab, train=True, generator=torch.Generator())
    torch.testing.assert_close(lt, le, atol=1e-6, rtol=1e-6)
    balance = model.moe_aux["balance_loss"]
    assert len(balance) == {"vit": 2, "cross": 4}[family]   # layers, streams × self blocks
    gap = float(loss_t - loss_e)
    assert gap == pytest.approx(0.01 * float(balance.mean()), rel=1e-5)
    jcfg = _jax_config(family, moe_experts=4)
    module = _MODELS[family][1]
    _, jle = module.apply(params, jcfg, img.numpy(), lab.numpy().astype(np.int32))
    _, jlt = module.apply(params, jcfg, img.numpy(), lab.numpy().astype(np.int32), train=True,
                          rng=jax.random.key(0))
    assert float(loss_e) == pytest.approx(float(jle), rel=TOL)
    assert gap == pytest.approx(float(jlt) - float(jle), abs=TOL)


@pytest.mark.parametrize("name", ["vit_ep2", "vit_dp2_ep2"])
def test_model_vit_moe_ep_sharded_matches_serial(runs, name):
    """The eval step over (expert 2) and (data 2 × expert 2): probs, loss and
    the sites' balance losses equal the one-process model's."""
    _, got, refs = runs
    ref = refs[name]
    for rank in got[name]:
        np.testing.assert_allclose(rank["eval/probs"], ref["eval/probs"], atol=TOL, rtol=TOL)
        assert float(rank["eval/loss"]) == pytest.approx(ref["eval/loss"], rel=TOL)
        np.testing.assert_allclose(rank["moe/balance_loss"], ref["moe/balance_loss"], atol=TOL)
        np.testing.assert_array_equal(rank["moe/dispatch_fraction"],
                                      ref["moe/dispatch_fraction"])


@pytest.mark.parametrize("name", ["vit_ep2", "vit_dp2_ep2"])
def test_model_vit_moe_ep_train_step_matches_serial(runs, name):
    _check_case(runs, name)


def test_moe_rejects_pipeline():
    with pytest.raises(ValueError, match="pipeline_stages"):
        ModelVIT(port_config("vit", moe_experts=4, pipeline_stages=2), device="cpu")
    with pytest.raises(ValueError, match="pipeline_stages"):
        jmv.init(jax.random.key(0), _jax_config("vit", moe_experts=4, pipeline_stages=2))


def test_trainer_sets_ambient_meshes(runs):
    """Trainer(mesh=(seq 2, expert 2)) publishes the seq and expert meshes
    the models read while its train and eval steps run, and leaves none set
    after them (nor after its construction); it refuses a config that
    disagrees with the mesh and builds with FSDP on the same mesh, and its
    step (a ModelVIT with both on) equals the one-process step."""
    _, got, _ = runs
    for rank in got["vit_sp2_ep2"]:
        assert rank["ambient_in_steps"].shape == (STEPS + 1, 2)
        assert rank["ambient_in_steps"].all()
        assert rank["ambient_after_init"].all() and rank["ambient_after_steps"].all()
        assert "seq_parallel=4" in str(rank["refused/seq_parallel"])
        assert "moe_experts=3" in str(rank["refused/moe_experts"])
        assert str(rank["refused/fsdp"]) == ""      # FSDP with EP and SP composes
    _check_case(runs, "vit_sp2_ep2")


# ---------------------------------------------------------------------------
# moe_experts through ModelCross
# ---------------------------------------------------------------------------

def test_model_cross_moe_init_structure():
    """The per-stream self-block FFNs are MoEs (each stream its own router
    and experts); the cross-block FFNs stay dense; moe_every indexes the
    per-stream depth mb·num_self_blocks + layer."""
    sd = ModelCross(port_config("cross", moe_experts=4), device="cpu").state_dict()
    for m in range(2):
        for j in range(2):
            assert sd[f"transformer.0.blocks.{m}.{j}.ffn.fn.experts.fc1.weight"].shape == \
                (4, 64, 32)
    assert "transformer.0.fusion.0.ffn.fn.net.0.weight" in sd
    every2 = ModelCross(port_config("cross", moe_experts=4, moe_every=2),
                        device="cpu").state_dict()
    assert "transformer.0.blocks.0.0.ffn.fn.net.0.weight" in every2
    assert "transformer.0.blocks.1.1.ffn.fn.router.weight" in every2
    jtree = _jax_init("cross", moe_experts=4, moe_every=2)
    assert set(state_dict_from_jax(jtree, port_config("cross"))) == set(every2)
    with pytest.raises(ValueError, match="stacked_streams"):
        ModelCross(port_config("cross", moe_experts=4, stacked_streams=True), device="cpu")


def test_model_cross_moe_dense_equivalent_with_identical_experts():
    """Identical experts and top-2 renormalised gates at ample capacity: the
    MoE is the dense FFN (g1·f(x) + g2·f(x) = f(x)), so the logits equal a
    dense model holding expert 0's weights."""
    fields = dict(moe_experts=2, moe_num_selected=2, moe_capacity_factor=4.0)
    params = _jax_init("cross", seed=3, **fields)
    dense = _jax_init("cross", seed=3)
    for blk_m, blk_d in zip(params["multi_blocks"], dense["multi_blocks"]):
        for st_m, st_d in zip(blk_m["self_blocks"], blk_d["self_blocks"]):
            for lay_m, lay_d in zip(st_m, st_d):
                ex = lay_m["ffn"]["experts"]
                for w in ("fc1", "fc2"):
                    for leaf in ("kernel", "bias"):
                        ex[w][leaf] = np.stack([ex[w][leaf][0]] * 2)
                    lay_d["ffn"][w] = {leaf: ex[w][leaf][0] for leaf in ("kernel", "bias")}
                for k in ("attn_norm", "attn", "ffn_norm"):
                    lay_d[k] = lay_m[k]
        blk_d["cross_blocks"] = blk_m["cross_blocks"]
    for k in ("pos_embedding", "cls_token", "patch_to_embedding", "norm", "mlp_head"):
        dense[k] = params[k]
    img = torch.from_numpy(model_batches("cross")[0][0])
    with torch.no_grad():
        got = _port("cross", params, **fields)(img)
        want = _port("cross", dense)(img)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["cross_ep2", "cross_dp2_ep2", "cross_dp2_moe_fsdp"])
def test_model_cross_moe_ep_train_step_matches_serial(runs, name):
    """The MoE ModelCross over (expert 2), (data 2 × expert 2) and, with its
    experts whole, (data 2) under FSDP."""
    _check_case(runs, name)


# ---------------------------------------------------------------------------
# Trainer.fit, the CLIs, checkpoints and serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit")
    spawn("fit", tmp, 2)
    return tmp


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_fit_matches_the_one_process_fit(fitted, name):
    """Two epochs of Trainer.fit over (expert 2) and over (seq 2): both
    ranks' histories equal the one-process run's within 1e-5; rank 0's
    rolling checkpoint holds the whole experts."""
    hists = [json.loads((fitted / f"{name}_{r}.json").read_text()) for r in range(2)]
    one = fit_trainer(name)
    want = one.fit(*fit_loaders(), verbose=False)
    assert hists[0] == hists[1] and len(want) == len(hists[0]) == 2
    for row, wrow in zip(hists[0], want):
        for k, v in row.items():
            assert abs(v - wrow[k]) <= TOL, (k, v, wrow[k])
    from cross_attention_vit_tpu_torch.train.checkpoint import restore_flat

    ckpt = next((fitted / name / "latest").glob("step=*.npz"))
    flat = restore_flat(ckpt)
    got = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    for k, v in flatten(one.params).items():
        np.testing.assert_allclose(got[k], v, atol=2.5 * LR * 8, rtol=0, err_msg=k)
    if "moe_experts" in FIT_CASES[name][0]:
        key = "multi_blocks/0/self_blocks/0/0/ffn/experts/fc1/kernel"
        assert flat[f"params/{key}"].shape == (4, 32, 64)
        assert flat[f"opt/mu/{key}"].shape == (4, 32, 64)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    write_cohort(tmp)
    spawn("cli", tmp, 2)
    return tmp, [json.loads((tmp / f"cli_{r}.json").read_text()) for r in range(2)]


def test_experiments_cli_trains_over_ep_and_sp(cli):
    """``--ep 2 --set moe_experts=4`` and ``--sp 2`` over two processes: one
    epoch, the same finite history on both ranks, the JAX driver's
    artifacts, and the MoE checkpoint's config carrying moe_experts."""
    tmp, (c0, c1) = cli
    assert c0 == c1
    for axis in ("ep", "sp"):
        hist = c0[axis]["test_200_0_0_0"]
        assert len(hist) == 1 and all(np.isfinite(v) for v in hist[0].values())
        files = {str(p.relative_to(tmp / axis)) for p in (tmp / axis).rglob("*") if p.is_file()}
        assert "checkpoints/cross/config_test_200_0_0_0.json" in files
        assert any(f.startswith("latest/test_200_0_0_0/step=") for f in files)
    cfg = json.loads((tmp / "ep" / "checkpoints" / "cross" / "config_test_200_0_0_0.json")
                     .read_text())
    assert cfg["moe_experts"] == 4
    sp = json.loads((tmp / "sp" / "checkpoints" / "cross" / "config_test_200_0_0_0.json")
                    .read_text())
    assert sp["seq_parallel"] == 2


@pytest.mark.parametrize("axis", ["ep", "sp"])
def test_evaluate_reads_the_sharded_runs_checkpoint_as_jax_does(cli, axis):
    """A checkpoint of the two-process run (a MoE one for --ep) evaluated in
    one process by the port and by JAX: the same metrics within 1e-6."""
    from cross_attention_vit_tpu.drivers import evaluate as jeval
    from cross_attention_vit_tpu_torch.drivers import evaluate as teval

    tmp, _ = cli
    ckpt = next((tmp / axis / "checkpoints" / "cross").glob("epoch=*.npz"))
    args = ["--checkpoint", str(ckpt), "--model", "cross", "--labels", str(tmp / "labels.csv"),
            "--data", str(tmp / "data"), "--only-available", "--batch-size", "4"]
    got, want = teval.main(args, device="cpu"), jeval.main(args)
    assert set(got) == set(want) and got["n"] == want["n"] == 20
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_moe_checkpoint_crosses_both_ways(tmp_path):
    """A JAX Trainer's MoE checkpoint resumes in the port (params and Adam
    moments exact), and the port's checkpoint restores in JAX."""
    from cross_attention_vit_tpu.train import checkpoint as jckpt
    from cross_attention_vit_tpu.train import optim as joptim
    from cross_attention_vit_tpu.train import trainer as jtrainer
    from cross_attention_vit_tpu_torch.train.checkpoint import LatestCheckpointer, restore_flat

    jcfg = _jax_config("cross", moe_experts=4)
    jt = jtrainer.Trainer(jmc, jcfg, max_epochs=1, seed=3,
                          latest=jckpt.LatestCheckpointer(tmp_path / "jax"))
    jt.init_state()
    img, lab = model_batches("cross")[0]
    jt.params, jt.opt_state, _ = jt.train_step(jt.params, jt.opt_state, img,
                                               lab.astype(np.int32),
                                               jnp.asarray(LR, jnp.float32), jax.random.key(0))
    jt.latest.save(1, {"params": jt.params, "opt": jt.opt_state,
                       "epoch": jnp.zeros((), jnp.int32)})
    t = ttrainer.Trainer(ModelCross, port_config("cross", moe_experts=4), max_epochs=3,
                         device="cpu", latest=LatestCheckpointer(tmp_path / "jax"))
    t.init_state()
    assert t.maybe_resume() == 1 and t.optimizer.step_count == 1
    flat = restore_flat(next((tmp_path / "jax").glob("step=*.npz")))
    for k, v in flatten(t.params).items():
        np.testing.assert_array_equal(v, flat[f"params/{k}"], err_msg=k)
    mu, _ = t._moment_trees()
    for k, v in flatten(mu).items():
        np.testing.assert_array_equal(v, flat[f"opt/mu/{k}"], err_msg=k)
    # the port's own checkpoint, restored by JAX
    t.latest = LatestCheckpointer(tmp_path / "port")
    t.latest.save(1, t._ckpt_state(0))
    like_params = jmc.init(jax.random.key(1), jcfg)
    like = {"params": like_params, "opt": joptim.init(like_params),
            "epoch": jnp.zeros((), jnp.int32)}
    state = jckpt.restore_pytree(next((tmp_path / "port").glob("step=*.npz")), like)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 state["params"], t.params)


def test_moe_checkpoint_serves_on_one_device(tmp_path):
    """InferenceServer on a MoE checkpoint: its answers equal a direct
    forward and JAX's logits; the router and experts stay f32 in a bf16
    serving model; int8 quantizes what JAX quantizes (the stacked experts
    and the router are not eligible)."""
    from cross_attention_vit_tpu.models.quantize import count_quantized as jax_count
    from cross_attention_vit_tpu.models.quantize import quantize_for_inference
    from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer
    from cross_attention_vit_tpu_torch.models.quantize import count_quantized
    from cross_attention_vit_tpu_torch.train.checkpoint import save_config

    fields = dict(moe_experts=4, hidden_dim=128, mlp_dim=512, num_heads=4)
    params = _jax_init("cross", seed=5, **fields)
    ckpt = tmp_path / "moe.npz"
    save_pytree(ckpt, {"params": params})
    cfg = port_config("cross", **fields)
    save_config(tmp_path, cfg)
    img = model_batches("cross")[0][0][:4]     # one whole bucket: the routing sees no padding
    server = InferenceServer(ckpt, "cross", buckets=(1, 4), device="cpu")
    server.start()
    try:
        got = server.predict(img)
    finally:
        server.stop()
    with torch.no_grad():
        direct = server.model(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, direct)
    want = jax.jit(lambda p, x: jmc.apply(p, _jax_config("cross", **fields), x))(params, img)
    np.testing.assert_allclose(got, np.asarray(want), atol=LOGIT_TOL, rtol=0)
    site = server.model.transformer[0].blocks[0][0].ffn.fn
    assert site.router.weight.dtype == site.experts["fc1"].weight.dtype == torch.float32
    q = InferenceServer(ckpt, "cross", buckets=(1,), quantize="int8", device="cpu")
    jq = quantize_for_inference(params)
    assert q.quantized_kernels == jax_count(jq)[0] > 0
    assert count_quantized(q.model)[0] == q.quantized_kernels
