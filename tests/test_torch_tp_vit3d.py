"""The stateful ViT3D over a 'model' axis in the port — the counterpart of
JAX's ``Trainer(vit3d, stateful=True, mesh=make_mesh(D, T))``, whose
``shard_params`` places ViT3D's leaves by name (``_spec_for``: the qkv
kernel's heads, the out kernel's heads, fc1/fc2 of each layer and of the
head) and whose GSPMD then runs the Megatron split.

* Over gloo ranks (``tests/torch_mesh_workers.py``, mode tp_vit3d,
  ``BN_TP_CASES``): (model 2); (data 2 × model 2), the BatchNorms
  synchronised over the data line; and (data 2 × model 2) with FSDP at
  hidden 128, where FSDP shards the qkv, the feed-forwards and the last stem
  conv.  Two stateful ``Trainer`` steps from the same weights and
  BatchNorm state: the loss and probs within 1e-5 of the one-process step's
  and of JAX's ``make_stateful_train_step`` over its own mesh of the same
  axes on the CPU's virtual devices; the first step's gathered gradients
  within 2e-4 normalised (max |diff| / max |ref|) of the one-process
  step's (the stem's conv biases, whose gradient is zero in exact
  arithmetic, at 1e-6 absolute, as ``test_torch_sync_bn.py`` holds them);
  the running statistics within 1e-5 relative of both; the parameters after
  Adam within 2.5·lr of both; the ranks bit-equal (what no region splits
  gets the 'model' line's mean gradient); each rank holds its
  heads' and MLP columns' slices; the checkpoint state is whole, in JAX's
  layout, and loads into a one-process (model 1) Trainer.
* The refusals: JAX's ``shard_params`` raises on the DenseNet-stem ViT3D
  and on CNNViT over any mesh (their 2-D ``out`` kernels get the 3-entry
  spec P('model', None, None)); the port's ``shard_tensor_parallel`` raises
  ValueError over a 'model' axis, naming the leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu import parallel as jpar
from cross_attention_vit_tpu.configs import get_mgmt_config as jax_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.models import vit3d as jvit3d
from cross_attention_vit_tpu.train import optim as joptim
from cross_attention_vit_tpu.train.trainer import make_stateful_train_step
from cross_attention_vit_tpu_torch.models import convert as tconvert
from cross_attention_vit_tpu_torch.models.cnn_vit import CNNViT
from cross_attention_vit_tpu_torch.models.vit3d import ViT3D
from cross_attention_vit_tpu_torch.parallel.tensor import shard_tensor_parallel
from cross_attention_vit_tpu_torch.train.checkpoint import flatten, save_pytree
from torch_mesh_workers import (BN_TINY, BN_TP_CASES, LR, STEPS, bn_batches, bn_config,
                                bn_steps, bn_trainer, launch, load, wait_world)

TOL = 1e-5
GRAD_TOL = 2e-4
# the stem's conv biases each feed a BatchNorm: zero gradient in exact arithmetic
ZERO_GRAD = {f"grad/encoder.conv{i}.bias" for i in range(1, 5)}


def _init(**fields) -> tuple[dict, dict]:
    """Weights and BatchNorm state from a seed, the stem's conv biases at 1
    (see ``test_torch_sync_bn.py``)."""
    model = ViT3D(bn_config(**fields), device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i in range(1, 5):
            getattr(model.encoder, f"conv{i}").bias.fill_(1.0)
    return tconvert.jax_params_from_model(model), tconvert.jax_state_from_model(model)


def _jax_mesh_steps(params: dict, state: dict, axes: dict, fsdp: bool, fields: dict) -> dict:
    """JAX's stateful step over its own mesh of ``axes`` (parameters by
    ``shard_params``, the state replicated, as JAX's ``Trainer`` sets them
    up): loss, probs, parameters and running statistics after each step."""
    cfg = jax_config()
    jax_modify(cfg, {**BN_TINY, **fields})
    mesh = jpar.make_mesh(axes.get("data", 1), axes.get("model", 1))
    p = jpar.shard_params(jax.tree.map(jnp.asarray, params), mesh, fsdp=fsdp)
    st = jax.device_put(jax.tree.map(jnp.asarray, state), jpar.replicated(mesh))
    opt = joptim.init(p)
    step = make_stateful_train_step(jvit3d.apply, cfg, donate=False, mesh=mesh)
    out = {}
    for s, (img, lab) in enumerate(bn_batches()):
        img, lab = jpar.shard_batch((img, lab.astype(np.int32)), mesh)
        p, st, opt, aux = step(p, st, opt, img, lab, jnp.asarray(LR, jnp.float32),
                               jax.random.key(s))
        out[f"loss/{s}"], out[f"probs/{s}"] = float(aux["loss"]), np.asarray(aux["probs"])
        out.update({f"params{s}/{k}": v for k, v in flatten(jax.tree.map(np.asarray, p)).items()})
        out.update({f"state{s}/{k}": v
                    for k, v in flatten(jax.tree.map(np.asarray, st)).items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks (both worlds run while the references are made),
    its one-process run and JAX's mesh run."""
    tmp = tmp_path_factory.mktemp("tp_vit3d")
    inits = {}
    for name, (fields, *_) in BN_TP_CASES.items():
        inits[name] = _init(**fields)
        save_pytree(tmp / f"bn_init_{name}.npz", dict(zip(("params", "state"), inits[name])))
    worlds = [launch("tp_vit3d", tmp, w) for w in sorted({c[2] for c in BN_TP_CASES.values()})]
    one, jax_ref, by_fields = {}, {}, {}
    for name, (fields, axes, _, fsdp) in BN_TP_CASES.items():
        key = tuple(sorted(fields.items()))
        if key not in by_fields:           # the same fields: the same one-process run
            by_fields[key] = bn_steps(bn_trainer(*inits[name], **fields))
        one[name] = by_fields[key]
        jax_ref[name] = _jax_mesh_steps(*inits[name], axes, fsdp, fields)
    for w in worlds:
        wait_world(w)
    ranks = {name: load(tmp, f"tp_vit3d_{name}", world)
             for name, (_, _, world, _) in BN_TP_CASES.items()}
    return ranks, one, jax_ref


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("name", list(BN_TP_CASES))
def test_tp_vit3d_steps_match_one_process(runs, name):
    """Loss and probs within 1e-5, the first step's whole gradients within
    2e-4 normalised, the running statistics within 1e-5 relative, the
    parameters after each Adam step within 2.5·lr, and the eval step, of
    the one-process batch-8 run."""
    ranks, one, _ = runs
    got, ref = ranks[name][0], one[name]
    for s in range(STEPS):
        assert float(got[f"loss/{s}"]) == pytest.approx(float(ref[f"loss/{s}"]), rel=TOL)
        np.testing.assert_allclose(got[f"probs/{s}"], ref[f"probs/{s}"], atol=TOL)
        for k in (k for k in ref if k.startswith(f"params{s}/")):
            np.testing.assert_allclose(got[k], ref[k], atol=2.5 * LR, rtol=0, err_msg=k)
        stats = [k for k in ref if k.startswith(f"state{s}/")]
        assert len(stats) == 8                    # 4 BatchNorms × (mean, var)
        for k in stats:
            assert _rel(got[k], ref[k]) <= TOL, (k, _rel(got[k], ref[k]))
    grads = [k for k in ref if k.startswith("grad/")]
    assert grads and set(grads) == {k for k in got if k.startswith("grad/")}
    for k in grads:
        if k in ZERO_GRAD:      # rounding noise on both sides
            assert np.abs(got[k]).max() <= 1e-6 and np.abs(ref[k]).max() <= 1e-6, k
            continue
        assert _rel(got[k], ref[k]) <= GRAD_TOL, (k, _rel(got[k], ref[k]))
    np.testing.assert_allclose(got["eval/probs"], ref["eval/probs"], atol=TOL)
    assert float(got["eval/loss"]) == pytest.approx(float(ref["eval/loss"]), rel=TOL)


@pytest.mark.parametrize("name", list(BN_TP_CASES))
def test_tp_vit3d_steps_match_jax_mesh_step(runs, name):
    """Loss, probs, running statistics and the parameters after each step
    against JAX's stateful step over its own mesh of the same axes."""
    ranks, _, jax_ref = runs
    got, ref = ranks[name][0], jax_ref[name]
    for s in range(STEPS):
        assert float(got[f"loss/{s}"]) == pytest.approx(ref[f"loss/{s}"], rel=TOL)
        np.testing.assert_allclose(got[f"probs/{s}"], ref[f"probs/{s}"], atol=TOL)
        keys = [k for k in ref if k.startswith(f"params{s}/")]
        assert keys and set(keys) == {k for k in got if k.startswith(f"params{s}/")}
        for k in keys:
            np.testing.assert_allclose(got[k], ref[k], atol=2.5 * LR, rtol=0, err_msg=k)
        for k in (k for k in ref if k.startswith(f"state{s}/")):
            assert _rel(got[k], ref[k]) <= TOL, (k, _rel(got[k], ref[k]))


@pytest.mark.parametrize("name", list(BN_TP_CASES))
def test_tp_vit3d_ranks_agree_and_hold_their_slices(runs, name):
    """Every rank's results bit for bit, running statistics included; each
    rank holds half the heads and MLP columns of every split layer and of
    the head, the qkv bias, LayerNorms and stem whole; the BatchNorms
    synchronise over the data line where there is one; FSDP shards only
    over 'data', on top of the TP slices."""
    ranks = runs[0][name]
    fields, axes, _, fsdp = BN_TP_CASES[name]
    H = bn_config(**fields).hidden_dim
    for other in ranks[1:]:
        assert set(other) == set(ranks[0])
        for k in ranks[0]:
            if not k.startswith("local/"):
                np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)
    shards = {k for k in ranks[0] if k.startswith("local/fsdp:")}
    assert bool(shards) == fsdp
    for rank in ranks:
        assert int(rank["sync_groups"]) == (4 if axes.get("data", 1) > 1 else 0)

        def local(n: str) -> tuple:
            shape = list(rank[f"local/{n}"])
            if f"local/fsdp:{n}" in rank:        # the TP slice, before FSDP's half
                shape[int(rank[f"local/fsdp:{n}"])] *= axes["data"]
            return tuple(shape)

        p = "transformer.layers.0"
        assert local(f"{p}.self_attn.in_proj_weight") == (3 * H // 2, H)
        assert local(f"{p}.self_attn.in_proj_bias") == (3 * H,)
        assert local(f"{p}.self_attn.out_proj.weight") == (H, H // 2)
        assert local(f"{p}.self_attn.out_proj.bias") == (H,)
        assert local(f"{p}.linear1.weight") == (2 * H, H)
        assert local(f"{p}.linear1.bias") == (2 * H,)
        assert local(f"{p}.linear2.weight") == (H, 2 * H)
        assert local("mlp_head.1.weight") == (H // 16, H)
        assert local("mlp_head.1.bias") == (H // 16,)
        assert local("mlp_head.2.weight") == (2, H // 16)
        assert local("pos_embed")[-1] == H


@pytest.mark.parametrize("name", [n for n, case in BN_TP_CASES.items() if not case[3]])
def test_tp_vit3d_model_line_averages_what_it_replicates(runs, name):
    """``sync_replicated_grads`` on gradients of 1 + the rank's 'model'
    coordinate: the stem's conv gradient becomes the line's mean (1.5) on
    both of its ranks, so the replicated parameters stay one value even
    where the card's stem kernels round the ranks' gradients apart; a split
    slice keeps its own."""
    ranks = runs[0][name]
    axes = BN_TP_CASES[name][1]
    for r, rank in enumerate(ranks):
        coord = r % axes["model"]              # the mesh's last axis is 'model'
        np.testing.assert_array_equal(rank["local/line_mean:replicated"], 1.5)
        np.testing.assert_array_equal(rank["local/line_mean:split"], 1.0 + coord)


@pytest.mark.parametrize("name", list(BN_TP_CASES))
def test_tp_vit3d_checkpoint_loads_at_model_1(runs, name):
    """The ranks' checkpoint state is whole and in JAX's key layout (the
    one-process run's keys and shapes), and loads into a one-process Trainer
    (model 1) whose parameters and running statistics are the one-process
    run's after its two steps."""
    ranks, one, _ = runs
    fields = BN_TP_CASES[name][0]
    ckpt = {k[len("ckpt/"):]: v for k, v in ranks[name][0].items() if k.startswith("ckpt/")}
    want = {k[len("ckpt/"):]: v for k, v in one[name].items() if k.startswith("ckpt/")}
    assert set(ckpt) == set(want)
    for k, v in want.items():
        assert ckpt[k].shape == v.shape, k
    t = bn_trainer(*_init(**fields), **fields)
    t._load_flat(ckpt)
    for k, v in flatten(t.params).items():
        np.testing.assert_allclose(v, want[f"params/{k}"], atol=2.5 * LR, rtol=0, err_msg=k)
    for k, v in flatten(t.model_state).items():
        assert _rel(v, want[f"model_state/{k}"]) <= TOL, k


# ---------------------------------------------------------------------------
# the models JAX does not place over 'model'
# ---------------------------------------------------------------------------

class _Mesh:
    """The axis sizes the port's placement reads."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, i):
        return self._sizes[i]


REFUSED = {
    "vit3d_densenet": (ViT3D, dict(BN_TINY, pretrained_cnn=True, num_modalities=1,
                                   hidden_dim=64), "encoder.class_layers.out.weight"),
    "cnn_vit": (CNNViT, dict(img_size=(32, 32, 32), num_modalities=2, patches_grid=(2, 2, 2),
                             hidden_size=64, transformer_num_layers=1, transformer_num_heads=4,
                             transformer_mlp_dim=128), "blocks.0.out.weight"),
}


@pytest.mark.parametrize("name", list(REFUSED))
@pytest.mark.parametrize("size", [2, 4])
def test_models_jax_refuses_are_refused(name, size):
    """JAX's ``shard_params`` fails on the model's 2-D ``out`` kernel over
    (data 1 × model ``size``); the port's raises ValueError naming the leaf
    and JAX's refusal, before it splits anything."""
    cls, fields, leaf = REFUSED[name]
    cfg = bn_config(**fields)
    model = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, tconvert.jax_params_from_model(model))
    with pytest.raises(ValueError, match="only valid for values of rank at least 3"):
        jpar.shard_params(params, jpar.make_mesh(1, size))
    before = {n: p.shape for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match=f"{leaf}.*JAX.*refuses"):
        shard_tensor_parallel(model, _Mesh(data=1, model=size))
    assert {n: p.shape for n, p in model.named_parameters()} == before
    assert getattr(model, "tp_layout", None) is None
