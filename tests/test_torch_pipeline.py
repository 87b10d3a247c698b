"""Pipeline parallelism in the port — GPipe over a 'pipe' mesh axis for
ModelVIT (``pipeline_stages > 1``), the counterpart of ``tests/test_pipeline.py``.

* The schedule's pieces: JAX's strided microbatches, the bubble fraction,
  stacking and unstacking per-layer trees as JAX does, and the validation
  errors (depth over stages, batch over microbatches, MoE with PP, a 'pipe'
  axis without ``pipeline_stages``, a model not split over the mesh).
* The serial schedule (no 'pipe' axis) against the plain trunk loop and
  JAX's sequential ModelVIT: logits within 1e-5.
* Over gloo ranks (``tests/torch_mesh_workers.py``): (pipe 2), (pipe 2 ×
  data 2) and (pipe 2 × model 2), from a JAX PP checkpoint (stacked
  ``layers``): the logits before any step within 1e-5 of JAX's sequential
  ModelVIT; one Adam step within atol=1e-5, rtol=1e-4 of JAX's PP train
  step (``assert_adam_step_matches``); two steps equal to the one-process
  serial schedule's, and with dropout 0.1 and drop path 0.1 too (the
  per-(layer, microbatch) masks are the serial ones); the ranks of a pipe
  line agree exactly; each stage holds only its layers.
* Checkpoints: the port's PP checkpoint is stacked and JAX restores it
  against ``init(cfg)`` with ``pipeline_stages``; the one-process state
  resumes over (pipe 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.models import model_vit as jmv
from cross_attention_vit_tpu.parallel import stack_layers as jax_stack
from cross_attention_vit_tpu.parallel import unstack_layers as jax_unstack
from cross_attention_vit_tpu.parallel.pipeline import _microbatch as jax_microbatch
from cross_attention_vit_tpu.train import checkpoint as jckpt
from cross_attention_vit_tpu.train import optim as joptim
from cross_attention_vit_tpu_torch.models.convert import load_jax_params
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.parallel import (bubble_fraction, set_pipeline_mesh,
                                                    shard_stages, stack_layers, unstack_layers)
from cross_attention_vit_tpu_torch.parallel.pipeline import _microbatch, _unmicrobatch
from torch_mesh_workers import LR, PP, PP_CASES, model_batches, port_config
from torch_split_reference import (TOL, assert_adam_step_matches, assert_matches_one_process,
                                   jax_config, jax_init, jax_step, run_cases)


class _Mesh:
    """The axis sizes the pipeline's checks read, without a group."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, i=None):
        return int(np.prod(self._sizes)) if i is None else self._sizes[i]

    def get_local_rank(self, name):
        return 0


@pytest.fixture(autouse=True)
def _clear_pipeline_mesh():
    yield
    set_pipeline_mesh(None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    got, refs = run_cases(tmp, PP_CASES)
    return tmp, got, refs


def _port_vit(params, **fields):
    model = ModelVIT(port_config("vit", **fields), device="cpu", master_weights=True)
    load_jax_params(model, params)
    return model


# ---------------------------------------------------------------------------
# the schedule's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mb", [1, 2, 4, 8])
def test_strided_microbatches_match_jax(mb):
    """Microbatch i holds the rows b % MB == i, as JAX's ``_microbatch``;
    ``_unmicrobatch`` puts them back."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    parts = _microbatch(torch.from_numpy(x), mb)
    np.testing.assert_array_equal(np.stack([p.numpy() for p in parts]),
                                  np.asarray(jax_microbatch(jnp.asarray(x), mb)))
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(p.numpy(), x[i::mb])
    np.testing.assert_array_equal(_unmicrobatch(parts).numpy(), x)


def test_bubble_fraction_and_stacked_layers():
    """(S − 1)/(MB + S − 1); stacking per-layer trees gives JAX's stacked
    leaves and unstacking gives them back."""
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(2, 4) == pytest.approx(0.2)
    params = jax_init("vit", num_layers=3)
    stacked = stack_layers(params["layers"])
    jax.tree.map(np.testing.assert_array_equal, stacked,
                 jax.tree.map(np.asarray, jax_stack(params["layers"])))
    assert stacked["attn"]["qkv"]["kernel"].shape[0] == 3
    jax.tree.map(np.testing.assert_array_equal, unstack_layers(stacked), params["layers"])
    jax.tree.map(np.testing.assert_array_equal, unstack_layers(stacked),
                 jax.tree.map(np.asarray, jax_unstack(jax_stack(params["layers"]), 3)))


def test_pipeline_validation():
    """JAX's errors: depth not divisible by the stages, a batch not divisible
    by the microbatches, MoE with PP; and the port's own: a 'pipe' axis for a
    model without a pipelined trunk, and a pipeline mesh over a model not
    split over it."""
    with pytest.raises(ValueError, match="depth 3 not divisible by pipe=2"):
        shard_stages(ModelVIT(port_config("vit", **{**PP, "num_layers": 3}), device="cpu"),
                     _Mesh(pipe=2, data=1))
    with pytest.raises(ValueError, match="pipelined trunk"):
        shard_stages(ModelCross(port_config("cross", pipeline_stages=2), device="cpu"),
                     _Mesh(pipe=2, data=1))
    with pytest.raises(ValueError, match="pipelined trunk"):
        shard_stages(ModelVIT(port_config("vit"), device="cpu"), _Mesh(pipe=2, data=1))
    img = torch.from_numpy(model_batches("vit")[0][0])
    with pytest.raises(ValueError, match="num_microbatches=3"):
        ModelVIT(port_config("vit", **{**PP, "pipeline_microbatches": 3}), device="cpu")(img)
    with pytest.raises(ValueError, match="pipeline_stages"):
        ModelVIT(port_config("vit", moe_experts=4, pipeline_stages=2), device="cpu")
    set_pipeline_mesh(_Mesh(pipe=2, data=1))
    with pytest.raises(RuntimeError, match="not split over it"):
        ModelVIT(port_config("vit", **PP), device="cpu")(img)


def test_trainer_refuses_a_pipe_axis_without_pipeline_stages():
    import torch.distributed as dist
    from cross_attention_vit_tpu_torch.parallel import multihost_init
    from cross_attention_vit_tpu_torch.train.trainer import Trainer
    from torch_mesh_workers import free_port

    multihost_init(f"127.0.0.1:{free_port()}", 1, 0, device="cpu", timeout_s=30)
    try:
        with pytest.raises(ValueError, match="pipeline_stages=0"):
            Trainer(ModelVIT, port_config("vit"), max_epochs=1, mesh=_Mesh(pipe=2, data=1),
                    device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mb", [1, 2, 4])
def test_serial_schedule_matches_plain_trunk_and_jax(mb):
    """pipeline_stages = 2 without a mesh: the serial schedule, equal to the
    plain trunk loop and to JAX's sequential ModelVIT within 1e-5, and to
    JAX's own PP ModelVIT (its serial fallback)."""
    params = jax_init("vit", num_layers=4)
    img = model_batches("vit")[0][0]
    pp = {**PP, "pipeline_microbatches": mb}
    with torch.no_grad():
        plain = _port_vit(params, num_layers=4)(torch.from_numpy(img)).numpy()
        piped = _port_vit(params, **pp)(torch.from_numpy(img)).numpy()
    want = np.asarray(jmv.apply(params, jax_config("vit", num_layers=4), img))
    stacked = dict(params, layers=jax_stack(params["layers"]))
    jax_pp = np.asarray(jmv.apply(stacked, jax_config("vit", **pp), img))
    np.testing.assert_allclose(piped, plain, atol=1e-6, rtol=0)
    np.testing.assert_allclose(piped, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(piped, jax_pp, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the pipe schedule over gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PP_CASES))
def test_pipe_schedule_matches_the_serial_schedule(runs, name):
    """Two steps over the mesh equal the one-process serial schedule's
    (dropout and drop path on in vit_pp2_dropout: the same masks)."""
    _, got, refs = runs
    assert_matches_one_process(got[name], refs[name])


@pytest.mark.parametrize("name", ["vit_pp2", "vit_pp2_dp2", "vit_pp2_tp2"])
def test_pipe_schedule_matches_jax(runs, name):
    """Logits within 1e-5 of JAX's sequential ModelVIT; one Adam step
    against JAX's PP train step (stacked parameters)."""
    _, got, _ = runs
    _, fields, _, _ = PP_CASES[name]
    stacked = jax_init("vit", seed=len(name), **fields)
    sequential = dict(stacked, layers=unstack_layers(stacked["layers"]))
    img = model_batches("vit")[0][0]
    want = np.asarray(jmv.apply(sequential, jax_config("vit", num_layers=4), img))
    _, new = jax_step("vit", stacked, **fields)
    for rank in got[name]:
        np.testing.assert_allclose(rank["logits0"], want, atol=TOL, rtol=0)
        assert_adam_step_matches({k: rank[f"params0/{k}"] for k in new}, stacked, new)


@pytest.mark.parametrize("name", ["vit_pp2", "vit_pp2_tp2"])
def test_pipe_stages_hold_their_layers(runs, name):
    """Stage s holds layers 2s and 2s + 1 of 4 and nothing of the others;
    the embedding and the head are on every stage."""
    _, got, _ = runs
    for r, rank in enumerate(got[name]):
        stage = r // (len(got[name]) // 2)
        layers = {int(k.split(".")[2]) for k in rank if k.startswith("local/transformer.layers.")}
        assert layers == {2 * stage, 2 * stage + 1}, (r, layers)
        assert "local/pos_embedding" in rank and "local/mlp_head.4.weight" in rank


def test_pipe_checkpoint_is_stacked_and_jax_restores_it(runs, tmp_path):
    """The (pipe 2) run's checkpoint holds the whole trunk stacked on a depth
    axis; JAX restores it against ``init(cfg)`` with pipeline_stages, equal to
    the one-process state; the one-process state after step 0 resumes over
    (pipe 2) into the one-process step 1."""
    _, got, refs = runs
    rank, ref = got["vit_pp2"][0], refs["vit_pp2"]
    ckpt = {k[len("ckpt/"):]: v for k, v in rank.items() if k.startswith("ckpt/")}
    assert ckpt["params/layers/attn/qkv/kernel"].shape[0] == 4
    assert ckpt["opt/mu/layers/ffn/fc1/kernel"].shape[0] == 4
    np.savez(tmp_path / "pp.npz", **ckpt)
    cfg = jax_config("vit", **PP)
    like_params = jmv.init(jax.random.key(1), cfg)
    like = {"params": like_params, "opt": joptim.init(like_params),
            "epoch": jnp.zeros((), jnp.int32)}
    state = jckpt.restore_pytree(tmp_path / "pp.npz", like)
    for k, v in ((k, v) for k, v in ref.items() if k.startswith("ckpt/params/")):
        path = k[len("ckpt/params/"):].split("/")
        leaf = state["params"]
        for p in path:
            leaf = leaf[int(p)] if isinstance(leaf, list) else leaf[p]
        np.testing.assert_allclose(np.asarray(leaf), v, atol=2.5 * LR, rtol=0, err_msg=k)
    assert float(rank["resumed/loss"]) == pytest.approx(float(ref["loss/1"]), rel=TOL, abs=TOL)
    for k in (k for k in ref if k.startswith("params1/")):
        np.testing.assert_allclose(rank["resumed/" + k[len("params1/"):]], ref[k],
                                   atol=2.5 * LR, rtol=0, err_msg=k)
