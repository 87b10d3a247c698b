"""Tensor parallelism in the port — the head-aligned Megatron split over a
'model' mesh axis, the counterpart of the TP cases of ``tests/test_parallel.py``.

* The rule (``parallel.sharding.tp_dim``): for every parameter of ModelCross
  and ModelVIT, dense and MoE, and of the stateful ViT3D (CNN3DEncoder
  stem, CLS or mean pooling), the elements each of T ranks keeps are those
  JAX's ``param_specs`` gives that rank, the (3, K, D) interleave of the
  fused qkv included (``test_torch_tp_vit3d.py`` trains the ViT3D split).
* Over gloo ranks (``tests/torch_mesh_workers.py``), (model 2) and (data 2 ×
  model 2), both models, from JAX-initialised parameters: the logits before
  any step equal JAX's within 1e-5; one Adam step (f32, dropout 0) equals
  JAX's single-device step within JAX's own atol=1e-5, rtol=1e-4 (the
  cross-attention key biases left out, as JAX's test leaves them out: their
  gradient is zero in exact arithmetic); two steps' loss, probs, gradients
  and parameters equal the one-process port's within 1e-5 (the parameters
  after Adam within 2.5·lr, as ``test_torch_sp_ep_models.py`` holds them);
  the ranks of a model line agree exactly.
* Dropout 0.1 over (model 2): the step equals the one-process step, so the
  split regions draw the one-process masks; the split mask alone is the
  whole mask's slice.
* Checkpoints cross TP sizes: the two-rank run writes whole tensors (JAX
  layout) equal to the one-process state, and the one-process state after
  step 0 resumes over (model 2) into the one-process step 1.
* The refusals: T not dividing the heads or the MLP width, and a 'pipe'
  axis with a 'seq' axis alone among the axis combinations (TP and PP with
  FSDP, SP and EP compose: ``test_torch_composed_parallel.py``).
"""

import jax
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.parallel import param_specs
from cross_attention_vit_tpu_torch.models.convert import jax_params_from_state_dict
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.models.vit3d import ViT3D
from cross_attention_vit_tpu_torch.ops.layers import dropout, dropout_mask
from cross_attention_vit_tpu_torch.parallel import TP, tp_dim
from cross_attention_vit_tpu_torch.parallel.tensor import split_place, split_slice
from cross_attention_vit_tpu_torch.train.checkpoint import flatten
from torch_mesh_workers import CROSS, LR, TP_CASES, bn_config, port_config, port_trainer
from torch_split_reference import (TOL, assert_adam_step_matches, assert_matches_one_process,
                                   jax_init, jax_step, run_cases)

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    got, refs = run_cases(tmp, TP_CASES)
    return tmp, got, refs


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

def _numbered(model) -> dict[str, np.ndarray]:
    """The model's state dict with every element numbered: the JAX layout
    is a permutation of the same numbers."""
    sd, start = {}, 0
    for name, t in model.state_dict().items():
        sd[name] = np.arange(start, start + t.numel(), dtype=np.float64).reshape(t.shape)
        start += t.numel()
    return sd


def _rule_model(family: str, fields: dict):
    if family == "vit3d":          # the stateful ViT3D JAX places: the CNN3DEncoder stem
        cfg = bn_config(**fields)
        return cfg, ViT3D(cfg, device="cpu")
    cfg = port_config(family, **fields)
    return cfg, (ModelCross if family == "cross" else ModelVIT)(cfg, device="cpu")


@pytest.mark.parametrize("family,fields", [("cross", {}), ("cross", {"moe_experts": 4}),
                                           ("vit", {}), ("vit", {"moe_experts": 4}),
                                           ("vit3d", {}), ("vit3d", {"add_cls_token": False})],
                         ids=["cross", "cross_moe", "vit", "vit_moe", "vit3d",
                              "vit3d_mean_pool"])
@pytest.mark.parametrize("size", [2, 4])
def test_tp_rule_matches_jax_param_specs(family, fields, size):
    """For each parameter and each of ``size`` ranks, the elements the port's
    rule keeps are those of JAX's shard of the same leaf."""
    cfg, model = _rule_model(family, fields)
    sd = _numbered(model)
    tree = jax_params_from_state_dict(sd, cfg)
    owner = {int(v.flat[0]): name for name, v in sd.items()}
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree.leaves(param_specs(tree),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    split_names = set()
    for (path, leaf), spec in zip(leaves, specs):
        name = owner[int(leaf.min())]
        axes = [i for i, a in enumerate(spec) if a == "model"]
        rule = tp_dim(name, sd[name].shape)
        assert (rule is not None) == bool(axes), (name, spec, rule)
        if rule is not None:
            split_names.add(name)
        for t in range(size):
            want = (np.split(leaf, size, axis=axes[0])[t] if axes else leaf).ravel()
            got = (split_slice(torch.from_numpy(sd[name]), *rule, t, size).numpy()
                   if rule else sd[name]).ravel()
            np.testing.assert_array_equal(np.sort(got), np.sort(want), err_msg=name)
    # what the split covers: the fused qkv, wq/wk/wv, both output projections,
    # every dense fc1/fc2 weight and fc1 bias; never an expert stack, nor
    # ViT3D's qkv bias (JAX's (3, K, D) qkv/bias matches no rule)
    assert any(n.endswith(("to_qkv.weight", "in_proj_weight")) for n in split_names)
    assert not any(".experts." in n or n.endswith("in_proj_bias") for n in split_names)
    if family == "vit3d":
        assert {n.split(".", 3)[-1] for n in split_names if n.startswith("transformer.")} == {
            "self_attn.in_proj_weight", "self_attn.out_proj.weight", "linear1.weight",
            "linear1.bias", "linear2.weight"}
        assert {n for n in split_names if n.startswith("mlp_head")} == {
            "mlp_head.1.weight", "mlp_head.1.bias", "mlp_head.2.weight"}


def test_qkv_split_keeps_the_kernel_layout():
    """Rank t's (3H/T, H) fused weight is the (H, 3, K/T, D) slice of the
    JAX kernel (its heads t·K/T ... (t+1)·K/T of q, k and v)."""
    H, K, D, T = 32, 4, 8, 2
    w = torch.arange(3 * H * H, dtype=torch.float64).reshape(3 * H, H)
    kernel = w.t().reshape(H, 3, K, D)
    for t in range(T):
        local = split_slice(w, *tp_dim("x.fn.to_qkv.weight", (3 * H, H)), t, T)
        torch.testing.assert_close(local.t().reshape(H, 3, K // T, D),
                                   kernel[:, :, t * K // T:(t + 1) * K // T])
        torch.testing.assert_close(split_slice(split_place(local, 0, 3, t, T), 0, 3, t, T),
                                   local)


def test_split_dropout_mask_is_the_whole_masks_slice():
    """The mask a split region draws is the one-process mask's slice on the
    split dim, and the generator ends where the one-process one does."""
    x = torch.ones(3, 8, 6)
    for t in range(2):
        g_one, g_split = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
        whole = dropout(torch.ones(3, 8, 12), 0.25, g_one, True)
        part = dropout(x, 0.25, g_split, True, split=(-1, TP(None, t, 2)))
        torch.testing.assert_close(part, whole[..., t * 6:(t + 1) * 6])
        assert torch.equal(dropout_mask((4,), 0.5, g_one, "cpu"),
                           dropout_mask((4,), 0.5, g_split, "cpu"))


# ---------------------------------------------------------------------------
# DP × TP steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cross_tp2", "vit_tp2", "cross_dp2_tp2", "vit_dp2_tp2"])
def test_tp_step_matches_jax_single_device(runs, name):
    """Logits before the step within 1e-5 of JAX's; one Adam step at f32,
    dropout 0, within JAX's own tolerance of JAX's single-device step."""
    tmp, got, _ = runs
    family, fields, _, _ = TP_CASES[name]
    params = jax_init(family, seed=len(name), **fields)
    logits, new = jax_step(family, params, **fields)
    for rank in got[name]:
        np.testing.assert_allclose(rank["logits0"], logits, atol=TOL, rtol=0)
        assert_adam_step_matches({k: rank[f"params0/{k}"] for k in new}, params, new)


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_steps_match_one_process(runs, name):
    """Two steps over the mesh against the one-process port's, dropout 0.1
    included (the masks are the one-process masks)."""
    _, got, refs = runs
    assert_matches_one_process(got[name], refs[name])


@pytest.mark.parametrize("name", ["cross_tp2", "cross_dp2_tp2"])
def test_tp_ranks_hold_their_heads(runs, name):
    """Each rank holds half the heads of every split region: the fused qkv
    (3H/2, H), the output projections (H, H/2), fc1 (mlp/2, H), fc2 (out,
    mlp/2); LayerNorms, embeddings and biases of the row-split exits whole."""
    _, got, _ = runs
    H, mlp = CROSS["hidden_dim"], CROSS["mlp_dim"]
    p = "local/transformer.0.blocks.0.0"
    for rank in got[name]:
        assert tuple(rank[f"{p}.attn.fn.to_qkv.weight"]) == (3 * H // 2, H)
        assert tuple(rank[f"{p}.attn.fn.to_out.0.weight"]) == (H, H // 2)
        assert tuple(rank[f"{p}.attn.fn.to_out.0.bias"]) == (H,)
        assert tuple(rank[f"{p}.ffn.fn.net.0.weight"]) == (mlp // 2, H)
        assert tuple(rank[f"{p}.ffn.fn.net.3.weight"]) == (H, mlp // 2)
        assert tuple(rank["local/transformer.0.fusion.0.attn.fn.wk.bias"]) == (H // 2,)
        assert tuple(rank["local/mlp_head.0.3.weight"]) == (2, mlp // 2)
        assert tuple(rank["local/pos_embedding"]) == (1, 5, H)


# ---------------------------------------------------------------------------
# checkpoints across TP sizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cross_tp2", "vit_dp2_tp2"])
def test_tp_checkpoint_crosses_tp_sizes(runs, name):
    """2 → 1: the two-rank run's checkpoint state is whole, in the JAX key
    layout, and loads into a one-process Trainer equal to the one-process
    state (parameters within 2.5·lr, Adam moments within 1e-5).  1 → 2: the
    one-process state after step 0 resumes over the mesh into the
    one-process step 1."""
    _, got, refs = runs
    family, fields, _, _ = TP_CASES[name]
    rank, ref = got[name][0], refs[name]
    ckpt = {k[len("ckpt/"):]: v for k, v in rank.items() if k.startswith("ckpt/")}
    want = {k[len("ckpt/"):]: v for k, v in ref.items() if k.startswith("ckpt/")}
    assert set(ckpt) == set(want)
    t = port_trainer(family, fields)
    t._load_flat(ckpt)
    for k, v in flatten(t.params).items():
        np.testing.assert_allclose(v, want[f"params/{k}"], atol=2.5 * LR, rtol=0, err_msg=k)
    for k, v in want.items():
        assert ckpt[k].shape == v.shape, k
        if k.startswith("opt/"):
            np.testing.assert_allclose(ckpt[k], v, atol=TOL, rtol=TOL, err_msg=k)
    assert float(rank["resumed/loss"]) == pytest.approx(float(ref["loss/1"]), rel=TOL, abs=TOL)
    for k in (k for k in ref if k.startswith("params1/")):
        np.testing.assert_allclose(rank["resumed/" + k[len("params1/"):]], ref[k],
                                   atol=2.5 * LR, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_tp_refusals_in_one_process():
    """T not dividing the heads or the MLP width; of the axis combinations
    only a 'pipe' axis with a 'seq' axis is refused (JAX fails on it too,
    ``test_torch_composed_parallel.py``): TP and PP with FSDP, a 'seq' or an
    'expert' axis compose, on the axis sizes alone; then make_mesh's checks
    and a world of one over a one-process group."""
    import torch.distributed as dist
    from cross_attention_vit_tpu_torch.parallel import multihost_init, shard_params
    from cross_attention_vit_tpu_torch.parallel.sharding import _refuse_combinations
    from cross_attention_vit_tpu_torch.parallel.tensor import shard_tensor_parallel
    from torch_mesh_workers import free_port

    class _Mesh:            # the axis sizes the checks read
        def __init__(self, **sizes):
            self.mesh_dim_names = tuple(sizes)
            self._sizes = sizes

        def size(self, i):
            return list(self._sizes.values())[i]

    model = ModelCross(port_config("cross", num_heads=4, mlp_dim=64), device="cpu")
    for split in ("model", "pipe"):
        for axes in ({}, {"seq": 2}, {"expert": 2}, {"data": 2}):
            sizes = {"data": 1, split: 2, **axes}
            if split == "pipe" and "seq" in axes:
                with pytest.raises(NotImplementedError, match="'pipe' axis.*'seq' axis.*item 13"):
                    _refuse_combinations(_Mesh(**sizes))
            else:
                _refuse_combinations(_Mesh(**sizes))            # composed
    _refuse_combinations(_Mesh(pipe=2, data=2, model=2))
    for fields, words in (({"num_heads": 4, "mlp_dim": 66}, "mlp_dim=66"),
                          ({"num_heads": 2, "hidden_dim": 32, "mlp_dim": 64}, "num_heads=2")):
        bad = ModelCross(port_config("cross", **fields), device="cpu")
        with pytest.raises(ValueError, match=words):
            shard_tensor_parallel(bad, _Mesh(data=1, model=4))
    multihost_init(f"127.0.0.1:{free_port()}", 1, 0, device="cpu", timeout_s=30)
    try:
        from cross_attention_vit_tpu_torch.parallel import make_mesh

        with pytest.raises(ValueError, match="world size 1"):
            make_mesh(model=2)
        with pytest.raises(ValueError, match="positive"):
            make_mesh(pipe=0)
        mesh = make_mesh(model=1, pipe=1)
        assert mesh.mesh_dim_names == ("data",)
        shard_params(model, mesh)     # a world of one: DDP, nothing split
    finally:
        dist.destroy_process_group()
