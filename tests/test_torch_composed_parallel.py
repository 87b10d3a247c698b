"""The parallel axes composed in the port as the JAX package composes them —
the counterpart of ``tests/test_parallel.py``'s FSDP-over-(data × model)
step, ``tests/test_ring.py``'s ring over data × seq × model, and JAX's
``param_specs`` composing TP, FSDP, 'expert' and the stacked 'pipe' leaf.

Over four gloo ranks (``tests/torch_mesh_workers.py``, mode split,
``COMPOSED_CASES``), from JAX-initialised parameters:

  TP × FSDP   live ModelCross over (data 2 × model 2), FSDP
  TP × SP     ModelCross, ``seq_parallel`` 2, over (seq 2 × model 2)
  TP × EP     the MoE ModelCross over (expert 2 × model 2)
  FSDP × EP   the MoE ModelCross over (data 2 × expert 2), FSDP
  PP × FSDP   the 2-stage ModelVIT over (pipe 2 × data 2), FSDP
  FSDP        the 2-stream ModelVIT over (data 2), two ranks: its trunk
              layers are FSDP's units, gathered one at a time
  remat       the TP × FSDP case with ``remat=True`` (policy 'full'): the
              recompute runs inside FSDP's units and through TP's f and g

* Each case's first step against JAX's own step over a mesh of the same
  axes on the CPU's virtual devices (``jax_mesh_step``: parameters placed by
  JAX's ``shard_params`` with its FSDP and pipeline flags, the ambient
  meshes set as JAX's ``Trainer`` sets them): the loss within 1e-5 and the
  parameters after Adam within JAX's atol=1e-5, rtol=1e-4
  (``assert_adam_step_matches``).
* Two steps against the one-process port's: loss and probs within 1e-5,
  the first step's whole gradients within 1e-5, the parameters within
  2.5·lr, the eval step; the ranks agree exactly; the checkpoint state is
  whole and the one-process state after step 0 resumes over the mesh.
* The placements: FSDP shards exactly the parameters ``fsdp_dim`` names, on
  its dim, over 'data' only (half of the TP slice or of the rank's experts);
  TP slices, expert splits and stages as without FSDP.
* FSDP's units: each ModelVIT trunk layer (this stage's, under PP) and the
  root; each ModelCross self- and cross-attention block and the root.
* What stays refused: a 'pipe' axis with a 'seq' axis, which JAX's own step
  fails on (its ring's shard_map inside the pipeline's).
"""

import numpy as np
import pytest

from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.parallel import fsdp_dim, tp_dim
from torch_mesh_workers import COMPOSED_CASES, PP, port_config
from torch_split_reference import (TOL, assert_adam_step_matches, assert_matches_one_process,
                                   jax_init, jax_mesh_step, run_cases)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("composed")
    got, refs = run_cases(tmp, COMPOSED_CASES)
    return tmp, got, refs


@pytest.mark.parametrize("name", list(COMPOSED_CASES))
def test_composed_step_matches_jax_mesh_step(runs, name):
    _, got, _ = runs
    family, fields, axes, _, fsdp = COMPOSED_CASES[name]
    params = jax_init(family, seed=len(name), **fields)
    loss, new = jax_mesh_step(family, params, axes, fsdp, **fields)
    for rank in got[name]:
        assert float(rank["loss/0"]) == pytest.approx(loss, rel=TOL, abs=TOL)
        assert_adam_step_matches({k: rank[f"params0/{k}"] for k in new}, params, new)


@pytest.mark.parametrize("name", list(COMPOSED_CASES))
def test_composed_steps_match_one_process(runs, name):
    _, got, refs = runs
    assert_matches_one_process(got[name], refs[name])


def _expected_local(name: str, family: str, fields: dict, axes: dict, fsdp: bool) -> dict:
    """Each parameter this case's rank 0 holds: (its local shape, its FSDP
    dim or None), from the whole model, the TP rule, the expert and stage
    splits and ``fsdp_dim`` on the whole JAX layout."""
    cfg = port_config(family, **fields)
    model = (ModelCross if family == "cross" else ModelVIT)(cfg, device="cpu")
    depth = cfg.num_layers if axes.get("pipe", 1) > 1 else 1
    stage = [f"transformer.layers.{i}." for i in range(depth // axes.get("pipe", 1))]
    out = {}
    for n, p in model.named_parameters():
        if depth > 1 and n.startswith("transformer.layers.") and not n.startswith(tuple(stage)):
            continue                                   # another stage's layer
        shape = list(p.shape)
        if ".experts." in n and axes.get("expert", 1) > 1:
            shape[0] //= axes["expert"]
        split = tp_dim(n, tuple(p.shape)) if axes.get("model", 1) > 1 else None
        if split is not None:
            shape[split[0]] //= axes["model"]
        layer_depth = depth if n.startswith("transformer.layers.") else 1
        dim = fsdp_dim(n, tuple(p.shape), cfg.num_heads, axes.get("data", 1),
                       layer_depth) if fsdp else None
        if dim is not None:
            assert split is None or dim != split[0], n   # never the TP-split dim
            shape[dim] //= axes["data"]
        out[n] = (tuple(shape), dim)
    return out


@pytest.mark.parametrize("name", list(COMPOSED_CASES))
def test_composed_placements(runs, name):
    """Rank 0's local shapes and FSDP dims are those of the rule; every FSDP
    case shards something, and the PP case shards per-layer parameters that
    are under FSDP_MIN_SIZE alone but not stacked."""
    _, got, _ = runs
    family, fields, axes, _, fsdp = COMPOSED_CASES[name]
    want = _expected_local(name, family, fields, axes, fsdp)
    rank = got[name][0]
    held = {k[len("local/"):] for k in rank if k.startswith("local/") and ":" not in k}
    assert held == set(want)
    for n, (shape, dim) in want.items():
        assert tuple(rank[f"local/{n}"]) == shape, (n, tuple(rank[f"local/{n}"]), shape)
        got_dim = rank.get(f"local/fsdp:{n}")
        assert (None if got_dim is None else int(got_dim)) == dim, n
    sharded = [n for n, (_, d) in want.items() if d is not None]
    assert bool(sharded) == fsdp
    if name == "vit_pp2_dp2_fsdp":
        per_layer = [n for n in sharded if n.startswith("transformer.layers.")]
        assert per_layer and all(np.prod(want[n][0]) * 2 < 2 ** 15 for n in per_layer)


@pytest.mark.parametrize("name", [n for n, case in COMPOSED_CASES.items() if case[4]])
def test_fsdp_gathers_a_block_at_a_time(runs, name):
    """Under FSDP every rank's model is one unit per block FSDP gathers at
    its use (``blocks()``: ModelVIT's trunk layers, this stage's under PP;
    ModelCross's self- and cross-attention blocks) plus the root, as JAX's
    GSPMD gathers each layer's leaves where they are used."""
    _, got, _ = runs
    family, fields, axes, _, _ = COMPOSED_CASES[name]
    model = (ModelCross if family == "cross" else ModelVIT)(port_config(family, **fields),
                                                            device="cpu")
    blocks = len(model.blocks()) // axes.get("pipe", 1)
    assert blocks > 1
    for rank in got[name]:
        assert int(rank["fsdp_units"]) == blocks + 1


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

def test_pipeline_with_seq_parallel_is_refused_as_jax_fails_it():
    """The port refuses a 'pipe' axis with a 'seq' axis, naming the reference's
    failure and ROADMAP item 13; JAX's own step over (pipe 2 × data 2 × seq
    2) fails (its ring's shard_map nested in the pipeline's), so this
    refusal is revisited if the reference ever runs it."""
    from cross_attention_vit_tpu_torch.parallel.sharding import _refuse_combinations

    class _Mesh:
        def __init__(self, **sizes):
            self.mesh_dim_names = tuple(sizes)
            self._sizes = list(sizes.values())

        def size(self, i):
            return self._sizes[i]

    with pytest.raises(NotImplementedError, match="JAX package does not run it.*item 13"):
        _refuse_combinations(_Mesh(pipe=2, data=2, seq=2))
    fields = {**PP, "seq_parallel": 2}
    params = jax_init("vit", **fields)
    with pytest.raises(ValueError, match="should match the mesh passed to shard_map"):
        jax_mesh_step("vit", params, {"pipe": 2, "data": 2, "seq": 2}, **fields)
