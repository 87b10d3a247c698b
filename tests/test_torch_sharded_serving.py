"""Sharded serving and the CLIs over a 'model' and a 'pipe' axis in the port —
the counterpart of ``tests/test_serve.py::test_sharded_serving_matches_single_device``
and of the JAX CLIs' ``--tp/--pp`` and ``evaluate --mesh``.

* ``InferenceServer(mesh=)`` over gloo ranks (``tests/torch_mesh_workers.py``):
  (model 2) and (data 2 × model 2).  Rank 0 serves HTTP; the answers to 3
  and 8 volumes (one request over HTTP) equal ``model_cross.apply`` within
  1e-5.  Under int8+attn the quantized layers stay whole on every rank, as
  JAX's rules leave its int8 leaves whole (checked on JAX's side), and the
  answers equal the one-process int8+attn server's within the int8 parity
  band of ``test_torch_quant.py`` (1e-3): a data split changes the CPU
  GEMMs' blocking, and a last-bit difference before a dynamic quantization
  can move an int8 value by one.  Buckets the data axis does not divide
  raise ValueError up front.  ``stop()`` with a batch in flight answers it
  before the workers' STOP.
* ``experiments.main --tp 2`` (ModelCross) and ``--pp 2 --model vit`` over
  two processes: the same finite history on both ranks and equal to the
  one-process run's within 1e-5, whole checkpoints in the JAX layout
  (stacked for PP); ``evaluate.main --mesh data=1,model=2`` on the --tp
  run's checkpoint gives the one-process port's and JAX's metrics.
"""

import json

import jax
import numpy as np
import pytest

from cross_attention_vit_tpu.models import model_cross as jmc
from cross_attention_vit_tpu.models.quantize import quantize_for_inference
from cross_attention_vit_tpu.parallel import param_specs
from cross_attention_vit_tpu_torch.train.checkpoint import save_config, save_pytree
from torch_mesh_workers import (CLI_PP, CROSS, SERVE_BUCKETS, SERVE_INT8, SERVE_MESHES, cli_args,
                                load, port_config, serve_volumes, spawn, write_cohort)
from torch_split_reference import TOL, jax_config, jax_init

INT8_ATOL = 1e-3        # tests/test_torch_quant.py's ATOL: one int8 step of a logit


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each world's ranks on the float and int8+attn checkpoints."""
    tmp = tmp_path_factory.mktemp("serve")
    params = {}
    for name, fields in (("float", {}), ("int8+attn", SERVE_INT8)):
        params[name] = jax_init("cross", seed=3, **fields)
        (tmp / name).mkdir()
        save_pytree(tmp / name / "ckpt.npz", {"params": params[name]})
        save_config(tmp / name, port_config("cross", **fields))
    for world in SERVE_MESHES:
        spawn("serve", tmp, world)
    return tmp, params, {w: load(tmp, f"serve_w{w}", w) for w in SERVE_MESHES}


@pytest.mark.parametrize("world", list(SERVE_MESHES))
def test_sharded_server_matches_model_cross_apply(served, world):
    """Rank 0's answers (3 volumes padded to the 4 bucket; 8 over HTTP)
    against JAX's apply on the same weights; /healthz names the mesh."""
    _, params, ranks = served
    cfg = jax_config("cross")
    for n, seed in ((3, 7), (8, 8)):
        vols = serve_volumes(n, seed)
        want = np.asarray(jax.jit(lambda p, x: jmc.apply(p, cfg, x))(params["float"], vols))
        np.testing.assert_allclose(ranks[world][0][f"float/{n}"], want, atol=TOL, rtol=TOL)
    assert json.loads(str(ranks[world][0]["float/health_mesh"])) == {
        "data": SERVE_MESHES[world].get("data", 1), "model": 2}
    for rank in ranks[world]:      # every rank holds half the heads of the float model
        assert tuple(rank["float/local_qkv"]) == (3 * CROSS["hidden_dim"] // 2,
                                                  CROSS["hidden_dim"])


@pytest.mark.parametrize("world", list(SERVE_MESHES))
def test_sharded_int8_server_keeps_int8_layers_whole(served, world):
    """int8+attn over the mesh: the int8 qkv stays whole on every rank and
    the answers equal the one-process int8+attn server's within the int8
    band."""
    from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer

    tmp, _, ranks = served
    one = InferenceServer(tmp / "int8+attn" / "ckpt.npz", "cross", buckets=SERVE_BUCKETS,
                          quantize="int8+attn", device="cpu")
    one.start()
    try:
        for n, seed in ((3, 7), (8, 8)):
            np.testing.assert_allclose(ranks[world][0][f"int8+attn/{n}"],
                                       one.predict(serve_volumes(n, seed)), atol=INT8_ATOL,
                                       rtol=0)
    finally:
        one.stop()
    H = SERVE_INT8["hidden_dim"]
    for rank in ranks[world]:
        assert tuple(rank["int8+attn/local_qkv"]) == (3 * H, H)


def test_jax_rules_leave_int8_leaves_whole():
    """JAX's TP rules match only float ``kernel`` leaves: in an int8+attn
    tree the int8 kernels and their scales are replicated, while the float
    cross-attention kernels stay split over 'model' — the layout the port's
    sharded server keeps."""
    params = jax_init("cross", **SERVE_INT8)
    q = quantize_for_inference(params, attn=True)
    specs = param_specs(q)
    leaves = jax.tree_util.tree_flatten_with_path(q)[0]
    flat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    seen = {"int8": 0, "float_split": 0}
    for (path, _), spec in zip(leaves, flat):
        names = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        if names[-1] in ("kernel_q", "kernel_scale"):
            assert "model" not in spec, names
            seen["int8"] += 1
        elif names[-2:] == ["wq", "kernel"]:
            assert "model" in spec, names
            seen["float_split"] += 1
    assert seen["int8"] > 0 and seen["float_split"] > 0


def test_sharded_server_refuses_other_axes(tmp_path):
    """No axis is refused any more: a mesh with a 'pipe' and a 'seq' axis
    (of one each, over a one-process group) builds, as JAX's server takes
    any mesh, and answers as the server without a mesh does (the 'seq' and
    'pipe' axes split nothing in serving, as in JAX; the expert split is
    held over four ranks in ``test_torch_composed_fit.py``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer
    from cross_attention_vit_tpu_torch.parallel import multihost_init
    from torch_mesh_workers import free_port

    save_pytree(tmp_path / "ckpt.npz", {"params": jax_init("cross")})
    save_config(tmp_path, port_config("cross"))
    want = InferenceServer(tmp_path / "ckpt.npz", "cross", device="cpu")
    multihost_init(f"127.0.0.1:{free_port()}", 1, 0, device="cpu", timeout_s=30)
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pipe", "data", "seq"))
        server = InferenceServer(tmp_path / "ckpt.npz", "cross", mesh=mesh, device="cpu")
        assert server.health()["mesh"] == {"pipe": 1, "data": 1, "seq": 1}
        vols = serve_volumes(3)
        np.testing.assert_allclose(server._run_padded(vols), want._run_padded(vols),
                                   atol=TOL, rtol=TOL)
        server.stop()
    finally:
        dist.destroy_process_group()


def test_stop_while_a_batch_is_in_flight(served):
    """(model 2): ``stop()`` while rank 0's dispatcher is inside a sharded
    forward waits for that batch — answered as the float server answers it —
    fails the request queued behind it, and only then sends the workers'
    STOP, so the two ranks' collectives stay in step and rank 1 returns."""
    _, _, ranks = served
    r0 = ranks[2][0]
    np.testing.assert_allclose(r0["inflight/3"], r0["float/3"], atol=TOL, rtol=TOL)
    assert str(r0["inflight/queued_error"]) == "server stopped"
    assert not bool(r0["inflight/dispatcher_alive"])


def test_bucket_not_divisible_by_the_data_axis_raises(served):
    """Buckets (1, 2) over a data axis of 2: ValueError before any work, on
    every rank."""
    _, _, ranks = served
    for rank in ranks[4]:
        assert "buckets [1] not divisible by the mesh data axis (2)" in str(rank["bucket_error"])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_split")
    write_cohort(tmp)
    spawn("cli_split", tmp, 2)
    return tmp, [json.loads((tmp / f"cli_split_{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("axis", ["tp", "pp"])
def test_experiments_cli_trains_over_tp_and_pp(cli, tmp_path, axis):
    """One epoch over two processes: both ranks' histories equal and equal
    to the one-process run's within 1e-5; the run's checkpoint config carries
    pipeline_stages for --pp, whose checkpoint is stacked."""
    from cross_attention_vit_tpu_torch.drivers import experiments as texp
    from cross_attention_vit_tpu_torch.train.checkpoint import restore_flat

    tmp, (c0, c1) = cli
    assert c0["hist"] == c1["hist"]
    family = "cross" if axis == "tp" else "vit"
    run = f"test_200_0_{0 if axis == 'tp' else 1}_0"
    args = cli_args(tmp, str(tmp_path / "one"))
    args[args.index("--model") + 1] = family
    if axis == "pp":
        args += [*CLI_PP, "--set", "pipeline_stages=2"]
    want = texp.main(args, device="cpu")[run]
    got = c0["hist"][axis][run]
    assert len(got) == len(want) == 1
    for k, v in got[0].items():
        assert np.isfinite(v) and abs(v - want[0][k]) <= TOL, (k, v, want[0][k])
    cfg = json.loads((tmp / axis / "checkpoints" / "cross" / f"config_{run}.json").read_text())
    ckpt = restore_flat(next((tmp / axis / "checkpoints" / "cross").glob("epoch=*.npz")))
    if axis == "pp":
        assert cfg["pipeline_stages"] == 2
        assert ckpt["params/layers/attn/qkv/kernel"].shape[0] == 2
    else:
        H = cfg["hidden_dim"]
        assert ckpt["params/multi_blocks/0/self_blocks/0/0/attn/qkv/kernel"].shape[:2] == (H, 3)


def test_evaluate_over_a_model_axis_matches_one_process_and_jax(cli):
    """``evaluate --mesh data=1,model=2`` on the --tp run's checkpoint: the
    one-process port's metrics and JAX's within 1e-6."""
    from cross_attention_vit_tpu.drivers import evaluate as jeval
    from cross_attention_vit_tpu_torch.drivers import evaluate as teval

    tmp, (c0, c1) = cli
    ckpt = next((tmp / "tp" / "checkpoints" / "cross").glob("epoch=*.npz"))
    args = ["--checkpoint", str(ckpt), "--model", "cross", "--labels", str(tmp / "labels.csv"),
            "--data", str(tmp / "data"), "--only-available", "--batch-size", "4"]
    one, want = teval.main(args, device="cpu"), jeval.main(args)
    assert c0["evaluate"] == c1["evaluate"]
    assert set(c0["evaluate"]) == set(want) and c0["evaluate"]["n"] == want["n"] == 20
    for k in want:
        assert abs(c0["evaluate"][k] - one[k]) <= 1e-6, (k, c0["evaluate"][k], one[k])
        assert abs(c0["evaluate"][k] - want[k]) <= 1e-6, (k, c0["evaluate"][k], want[k])
