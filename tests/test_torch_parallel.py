"""The port's data parallelism and FSDP (``cross_attention_vit_tpu_torch.parallel``)
against the JAX package's sharded semantics, on the CPU over gloo.

* ``make_mesh`` / ``multihost_init``: errors without a group, a world of one
  in process, torchrun's environment.
* The FSDP rule: the port shards exactly the parameters JAX's
  ``param_specs(..., fsdp=True, data_size=W)`` marks with 'data', through
  ``models/convert``'s names, at W = 2, 3 and 4.
* Two ranks (subprocesses running this file's worker block) train 2 steps of
  global batch 8 from JAX-initialised parameters under DDP and FSDP (and
  with ``grad_accum=2``, and a 2-stream ModelVIT under DDP): the ranks agree
  exactly; the gradients equal the one-process port step's (atol 1e-6, rtol
  1e-4); loss, probs and post-Adam parameters equal the JAX single-device
  ``make_train_step`` on the same global batch (loss rel 1e-5, probs 1e-5,
  params 2.5·lr after each step: Adam's first update is about lr·sign(g),
  so summation noise on a gradient that is zero in exact arithmetic, as the
  cross-attention key biases' are, moves a parameter by up to 2·lr); under
  FSDP each rank holds half of every sharded parameter and of its moments.
* ``Trainer.fit`` over 2 ranks: identical history rows, only rank 0 writes;
  its checkpoint is the JAX npz layout that JAX restores and a one-process
  port ``Trainer`` resumes, and a 2-rank FSDP ``Trainer`` resumes from a
  one-process checkpoint.
* ``experiments.main --dp 2 --coordinator ...`` in two processes trains one
  epoch; ``evaluate --mesh data=2`` on a cohort that is not a multiple of
  batch × 2 gives the one-process ``evaluate``'s and JAX's metrics.

Tiny geometry: 3 streams, hidden 32, 4 heads, MLP 1024 (so the feed-forward
and head weights, 32·1024 = 2^15 elements, reach ``FSDP_MIN_SIZE``), img
16×16×8, patch 8, f32, dropout 0, no augmentation, flash attention on: the
port's fused-QKV autograd Function with K1's and K2's plain versions (the
path the card runs with the kernels) against JAX's Pallas kernels in
interpret mode.  Workers run with one thread and every wait has a timeout.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
WORKER_TIMEOUT_S = 180
LR = 1e-3
STEPS = 2
GLOBAL_BATCH = 8
CROSS = dict(hidden_dim=32, mlp_dim=1024, num_heads=4, num_multi_blocks=1, num_self_blocks=1,
             img_size=(16, 16, 8), patch_size=(8, 8, 8), num_modalities=3,
             attn_order={"0": "1", "1": "2", "2": "0"}, dropout=0.0, lr=LR, weight_decay=5e-4,
             label_smoothing=0.0, img_aug=False, optim_params={"T_max": 10, "eta_min": 1e-6},
             use_flash_attention=True)
VIT = dict(CROSS, mlp_dim=64, num_layers=1, num_modalities=2)
# name: (model, fsdp, grad_accum)
CASES = {"ddp": ("cross", False, 1), "fsdp": ("cross", True, 1),
         "ddp_accum2": ("cross", False, 2), "fsdp_accum2": ("cross", True, 2),
         "vit_ddp": ("vit", False, 1)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_cfg(model: str):
    from cross_attention_vit_tpu_torch.configs import (get_mgmt_config, get_mgmt_cross_config,
                                                       modify_config)
    cfg = get_mgmt_cross_config() if model == "cross" else get_mgmt_config()
    modify_config(cfg, CROSS if model == "cross" else VIT)
    return cfg


def _batches(model: str):
    """The global batches of the run, made from a seed."""
    m = CROSS["num_modalities"] if model == "cross" else VIT["num_modalities"]
    rng = np.random.default_rng(7)
    return [((rng.normal(size=(GLOBAL_BATCH, m, 1, 16, 16, 8)) * 2).astype(np.float32),
             rng.integers(0, 2, size=GLOBAL_BATCH).astype(np.int64)) for _ in range(STEPS)]


class _Data:
    """An in-memory dataset with the BrainDataset batch interface."""

    def __init__(self, n: int = 12, seed: int = 0):
        r = np.random.default_rng(seed)
        self.labels = (np.arange(n) % 3 == 0).astype(np.int32)
        self.imgs = (r.normal(size=(n, 3, 1, 16, 16, 8))
                     + self.labels[:, None, None, None, None, None]).astype(np.float32)

    def __len__(self):
        return len(self.labels)

    def batch(self, indices):
        idx = np.asarray(indices)
        return self.imgs[idx], self.labels[idx]


# -- the workers: ``python tests/test_torch_parallel.py <mode> <rendezvous> <rank> <world> <dir>``

def _flat_params(trainer) -> dict:
    from cross_attention_vit_tpu_torch.train.checkpoint import flatten
    return flatten(trainer.params)


def _worker_steps(rank: int, tmp: Path) -> None:
    from cross_attention_vit_tpu_torch.data.dataset import WeightedRandomSampler
    from cross_attention_vit_tpu_torch.models.convert import params_from_flat
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
    from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
    from cross_attention_vit_tpu_torch.parallel import full_tensor, make_mesh, shard_batch, unwrap
    from cross_attention_vit_tpu_torch.train import trainer as ttrainer
    from cross_attention_vit_tpu_torch.train.checkpoint import restore_flat
    from torch.distributed.tensor import DTensor

    mesh = make_mesh()
    for case, (model, fsdp, accum) in CASES.items():
        params = params_from_flat(restore_flat(tmp / f"init_{model}.npz"))
        t = ttrainer.Trainer(ModelCross if model == "cross" else ModelVIT, _port_cfg(model),
                             max_epochs=1, mesh=mesh, fsdp=fsdp, grad_accum=accum,
                             device="cpu").init_state(params)
        out = {}
        for s, batch in enumerate(_batches(model)):
            img, lab = (torch.from_numpy(x) for x in shard_batch(batch, mesh))
            aux = t.train_step(img, lab, LR, ttrainer._step_generator(0, 0, s, rank))
            out[f"loss/{s}"] = aux["loss"].numpy()
            out[f"probs/{s}"] = aux["probs"].numpy()
            out[f"labels/{s}"] = aux["labels"].numpy()
            out[f"counts/{s}"] = np.array([int(v) for v in aux["counts"].values()])
            if s == 0:
                for n, p in unwrap(t.model).named_parameters():
                    out[f"grad/{n}"] = full_tensor(p.grad).numpy()
            out.update({f"params{s}/{k}": v for k, v in _flat_params(t).items()})
        shards = {}
        for n, p in unwrap(t.model).named_parameters():
            if isinstance(p, DTensor):
                st = t.optimizer._opt.state[p]
                shards[n] = [p.numel(), p.to_local().numel(), st["exp_avg"].to_local().numel(),
                             st["exp_avg_sq"].to_local().numel()]
        out["sampler"] = WeightedRandomSampler(np.ones(10), 10, seed=3).epoch_indices(
            0, host_id=rank, num_hosts=2)
        out["step_draw"] = torch.rand(4, generator=ttrainer._step_generator(0, 0, 0, rank))
        np.savez(tmp / f"{case}_{rank}.npz", **out)
        (tmp / f"{case}_{rank}_shards.json").write_text(json.dumps(shards))


def _fit_trainer(cfg, mesh, root: Path, rank: int, max_epochs: int, latest_dir=None):
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
    from cross_attention_vit_tpu_torch.train.checkpoint import (CheckpointManager,
                                                                LatestCheckpointer)
    from cross_attention_vit_tpu_torch.train.loggers import CSVLogger, MultiLogger
    from cross_attention_vit_tpu_torch.train.trainer import Trainer

    return Trainer(ModelCross, cfg, max_epochs=max_epochs, seed=3, mesh=mesh,
                   fsdp=mesh is not None, device="cpu",
                   logger=MultiLogger(CSVLogger(root / "csv", "run")),
                   checkpoint=CheckpointManager(root / "topk", save_top_k=2,
                                                config=cfg if rank == 0 else None),
                   latest=LatestCheckpointer(latest_dir or root / "latest"))


def _worker_fit(rank: int, tmp: Path) -> None:
    from cross_attention_vit_tpu_torch.data.loader import PrefetchLoader
    from cross_attention_vit_tpu_torch.models.convert import params_from_flat
    from cross_attention_vit_tpu_torch.parallel import make_mesh
    from cross_attention_vit_tpu_torch.train.checkpoint import restore_flat

    mesh = make_mesh()
    cfg = _port_cfg("cross")
    ds = _Data()
    t = _fit_trainer(cfg, mesh, tmp / f"rank{rank}", rank, max_epochs=2)
    t.init_state(params_from_flat(restore_flat(tmp / "init_cross.npz")))
    hist = t.fit(PrefetchLoader(ds, batch_size=2, device="cpu"),
                 PrefetchLoader(ds, batch_size=2, device="cpu"), verbose=False)
    # a one-process run's checkpoint, resumed by two FSDP ranks
    resumed = _fit_trainer(cfg, mesh, tmp / f"unused{rank}", rank, max_epochs=3,
                           latest_dir=tmp / "one" / "latest").init_state()
    start = resumed.maybe_resume()
    state = resumed._ckpt_state(start - 1)          # a collective: every rank
    if rank == 0:
        np.savez(tmp / "resumed_state.npz", **state)
    (tmp / f"fit_{rank}.json").write_text(json.dumps(
        {"history": [{k: v for k, v in row.items() if k != "epoch_time_s"} for row in hist],
         "start": start, "global_step": resumed.global_step}))


def _worker_cli(rank: int, tmp: Path, address: str) -> None:
    from cross_attention_vit_tpu_torch.drivers import evaluate as teval
    from cross_attention_vit_tpu_torch.drivers import experiments as texp

    hist = texp.main([*_cli_args(tmp), "--dp", "2", "--coordinator", address,
                      "--num-processes", "2", "--process-id", str(rank),
                      "--dist-timeout", str(WORKER_TIMEOUT_S)], device="cpu")
    ckpt = next((tmp / "runs" / "checkpoints" / "cross").glob("epoch=*.npz"))
    metrics = teval.main([*_eval_args(tmp, ckpt), "--mesh", "data=2"], device="cpu")
    (tmp / f"cli_{rank}.json").write_text(json.dumps(
        {"history": {k: [{c: v for c, v in row.items() if c != "epoch_time_s"} for row in h]
                     for k, h in hist.items()},
         "metrics": metrics, "checkpoint": str(ckpt)}))


def _worker(mode: str, address: str, rank: int, world: int, tmp: Path) -> None:
    torch.set_num_threads(1)
    from cross_attention_vit_tpu_torch.parallel import multihost_init
    if mode == "cli":       # the CLI joins the group itself
        return _worker_cli(rank, tmp, address)
    multihost_init(address, world, rank, device="cpu", timeout_s=WORKER_TIMEOUT_S)
    {"steps": _worker_steps, "fit": _worker_fit}[mode](rank, tmp)


def _spawn(mode: str, tmp: Path, world: int = 2) -> None:
    """Run ``world`` ranks of the worker and wait for them all; they meet in
    a FileStore under ``tmp`` (``torch_mesh_workers.rendezvous``)."""
    from torch_mesh_workers import rendezvous

    address = rendezvous(tmp)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(HERE), mode, address, str(r), str(world),
                               str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r} of {mode} failed:\n{err[-6000:]}"


# -- references -----------------------------------------------------------------------

def _jax_init(model: str, tmp: Path) -> dict:
    """JAX-initialised parameters (numpy), written into ``tmp`` for the
    workers."""
    import jax
    from cross_attention_vit_tpu.configs import get_mgmt_config, get_mgmt_cross_config
    from cross_attention_vit_tpu.configs import modify_config
    from cross_attention_vit_tpu.models import model_cross, model_vit
    from cross_attention_vit_tpu_torch.train.checkpoint import save_pytree

    jcfg = get_mgmt_cross_config() if model == "cross" else get_mgmt_config()
    modify_config(jcfg, CROSS if model == "cross" else VIT)
    module = model_cross if model == "cross" else model_vit
    params = jax.tree.map(lambda a: np.array(a, np.float32), module.init(jax.random.key(0), jcfg))
    save_pytree(tmp / f"init_{model}.npz", {"params": params})
    return params


def _one_process(model: str, params: dict) -> dict:
    """The port without a mesh on the global batches: first-step gradients,
    parameters after each step."""
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
    from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
    from cross_attention_vit_tpu_torch.train import trainer as ttrainer

    t = ttrainer.Trainer(ModelCross if model == "cross" else ModelVIT, _port_cfg(model),
                         max_epochs=1, device="cpu").init_state(params)
    out = {}
    for s, (img, lab) in enumerate(_batches(model)):
        t.train_step(torch.from_numpy(img), torch.from_numpy(lab), LR,
                     ttrainer._step_generator(0, 0, s))
        if s == 0:
            out.update({f"grad/{n}": p.grad.numpy().copy() for n, p in t.model.named_parameters()})
        out.update({f"params{s}/{k}": v for k, v in _flat_params(t).items()})
    return out


def _jax_steps(params: dict) -> dict:
    """The JAX single-device step on the same global batches."""
    import jax
    import jax.numpy as jnp
    from cross_attention_vit_tpu.configs import get_mgmt_cross_config, modify_config
    from cross_attention_vit_tpu.models import model_cross
    from cross_attention_vit_tpu.train import optim
    from cross_attention_vit_tpu.train.trainer import make_train_step
    from cross_attention_vit_tpu_torch.train.checkpoint import flatten

    jcfg = get_mgmt_cross_config()
    modify_config(jcfg, CROSS)
    step = make_train_step(model_cross.apply, jcfg, donate=False)
    p, o = params, optim.init(params)
    out = {}
    for s, (img, lab) in enumerate(_batches("cross")):
        p, o, aux = step(p, o, img, lab.astype(np.int32), jnp.asarray(LR, jnp.float32),
                         jax.random.key(s))
        out[f"loss/{s}"] = float(aux["loss"])
        out[f"probs/{s}"] = np.asarray(aux["probs"])
        out.update({f"params{s}/{k}": v for k, v in
                    flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), p)).items()})
    return out


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("init")
    return tmp, {m: _jax_init(m, tmp) for m in ("cross", "vit")}


@pytest.fixture(scope="module")
def steps(tmp_path_factory, jax_init):
    tmp = tmp_path_factory.mktemp("steps")
    src, init = jax_init
    for m in init:
        shutil.copy(src / f"init_{m}.npz", tmp)
    _spawn("steps", tmp)
    ranks = {case: [dict(np.load(tmp / f"{case}_{r}.npz")) for r in range(2)] for case in CASES}
    shards = {case: json.loads((tmp / f"{case}_0_shards.json").read_text()) for case in CASES}
    one = {m: _one_process(m, init[m]) for m in init}
    return {"ranks": ranks, "shards": shards, "one": one, "jax": _jax_steps(init["cross"])}


# -- tests: meshes and the rule --------------------------------------------------------

def test_make_mesh_and_multihost_init_without_a_group(monkeypatch):
    from cross_attention_vit_tpu_torch import parallel

    assert not torch.distributed.is_initialized()
    assert (parallel.rank(), parallel.world_size()) == (0, 1)
    with pytest.raises(RuntimeError, match="multihost_init"):
        parallel.make_mesh()
    for axis in ("model", "pipe", "seq", "expert"):      # ported: they need a group
        with pytest.raises(RuntimeError, match="multihost_init"):
            parallel.make_mesh(**{axis: 2})
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        parallel.multihost_init(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            parallel.multihost_init("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()


def test_world_of_one_in_process(monkeypatch):
    """torchrun's environment, a second call that does nothing, the mesh,
    the batch descriptors and the rank-order gather at world size 1."""
    from cross_attention_vit_tpu_torch import parallel

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    parallel.multihost_init(device="cpu", timeout_s=30)
    try:
        parallel.multihost_init("127.0.0.1:1", 5, 3, device="cpu")     # already up: a no-op
        assert (parallel.rank(), parallel.world_size()) == (0, 1)
        mesh = parallel.make_mesh()
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
        assert mesh.device_type == "cpu"
        with pytest.raises(ValueError, match="world size 1"):
            parallel.make_mesh(2)
        sh = parallel.batch_sharding(mesh, 6)
        assert sh.spec == ("data", None, None, None, None, None) and sh.batch_divisor() == 1
        assert parallel.replicated(mesh).batch_divisor() == 1
        x = np.arange(8)
        assert (parallel.shard_batch((x,), mesh)[0] == x).all()
        t = torch.arange(6.0).view(3, 2)
        assert torch.equal(parallel.gather_rows(t, mesh), t)
    finally:
        torch.distributed.destroy_process_group()


def _jax_fsdp_shards(port_model, data_size: int, pipeline: bool) -> dict[str, np.ndarray]:
    """Each element's shard over 'data' under JAX's rule (-1: not sharded),
    in the port's layout: JAX's ``param_specs(fsdp=True, pipeline=...)`` on
    the model's JAX tree (stacked for a pipelined trunk), each leaf's shard
    index along its 'data' axis mapped through convert."""
    from jax.sharding import PartitionSpec as P

    import jax
    from cross_attention_vit_tpu.parallel.sharding import param_specs
    from cross_attention_vit_tpu_torch.models.convert import (jax_params_from_model,
                                                              state_dict_from_jax)

    def marks(a, spec):
        a = np.asarray(a)
        axes = [i for i, s in enumerate(spec) if s == "data"]
        if not axes:
            return np.full(a.shape, -1.0)
        ax = axes[0]
        index = np.arange(a.shape[ax]) // (a.shape[ax] // data_size)
        return np.broadcast_to(index.reshape([-1 if i == ax else 1 for i in range(a.ndim)]),
                               a.shape).astype(np.float64)

    tree = jax_params_from_model(port_model)
    specs = param_specs(tree, fsdp=True, data_size=data_size, pipeline=pipeline)
    tree = jax.tree.map(marks, tree, specs, is_leaf=lambda x: isinstance(x, P))
    return state_dict_from_jax(tree, port_model.config)


class _Sizes:
    """The axis sizes ``_fsdp_dims`` reads, without a group."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, i):
        return self._sizes[i]


_PP4 = dict(num_layers=4, pipeline_stages=2, pipeline_microbatches=2)
GEOMETRIES = {
    "cross_mlp1024": ("cross", {}),
    "cross_h48_k3": ("cross", dict(hidden_dim=48, num_heads=3, mlp_dim=768)),
    "cross_h192_k6_mlp48": ("cross", dict(hidden_dim=192, num_heads=6, mlp_dim=48)),
    # at W = 3 the port's (1056, 32) fc1 has a dim 3 divides, JAX's free axis (32) none
    "cross_mlp1056": ("cross", dict(mlp_dim=1056)),
    "vit_h64": ("vit", dict(hidden_dim=64, mlp_dim=512, num_layers=2)),
    # EP x FSDP: the (4, 256, 32) expert stacks, E left to 'expert'
    "cross_moe_mlp256": ("cross", dict(moe_experts=4, mlp_dim=256)),
    # PP x FSDP: fc1/fc2 (256 x 32) are under FSDP_MIN_SIZE a layer, over it stacked
    "vit_pp_mlp256": ("vit", dict(_PP4, mlp_dim=256)),
    # PP x TP x FSDP at a width where the per-layer rule alone also shards
    "vit_pp_h64": ("vit", dict(_PP4, hidden_dim=64, mlp_dim=512)),
}


@pytest.mark.parametrize("data_size", [2, 3, 4])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_fsdp_rule_shards_the_jax_set(geometry, data_size):
    """The port's FSDP set and dims (``fsdp_dim`` on the whole JAX layout,
    as ``shard_params`` reads it before its splits) put every element in
    the data shard JAX's ``param_specs`` puts it in, the pipelined trunk
    read as JAX's stacked leaf (a 'pipe' axis of 2); the dim is never an
    axis JAX gives 'model' nor an expert stack's E."""
    from cross_attention_vit_tpu_torch.configs import modify_config
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
    from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
    from cross_attention_vit_tpu_torch.parallel import tp_dim
    from cross_attention_vit_tpu_torch.parallel.sharding import _fsdp_dims

    family, extra = GEOMETRIES[geometry]
    cfg = _port_cfg(family)
    modify_config(cfg, extra)
    model = (ModelCross if family == "cross" else ModelVIT)(cfg, device="cpu",
                                                            master_weights=True)
    pipeline = int(cfg.get("pipeline_stages", 0)) > 1
    dims = _fsdp_dims(model, _Sizes(pipe=2 if pipeline else 1, data=data_size))
    want = _jax_fsdp_shards(model, data_size, pipeline)
    assert any(d is not None for d in dims.values()) or data_size != 2, "shards nothing"
    params = dict(model.named_parameters())
    assert set(want) >= set(params)
    for n, p in params.items():
        d = dims[n]
        if d is None:
            assert (want[n] == -1).all(), n
            continue
        assert p.shape[d] % data_size == 0
        index = np.arange(p.shape[d]) // (p.shape[d] // data_size)
        got = np.broadcast_to(index.reshape([-1 if i == d else 1 for i in range(p.dim())]),
                              tuple(p.shape))
        np.testing.assert_array_equal(got, want[n], err_msg=n)
        # on the dim 'model' splits only along its (q, k, v) blocks (JAX's
        # free 3 axis at a data size that H does not divide): the data
        # shards of a TP slice are then the whole tensor's, block by block
        split = tp_dim(n, tuple(p.shape))
        assert split is None or split[0] != d or split[1] % data_size == 0, n
        assert not (".experts." in n and d == 0), n


# -- tests: two ranks, two steps ------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_ranks_agree_exactly(steps, case):
    r0, r1 = steps["ranks"][case]
    for k in r0:
        if k not in ("sampler", "step_draw") and not k.startswith("grad/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    for k in (k for k in r0 if k.startswith("grad/")):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_the_one_process_step(steps, case):
    one = steps["one"][CASES[case][0]]
    got = steps["ranks"][case][0]
    names = [k for k in one if k.startswith("grad/")]
    assert names and set(names) == {k for k in got if k.startswith("grad/")}
    for k in names:
        np.testing.assert_allclose(got[k], one[k], atol=1e-6, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", ["ddp", "fsdp", "ddp_accum2", "fsdp_accum2"])
def test_step_matches_the_jax_single_device_step(steps, case):
    got, ref = steps["ranks"][case][0], steps["jax"]
    _, labels = zip(*_batches("cross"))
    for s in range(STEPS):
        assert float(got[f"loss/{s}"]) == pytest.approx(ref[f"loss/{s}"], rel=1e-5)
        np.testing.assert_allclose(got[f"probs/{s}"], ref[f"probs/{s}"], atol=1e-5)
        np.testing.assert_array_equal(got[f"labels/{s}"], labels[s])
        keys = [k for k in ref if k.startswith(f"params{s}/")]
        assert keys and set(keys) == {k for k in got if k.startswith(f"params{s}/")}
        for k in keys:
            np.testing.assert_allclose(got[k], ref[k], atol=2.5 * LR, rtol=0, err_msg=k)


def test_vit_ddp_matches_the_one_process_step(steps):
    got, one = steps["ranks"]["vit_ddp"][0], steps["one"]["vit"]
    for k in (k for k in one if k.startswith("params")):
        np.testing.assert_allclose(got[k], one[k], atol=2.5 * LR, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["fsdp", "fsdp_accum2"])
def test_fsdp_ranks_hold_half_of_each_sharded_param_and_moment(steps, case):
    from cross_attention_vit_tpu_torch.parallel import FSDP_MIN_SIZE

    shards = steps["shards"][case]
    want = {k[len("grad/"):] for k, v in steps["one"]["cross"].items()
            if k.startswith("grad/") and v.size >= FSDP_MIN_SIZE}
    assert set(shards) == want and want
    for name, (whole, local, mu, nu) in shards.items():
        assert local == mu == nu == whole // 2, name
    assert not steps["shards"]["ddp"]


def test_ranks_draw_their_own_samples_and_randomness(steps):
    from cross_attention_vit_tpu_torch.train import trainer as ttrainer

    r0, r1 = steps["ranks"]["ddp"]
    assert not np.array_equal(r0["sampler"], r1["sampler"])
    assert not np.array_equal(r0["step_draw"], r1["step_draw"])
    # rank 0 draws what the single-device Trainer draws
    single = torch.rand(4, generator=ttrainer._step_generator(0, 0, 0))
    np.testing.assert_array_equal(r0["step_draw"], single.numpy())


# -- tests: Trainer.fit, checkpoints and resume -----------------------------------------

@pytest.fixture(scope="module")
def fitted(tmp_path_factory, jax_init):
    from cross_attention_vit_tpu_torch.data.loader import PrefetchLoader

    tmp = tmp_path_factory.mktemp("fit")
    src, init = jax_init
    shutil.copy(src / "init_cross.npz", tmp)
    one = _fit_trainer(_port_cfg("cross"), None, tmp / "one", 0, max_epochs=1)
    one.init_state(init["cross"])
    ds = _Data()
    one.fit(PrefetchLoader(ds, batch_size=4, device="cpu"),
            PrefetchLoader(ds, batch_size=4, device="cpu"), verbose=False)
    _spawn("fit", tmp)
    return tmp, [json.loads((tmp / f"fit_{r}.json").read_text()) for r in range(2)]


def _files(root: Path) -> set[str]:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def test_fit_gives_every_rank_the_history_and_rank_0_alone_writes(fitted):
    tmp, (f0, f1) = fitted
    assert len(f0["history"]) == 2 and f0["history"] == f1["history"]
    assert all(np.isfinite(v) for row in f0["history"] for v in row.values())
    assert _files(tmp / "rank1") == set()
    files = _files(tmp / "rank0")
    assert "csv/run/metrics.csv" in files and "config.json" in {Path(f).name for f in files}
    assert sum(f.startswith("topk/epoch=") for f in files) == 2
    # 12 samples over 2 ranks at batch 2: 3 steps an epoch
    assert {"latest/step=3.npz", "latest/step=6.npz"} <= files
    rows = (tmp / "rank0" / "csv" / "run" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 3


def test_fsdp_checkpoint_is_the_jax_layout_and_resumes_in_one_process(fitted):
    import jax
    from cross_attention_vit_tpu.configs import get_mgmt_cross_config, modify_config
    from cross_attention_vit_tpu.models import model_cross
    from cross_attention_vit_tpu.train import optim
    from cross_attention_vit_tpu.train.checkpoint import restore_pytree
    from cross_attention_vit_tpu_torch.models.convert import params_from_flat
    from cross_attention_vit_tpu_torch.train.checkpoint import flatten, restore_flat

    tmp, _ = fitted
    ckpt = tmp / "rank0" / "latest" / "step=6.npz"
    jcfg = get_mgmt_cross_config()
    modify_config(jcfg, CROSS)
    like_params = model_cross.init(jax.random.key(1), jcfg)
    like = {"params": like_params, "opt": optim.init(like_params),
            "epoch": jax.numpy.zeros((), jax.numpy.int32)}
    state = restore_pytree(ckpt, like)
    flat = restore_flat(ckpt)
    assert int(state["epoch"]) == 1 and int(state["opt"].step) == 6
    for k, v in flatten(jax.tree.map(np.asarray, state["params"])).items():
        np.testing.assert_array_equal(v, flat[f"params/{k}"])
    # a one-process Trainer resumes the 2-rank run
    t = _fit_trainer(_port_cfg("cross"), None, tmp / "one_resumes", 0, max_epochs=3,
                     latest_dir=ckpt.parent).init_state()
    assert t.maybe_resume() == 2 and t.global_step == 6
    for k, v in flatten(t.params).items():
        np.testing.assert_array_equal(v, flat[f"params/{k}"])
    mu, nu = t._moment_trees()
    for which, tree in (("mu", mu), ("nu", nu)):
        for k, v in flatten(tree).items():
            np.testing.assert_array_equal(v, flat[f"opt/{which}/{k}"])
    assert params_from_flat(flat).keys() == state["params"].keys()


def test_two_fsdp_ranks_resume_a_one_process_checkpoint(fitted):
    from cross_attention_vit_tpu_torch.train.checkpoint import restore_flat

    tmp, (f0, f1) = fitted
    assert f0["start"] == f1["start"] == 1 and f0["global_step"] == 3
    one = restore_flat(tmp / "one" / "latest" / "step=3.npz")
    got = dict(np.load(tmp / "resumed_state.npz"))
    assert set(got) == set(one)
    for k in one:
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)


# -- tests: the CLIs over two processes --------------------------------------------------

MODS = ("DWI", "SWI", "ASL")
TINY_CLI = {"hidden_dim": 16, "mlp_dim": 32, "num_heads": 2, "num_multi_blocks": 1,
            "num_self_blocks": 1, "num_layers": 1, "img_size": (16, 16, 8),
            "patch_size": (8, 8, 8), "img_aug": False, "dropout": 0.0}


def _cli_args(tmp: Path) -> list[str]:
    return ["--model", "cross", "--grid-index", "0", "--seeds", "2004", "--batch-size", "4",
            "--epochs", "1", "--only-available", "--labels", str(tmp / "labels.csv"),
            "--data", str(tmp / "data"), "--out", str(tmp / "runs"),
            *[a for k, v in TINY_CLI.items() for a in ("--set", f"{k}={v!r}")]]


def _eval_args(tmp: Path, ckpt: Path) -> list[str]:
    return ["--checkpoint", str(ckpt), "--model", "cross", "--labels", str(tmp / "labels.csv"),
            "--data", str(tmp / "data"), "--only-available", "--batch-size", "4"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The synthetic cohort of tests/test_torch_drivers.py (20 subjects on
    disk), then two ranks of the experiments and evaluate CLIs."""
    from cross_attention_vit_tpu_torch.data.nifti import write_volume

    tmp = tmp_path_factory.mktemp("cli")
    r = np.random.default_rng(0)
    rows = []
    for i in range(1, 21):
        rows.append(f"UCSF-PDGM-{i},{'positive' if r.random() < 0.4 else 'negative'}")
        case = f"UCSF-PDGM-{i:04d}"
        (tmp / "data" / f"{case}_nifti").mkdir(parents=True)
        for m in MODS:
            write_volume(tmp / "data" / f"{case}_nifti" / f"{case}_{m}.nii.gz",
                         r.integers(0, 900, size=(18, 16, 9)).astype(np.int16), scl_slope=1.0)
    rows += ["UCSF-PDGM-175,positive", "UCSF-PDGM-21,indeterminate"]
    (tmp / "labels.csv").write_text("ID,MGMT status\n" + "\n".join(rows) + "\n")
    _spawn("cli", tmp)
    return tmp, [json.loads((tmp / f"cli_{r}.json").read_text()) for r in range(2)]


def test_experiments_cli_trains_over_two_processes(cli):
    tmp, (c0, c1) = cli
    assert list(c0["history"]) == ["test_200_0_0_0"]
    assert c0["history"] == c1["history"] and len(c0["history"]["test_200_0_0_0"]) == 1
    assert all(np.isfinite(v) for v in c0["history"]["test_200_0_0_0"][0].values())
    files = _files(tmp / "runs")
    # 13 training subjects: 6 sampler draws a rank, 2 steps at batch 4
    assert {"csv_logs/cross/test_200_0_0_0/metrics.csv", "latest/test_200_0_0_0/step=2.npz",
            "checkpoints/cross/config_test_200_0_0_0.json",
            "checkpoints/cross/manifest_test_200_0_0_0.json"} <= files


def test_sharded_evaluate_equals_one_process_and_jax(cli):
    from cross_attention_vit_tpu.drivers import evaluate as jeval
    from cross_attention_vit_tpu_torch.drivers import evaluate as teval

    tmp, (c0, c1) = cli
    assert c0["metrics"] == c1["metrics"]
    args = _eval_args(tmp, Path(c0["checkpoint"]))
    one = teval.main(args, device="cpu")
    want = jeval.main(args)
    assert c0["metrics"]["n"] == one["n"] == want["n"] == 20     # 20 % (4 × 2) != 0
    assert set(c0["metrics"]) == set(want)
    for k in want:
        assert abs(c0["metrics"][k] - one[k]) <= 1e-6, (k, c0["metrics"][k], one[k])
        assert abs(c0["metrics"][k] - want[k]) <= 1e-6, (k, c0["metrics"][k], want[k])


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent.parent))
    _mode, _address, _rank, _world, _dir = sys.argv[1:6]
    t0 = time.perf_counter()
    _worker(_mode, _address, int(_rank), int(_world), Path(_dir))
    print(f"rank {_rank} {_mode}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    from torch_mesh_workers import leave

    leave()
