"""Gloo ranks for the port's expert-, sequence-, tensor- and pipeline-parallel
tests and their compositions (``tests/test_torch_moe.py``,
``test_torch_ring.py``, ``test_torch_sp_ep_models.py``,
``test_torch_tensor_parallel.py``, ``test_torch_pipeline.py``,
``test_torch_sharded_serving.py``, ``test_torch_composed_parallel.py``,
``test_torch_composed_fit.py``, ``test_torch_sync_bn.py``,
``test_torch_tp_vit3d.py``, ``test_torch_serve_mesh_cli.py``), run as
subprocesses of the test process.

``spawn(mode, tmp, world)`` starts ``python tests/torch_mesh_workers.py
<mode> <rendezvous> <rank> <world> <tmp>`` once for each rank (``launch``)
and waits for them all under one deadline for the whole world
(``wait_world``), which ends the world as soon as a rank fails.  The
ranks meet in a FileStore under ``tmp`` (``rendezvous``), so no port is
picked and released for another world, started at the same time by
another test process, to take.  Each rank joins a gloo group (the CLI
modes let the CLI join it), runs the mode's worker on inputs the test wrote into
``tmp`` (or made here from a seed), writes its results there as
``<name>_<rank>.npz`` and leaves without the interpreter's teardown
(``leave``).  Workers run with one thread each and import the port
only.  The geometry and the batches live here, so the test process builds
its one-process references from the same definitions.
"""

from __future__ import annotations

import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WORKER_TIMEOUT_S = 180
LR = 1e-3
STEPS = 2
GLOBAL_BATCH = 8

# -- the MoE FFN alone (tests/test_torch_moe.py)
HIDDEN, MLP, EXPERTS = 16, 32, 4
MOE_CAPACITY_FACTOR = 2.0      # no choice dropped: every slot order gives one answer

# -- the models (tests/test_torch_sp_ep_models.py): 2 streams, N = 5 tokens a
# stream for ModelCross and 9 for ModelVIT (ragged at P = 2 and 4)
CROSS = dict(hidden_dim=32, mlp_dim=64, num_heads=4, num_multi_blocks=1, num_self_blocks=2,
             img_size=(16, 16, 8), patch_size=(8, 8, 8), num_modalities=2,
             attn_order={"0": "1", "1": "0"}, dropout=0.0, lr=LR, weight_decay=5e-4,
             label_smoothing=0.1, img_aug=False, optim_params={"T_max": 10, "eta_min": 1e-6},
             use_flash_attention=True)
VIT = dict(CROSS, num_layers=2, label_smoothing=0.0)
# name: (family, config fields, mesh axes, fsdp, world)
MODEL_CASES = {
    "cross_sp2": ("cross", {"seq_parallel": 2, "dropout": 0.1}, {"seq": 2}, False, 2),
    "vit_sp2": ("vit", {"seq_parallel": 2, "dropout": 0.1, "drop_path_rate": 0.1},
                {"seq": 2}, False, 2),
    "cross_ep2": ("cross", {"moe_experts": 4, "dropout": 0.1}, {"expert": 2}, False, 2),
    "cross_dp2_moe_fsdp": ("cross", {"moe_experts": 4}, {"data": 2}, True, 2),
    "vit_ep2": ("vit", {"moe_experts": 4, "dropout": 0.1}, {"expert": 2}, False, 2),
    "cross_dp2_ep2": ("cross", {"moe_experts": 4}, {"data": 2, "expert": 2}, False, 4),
    "vit_dp2_ep2": ("vit", {"moe_experts": 4}, {"data": 2, "expert": 2}, False, 4),
    "vit_sp4": ("vit", {"seq_parallel": 4, "dropout": 0.1}, {"seq": 4}, False, 4),
    "cross_sp4": ("cross", {"seq_parallel": 4, "dropout": 0.1}, {"seq": 4}, False, 4),
    "cross_dp2_sp2_fsdp": ("cross", {"seq_parallel": 2}, {"data": 2, "seq": 2}, True, 4),
    "vit_sp2_ep2": ("vit", {"seq_parallel": 2, "moe_experts": 4}, {"seq": 2, "expert": 2},
                    False, 4),
}
SHARDED_NS = (9, 13, 16)     # sharded_ring_sdpa over seq 2: ragged and exact
# -- tensor and pipeline parallelism: name -> (family, config fields, mesh axes, world)
PP = {"num_layers": 4, "pipeline_stages": 2, "pipeline_microbatches": 4}
TP_CASES = {
    "cross_tp2": ("cross", {}, {"model": 2}, 2),
    "vit_tp2": ("vit", {}, {"model": 2}, 2),
    "cross_tp2_dropout": ("cross", {"dropout": 0.1}, {"model": 2}, 2),
    "cross_dp2_tp2": ("cross", {}, {"data": 2, "model": 2}, 4),
    "vit_dp2_tp2": ("vit", {}, {"data": 2, "model": 2}, 4),
}
PP_CASES = {
    "vit_pp2": ("vit", PP, {"pipe": 2}, 2),
    "vit_pp2_dropout": ("vit", {**PP, "dropout": 0.1, "drop_path_rate": 0.1}, {"pipe": 2}, 2),
    "vit_pp2_dp2": ("vit", PP, {"pipe": 2, "data": 2}, 4),
    "vit_pp2_tp2": ("vit", PP, {"pipe": 2, "model": 2}, 4),
}
# the composed axes: name -> (family, config fields, mesh axes, world, fsdp).
# The FSDP cases widen the MLP until parameters reach FSDP_MIN_SIZE: fc1/fc2
# (512 x 64), the expert stacks (4 x 256 x 32), and under PP the stacked
# (4 x 256 x 32) fc1/fc2 whose layers alone (8192) are under it
MOE = {"moe_experts": 4}
COMPOSED_CASES = {
    "cross_dp2_tp2_fsdp": ("cross", {"hidden_dim": 64, "mlp_dim": 512}, {"data": 2, "model": 2},
                           4, True),
    "cross_sp2_tp2": ("cross", {"seq_parallel": 2}, {"seq": 2, "model": 2}, 4, False),
    "cross_ep2_tp2": ("cross", MOE, {"expert": 2, "model": 2}, 4, False),
    "cross_dp2_ep2_fsdp": ("cross", {**MOE, "mlp_dim": 256}, {"data": 2, "expert": 2}, 4,
                           True),
    "vit_pp2_dp2_fsdp": ("vit", {**PP, "mlp_dim": 256}, {"pipe": 2, "data": 2}, 4, True),
    # ModelVIT's trunk layers as FSDP's units: fc1/fc2 (1024 x 32) reach FSDP_MIN_SIZE
    "vit_dp2_fsdp": ("vit", {"mlp_dim": 1024}, {"data": 2}, 2, True),
    # remat inside FSDP's units and across TP's f/g (the recompute re-runs them)
    "cross_dp2_tp2_fsdp_remat": ("cross", {"hidden_dim": 64, "mlp_dim": 512, "remat": True,
                                           "remat_policy": "full"},
                                 {"data": 2, "model": 2}, 4, True),
}
# Trainer.fit over (data 2 x model 2) with FSDP and grad_accum 2: one step an
# epoch, so its global batch is the whole set in any order and JAX's
# single-process fit over the same mesh sees the same batches
COMPOSED_FIT = {"hidden_dim": 64, "mlp_dim": 512}
COMPOSED_FIT_AXES = {"data": 2, "model": 2}
# experiments --tp 2 --fsdp over four processes: fc1/fc2 (2048 x 16) reach
# FSDP_MIN_SIZE at TINY_CLI's hidden 16
COMPOSED_CLI = ("--set", "mlp_dim=2048")
# the server over (data 1 x expert 2 x model 2) on a MoE checkpoint
SERVE_EP_AXES = {"data": 1, "expert": 2, "model": 2}
# the stateful ViT3D (BatchNorm stem) over (data 2), tests/test_torch_sync_bn.py
BN_TINY = dict(hidden_dim=32, num_heads=4, num_layers=1, img_size=(32, 32, 16),
               num_modalities=2, dropout=0.0, label_smoothing=0.0, lr=LR, weight_decay=5e-4,
               img_aug=False, optim_params={"factor": 0.5, "patience": 0})
# the stateful ViT3D over a 'model' axis (tests/test_torch_tp_vit3d.py):
# name -> (config fields over BN_TINY, mesh axes, world, fsdp).  The FSDP
# case widens the model to hidden 128, where the qkv (384 x 128), linear1
# and linear2 (512 x 128) and the last stem conv reach FSDP_MIN_SIZE
BN_TP_CASES = {
    "tp2": ({}, {"model": 2}, 2, False),
    "dp2_tp2": ({}, {"data": 2, "model": 2}, 4, False),
    "dp2_tp2_fsdp": ({"hidden_dim": 128}, {"data": 2, "model": 2}, 4, True),
}
# the server over a mesh (world -> mesh axes), and a width at which int8 quantizes
SERVE_MESHES = {2: {"model": 2}, 4: {"data": 2, "model": 2}}
SERVE_INT8 = {"hidden_dim": 256, "mlp_dim": 1024}
SERVE_BUCKETS = (2, 4, 8)
# Trainer.fit over 2 ranks: name -> (config fields, mesh axes)
FIT_CASES = {"fit_ep2": ({"moe_experts": 4}, {"expert": 2}),
             "fit_sp2": ({"seq_parallel": 2}, {"seq": 2})}


def dispatch_combine_masks(probs: torch.Tensor, num_selected: int, capacity: int):
    """JAX's ``_dispatch_combine`` from the port's ``route``: the (T, E, C)
    one-hot dispatch and gate-weighted combine masks and the balance loss."""
    from cross_attention_vit_tpu_torch.parallel.moe import route

    t, num_experts = probs.shape
    r = route(probs, num_selected, capacity)
    dispatch = probs.new_zeros((t, num_experts, capacity))
    combine = probs.new_zeros((t, num_experts, capacity))
    kept = r.slots >= 0
    tok = torch.arange(t)[:, None].expand_as(r.slots)[kept]
    at = (tok, r.experts[kept], r.slots[kept])
    dispatch = dispatch.index_put(at, torch.ones_like(r.gates[kept]), accumulate=True)
    combine = combine.index_put(at, r.gates[kept], accumulate=True)
    return dispatch, combine, r.balance


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rendezvous(tmp: Path) -> str:
    """A fresh ``file://`` rendezvous under ``tmp`` for one world of ranks
    (``multihost_init``'s FileStore address)."""
    return f"file://{tmp / f'rendezvous-{uuid.uuid4().hex}'}"


def leave(code: int = 0) -> None:
    """End a worker process without the interpreter's teardown, once its
    results are on disk (and any checkpoint write has finished).  torch's
    c10d can abort in that teardown under load, after the group was
    destroyed ("terminate called without an active exception", SIGABRT):
    ``spawn`` would then fail a test on a rank whose work was done."""
    from cross_attention_vit_tpu_torch.train.checkpoint import wait_for_writes

    wait_for_writes()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


class World:
    """The ranks of one world: their processes and the files their output
    goes to (a file each, so that no rank blocks on a full pipe)."""

    def __init__(self, mode: str, procs: list, logs: list[Path]):
        self.mode, self.procs, self.logs = mode, procs, logs

    def tail(self, rank: int) -> str:
        return self.logs[rank].read_text(errors="replace")[-6000:]


def launch(mode: str, tmp: Path, world: int, script: Path | str = __file__,
           address: str | None = None) -> World:
    """Start ``world`` ranks of ``script``'s worker ``mode`` (``python
    <script> <mode> <address> <rank> <world> <tmp>``), meeting at
    ``address`` (default: a fresh ``rendezvous`` under ``tmp``), each rank's
    stdout and stderr in a file under ``tmp``."""
    address = address or rendezvous(tmp)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    tag = uuid.uuid4().hex[:8]
    procs, logs = [], []
    for r in range(world):
        logs.append(tmp / f"{mode}-{tag}-rank{r}.log")
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), mode, address, str(r), str(world), str(tmp)],
                stdout=out, stderr=subprocess.STDOUT, text=True, env=env))
    return World(mode, procs, logs)


def wait_world(w: World, timeout_s: float = WORKER_TIMEOUT_S) -> None:
    """Wait for every rank of ``w`` under one deadline for the whole world;
    as soon as a rank exits with an error, or when the deadline passes, kill
    the ranks still running.  Fails with the output of the rank at fault."""
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while True:
            codes = [p.poll() for p in w.procs]
            failed = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
            if failed is not None or None not in codes or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in w.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        raise AssertionError(f"rank {failed} of {w.mode} failed (exit "
                             f"{w.procs[failed].returncode}; the others were ended):\n"
                             f"{w.tail(failed)}")
    late = [r for r, c in enumerate(codes) if c is None]
    if late:
        raise AssertionError(f"{w.mode}: ranks {late} of {len(w.procs)} were still running "
                             f"after the world's {timeout_s:.0f} s and were killed; rank "
                             f"{late[0]}'s output:\n{w.tail(late[0])}")


def spawn(mode: str, tmp: Path, world: int) -> None:
    """Run ``world`` ranks of the worker ``mode`` and wait for them all
    (``launch``, ``wait_world``)."""
    wait_world(launch(mode, tmp, world))


def load(tmp: Path, name: str, world: int) -> list[dict]:
    """Every rank's results of ``name``."""
    return [dict(np.load(tmp / f"{name}_{r}.npz")) for r in range(world)]


# -- shared definitions --------------------------------------------------------------

def port_config(family: str, **fields):
    from cross_attention_vit_tpu_torch.configs import (get_mgmt_config, get_mgmt_cross_config,
                                                       modify_config)
    cfg = get_mgmt_cross_config() if family == "cross" else get_mgmt_config()
    modify_config(cfg, {**(CROSS if family == "cross" else VIT), **fields})
    return cfg


def model_batches(family: str) -> list[tuple[np.ndarray, np.ndarray]]:
    """The global batches of a run, made from a seed."""
    rng = np.random.default_rng(11 if family == "cross" else 12)
    return [((rng.normal(size=(GLOBAL_BATCH, 2, 1, 16, 16, 8)) * 2).astype(np.float32),
             rng.integers(0, 2, size=GLOBAL_BATCH).astype(np.int64)) for _ in range(STEPS)]


class Data:
    """An in-memory dataset with the BrainDataset batch interface."""

    def __init__(self, n: int = 8, seed: int = 0):
        r = np.random.default_rng(seed)
        self.labels = (np.arange(n) % 3 == 0).astype(np.int32)
        self.imgs = (r.normal(size=(n, 2, 1, 16, 16, 8))
                     + self.labels[:, None, None, None, None, None]).astype(np.float32)

    def __len__(self):
        return len(self.labels)

    def batch(self, indices):
        idx = np.asarray(indices)
        return self.imgs[idx], self.labels[idx]


def fit_trainer(name: str, mesh=None):
    """The Trainer of a FIT_CASES run (a one-process one without a mesh)."""
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
    from cross_attention_vit_tpu_torch.train.trainer import Trainer

    fields, _ = FIT_CASES[name]
    return Trainer(ModelCross, port_config("cross", **fields), max_epochs=2, seed=3, mesh=mesh,
                   device="cpu")


def fit_loaders():
    from cross_attention_vit_tpu_torch.data.loader import PrefetchLoader

    ds = Data()
    return PrefetchLoader(ds, batch_size=2, device="cpu"), PrefetchLoader(ds, batch_size=2,
                                                                          device="cpu")


def history_rows(hist: list[dict]) -> list[dict]:
    """A fit history without its wall times."""
    return [{k: v for k, v in row.items() if k != "epoch_time_s"} for row in hist]


def whole_grads(model) -> dict[str, np.ndarray]:
    """Every parameter's gradient, whole: FSDP shards, split experts, TP
    slices and the other stages' layers gathered (a collective)."""
    from cross_attention_vit_tpu_torch.parallel import full_tensor, unwrap, whole_tensors

    m = unwrap(model)
    grads = {n: full_tensor(p.grad).detach() for n, p in m.named_parameters()}
    return {n: g.numpy().copy() for n, g in whole_tensors(m, grads).items()}


def _mesh(axes: dict):
    from cross_attention_vit_tpu_torch.parallel import make_mesh
    return make_mesh(axes.get("data", -1), model=axes.get("model", 1), pipe=axes.get("pipe", 1),
                     seq=axes.get("seq", 1), expert=axes.get("expert", 1))


def _clear_ambient():
    from cross_attention_vit_tpu_torch.parallel import (set_expert_mesh, set_pipeline_mesh,
                                                        set_seq_mesh)
    set_expert_mesh(None)
    set_seq_mesh(None)
    set_pipeline_mesh(None)


def port_trainer(family: str, fields: dict, mesh=None, params=None, fsdp: bool = False):
    """A Trainer of the family over ``mesh`` (one process without), from a
    JAX param tree."""
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
    from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
    from cross_attention_vit_tpu_torch.train.trainer import Trainer

    return Trainer(ModelCross if family == "cross" else ModelVIT, port_config(family, **fields),
                   max_epochs=1, mesh=mesh, fsdp=fsdp, device="cpu").init_state(params)


def split_steps(t, family: str, mesh=None, one_ckpt: Path | None = None,
                save_first: Path | None = None) -> dict:
    """The results the split tests compare: the eval logits (whole) before
    any step; STEPS train steps (loss, probs, the first step's whole
    gradients, the parameters after each step); one eval step after them;
    the checkpoint state after them (``ckpt/...``, whole, JAX layout); and,
    from ``one_ckpt`` (a state after step 0), step 1 again (``resumed/...``).
    ``save_first``: where to write the state after step 0."""
    from cross_attention_vit_tpu_torch.parallel import gather_rows, shard_batch
    from cross_attention_vit_tpu_torch.train import trainer as ttrainer
    from cross_attention_vit_tpu_torch.train.checkpoint import flatten

    def rows(batch):
        return tuple(torch.from_numpy(x) for x in
                     (batch if mesh is None else shard_batch(batch, mesh)))

    batches = model_batches(family)
    img, lab = rows(batches[0])
    logits = t.eval_step(img, lab)["logits"]
    out = {"logits0": (logits if mesh is None else gather_rows(logits, mesh)).numpy()}
    shard = t.shard
    for s, batch in enumerate(batches):
        aux = t.train_step(*rows(batch), LR, ttrainer._step_generator(0, 0, s, shard))
        out[f"loss/{s}"], out[f"probs/{s}"] = aux["loss"].numpy(), aux["probs"].numpy()
        if s == 0:
            out.update({f"grad/{n}": g for n, g in whole_grads(t.model).items()})
            if save_first is not None:
                np.savez(save_first, **t._ckpt_state(0))
        out.update({f"params{s}/{k}": v for k, v in flatten(t.params).items()})
    aux = t.eval_step(img, lab)
    out["eval/probs"], out["eval/loss"] = aux["probs"].numpy(), aux["loss"].numpy()
    out.update({f"ckpt/{k}": v for k, v in t._ckpt_state(0).items()})
    if one_ckpt is not None:
        t._load_flat(dict(np.load(one_ckpt)))
        aux = t.train_step(*rows(batches[1]), LR, ttrainer._step_generator(0, 0, 1, shard))
        out["resumed/loss"] = aux["loss"].numpy()
        out.update({f"resumed/{k}": v for k, v in flatten(t.params).items()})
    return out


# -- workers: the MoE FFN alone --------------------------------------------------------

def _moe_worker(rank: int, world: int, tmp: Path) -> None:
    """The MoE FFN over (expert 2) at world 2 and (data 2, expert 2) at world
    4, top-1 and top-2: each data coordinate's rows of the batch, the
    test's loss D·Σ tanh(y) + 0.01·balance on every rank, gradients
    averaged over the data axis as DDP does."""
    import torch.distributed as dist
    from cross_attention_vit_tpu_torch.parallel import (MoEFFN, axis_group, axis_index,
                                                        axis_size, gather_experts,
                                                        set_expert_mesh, shard_experts)

    src = dict(np.load(tmp / "moe.npz"))
    mesh = _mesh({"data": world // 2, "expert": 2})
    set_expert_mesh(mesh)
    d, nd = axis_index(mesh, "data"), axis_size(mesh, "data")
    rows = len(src["x"]) // nd
    out = {}
    for k in (1, 2):
        site = MoEFFN(HIDDEN, MLP, EXPERTS, num_selected=k, capacity_factor=MOE_CAPACITY_FACTOR)
        site.load_state_dict({n: torch.from_numpy(src[n]) for n in site.state_dict()})
        shard_experts(site, mesh)
        if k == 1:
            out["layout"] = np.array([site.experts["fc1"].weight.shape[0],
                                      site.router.weight.shape[0]])
            out["fc1_local"] = site.experts["fc1"].weight.detach().numpy().copy()
        x = torch.from_numpy(src["x"][d * rows:(d + 1) * rows]).requires_grad_()
        y, aux = site(x)
        (nd * torch.tanh(y).sum() + 0.01 * aux["balance_loss"]).backward()
        grads = {n: p.grad for n, p in site.named_parameters()}
        for g in grads.values():
            dist.all_reduce(g, group=axis_group(mesh, "data"))
            g.div_(nd)
        x.grad.div_(nd)     # this coordinate's rows: D times the global loss's
        out.update({f"k{k}/y": y.detach().numpy(), f"k{k}/dx": x.grad.numpy(),
                    f"k{k}/balance": aux["balance_loss"].detach().numpy(),
                    f"k{k}/dispatch_fraction": aux["dispatch_fraction"].numpy()})
        out.update({f"k{k}/grad/{n}": g.numpy()
                    for n, g in gather_experts(site, grads).items()})
    np.savez(tmp / f"moe_w{world}_{rank}.npz", **out)


# -- workers: the ring alone -----------------------------------------------------------

def ring_inputs(b=4, heads=4, n=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(3, b, heads, n, d)).astype(np.float32)


def ring_grads(qkv: np.ndarray, fn) -> np.ndarray:
    """(dq, dk, dv) of Σ tanh(fn(q, k, v)), stacked."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv)
    torch.tanh(fn(q, k, v)).sum().backward()
    return np.stack([q.grad.numpy(), k.grad.numpy(), v.grad.numpy()])


def _ring_worker(rank: int, world: int, tmp: Path) -> None:
    """``ring_sdpa`` forward (f32, bf16) and gradient and the per-rank ring
    body (``_ring_fwd``) on each rank's slices, over (seq = world); at world
    4 also the gradient over (data 2, seq 2) and the mesh layouts."""
    from cross_attention_vit_tpu_torch.parallel import make_mesh, ring_sdpa
    from cross_attention_vit_tpu_torch.parallel.ring import _line, _ring_fwd

    mesh = make_mesh(1, seq=world)
    out = {}
    q, k, v = (torch.from_numpy(a) for a in ring_inputs())
    out["fwd"] = ring_sdpa(mesh)(q, k, v).numpy()
    out["fwd_bf16"] = ring_sdpa(mesh)(*(t.bfloat16() for t in (q, k, v))).float().numpy()
    # the per-rank body on this rank's slices of the sequence
    n = q.shape[2] // world
    local = [t[:, :, rank * n:(rank + 1) * n] for t in (q, k, v)]
    out["local"] = _ring_fwd(*local, q.shape[-1] ** -0.5, _line(mesh, "seq"), None)[0].numpy()

    small = ring_inputs(n=32, heads=2, d=8)
    out["grad"] = ring_grads(small, lambda q, k, v: ring_sdpa(mesh)(q, k, v))
    if world == 4:
        grid = make_mesh(2, seq=2)
        out["grad_data2_seq2"] = ring_grads(small, lambda q, k, v: ring_sdpa(grid)(q, k, v))
        errors = []
        for kw in ({"data": 3, "seq": 3}, {"seq": 3}):
            try:
                make_mesh(**kw)
                errors.append("")
            except ValueError as e:
                errors.append(str(e))
        layout = {"grid": [list(grid.mesh_dim_names), list(grid.mesh.shape)],
                  "line": [list(mesh.mesh_dim_names), list(mesh.mesh.shape)],
                  "errors": errors}
        (tmp / f"layout_{rank}.json").write_text(json.dumps(layout))
    np.savez(tmp / f"ring_w{world}_{rank}.npz", **out)


# -- workers: the models ---------------------------------------------------------------

def _model_worker(rank: int, world: int, tmp: Path) -> None:
    """Each MODEL_CASES case of this world: a Trainer over its mesh from the
    JAX-initialised parameters, STEPS train steps on this data coordinate's
    rows (loss, probs, the first step's whole gradients, the parameters
    after each step) and one eval step (probs, loss, the MoE aux values)."""
    from cross_attention_vit_tpu_torch.models.convert import params_from_flat
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
    from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
    from cross_attention_vit_tpu_torch.parallel import (active_expert_mesh, active_seq_mesh,
                                                        shard_batch, unwrap)
    from cross_attention_vit_tpu_torch.train import trainer as ttrainer
    from cross_attention_vit_tpu_torch.train.checkpoint import flatten, restore_flat

    if world == 2:      # sharded_ring_sdpa alone, ragged and exact N
        from cross_attention_vit_tpu_torch.parallel import make_mesh, sharded_ring_sdpa

        mesh, out = make_mesh(1, seq=2), {}
        for n in SHARDED_NS:
            qkv = ring_inputs(b=2, heads=2, n=n, d=8, seed=n)
            out[f"grad{n}"] = ring_grads(qkv, lambda q, k, v: sharded_ring_sdpa(
                q, k, v, 8 ** -0.5, mesh=mesh))
            with torch.no_grad():
                out[f"out{n}"] = sharded_ring_sdpa(*(torch.from_numpy(a) for a in qkv),
                                                   8 ** -0.5, mesh=mesh).numpy()
        np.savez(tmp / f"sharded_sdpa_{rank}.npz", **out)
    for name, (family, fields, axes, fsdp, w) in MODEL_CASES.items():
        if w != world:
            continue
        _clear_ambient()
        mesh = _mesh(axes)
        cfg = port_config(family, **fields)
        params = params_from_flat(restore_flat(tmp / f"init_{name}.npz"))
        t = ttrainer.Trainer(ModelCross if family == "cross" else ModelVIT, cfg, max_epochs=1,
                             mesh=mesh, fsdp=fsdp, device="cpu").init_state(params)
        seen = []      # the ambient meshes each forward of a step finds
        unwrap(t.model).register_forward_pre_hook(
            lambda *_: seen.append([active_seq_mesh() is mesh, active_expert_mesh() is mesh]))
        out = {"ambient_after_init": np.array([active_seq_mesh() is None,
                                               active_expert_mesh() is None])}
        for s, batch in enumerate(model_batches(family)):
            img, lab = (torch.from_numpy(x) for x in shard_batch(batch, mesh))
            aux = t.train_step(img, lab, LR, ttrainer._step_generator(0, 0, s, t.shard))
            out[f"loss/{s}"] = aux["loss"].numpy()
            out[f"probs/{s}"] = aux["probs"].numpy()
            if s == 0:
                out.update({f"grad/{n}": g for n, g in whole_grads(t.model).items()})
            out.update({f"params{s}/{k}": v for k, v in flatten(t.params).items()})
        img, lab = (torch.from_numpy(x) for x in shard_batch(model_batches(family)[0], mesh))
        aux = t.eval_step(img, lab)
        out["eval/probs"], out["eval/loss"] = aux["probs"].numpy(), aux["loss"].numpy()
        out["ambient_in_steps"] = np.array(seen)
        out["ambient_after_steps"] = np.array([active_seq_mesh() is None,
                                               active_expert_mesh() is None])
        moe = unwrap(t.model).moe_aux
        if moe is not None:
            out.update({f"moe/{k}": v.numpy() for k, v in moe.items()})
        if name == "vit_sp2_ep2":   # the Trainer checks the config against the mesh
            for bad in ({"seq_parallel": 4}, {"moe_experts": 3}, {"fsdp": True}):
                key = next(iter(bad))
                try:
                    ttrainer.Trainer(ModelVIT, port_config(family, **{**fields, **bad}),
                                     max_epochs=1, mesh=mesh, fsdp=key == "fsdp",
                                     device="cpu").init_state(params)
                    out[f"refused/{key}"] = np.array("")
                except (ValueError, NotImplementedError) as e:
                    out[f"refused/{key}"] = np.array(str(e))
        np.savez(tmp / f"{name}_{rank}.npz", **out)


def _fit_worker(rank: int, world: int, tmp: Path) -> None:
    """Trainer.fit of each FIT_CASES case over its mesh from one seed, with
    its checkpoints (rank 0 writes them)."""
    from cross_attention_vit_tpu_torch.train.checkpoint import LatestCheckpointer

    for name, (_, axes) in FIT_CASES.items():
        _clear_ambient()
        t = fit_trainer(name, _mesh(axes))
        t.latest = LatestCheckpointer(tmp / name / "latest")
        hist = t.fit(*fit_loaders(), verbose=False)
        (tmp / f"{name}_{rank}.json").write_text(json.dumps(history_rows(hist)))


def _split_worker(rank: int, world: int, tmp: Path) -> None:
    """Each TP_CASES, PP_CASES and COMPOSED_CASES case of this world (those
    in ``tmp/cases``) over its mesh from the JAX-initialised parameters
    (``split_steps``), resuming step 1 from the one-process state after step
    0, and the layout this rank holds: each parameter's local shape and,
    for an FSDP shard, its placement's dim (``local/fsdp:<name>``), and the
    number of modules FSDP gathers as one unit (``fsdp_units``)."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from cross_attention_vit_tpu_torch.models.convert import params_from_flat
    from cross_attention_vit_tpu_torch.parallel import unwrap
    from cross_attention_vit_tpu_torch.train.checkpoint import restore_flat

    wanted = set((tmp / "cases").read_text().split())
    for name, (family, fields, axes, w, *fsdp) in {**TP_CASES, **PP_CASES,
                                                   **COMPOSED_CASES}.items():
        if w != world or name not in wanted:
            continue
        _clear_ambient()
        mesh = _mesh(axes)
        params = params_from_flat(restore_flat(tmp / f"init_{name}.npz"))
        t = port_trainer(family, fields, mesh, params, fsdp=bool(fsdp and fsdp[0]))
        out = split_steps(t, family, mesh, tmp / f"one_ckpt_{name}.npz")
        out["fsdp_units"] = np.array(sum(isinstance(m, FSDPModule) for m in t.model.modules()))
        for n, p in unwrap(t.model).named_parameters():
            local = p.to_local() if isinstance(p, DTensor) else p
            out[f"local/{n}"] = np.array(local.shape)
            if isinstance(p, DTensor):
                out[f"local/fsdp:{n}"] = np.array(p.placements[0].dim)
        np.savez(tmp / f"{name}_{rank}.npz", **out)


def serve_config(**fields):
    return port_config("cross", **fields)


def serve_volumes(n: int, seed: int = 7) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(n, 2, 1, 16, 16, 8)) * 2).astype(np.float32)


def _serve_worker(rank: int, world: int, tmp: Path) -> None:
    """``InferenceServer(mesh=)`` over SERVE_MESHES[world] on the float and
    the int8+attn checkpoints the test wrote: rank 0 answers requests of 3
    and 8 volumes (one over HTTP) and stops; the others run ``run_worker``.
    At world 2 also a stop with a batch in flight, at world 4 the bucket
    check against the data axis."""
    import urllib.request

    from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer, serve

    mesh = _mesh(SERVE_MESHES[world])
    out = {}
    for name, quantize in (("float", None), ("int8+attn", "int8+attn")):
        server = InferenceServer(tmp / name / "ckpt.npz", "cross", buckets=SERVE_BUCKETS,
                                 max_wait_ms=1.0, quantize=quantize, mesh=mesh, device="cpu")
        out[f"{name}/local_qkv"] = np.array(
            server.model.transformer[0].blocks[0][0].attn.fn.to_qkv.weight_q.shape
            if quantize else server.model.transformer[0].blocks[0][0].attn.fn.to_qkv.weight.shape)
        if rank != 0:
            server.run_worker()
            continue
        httpd = serve(server, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            out[f"{name}/3"] = server.predict(serve_volumes(3))
            buf = io.BytesIO()
            np.save(buf, serve_volumes(8, seed=8))
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                                         data=buf.getvalue(), method="POST")
            out[f"{name}/8"] = np.array(json.load(urllib.request.urlopen(req))["logits"])
            out[f"{name}/health_mesh"] = np.array(json.dumps(server.health()["mesh"]))
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.stop()
    if world == 2:
        out.update(_stop_in_flight(rank, mesh, tmp / "float" / "ckpt.npz"))
    if world == 4:
        try:
            InferenceServer(tmp / "float" / "ckpt.npz", "cross", buckets=(1, 2), mesh=mesh,
                            device="cpu")
            out["bucket_error"] = np.array("")
        except ValueError as e:
            out["bucket_error"] = np.array(str(e))
    np.savez(tmp / f"serve_w{world}_{rank}.npz", **out)


def _stop_in_flight(rank: int, mesh, ckpt: Path) -> dict:
    """``stop()`` on rank 0 while a batch of 3 volumes is in its sharded
    forward and a request of 2 waits behind it: the batch is answered, the
    waiting request fails with "server stopped", the dispatcher has left its
    loop and the other ranks' ``run_worker`` returns."""
    from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer

    server = InferenceServer(ckpt, "cross", buckets=SERVE_BUCKETS, max_wait_ms=1.0, mesh=mesh,
                             device="cpu")
    if rank != 0:
        server.run_worker()
        return {}
    entered, forward, answers = threading.Event(), server._sharded_forward, {}

    def held(batch):                # runs once stop() has been called
        entered.set()
        server._stop.wait(WORKER_TIMEOUT_S)
        time.sleep(0.2)
        return forward(batch)

    def ask(name, n):
        try:
            answers[name] = server.predict(serve_volumes(n))
        except RuntimeError as e:
            answers[name] = np.array(str(e))

    server._sharded_forward = held
    server.start()
    first = threading.Thread(target=ask, args=("inflight/3", 3))
    first.start()
    assert entered.wait(WORKER_TIMEOUT_S)
    second = threading.Thread(target=ask, args=("inflight/queued_error", 2))
    second.start()
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    while server._queue.qsize() == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    server.stop()
    first.join(WORKER_TIMEOUT_S)
    second.join(WORKER_TIMEOUT_S)
    return {**answers, "inflight/dispatcher_alive": np.array(server._dispatcher.is_alive())}


# -- workers: the CLI ---------------------------------------------------------------------

CLI_MODS = ("DWI", "SWI", "ASL")
TINY_CLI = {"hidden_dim": 16, "mlp_dim": 32, "num_heads": 2, "num_multi_blocks": 1,
            "num_self_blocks": 1, "num_layers": 1, "img_size": (16, 16, 8),
            "patch_size": (8, 8, 8), "img_aug": False, "dropout": 0.0}


def write_cohort(root: Path) -> None:
    """20 subjects on disk as NIfTI (the cohort of tests/test_torch_drivers.py)."""
    from cross_attention_vit_tpu_torch.data.nifti import write_volume

    r = np.random.default_rng(0)
    rows = []
    for i in range(1, 21):
        rows.append(f"UCSF-PDGM-{i},{'positive' if r.random() < 0.4 else 'negative'}")
        case = f"UCSF-PDGM-{i:04d}"
        (root / "data" / f"{case}_nifti").mkdir(parents=True)
        for m in CLI_MODS:
            write_volume(root / "data" / f"{case}_nifti" / f"{case}_{m}.nii.gz",
                         r.integers(0, 900, size=(18, 16, 9)).astype(np.int16), scl_slope=1.0)
    (root / "labels.csv").write_text("ID,MGMT status\n" + "\n".join(rows) + "\n")


CLI_PP = ("--set", "num_layers=2", "--set", "pipeline_microbatches=1")


def cli_args(root: Path, out: str, *extra: str) -> list[str]:
    return ["--model", "cross", "--grid-index", "0", "--seeds", "2004", "--batch-size", "4",
            "--epochs", "1", "--only-available", "--labels", str(root / "labels.csv"),
            "--data", str(root / "data"), "--out", str(root / out),
            *[a for k, v in TINY_CLI.items() for a in ("--set", f"{k}={v!r}")], *extra]


def _cli_worker(rank: int, world: int, tmp: Path, address: str) -> None:
    """``experiments.main`` over two processes with ``--ep 2 --set
    moe_experts=4``, then with ``--sp 2``."""
    from cross_attention_vit_tpu_torch.drivers import experiments as texp

    group = ["--coordinator", address, "--num-processes", str(world),
             "--process-id", str(rank), "--dist-timeout", str(WORKER_TIMEOUT_S)]
    hist = {"ep": texp.main(cli_args(tmp, "ep", "--ep", "2", "--set", "moe_experts=4", *group),
                            device="cpu"),
            "sp": texp.main(cli_args(tmp, "sp", "--sp", "2", *group), device="cpu")}
    (tmp / f"cli_{rank}.json").write_text(json.dumps(
        {k: {run: history_rows(h) for run, h in res.items()} for k, res in hist.items()}))


def _cli_split_worker(rank: int, world: int, tmp: Path, address: str) -> None:
    """``experiments.main`` over two processes with ``--tp 2`` (ModelCross)
    and ``--pp 2 --model vit``, then ``evaluate.main --mesh data=1,model=2``
    on the --tp run's checkpoint."""
    from cross_attention_vit_tpu_torch.drivers import evaluate as teval
    from cross_attention_vit_tpu_torch.drivers import experiments as texp

    group = ["--coordinator", address, "--num-processes", str(world),
             "--process-id", str(rank), "--dist-timeout", str(WORKER_TIMEOUT_S)]
    # one microbatch: the epoch's last batches are ragged (1 to 4 rows)
    vit = cli_args(tmp, "pp", "--pp", "2", *CLI_PP, *group)
    vit[vit.index("--model") + 1] = "vit"
    hist = {"tp": texp.main(cli_args(tmp, "tp", "--tp", "2", *group), device="cpu"),
            "pp": texp.main(vit, device="cpu")}
    ckpt = next((tmp / "tp" / "checkpoints" / "cross").glob("epoch=*.npz"))
    metrics = teval.main(["--checkpoint", str(ckpt), "--model", "cross", "--labels",
                          str(tmp / "labels.csv"), "--data", str(tmp / "data"),
                          "--only-available", "--batch-size", "4", "--mesh", "data=1,model=2"],
                         device="cpu")
    (tmp / f"cli_split_{rank}.json").write_text(json.dumps(
        {"hist": {k: {run: history_rows(h) for run, h in res.items()} for k, res in hist.items()},
         "evaluate": metrics}))


# -- workers: the composed Trainer.fit and the expert-split server ---------------------

def composed_fit_trainer(root: Path, init: Path, mesh=None, max_epochs: int = 2):
    """The COMPOSED_FIT Trainer (FSDP over ``mesh``, grad_accum 2) from the
    JAX param tree in ``init``, with its rolling checkpoints under ``root``."""
    from cross_attention_vit_tpu_torch.models.convert import params_from_flat
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
    from cross_attention_vit_tpu_torch.train.checkpoint import LatestCheckpointer, restore_flat
    from cross_attention_vit_tpu_torch.train.trainer import Trainer

    t = Trainer(ModelCross, port_config("cross", **COMPOSED_FIT), max_epochs=max_epochs,
                seed=3, mesh=mesh, fsdp=mesh is not None, grad_accum=2,
                latest=LatestCheckpointer(root / "latest", keep=4), device="cpu")
    return t.init_state(params_from_flat(restore_flat(init)))


def composed_fit_loaders(per_coordinate: int):
    from cross_attention_vit_tpu_torch.data.loader import PrefetchLoader

    ds = Data(n=8)
    return (PrefetchLoader(ds, batch_size=per_coordinate, device="cpu"),
            PrefetchLoader(ds, batch_size=per_coordinate, device="cpu"))


def _composed_fit_worker(rank: int, world: int, tmp: Path) -> None:
    """Two epochs of ``Trainer.fit`` over (data 2 x model 2) with FSDP and
    grad_accum 2 (rank 0 writes the checkpoints); ``experiments.main --tp 2
    --fsdp`` over the same four processes; then the server over
    (data 1 x expert 2 x model 2) on the MoE checkpoint the test wrote:
    rank 0 answers 3 and 4 volumes, the others run ``run_worker``."""
    from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer

    from cross_attention_vit_tpu_torch.drivers import experiments as texp

    _clear_ambient()
    t = composed_fit_trainer(tmp / f"fit{rank}", tmp / "fit_init.npz", _mesh(COMPOSED_FIT_AXES))
    hist = t.fit(*composed_fit_loaders(GLOBAL_BATCH // 2), verbose=False)
    (tmp / f"composed_fit_{rank}.json").write_text(json.dumps(history_rows(hist)))
    # the CLI over the same group: --tp 2 --fsdp, at an MLP width FSDP shards
    _clear_ambient()
    cli = texp.main(cli_args(tmp, "cli_tp_fsdp", "--tp", "2", "--fsdp", *COMPOSED_CLI),
                    device="cpu")
    (tmp / f"composed_cli_{rank}.json").write_text(json.dumps(
        {run: history_rows(h) for run, h in cli.items()}))

    server = InferenceServer(tmp / "serve_moe" / "ckpt.npz", "cross", buckets=(2, 4),
                             max_wait_ms=1.0, mesh=_mesh(SERVE_EP_AXES), device="cpu")
    site = server.model.transformer[0].blocks[0][0]
    out = {"local/experts": np.array(site.ffn.fn.experts["fc1"].weight.shape),
           "local/router": np.array(site.ffn.fn.router.weight.shape),
           "local/qkv": np.array(site.attn.fn.to_qkv.weight.shape)}
    if rank == 0:
        server.start()
        try:
            out["3"] = server.predict(serve_volumes(3))
            out["4"] = server.predict(serve_volumes(4, seed=8))
            out["health_mesh"] = np.array(json.dumps(server.health()["mesh"]))
        finally:
            server.stop()
    else:
        server.run_worker()
    np.savez(tmp / f"serve_ep_{rank}.npz", **out)


# -- workers: the stateful ViT3D over a data axis ---------------------------------------

def bn_config(**fields):
    from cross_attention_vit_tpu_torch.configs import get_mgmt_config, modify_config

    cfg = get_mgmt_config()
    modify_config(cfg, {**BN_TINY, **fields})
    return cfg


def bn_batches() -> list[tuple[np.ndarray, np.ndarray]]:
    """The global batches of 8 volumes, made from a seed."""
    rng = np.random.default_rng(13)
    out = []
    for _ in range(STEPS):
        labels = rng.integers(0, 2, size=GLOBAL_BATCH).astype(np.int64)
        imgs = (rng.normal(size=(GLOBAL_BATCH, 2, 1, 32, 32, 16)) * 4
                + labels[:, None, None, None, None, None]).astype(np.float32)
        out.append((imgs, labels))
    return out


def bn_trainer(params: dict, state: dict, mesh=None, fsdp: bool = False, **fields):
    from cross_attention_vit_tpu_torch.models.vit3d import ViT3D
    from cross_attention_vit_tpu_torch.train.trainer import Trainer

    return Trainer(ViT3D, bn_config(**fields), max_epochs=1, stateful=True, schedule="plateau",
                   mesh=mesh, fsdp=fsdp, device="cpu").init_state(params, state)


def bn_init(path: Path) -> tuple[dict, dict]:
    """The JAX param and state trees a test wrote with ``save_pytree``."""
    from cross_attention_vit_tpu_torch.train.checkpoint import restore_flat, unflatten

    flat = restore_flat(path)
    return tuple(unflatten({k[len(which) + 1:]: v for k, v in flat.items()
                            if k.startswith(which + "/")}) for which in ("params", "state"))


def bn_steps(t, mesh=None) -> dict:
    """STEPS stateful train steps on the global batches (this data
    coordinate's rows over ``mesh``): loss, probs, the first step's whole
    gradients, the parameters and the running statistics after each step;
    then one eval step and the checkpoint state."""
    from cross_attention_vit_tpu_torch.parallel import shard_batch
    from cross_attention_vit_tpu_torch.train import trainer as ttrainer
    from cross_attention_vit_tpu_torch.train.checkpoint import flatten

    def rows(batch):
        return tuple(torch.from_numpy(x) for x in
                     (batch if mesh is None else shard_batch(batch, mesh)))

    out = {}
    for s, batch in enumerate(bn_batches()):
        aux = t.train_step(*rows(batch), LR, ttrainer._step_generator(0, 0, s, t.shard))
        out[f"loss/{s}"], out[f"probs/{s}"] = aux["loss"].numpy(), aux["probs"].numpy()
        if s == 0:
            out.update({f"grad/{n}": g for n, g in whole_grads(t.model).items()})
        out.update({f"params{s}/{k}": v for k, v in flatten(t.params).items()})
        out.update({f"state{s}/{k}": v for k, v in flatten(t.model_state).items()})
    aux = t.eval_step(*rows(bn_batches()[0]))
    out["eval/probs"], out["eval/loss"] = aux["probs"].numpy(), aux["loss"].numpy()
    out.update({f"ckpt/{k}": v for k, v in t._ckpt_state(0).items()})
    return out


def _sync_bn_worker(rank: int, world: int, tmp: Path) -> None:
    """``bn_steps`` of the stateful ViT3D over (data = world) from the
    weights and BatchNorm state the test wrote."""
    params, state = bn_init(tmp / "bn_init.npz")
    mesh = _mesh({"data": world})
    t = bn_trainer(params, state, mesh)
    out = bn_steps(t, mesh)
    out["sync_groups"] = np.array(sum(getattr(m, "sync_group", None) is not None
                                      for m in t.model.modules()))
    np.savez(tmp / f"sync_bn_{rank}.npz", **out)


def _tp_vit3d_worker(rank: int, world: int, tmp: Path) -> None:
    """``bn_steps`` of each BN_TP_CASES case of this world over its mesh from
    the weights and BatchNorm state the test wrote (``bn_init_<name>.npz``),
    with the layout this rank holds (``local/<name>``: each parameter's
    local shape; ``local/fsdp:<name>``: an FSDP shard's dim) and the
    BatchNorms' sync groups."""
    from torch.distributed.tensor import DTensor

    from cross_attention_vit_tpu_torch.parallel import unwrap

    for name, (fields, axes, w, fsdp) in BN_TP_CASES.items():
        if w != world:
            continue
        mesh = _mesh(axes)
        t = bn_trainer(*bn_init(tmp / f"bn_init_{name}.npz"), mesh, fsdp, **fields)
        out = bn_steps(t, mesh)
        model = unwrap(t.model)
        out["sync_groups"] = np.array(sum(getattr(m, "sync_group", None) is not None
                                          for m in model.modules()))
        for n, p in model.named_parameters():
            local = p.to_local() if isinstance(p, DTensor) else p
            out[f"local/{n}"] = np.array(local.shape)
            if isinstance(p, DTensor):
                out[f"local/fsdp:{n}"] = np.array(p.placements[0].dim)
        if not fsdp:
            out.update(_model_line_mean(t, mesh, rank))
        np.savez(tmp / f"tp_vit3d_{name}_{rank}.npz", **out)


def _model_line_mean(t, mesh, rank: int) -> dict:
    """``sync_replicated_grads`` on gradients set to 1 + this rank's
    coordinate on the 'model' line: what no region splits (a stem conv)
    gets the line's mean, a split slice (linear1's) keeps its own."""
    from cross_attention_vit_tpu_torch.parallel import axis_index, sync_replicated_grads, unwrap

    model = unwrap(t.model)
    for p in model.parameters():
        p.grad = torch.full_like(p, 1.0 + axis_index(mesh, "model"))
    sync_replicated_grads(t.model, mesh)
    return {"local/line_mean:replicated": model.encoder.conv1.weight.grad.numpy().copy(),
            "local/line_mean:split": model.transformer.layers[0].linear1.weight.grad.numpy().copy()}


def _serve_cli_worker(rank: int, world: int, tmp: Path, address: str) -> None:
    """``drivers.serve.main`` with the arguments the test wrote
    (``serve_cli_argv.json``), under torchrun's environment for this rank
    (coordinator ``address``): rank 0 serves HTTP until SIGINT, the others
    run the server's worker loop until rank 0 stops."""
    from cross_attention_vit_tpu_torch.drivers import serve as tserve

    host, port = address.rsplit(":", 1)
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(world))
    tserve.main(json.loads((tmp / "serve_cli_argv.json").read_text()))


def _ping_worker(rank: int, world: int, tmp: Path) -> None:
    """One all-reduce of (rank + 1) over the world: the harness's own test
    (``tests/test_torch_mesh_harness.py``)."""
    t = torch.full((4,), float(rank + 1))
    torch.distributed.all_reduce(t)
    np.savez(tmp / f"ping_{rank}.npz", sum=t.numpy())


def _stall_worker(rank: int, world: int, tmp: Path) -> None:
    """Rank 0 exits with code 3 when ``tmp/fail`` exists; every other rank
    (and rank 0 without it) sleeps far past any deadline: the harness's own
    test of ``wait_world``."""
    if rank == 0 and (tmp / "fail").exists():
        leave(3)
    time.sleep(3600)


WORKERS = {"ping": _ping_worker, "stall": _stall_worker, "moe": _moe_worker, "ring": _ring_worker, "models": _model_worker,
           "fit": _fit_worker, "split": _split_worker, "serve": _serve_worker,
           "composed_fit": _composed_fit_worker, "sync_bn": _sync_bn_worker,
           "tp_vit3d": _tp_vit3d_worker}
# the modes whose CLI joins the group itself: (rank, world, tmp, address)
CLI_WORKERS = {"cli": _cli_worker, "cli_split": _cli_split_worker,
               "serve_cli": _serve_cli_worker}


if __name__ == "__main__":
    torch.set_num_threads(1)
    from cross_attention_vit_tpu_torch.parallel import multihost_init

    _mode, _address, _rank, _world, _tmp = sys.argv[1:6]
    t0 = time.perf_counter()
    if _mode in CLI_WORKERS:                   # the CLI joins the group itself
        CLI_WORKERS[_mode](int(_rank), int(_world), Path(_tmp), _address)
    else:
        multihost_init(_address, int(_world), int(_rank), device="cpu",
                       timeout_s=WORKER_TIMEOUT_S)
        WORKERS[_mode](int(_rank), int(_world), Path(_tmp))
    torch.distributed.destroy_process_group()
    print(f"rank {_rank} {_mode}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    leave()
