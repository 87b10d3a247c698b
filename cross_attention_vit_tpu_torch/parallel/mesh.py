"""Process-group bootstrap and the device mesh — port of
``cross_attention_vit_tpu/parallel/mesh.py``.

The reference trains with Lightning DDP, ``Trainer(devices=4, num_nodes=2)``
(main_mist.py:216-217).  The JAX package replaces it with a ``Mesh`` over
the devices of every process, its axes in the order ('pipe', 'data',
'expert', 'seq', 'model'); the port goes back to the torch idiom: one
process per GPU, joined by a ``torch.distributed`` process group (NCCL
between cards, gloo on the CPU), and a ``DeviceMesh`` over that group with
the JAX axes in JAX's order: 'pipe' (``parallel/pipeline.py``), 'data',
'expert' (``parallel/moe.py``), 'seq' (``parallel/ring.py``) and 'model'
(``parallel/tensor.py``), each where it is larger than 1 ('data' always).  A JAX process
owning several chips has no counterpart: one torch process drives one
device, so the mesh holds the world.  Ranks that share a data coordinate
hold the same batch rows; the 'expert', 'seq' and 'model' axes split the
work of one layer among them (``parallel/tensor.py`` for 'model') and the
'pipe' axis the layers (``parallel/pipeline.py``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve_device

# Seconds a collective (and the rendezvous) may wait for a peer.  torch's
# default is 30 minutes, long enough for a dead peer to eat a test suite's
# time limit; this one still covers the first step's kernel builds.
DEFAULT_TIMEOUT_S = 600.0


def rank() -> int:
    """This process's rank (``jax.process_index()``); 0 without a group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes (``jax.process_count()``); 1 without a group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def multihost_init(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, *, backend: str | None = None,
                   device: str | torch.device = "cuda",
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group: one process per device.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there, as
    JAX's coordinator) or a ``file://`` path every process can reach (a
    FileStore rendezvous: no port to pick, for processes of one host).
    Arguments left None come from torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator ``host:port``), ``WORLD_SIZE`` and
    ``RANK``.  The backend is NCCL for a CUDA ``device`` and gloo for the CPU;
    an explicit ``backend`` (gloo on CUDA, say) is taken as given.  On CUDA
    the process's card is ``LOCAL_RANK`` (else the process id modulo the
    cards on the host) unless ``device`` names one.  Does nothing when a
    group is already up, as the JAX function is safe to call twice."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    missing = [name for name, value in (("coordinator_address", coordinator_address),
                                        ("num_processes", num_processes),
                                        ("process_id", process_id)) if value is None]
    if missing:
        raise ValueError(f"multihost_init needs {', '.join(missing)}: pass them, or launch "
                         "under torchrun (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = dev.index if dev.index is not None else int(
            env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    init_method = (coordinator_address if coordinator_address.startswith("file://")
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(data: int = -1, model: int = 1, pipe: int = 1, seq: int = 1, expert: int = 1,
              devices: str | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` over the process group with the axes ('pipe', 'data',
    'expert', 'seq', 'model') in JAX's order, each left out where it is 1
    ('data' always kept).

    ``data`` = -1 means the world size over model × pipe × seq × expert; the
    axes' product must be the world size.  Ranks are laid out row-major, so
    the 'model' ranks of one data coordinate are adjacent (JAX's "model
    innermost") and the 'pipe' stages are the outermost blocks of ranks.
    ``devices`` is the mesh's device type: 'cuda' under NCCL and 'cpu'
    otherwise by default.  FSDP places its shards on that type, so a gloo
    group on CUDA runs DDP only.  That ``model`` divides the heads and the
    MLP width is the model's to check (``parallel.shard_params``)."""
    sizes = {"pipe": pipe, "data": data, "expert": expert, "seq": seq, "model": model}
    bad = {k: v for k, v in sizes.items() if k != "data" and v < 1}
    if bad:
        raise ValueError(f"mesh axes must be positive, got {bad}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process group: call "
                           "parallel.multihost_init first, or launch under torchrun")
    n = dist.get_world_size()
    inner = model * pipe * seq * expert
    shape = f"pipe={pipe} x data={data} x expert={expert} x seq={seq} x model={model}"
    if data == -1:
        if n % inner:
            raise ValueError(f"world size {n} is not divisible by model={model} * "
                             f"pipe={pipe} * seq={seq} * expert={expert}")
        sizes["data"] = data = n // inner
    if data < 1 or data * inner != n:
        raise ValueError(f"mesh {shape} needs {data * inner} processes (one device each), "
                         f"have world size {n}")
    names = tuple(a for a in sizes if a == "data" or sizes[a] > 1)
    device_type = devices or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, tuple(sizes[a] for a in names), mesh_dim_names=names)


def axis_size(mesh: DeviceMesh | None, name: str) -> int:
    """The size of the mesh's axis ``name``; 1 without a mesh or the axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh: DeviceMesh | None, name: str) -> int:
    """This rank's coordinate on the axis ``name`` (``lax.axis_index``); 0
    without a mesh or the axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh: DeviceMesh | None, name: str):
    """The process group of this rank's line along the axis ``name``, None
    without a mesh or the axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(name)


def axis_mesh(mesh: DeviceMesh, name: str) -> DeviceMesh:
    """The one-dimensional mesh of this rank's line along the axis ``name``."""
    return mesh if mesh.mesh_dim_names == (name,) else mesh[name]


def axis_ranks(mesh: DeviceMesh, name: str) -> list[int]:
    """The global ranks of this rank's line along the axis ``name``, in
    coordinate order (this rank alone without the axis)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return [rank()]
    coord = list(mesh.get_coordinate())
    dim = mesh.mesh_dim_names.index(name)
    index = tuple(slice(None) if i == dim else c for i, c in enumerate(coord))
    return [int(r) for r in mesh.mesh[index].reshape(-1).tolist()]
