"""Train and eval steps and the epoch ``Trainer`` — port of
``cross_attention_vit_tpu/train/trainer.py``.

The steps take either live family, ``ModelCross`` or ``ModelVIT``: both are
called as ``model(img, labels, train=..., generator=...)`` and return
(logits, loss).  One train step: move the batch to the device; when
``config.img_aug``, cast it once to ``config.augment_dtype`` and augment it
there; hand the result to the model as it is (each model casts its input to
its activation dtype at entry); the model's forward and backward in train
mode (dropout), over ``grad_accum`` equal microbatches whose f32 gradients
are summed and divided by their number; Adam at a step-time learning rate.
It returns the aux dict of the JAX step: loss, confusion counts, probs[:, 1]
and labels.  Over a mesh (``mesh=``, the model from
``parallel.shard_params``) each data coordinate steps on its own rows of
the global batch and the aux dict comes back global and the same on every
rank, as JAX's ``_replicate_aux`` makes it: the loss is the global mean, the
counts are summed and probs and labels are gathered in data order.  The
ranks of one data coordinate (its 'expert', 'seq', 'model' and 'pipe'
lines) step on the same rows with the same generator, so their
augmentation and dropout agree and the work the MoE FFN (``moe_experts``),
the ring attention (``seq_parallel``), the Megatron split and the pipeline
split among them sees one batch.  The models find the
mesh of that split where JAX's do, in the ambient expert and seq meshes
(``parallel.moe``, ``parallel.ring``); a step over a mesh sets them while
it runs and puts back what was there before, so nothing of one Trainer's
mesh is left for a later model in the process.

The model, the optimizer state and the generators are objects that the step
updates in place, where the JAX step is a pure function of (params,
opt_state, rng).  ``config.remat`` and ``remat_policy`` are the models' own
(``ops/remat.py``): each self-block or trunk layer recomputes its
activations in the backward, keeping what the policy names, with the same
values, masks and generator state as without.

``Trainer`` is the epoch loop of the reference's Lightning trainer: the
weighted sampler's order (or a seeded permutation) per epoch, cosine or
plateau learning rate per epoch, epoch metrics logged to CSV and
TensorBoard, top-k and rolling checkpoints in the JAX npz layout
(``params/...``, ``opt/step``, ``opt/mu/...``, ``opt/nu/...``, ``epoch``, and
the plateau and early-stopping state), resume from the rolling checkpoint,
early stopping, ``test`` and ``predict``.  With a mesh
(``parallel.make_mesh``, one process per device) it trains data-parallel
under DDP or, with ``fsdp=True``, FSDP, over the mesh's data axis: each data
coordinate reads its ``host_shard`` of each epoch's indices (or its own
sampler draw), every rank computes the same history row, and only rank 0
logs, prints and writes checkpoints.  A mesh with an 'expert' axis splits
the MoE experts over it, one with a 'seq' axis the attention's sequence,
one with a 'model' axis the heads and MLP columns, and one with a 'pipe'
axis ModelVIT's trunk into GPipe stages (``config.pipeline_stages`` > 1;
JAX ``train/trainer.py:338-370``; the steps set the ambient expert, seq and
pipeline meshes the models read, see ``_ambient_meshes``).  Checkpoints
are written whole, in the JAX layout, and split again on load, so they
cross mesh shapes.

``stateful=True`` trains the BatchNorm families (``models.vit3d.ViT3D``;
JAX ``make_stateful_train_step`` / ``make_stateful_eval_step``,
:234-295): the running statistics are the model's buffers, which the train
forward moves in place from the pre-step parameters while the gradients
reach the parameters only, and which the eval forward reads.  The
checkpoint carries them as ``model_state/...`` in JAX's state layout beside
the plateau state, and resume restores them.  ``grad_accum`` > 1 is refused
for them, as in JAX.  Over a mesh their BatchNorm layers normalise over the
global batch, as JAX's do (SyncBatchNorm semantics, ``ops.conv.batch_norm3d``):
the running statistics then move alike on every rank, stay replicated and
are written whole.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..configs import Config
from ..data.augment import AugmentConfig, augment_batch
from ..models.convert import (jax_params_from_model, jax_params_from_state_dict,
                              jax_state_from_model, load_jax_params, params_from_flat,
                              state_dict_from_jax)
from ..parallel.mesh import axis_index, axis_size
from ..parallel.moe import active_expert_mesh, set_expert_mesh
from ..parallel.pipeline import active_pipeline_mesh, set_pipeline_mesh
from ..parallel.ring import active_seq_mesh, set_seq_mesh
from ..parallel.sharding import (batch_sharding, gather_rows, local_tensors, no_sync,
                                 shard_params, sync_replicated_grads, unwrap, whole_tensors)
from ..utils.device import resolve_device
from ..utils.profiling import span, to_device
from .checkpoint import CheckpointManager, LatestCheckpointer, flatten, unflatten, wait_for_writes
from .loggers import MultiLogger
from .metrics import MetricAccumulator, confusion_counts
from .optim import Adam
from .schedule import ReduceLROnPlateau, cosine_annealing_lr


def _aux(logits: torch.Tensor, loss: torch.Tensor, labels: torch.Tensor, mesh=None) -> dict:
    aux = {"loss": loss.detach(),
           "counts": confusion_counts(torch.argmax(logits, dim=1), labels),
           "probs": torch.softmax(logits.detach(), dim=1)[:, 1],
           "labels": labels}
    return aux if mesh is None else _replicate_aux(aux, mesh)


def _replicate_aux(aux: dict, mesh) -> dict:
    """The global aux dict on every rank, from one all-reduce over the data
    axis: the mean of the data coordinates' losses (their batches are of one
    size), the summed counts and the probs and labels of every coordinate in
    data order (the JAX ``_replicate_aux``, the reference's
    ``sync_dist=True``)."""
    keys = list(aux["counts"])
    b = aux["probs"].shape[0]
    row = torch.cat([aux["loss"].float().reshape(1),
                     torch.stack([aux["counts"][k] for k in keys]).float(),
                     aux["probs"].float(), aux["labels"].float()])
    rows = gather_rows(row[None], mesh)
    k = len(keys)
    counts = rows[:, 1:1 + k].sum(0).to(aux["counts"][keys[0]].dtype)
    return {"loss": rows[:, 0].sum() / rows.shape[0],
            "counts": dict(zip(keys, counts)),
            "probs": rows[:, 1 + k:1 + k + b].reshape(-1).to(aux["probs"].dtype),
            "labels": rows[:, 1 + k + b:].reshape(-1).to(aux["labels"].dtype)}


@contextlib.contextmanager
def _ambient_meshes(config: Config, mesh):
    """While one step runs over ``mesh``: the ambient seq mesh when
    ``config.seq_parallel`` > 1, the expert mesh when ``config.moe_experts``
    > 1 (the MoE routes the global batch over 'data' and splits its experts
    over 'expert') and the pipeline mesh when ``config.pipeline_stages`` > 1,
    the ones before restored after.  The backward needs none of them: the
    ring, the MoE and the pipeline keep their groups in the autograd graph.
    Tensor parallelism needs none: its regions hold their group."""
    if mesh is None:
        yield
        return
    before = active_seq_mesh(), active_expert_mesh(), active_pipeline_mesh()
    if int(config.get("seq_parallel", 0)) > 1:
        set_seq_mesh(mesh)
    if int(config.get("moe_experts", 0)) > 1:
        set_expert_mesh(mesh)
    if int(config.get("pipeline_stages", 0)) > 1:
        set_pipeline_mesh(mesh)
    try:
        yield
    finally:
        set_seq_mesh(before[0])
        set_expert_mesh(before[1])
        set_pipeline_mesh(before[2])


def _dropout_generator(generator: torch.Generator, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(torch.randint(0, 2 ** 62, (), generator=generator)))
    return gen


def make_train_step(model: torch.nn.Module, optimizer: Adam, config: Config,
                    grad_accum: int = 1, augment_cfg: AugmentConfig = AugmentConfig(),
                    accum_impl: str = "scan", mesh=None, zero_unreached: bool = False):
    """Returns ``step(img, labels, lr, generator) -> aux``.

    ``generator`` is a CPU ``torch.Generator``: each step draws from it the
    augmentation's gates and parameters and the seed of one dropout
    generator on the model's device per microbatch, so one seed fixes the
    whole step.  ``grad_accum`` > 1 splits the (augmented) batch into that
    many equal microbatches; their f32 gradients are summed and divided by
    ``grad_accum`` before the one Adam update, the loss is averaged and the
    logits are concatenated (JAX ``make_train_step``, :150-202).
    ``accum_impl`` names the JAX loop form ('scan' or 'unroll') and changes
    nothing here: the microbatches run one after another either way.
    ``augmented`` (a dict attribute of the step) holds, after each step, the
    number of volumes that drew each transform.

    While a profiler records, the step's phases are spans on its clock
    (``utils.profiling.span``): ``step:augment`` (the input's copy to the
    device, its cast to the augmentation's dtype, the augmentation),
    ``step:forward`` and ``step:backward`` once per microbatch (the last
    backward also finishes the gradients), then ``step:optimizer``.

    ``mesh``: the model is ``parallel.shard_params``' (DDP or FSDP) over it;
    ``img`` and ``labels`` are this data coordinate's rows, the gradients
    are averaged across data coordinates (the microbatches before the last
    do not reduce), and the aux dict is replicated (``_replicate_aux``).

    ``zero_unreached``: a parameter the forward never reached gets JAX's
    zero gradient, so Adam's moments and weight decay move it as JAX's do
    (a truncated DenseNet's tail; the stateful step sets it).  ModelCross
    and ModelVIT reach every parameter in each forward, so their steps
    leave it off."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if accum_impl not in ("scan", "unroll"):
        raise ValueError(f"accum_impl must be 'scan' or 'unroll', got {accum_impl!r}")
    if not getattr(unwrap(model), "master_weights", False):
        raise ValueError("training needs float32 master weights: build the model with "
                         "master_weights=True")
    img_aug = bool(config.get("img_aug", False))
    aug_dtype = (torch.bfloat16 if config.get("augment_dtype", "float32") == "bfloat16"
                 else torch.float32)
    params = list(model.parameters())
    device = params[0].device

    def finish_grads():
        """After the last microbatch's backward: JAX's zeros for unreached
        parameters, the hand-averaged gradients, the mean over microbatches."""
        if zero_unreached:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if mesh is not None:
            sync_replicated_grads(model, mesh)
        if grad_accum > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(grad_accum)

    def step(img: torch.Tensor, labels: torch.Tensor, lr: float,
             generator: torch.Generator) -> dict:
        with span("step:augment"):
            img = to_device(img, device)
            labels = to_device(labels, device)
            if img_aug:
                step.augmented.clear()
                img = augment_batch(img.to(aug_dtype), generator, augment_cfg, step.augmented)
        if img.shape[0] % grad_accum:
            raise ValueError(f"batch {img.shape[0]} not divisible by grad_accum {grad_accum}")
        for p in params:
            p.grad = None
        logit_parts, loss_sum = [], 0.0
        for i, (im, lb) in enumerate(zip(img.chunk(grad_accum), labels.chunk(grad_accum))):
            last = i == grad_accum - 1
            with no_sync(model, skip=not last), _ambient_meshes(config, mesh):
                with span("step:forward"):
                    dropout_gen = _dropout_generator(generator, device)
                    logits, loss = model(im, lb, train=True, generator=dropout_gen)
                with span("step:backward"):
                    loss.backward()
                    if last:
                        finish_grads()
            logit_parts.append(logits.detach())
            loss_sum = loss_sum + loss.detach()
        with span("step:optimizer"):
            optimizer.step(lr)
        return _aux(torch.cat(logit_parts), loss_sum / grad_accum, labels, mesh)

    step.augmented = {}
    return step


def make_stateful_train_step(model: torch.nn.Module, optimizer: Adam, config: Config,
                             augment_cfg: AugmentConfig = AugmentConfig(), mesh=None):
    """The BatchNorm families' train step (JAX :234-274): ``make_train_step``
    at one microbatch.  The train-mode forward moves the running statistics
    in place from the pre-step parameters (over ``mesh``, those of the
    global batch); the backward and Adam touch the parameters only, every
    one of them (an unreached one with a zero gradient, as JAX's)."""
    return make_train_step(model, optimizer, config, augment_cfg=augment_cfg, mesh=mesh,
                           zero_unreached=True)


def make_eval_step(model: torch.nn.Module, config: Config, mesh=None):
    """Returns ``step(img, labels) -> aux`` (with the logits), eval mode.
    Over a mesh the aux dict is replicated as the train step's; the logits
    stay this rank's rows."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(img: torch.Tensor, labels: torch.Tensor) -> dict:
        labels = labels.to(device)
        with _ambient_meshes(config, mesh):
            logits, loss = model(img.to(device), labels, train=False)
        return {**_aux(logits, loss, labels, mesh), "logits": logits}

    return step


# the BatchNorm families' eval step reads the running statistics: the eval step
make_stateful_eval_step = make_eval_step


class EarlyStopping:
    """Stop after ``patience`` epochs without improvement on a monitored
    metric (the Lightning callback the reference imports but leaves
    commented out, main_mist.py:36-42): an epoch improves when the metric
    beats the best by more than ``min_delta`` in the ``mode`` direction."""

    def __init__(self, monitor: str = "val_loss", min_delta: float = 0.0, patience: int = 25,
                 mode: str = "min", verbose: bool = False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.verbose = verbose
        self.best = float("inf") if mode == "min" else float("-inf")
        self.num_bad = 0

    def step(self, metric: float) -> bool:
        """Record one epoch's monitored value; returns True → stop now."""
        improved = (metric < self.best - self.min_delta if self.mode == "min"
                    else metric > self.best + self.min_delta)
        if improved:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad >= self.patience:
            if self.verbose:
                print(f"EarlyStopping: {self.monitor} did not improve for "
                      f"{self.patience} epochs (best {self.best:.4f})")
            return True
        return False


def _step_generator(seed: int, epoch: int, step: int, shard: int = 0) -> torch.Generator:
    """The host generator of one train step, fixed by (seed, epoch, step) —
    the JAX ``fold_in(fold_in(key(seed), epoch), step)`` — and, at data
    coordinate d > 0 of a mesh, d folded in too, so data shards draw their
    own augmentation and dropout (coordinate 0 draws what a single device
    does) and the ranks of one coordinate draw alike."""
    entropy = (seed, epoch, step) + ((shard,) if shard else ())
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & (2 ** 63 - 1))


class Trainer:
    """The epoch loop.

    ``model_cls`` is ``ModelCross`` or ``ModelVIT``, or with ``stateful``
    a BatchNorm family (``ViT3D``): ``init_state`` builds it
    with f32 master weights on ``device`` (default CUDA; raises without it),
    from the seed or from a JAX param tree.  schedule: 'cosine'
    (CosineAnnealingLR per epoch, the live contract) or 'plateau'
    (ReduceLROnPlateau on val_loss).  latest_every: rolling-checkpoint
    cadence in epochs.  mesh: a ``parallel.make_mesh`` mesh, one process per
    device — the Trainer-level replacement for Lightning's
    ``devices/num_nodes``; ``batch_size`` of the loaders is per data
    coordinate.  Its 'seq' axis must be ``config.seq_parallel`` when that is
    above 1, and its 'expert' axis must divide ``config.moe_experts``.
    fsdp: shard params and Adam moments over the data axis (needs a mesh);
    data_sharding defaults to ``batch_sharding(mesh, 6)``."""

    def __init__(self, model_cls, config: Config, max_epochs: int, logger=None,
                 checkpoint: CheckpointManager | None = None,
                 latest: LatestCheckpointer | None = None, seed: int = 0, data_sharding=None,
                 log_every_epochs: int = 1, stateful: bool = False, schedule: str = "cosine",
                 latest_every: int = 1, checkpoint_monitor: str = "val_loss", mesh=None,
                 early_stopping: EarlyStopping | None = None, fsdp: bool = False,
                 grad_accum: int = 1, accum_impl: str = "scan",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if fsdp and mesh is None:
            raise ValueError("fsdp=True requires a mesh")
        if grad_accum > 1 and stateful:
            raise ValueError("grad_accum > 1 is not supported for stateful (BatchNorm) models")
        self.stateful = bool(stateful)
        self.model_cls = model_cls
        self.config = config
        self.max_epochs = max_epochs
        self.logger = logger or MultiLogger()
        self.checkpoint = checkpoint
        self.latest = latest
        self.latest_every = max(1, latest_every)
        self.seed = seed
        self.log_every = log_every_epochs
        self.checkpoint_monitor = checkpoint_monitor
        self.early_stopping = early_stopping
        self.grad_accum = grad_accum
        self.accum_impl = accum_impl
        self.mesh = mesh
        self.fsdp = bool(fsdp)
        if mesh is not None and data_sharding is None:
            data_sharding = batch_sharding(mesh, 6)     # (B, M, C, D, H, W)
        self.data_sharding = data_sharding
        self.rank = 0 if mesh is None else torch.distributed.get_rank()
        self.world = 1 if mesh is None else mesh.size()
        # this process's data coordinate and the number of data coordinates
        self.shard, self.shards = axis_index(mesh, "data"), axis_size(mesh, "data")
        seq = int(config.get("seq_parallel", 0))
        if seq > 1 and mesh is not None:
            if axis_size(mesh, "seq") != seq:
                raise ValueError(f"config.seq_parallel={seq} but the mesh's 'seq' axis is "
                                 f"{axis_size(mesh, 'seq')}: build the mesh with "
                                 f"make_mesh(..., seq={seq})")
        experts = int(config.get("moe_experts", 0))
        if experts > 1 and mesh is not None:
            if experts % axis_size(mesh, "expert"):
                raise ValueError(f"moe_experts={experts} is not divisible by the mesh's "
                                 f"'expert' axis {axis_size(mesh, 'expert')}")
        stages = int(config.get("pipeline_stages", 0))
        if mesh is not None and axis_size(mesh, "pipe") > 1 and stages <= 1:
            raise ValueError(f"the mesh's 'pipe' axis is {axis_size(mesh, 'pipe')} but "
                             f"config.pipeline_stages={stages}: set pipeline_stages > 1")
        # FSDP shards and the parts split over 'expert', 'model' or 'pipe'
        # are gathered by every rank
        self.collective_snapshot = self.fsdp or any(
            axis_size(mesh, a) > 1 for a in ("expert", "model", "pipe"))
        if schedule == "cosine":
            op = config.optim_params
            self.lr_fn = cosine_annealing_lr(config.lr, op["T_max"], op["eta_min"])
            self.plateau = None
        elif schedule == "plateau":
            op = config.optim_params
            self.plateau = ReduceLROnPlateau(config.lr, factor=op.get("factor", 0.1),
                                             patience=op.get("patience", 10))
            self.lr_fn = lambda epoch: self.plateau.lr
        else:
            raise ValueError(f"unknown schedule {schedule!r}")
        self.model = None
        self.optimizer = None
        self.global_step = 0

    # -- lifecycle -------------------------------------------------------------
    def init_state(self, params: dict | None = None,
                   model_state: dict | None = None) -> "Trainer":
        """Build the model (from the seed, or from ``params``, a JAX param
        tree of arrays, and for a stateful family ``model_state``, JAX's
        BatchNorm state tree), place it on the mesh
        (``parallel.shard_params``; DDP starts every rank from rank 0's
        parameters) and make a fresh Adam.  ``self.model`` is then what
        runs: the DDP wrapper, or the model."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model = self.model_cls(self.config, device=self.device, generator=gen,
                                    master_weights=True)
        if params is not None:
            load_jax_params(self.model, params, model_state)
        if self.mesh is not None:
            self.model = shard_params(self.model, self.mesh, fsdp=self.fsdp)
        self.optimizer = Adam(self.model.parameters(), weight_decay=self.config.weight_decay)
        if self.stateful:
            self.train_step = make_stateful_train_step(self.model, self.optimizer, self.config,
                                                       mesh=self.mesh)
            self.eval_step = make_stateful_eval_step(self.model, self.config, mesh=self.mesh)
            return self
        self.train_step = make_train_step(self.model, self.optimizer, self.config,
                                          grad_accum=self.grad_accum,
                                          accum_impl=self.accum_impl, mesh=self.mesh)
        self.eval_step = make_eval_step(self.model, self.config, mesh=self.mesh)
        return self

    @property
    def params(self) -> dict:
        """The model's parameters as a JAX param tree of f32 numpy arrays
        (under FSDP a collective)."""
        return jax_params_from_model(self.model)

    @property
    def model_state(self) -> dict | None:
        """A stateful family's running statistics as JAX's state tree of f32
        numpy arrays (None for a stateless model)."""
        return jax_state_from_model(self.model) if self.stateful else None

    def _moment_trees(self) -> tuple[dict, dict]:
        model = unwrap(self.model)
        names = [n for n, _ in model.named_parameters()]
        if self.optimizer.step_count:
            mu, nu = self.optimizer.moments()
        else:   # JAX initialises the moments to zeros
            mu = nu = [torch.zeros(p.shape, device=p.device) for p in self.optimizer.params]
        return tuple(jax_params_from_state_dict(
            {n: t.detach().to("cpu", torch.float32, copy=True).numpy()
             for n, t in whole_tensors(model, dict(zip(names, ms))).items()}, self.config)
            for ms in (mu, nu))

    def _ckpt_state(self, epoch: int) -> dict:
        """The host snapshot of the training state as a flat dict in the JAX
        npz key layout (under FSDP a collective: every rank calls it)."""
        mu, nu = self._moment_trees()
        state = {"params": self.params,
                 "opt": {"step": np.asarray(self.optimizer.step_count, np.int32),
                         "mu": mu, "nu": nu},
                 "epoch": np.asarray(epoch, np.int32)}
        if self.stateful:
            state["model_state"] = self.model_state
        if self.plateau is not None:
            state["plateau"] = {"lr": np.asarray(self.plateau.lr, np.float32),
                                "best": np.asarray(self.plateau.best, np.float32),
                                "num_bad": np.asarray(self.plateau.num_bad, np.int32)}
        if self.early_stopping is not None:
            state["early_stop"] = {"best": np.asarray(self.early_stopping.best, np.float32),
                                   "num_bad": np.asarray(self.early_stopping.num_bad, np.int32)}
        return flatten(state)

    def _host_snapshot(self, epoch: int) -> dict | None:
        """``_ckpt_state`` on rank 0, None elsewhere; under FSDP, or with the
        experts split, every rank takes part in gathering the shards."""
        if self.collective_snapshot or self.rank == 0:
            state = self._ckpt_state(epoch)
            return state if self.rank == 0 else None
        return None

    def maybe_resume(self) -> int:
        """Resume params, Adam state, plateau and early-stopping state from the
        rolling checkpoint; returns the epoch to start at (0 without one).
        Over a mesh every rank reads the file and keeps its own share."""
        if self.latest is None or self.model is None:
            return 0
        step, flat = self.latest.restore_latest()
        if flat is None:
            return 0
        self._load_flat(flat)
        self.global_step = step
        return int(flat["epoch"]) + 1

    def _load_flat(self, flat: dict) -> None:
        model_state = None
        if self.stateful:
            prefix = "model_state/"
            model_state = unflatten({k[len(prefix):]: v for k, v in flat.items()
                                     if k.startswith(prefix)})
        load_jax_params(self.model, params_from_flat(flat), model_state)
        model = unwrap(self.model)
        names = [n for n, _ in model.named_parameters()]
        moments = []
        for which in ("mu", "nu"):
            prefix = f"opt/{which}/"
            tree = unflatten({k[len(prefix):]: v for k, v in flat.items()
                              if k.startswith(prefix)})
            sd = local_tensors(model, state_dict_from_jax(tree, self.config))
            moments.append([sd[n] for n in names])
        self.optimizer.load_state(int(flat["opt/step"]), *moments)
        if self.plateau is not None and "plateau/lr" in flat:
            self.plateau.lr = float(flat["plateau/lr"])
            self.plateau.best = float(flat["plateau/best"])
            self.plateau.num_bad = int(flat["plateau/num_bad"])
        if self.early_stopping is not None and "early_stop/best" in flat:
            self.early_stopping.best = float(flat["early_stop/best"])
            self.early_stopping.num_bad = int(flat["early_stop/num_bad"])

    # -- loops -------------------------------------------------------------------
    def _run_epoch_train(self, loader, indices, lr: float, epoch: int) -> dict:
        acc = MetricAccumulator()
        for imgs, labels in loader(indices):
            aux = self.train_step(imgs, labels, lr,
                                  _step_generator(self.seed, epoch, self.global_step, self.shard))
            self.global_step += 1
            acc.update(aux["loss"], aux["counts"], aux["probs"], aux["labels"])
        return acc.result()

    def _run_epoch_eval(self, loader, indices) -> dict:
        acc = MetricAccumulator()
        for imgs, labels in loader(indices):
            aux = self.eval_step(imgs, labels)
            acc.update(aux["loss"], aux["counts"], aux["probs"], aux["labels"])
        return acc.result()

    def fit(self, train_loader, val_loader, sampler=None, start_epoch: int | None = None,
            verbose: bool = True) -> list[dict]:
        """train_loader/val_loader: PrefetchLoader instances; sampler: an
        optional WeightedRandomSampler (the train index order per epoch).
        Over a mesh every rank calls it; each data coordinate runs its own
        share of the indices (the same number of batches on every rank) and
        every rank returns the same history; rank 0 alone writes."""
        if self.model is None:
            self.init_state()
        if start_epoch is None:
            start_epoch = self.maybe_resume()
        if self.data_sharding is not None:
            for ld in (train_loader, val_loader):
                if getattr(ld, "sharding", None) is None:
                    ld.sharding = self.data_sharding
        n_train = len(train_loader.dataset)
        n_val = len(val_loader.dataset)
        is_main = self.rank == 0
        history = []
        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.time()
            lr = self.lr_fn(epoch)
            if sampler is not None:
                train_idx = sampler.epoch_indices(epoch, host_id=self.shard,
                                                  num_hosts=self.shards)
            else:
                train_idx = host_shard(np.random.default_rng((self.seed, epoch))
                                       .permutation(n_train), self.shard, self.shards)
            val_idx = host_shard(np.arange(n_val), self.shard, self.shards)
            train_m = self._run_epoch_train(train_loader, train_idx, lr, epoch)
            val_m = self._run_epoch_eval(val_loader, val_idx)

            row = {f"train_{_short(k)}": v for k, v in train_m.items()}
            row.update({f"val_{_short(k)}": v for k, v in val_m.items()})
            row["lr"] = lr
            row["epoch_time_s"] = time.time() - t0
            if is_main and (epoch % self.log_every == 0 or epoch == self.max_epochs - 1):
                self.logger.log_metrics(row, epoch)
            history.append(row)

            if self.plateau is not None:
                self.plateau.step(row["val_loss"])
            # the patience counter steps before the snapshot, so a resumed run
            # keeps this epoch's tick
            stop = (self.early_stopping is not None
                    and self.early_stopping.step(row[self.early_stopping.monitor]))
            want_latest = self.latest is not None and (
                epoch % self.latest_every == self.latest_every - 1
                or epoch == self.max_epochs - 1 or stop)
            if self.checkpoint is not None or want_latest:
                state = self._host_snapshot(epoch)   # one snapshot for both writers
                if is_main and self.checkpoint is not None:
                    self.checkpoint.save(epoch, row[self.checkpoint_monitor], state)
                if is_main and want_latest:
                    self.latest.save(self.global_step, state)
            if verbose and is_main:
                print(f"epoch {epoch:3d}  lr {lr:.2e}  train_loss {row['train_loss']:.4f}  "
                      f"val_loss {row['val_loss']:.4f}  val_acc {row['val_acc']:.3f}  "
                      f"({row['epoch_time_s']:.1f}s)")
            if stop:
                break
        self.logger.finalize()
        wait_for_writes()
        if self.mesh is not None:   # no rank goes on before rank 0's files are whole
            torch.distributed.barrier()
        return history

    def test(self, test_loader) -> tuple[np.ndarray, np.ndarray]:
        """Logits and targets over a loader (reference test hooks,
        model_cross.py:294-308), in dataset order.  Over a mesh each data
        coordinate runs its ``host_shard``; the rows are gathered in data
        order and the wrap-around padding trimmed, on every rank."""
        if self.model is None:
            self.init_state()
        n = len(test_loader.dataset)
        logits, targets = [], []
        for imgs, labels in test_loader(host_shard(np.arange(n), self.shard, self.shards)):
            logits.append(self.eval_step(imgs, labels)["logits"].float())
            targets.append(labels.to(self.device))
        logits, targets = torch.cat(logits), torch.cat(targets)
        if self.mesh is not None:
            logits, targets = (gather_rows(t, self.mesh)[:n] for t in (logits, targets))
        return logits.cpu().numpy(), targets.cpu().numpy()

    def predict(self, loader, probabilities: bool = True) -> np.ndarray:
        """Softmax positive-class probabilities (or raw logits) over a loader."""
        logits, _ = self.test(loader)
        if not probabilities:
            return logits
        if logits.ndim == 1:   # single-logit BCE heads
            return 1.0 / (1.0 + np.exp(-logits))
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return (e / e.sum(axis=1, keepdims=True))[:, 1]


def host_shard(indices: np.ndarray, pid: int, nproc: int) -> np.ndarray:
    """This process's contiguous share of an epoch's index order, padded by
    wrap-around so every process yields the same number of batches (the
    torch DistributedSampler convention)."""
    if nproc <= 1:
        return indices
    share = -(-len(indices) // nproc)  # ceil
    return np.resize(indices, share * nproc)[pid * share:(pid + 1) * share]


_SHORT = {"accuracy": "acc", "precision": "prec", "recall": "rec", "specificity": "spec",
          "f1_score": "f1", "npv": "npv", "loss": "loss", "auc_roc": "auc_roc"}


def _short(k: str) -> str:
    return _SHORT.get(k, k)
