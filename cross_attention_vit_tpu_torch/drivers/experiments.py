"""Experiment drivers — the main_mist.py equivalents, port of
``cross_attention_vit_tpu/drivers/experiments.py``.

  * the Params hyperparameter grids (main_mist.py:69-79, same values);
  * ``train_full``: test seeds × {ModelCross, ModelVIT} × grid; a 15% test
    split, then an 18% val split with the same seed (:167, :182); the
    weighted sampler; top-10 val_loss checkpoints with run-tagged file names
    (:174-180); TensorBoard and CSV loggers (:183-184); the config mutated in
    place across grid points through modify_config (:186-188, quirk kept);
  * ``train_cv``: the stratified k-fold variant (:84-149), repaired as in the
    JAX package.

Labels are read without pandas (``data/labels.py``) and split without
sklearn: the row order, and with it the sampler's weights and the loader's
batches, equals the JAX driver's.  Training runs on one device (default
CUDA; ``device="cpu"`` for the tests), or data-parallel with one process per
device, the reference's ``Trainer(devices=4, num_nodes=2)``
(main_mist.py:216-217): launched under torchrun, or with ``--coordinator
host:port --num-processes N --process-id i`` in each process, the CLI joins
the process group and trains over a mesh of every process (``--dp``, -1 by
default; 0 trains each process alone), under DDP or with ``--fsdp`` FSDP.
``--ep E`` splits the MoE experts (``--set moe_experts=...``, a multiple of
E) over an 'expert' axis, ``--sp P`` the attention's sequence over a 'seq'
axis (it sets ``seq_parallel`` = P unless ``--set`` gives it), ``--tp T``
the heads and MLP columns over a 'model' axis and ``--pp S`` ModelVIT's
trunk into S GPipe stages over a 'pipe' axis (it sets ``pipeline_stages`` =
S unless ``--set`` gives it; ``--model vit``); the data axis is then the
world size over E·P·T·S.  ``--batch-size`` is per data coordinate: the
global batch is batch size × data size.

    python -m cross_attention_vit_tpu_torch.drivers.experiments \\
        --model cross --grid-index 0 --seeds 2004 --batch-size 8 --only-available \\
        --labels labels.csv --data ucsf-data --out runs
    torchrun --nproc-per-node 4 -m cross_attention_vit_tpu_torch.drivers.experiments \\
        --model cross --grid-index 0 --seeds 2004 --batch-size 8 --fsdp ...
"""

from __future__ import annotations

import ast
import os
from pathlib import Path

import numpy as np
import torch

from ..configs import Params, get_mgmt_config, get_mgmt_cross_config, modify_config
from ..data.dataset import BrainDataset, WeightedRandomSampler, create_sampler_weights
from ..data.labels import Table, clean_data, load_labels, stratified_kfold, train_test_split
from ..data.loader import PrefetchLoader, transfer_dtype_for
from ..models.model_cross import ModelCross
from ..models.model_vit import ModelVIT
from ..parallel.mesh import DEFAULT_TIMEOUT_S, make_mesh, multihost_init, rank, world_size
from ..train.checkpoint import CheckpointManager, LatestCheckpointer
from ..train.loggers import CSVLogger, MultiLogger, TensorBoardLogger
from ..train.trainer import EarlyStopping, Trainer
from ..utils.device import resolve_device

MODS = ["DWI", "SWI", "T1c", "brain_parenchyma_segmentation",
        "tumor_segmentation", "T2", "ADC", "ASL", "FLAIR"]

# the live grids (reference main_mist.py:69-79)
params_list1 = [
    Params(lr=1e-4, dropout=0.25, attn_order={"0": "1", "1": "2", "2": "0"},
           optim_params={"T_max": 250, "eta_min": 1e-6}, weight_decay=5e-4,
           img_types=(MODS[0], MODS[1], MODS[7]), label_smoothing=0.0, img_aug=True),
    Params(lr=1e-4, dropout=0.2, attn_order={"0": "1", "1": "2"},
           optim_params={"T_max": 250, "eta_min": 1e-6}, weight_decay=5e-4,
           img_types=(MODS[0], MODS[1], MODS[7]), label_smoothing=0.0, img_aug=True),
]

params_list2 = [
    Params(lr=1e-4, dropout=0.1, attn_order={},
           optim_params={"T_max": 150, "eta_min": 1e-6}, weight_decay=5e-4,
           img_types=(MODS[1], MODS[0]), label_smoothing=0.0, img_aug=False),
    Params(lr=1e-4, dropout=0.1, attn_order={},
           optim_params={"T_max": 150, "eta_min": 1e-6}, weight_decay=5e-4,
           img_types=(MODS[1], MODS[0]), label_smoothing=0.0, img_aug=True),
]

_MODELS = [ModelCross, ModelVIT]
_CONFIG_FACTORIES = [get_mgmt_cross_config, get_mgmt_config]


def filter_available(data: Table, folder) -> Table:
    """Keep only subjects whose NIfTI folder exists on disk."""
    return data.take(np.array([(Path(folder) / f"{c}_nifti").is_dir() for c in data["ID"]],
                              dtype=bool))


def _run_one(model_cls, cur_config, params, train_df, val_df, *, folder, out_dir, run_name,
             max_epochs, batch_size, seed, verbose, latest_every=5, grad_accum=1,
             accum_impl="scan", early_stop_patience=0, early_stop_min_delta=0.0,
             mesh=None, fsdp=False, device="cuda"):
    out = Path(out_dir)
    # the config sidecar is rank 0's to write, as every checkpoint
    checkpoint = CheckpointManager(out / "checkpoints" / "cross", monitor="val_loss",
                                   save_top_k=10, mode="min", tag=run_name, async_write=True,
                                   config=cur_config if rank() == 0 else None)
    latest = LatestCheckpointer(out / "latest" / run_name, async_write=True)
    # resume intent == a rolling checkpoint exists for this run name; only
    # then does the CSV logger inherit earlier rows
    resuming = latest.latest_step() is not None
    logger = MultiLogger(TensorBoardLogger(out / "lightning_logs" / "cross", run_name),
                         CSVLogger(out / "csv_logs" / "cross", run_name, resume=resuming))
    sampler = WeightedRandomSampler(create_sampler_weights(train_df, cur_config.target),
                                    num_samples=len(train_df), seed=seed)
    # disk cache: each volume decoded once per cohort, not once per epoch×run
    vol_cache = str(out / "vol_cache")
    train_ds = BrainDataset(train_df, cur_config, types=params.img_types, is_train=True,
                            folder=folder, cache=False, disk_cache=vol_cache)
    val_ds = BrainDataset(val_df, cur_config, types=params.img_types, is_train=False,
                          folder=folder, cache=False, disk_cache=vol_cache)
    td = transfer_dtype_for(cur_config)
    train_loader = PrefetchLoader(train_ds, batch_size=batch_size, num_workers=5,
                                  transfer_dtype=td, device=device)
    val_loader = PrefetchLoader(val_ds, batch_size=batch_size, num_workers=5,
                                transfer_dtype=td, device=device)
    early = None
    if early_stop_patience > 0:
        early = EarlyStopping(monitor="val_loss", patience=early_stop_patience,
                              min_delta=early_stop_min_delta, verbose=verbose)
    trainer = Trainer(model_cls, cur_config, max_epochs=max_epochs, logger=logger,
                      checkpoint=checkpoint, latest=latest, seed=seed,
                      latest_every=latest_every, grad_accum=grad_accum, accum_impl=accum_impl,
                      early_stopping=early, mesh=mesh, fsdp=fsdp, device=device)
    history = trainer.fit(train_loader, val_loader, sampler=sampler, verbose=verbose)
    return trainer, history


def train_full(params_big=None, *, labels_csv="labels.csv", folder="ucsf-data", out_dir="runs",
               run=200, test_seeds=(2004, 4444, 9780, 7564), max_epochs=250, batch_size=8,
               verbose=True, overrides=None, only_available=False, latest_every=5,
               grad_accum=1, accum_impl="scan", early_stop_patience=0,
               early_stop_min_delta=0.0, mesh=None, fsdp=False, device="cuda"):
    """The live driver (reference main_mist.py:156-219); returns
    {run_name: history}.  mesh: a ``parallel.make_mesh`` mesh (every process
    calls this with the same arguments; batch_size is per process); fsdp:
    shard params and Adam moments over it."""
    params_big = params_big or [params_list1, params_list2]
    big_data = clean_data(load_labels(labels_csv), "MGMT status")
    if only_available:
        big_data = filter_available(big_data, folder)
    results = {}
    for r, seed in enumerate(test_seeds):
        data, _test_df = train_test_split(big_data, 0.15, seed)
        for m, (model_cls, factory) in enumerate(zip(_MODELS, _CONFIG_FACTORIES)):
            cur_config = factory()
            for i, params in enumerate(params_big[m]):
                # .18 * .85 ≈ .15 (reference comment, main_mist.py:181)
                train_df, val_df = train_test_split(data, 0.18, seed)
                modify_config(cur_config, params)
                modify_config(cur_config, {"num_modalities": len(params.img_types)})
                if overrides:
                    modify_config(cur_config, overrides)
                run_name = f"test_{run}_{r}_{m}_{i}"
                _, history = _run_one(
                    model_cls, cur_config, params, train_df, val_df, folder=folder,
                    out_dir=out_dir, run_name=run_name, max_epochs=max_epochs,
                    batch_size=batch_size, seed=seed, verbose=verbose,
                    latest_every=latest_every, grad_accum=grad_accum, accum_impl=accum_impl,
                    early_stop_patience=early_stop_patience,
                    early_stop_min_delta=early_stop_min_delta, mesh=mesh, fsdp=fsdp,
                    device=device)
                results[run_name] = history
    return results


def train_cv(params_big=None, *, labels_csv="labels.csv", folder="ucsf-data", out_dir="runs",
             run=145, test_seed=6969, cv_seeds=(6253, 9253), k: int = 5, max_epochs=250,
             batch_size=8, verbose=True, overrides=None, only_available=False, grad_accum=1,
             accum_impl="scan", mesh=None, fsdp=False, device="cuda"):
    """Stratified k-fold variant (reference main_mist.py:84-149, repaired)."""
    params_big = params_big or [params_list1, params_list2]
    big_data = clean_data(load_labels(labels_csv), "MGMT status")
    if only_available:
        big_data = filter_available(big_data, folder)
    data, _test_df = train_test_split(big_data, 0.15, test_seed)
    results = {}
    for r, cv_seed in enumerate(cv_seeds):
        for m, (model_cls, factory) in enumerate(zip(_MODELS, _CONFIG_FACTORIES)):
            cur_config = factory()
            for i, params in enumerate(params_big[m]):
                modify_config(cur_config, params)
                modify_config(cur_config, {"num_modalities": len(params.img_types)})
                if overrides:
                    modify_config(cur_config, overrides)
                folds = stratified_kfold(data[cur_config.target], k, cv_seed)
                for fold, (train_idx, val_idx) in enumerate(folds):
                    run_name = f"{run}_{i}_{fold}_{m}_{r}"
                    _, history = _run_one(
                        model_cls, cur_config, params, data.take(train_idx),
                        data.take(val_idx), folder=folder, out_dir=out_dir,
                        run_name=run_name, max_epochs=max_epochs, batch_size=batch_size,
                        seed=cv_seed, verbose=verbose, grad_accum=grad_accum,
                        accum_impl=accum_impl, mesh=mesh, fsdp=fsdp, device=device)
                    results[run_name] = history
    return results


def _torchrun_env() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def main(argv=None, device: str = "cuda"):
    """The JAX CLI's flags and run names; ``device`` is where the runs train
    (a keyword for in-process callers, not a flag)."""
    import argparse

    p = argparse.ArgumentParser(description="cross_attention_vit_tpu_torch trainer")
    p.add_argument("--mode", choices=["full", "cv"], default="full")
    p.add_argument("--labels", default="/root/reference/labels.csv")
    p.add_argument("--data", default="/root/reference/ucsf-data")
    p.add_argument("--out", default="runs")
    p.add_argument("--epochs", type=int, default=250)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seeds", type=int, nargs="*", default=None,
                   help="test seeds (default: the reference's 4 seeds)")
    p.add_argument("--grid-index", type=int, default=None,
                   help="run only this grid point of each params list")
    p.add_argument("--model", choices=["cross", "vit", "both"], default="both")
    p.add_argument("--only-available", action="store_true",
                   help="drop labels rows whose volumes are not on disk")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel mesh axis: -1 (default) = the process group's world "
                        "size over --ep × --sp (one device without a group), 0 = no mesh")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh axis (must divide num_heads and mlp_dim; "
                        "parallel/tensor.py)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline mesh axis: ModelVIT's trunk in GPipe stages (sets config "
                        "pipeline_stages to match; needs --model vit; parallel/pipeline.py)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel mesh axis: exact ring attention over 'seq' (sets "
                        "config seq_parallel to match; parallel/ring.py)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel mesh axis (pair with --set moe_experts=E, a multiple "
                        "of it: the trunk FFNs become GShard MoEs; parallel/moe.py)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard params + Adam moments over the 'data' axis "
                        "(FSDP; see parallel/sharding.py)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches accumulated per optimizer step "
                        "(batch-size must be divisible by it)")
    p.add_argument("--accum-impl", choices=["scan", "unroll"], default="scan",
                   help="the JAX microbatch loop form; accepted, changes nothing here")
    p.add_argument("--coordinator", default=None,
                   help="process-group rendezvous host:port (torchrun's MASTER_ADDR:"
                        "MASTER_PORT when launched by it)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-timeout", type=float, default=DEFAULT_TIMEOUT_S,
                   help="seconds the rendezvous and each collective wait for a peer")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for the JAX CLI's sake: nothing is compiled ahead")
    p.add_argument("--set", dest="sets", action="append", default=[], metavar="KEY=VALUE",
                   help="config override, e.g. --set compute_dtype=bfloat16 "
                        "(python-literal values)")
    p.add_argument("--latest-every", type=int, default=5,
                   help="rolling resume-checkpoint cadence in epochs")
    p.add_argument("--early-stop-patience", type=int, default=0,
                   help="stop a run after this many epochs without val_loss improvement "
                        "(0 = off)")
    p.add_argument("--early-stop-min-delta", type=float, default=0.0)
    args = p.parse_args(argv)
    resolve_device(device)    # fail before any work on a host without the device
    split = {"ep": args.ep, "sp": args.sp, "tp": args.tp, "pp": args.pp}
    if args.dp == 0 and any(v > 1 for v in split.values()):
        raise SystemExit("--sp/--ep/--tp/--pp require a mesh (don't pass --dp 0)")
    if args.pp > 1 and args.model != "vit":
        raise SystemExit(f"--pp {args.pp} pipelines ModelVIT's trunk: pass --model vit")

    if args.coordinator or args.num_processes or args.process_id is not None \
            or _torchrun_env():
        multihost_init(args.coordinator, args.num_processes, args.process_id, device=device,
                       timeout_s=args.dist_timeout)
    mesh = None
    axes = " ".join(f"--{k} {v}" for k, v in {"dp": args.dp, **split}.items())
    if args.dp != 0 and torch.distributed.is_initialized():
        try:
            mesh = make_mesh(args.dp, model=args.tp, pipe=args.pp, seq=args.sp,
                             expert=args.ep)
        except ValueError as e:
            raise SystemExit(f"{axes}: {e}") from e
    elif args.dp > 0 or any(v > 1 for v in split.values()):
        need = max(args.dp, 1) * args.sp * args.ep * args.tp * args.pp
        raise SystemExit(f"{axes} needs a process group of world size {need}; none is "
                         f"running (world size {world_size()}): launch under torchrun or "
                         "pass --coordinator/--num-processes/--process-id")
    if args.fsdp and mesh is None:
        raise SystemExit("--fsdp requires a mesh (don't pass --dp 0)")

    overrides = {}
    for kv in args.sets:
        key, sep, value = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
        try:
            overrides[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            overrides[key] = value  # bare strings allowed
    if args.sp > 1:
        # the mesh axis is the source of truth; the config knob routes the
        # models' attention through the ring (ops/attention.attention_impl)
        overrides.setdefault("seq_parallel", args.sp)
    if args.pp > 1:
        # the knob routes ModelVIT's trunk through the pipeline
        overrides.setdefault("pipeline_stages", args.pp)

    grids = [list(params_list1), list(params_list2)]
    if args.grid_index is not None:
        grids = [[g[args.grid_index]] for g in grids]
    if args.model != "both":
        keep = 0 if args.model == "cross" else 1
        grids = [g if m == keep else [] for m, g in enumerate(grids)]

    kwargs = dict(labels_csv=args.labels, folder=args.data, out_dir=args.out,
                  max_epochs=args.epochs, batch_size=args.batch_size,
                  only_available=args.only_available, overrides=overrides or None,
                  grad_accum=args.grad_accum, accum_impl=args.accum_impl, mesh=mesh,
                  fsdp=args.fsdp, device=device)
    if args.mode == "full":
        kwargs["latest_every"] = args.latest_every
        kwargs["early_stop_patience"] = args.early_stop_patience
        kwargs["early_stop_min_delta"] = args.early_stop_min_delta
        if args.seeds:
            kwargs["test_seeds"] = tuple(args.seeds)
        return train_full(grids, **kwargs)
    return train_cv(grids, **kwargs)


if __name__ == "__main__":
    main()
