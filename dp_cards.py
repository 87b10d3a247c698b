#!/usr/bin/env python3
"""Data-, expert-, sequence-, tensor- and pipeline-parallel training of the
live ModelCross (and of the 2-stream ModelVIT for the pipeline) across the
cards of one host over NCCL, through the port's ``Trainer`` (one process per
card).

    python3 dp_cards.py [--cards N] [--modes ddp,fsdp,ep,sp,tp,pp,tp_fsdp,...]
        # default: every card of the host, every mode

``chip_smoke.py`` checks DDP and FSDP at world size 1 (NCCL refuses two
ranks on one card); this script runs them where the world has several
cards.  It builds the kernels (``chip_smoke.phase_build``), then on card 0
takes the one-process references: ``TRAIN_STEPS`` steps at batch 8 (its
step ms) and one step of the whole global batch (8 a card) at dropout 0
without augmentation (its gradients).  Then one process per card (this
script with ``--worker``) joins an NCCL group and, under DDP and then FSDP
(``Trainer(mesh=make_mesh(), fsdp=...)``), from the same seeded masters:

- ``TRAIN_STEPS`` steps of 8 volumes a card with augmentation and dropout
  0.25: finite losses, 12 K1 + 12 K2 launches a step, K3 over the run, step
  ms by CUDA events, peak memory; under DDP also steps with and without the
  gradient all-reduce, in turns (its share of the step); under FSDP each
  sharded parameter and its Adam moments hold 1/N of the whole on a rank;
- one step at dropout 0 without augmentation: every gradient within
  ``SERVE_TOL`` of the one-process step's, normalised by its own maximum
  (the cross-attention key biases, zero in exact arithmetic, are reported
  and not gated), and the parameters after it bit for bit equal on every
  rank.

Then the same for two more meshes (``ep`` and ``sp``):

- ``ep``: the MoE ModelCross (``moe_experts = 4``, chip_smoke's phase
  train_moe) over (data 1, expert N): each card holds 4/N of every site's
  experts and all cards step on the same 8 volumes; 12 K1 + 12 K2 launches
  a step; the comparison step against the one-process MoE step at batch 8
  (the split experts gathered);
- ``sp``: the ModelCross with ``seq_parallel = 2`` over (data N/2, seq 2):
  the self-attention runs as the ring across the two cards of a seq line
  (no K1 or K2 launch), 8 volumes a data coordinate; the comparison step
  against the one-process step of the same global batch on the dense plain
  attention (``use_flash_attention=False``), which the ring computes;
- ``tp``: the ModelCross over (data N/2, model 2): each card holds 8 of the
  16 heads and half the MLP columns of every region (12 K1 + 12 K2 a step at
  K = 8), 8 volumes a data coordinate; the comparison step against the
  one-process step of the same global batch (the slices gathered);
- ``pp``: the 2-stream ModelVIT (N = 1025, 4 layers; chip_smoke's phase
  train_pp) with ``pipeline_stages`` = 2 and 4 microbatches over (pipe 2,
  data N/2): each card holds 2 of the 4 layers (8 K1 + 8 K2 a step: 2
  layers × 4 microbatches of 2 rows), 8 volumes a data coordinate; the
  comparison step against the one-process step of the plain trunk on the
  same global batch.

And the axes composed, at four cards:

- ``tp_fsdp``: the ModelCross over (data N/2 × model 2) under FSDP: the TP
  slices, each sharded over its data line;
- ``tp_sp``: the ModelCross with ``seq_parallel = 2`` over (data N/4 × seq 2
  × model 2): the ring on each rank's 8 heads (no K1 or K2 launch),
  compared as ``sp``;
- ``fsdp_ep``: the MoE ModelCross over (data N/2 × expert 2) under FSDP;
- ``pp_fsdp``: the 2-stream ModelVIT over (pipe 2 × data N/2) under FSDP,
  4 microbatches;
- ``tp_ep``: the MoE ModelCross over (data N/4 × expert 2 × model 2);
- ``sync_bn``: ViT3D at train_vit3d's width (CNN3DEncoder stem, f32
  convolutions) over (data N), 8/N volumes a card, stateful: its BatchNorm
  statistics taken over the global batch of 8; the comparison step's
  running statistics within ``cs.BN_STAT_REL_TOL`` relative of the
  one-process step's and bit-equal on every rank (no K1, K2 or K3: ViT3D's
  attention is plain and train_vit3d does not augment);
- ``tp_vit3d``: the same ViT3D over (data N/2 × model 2), as JAX's rules
  place it: each card holds 8 of the 16 heads and half of every FFN and of
  the head, 8/(N/2) volumes a data coordinate, the BatchNorms synchronised
  over the data line;
- ``ddp_vit`` and ``fsdp_vit``: the 2-stream ModelVIT (N = 1025, 4 layers;
  chip_smoke's phase train_vit) over (data N) under DDP and under FSDP,
  whose units are its trunk layers (``ModelVIT.blocks``), 8 volumes a card,
  4 K1 + 4 K2 a step.

Under FSDP each sharded parameter and its Adam moments hold 1/D of the
whole on a rank, D the data axis.

Prints one JSON line per mode, the cards' names and power limits as
nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``; any
failure exits non-zero before those lines.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.parallel import make_mesh, multihost_init, shard_batch, unwrap
from cross_attention_vit_tpu_torch.train.checkpoint import flatten
from cross_attention_vit_tpu_torch.train.schedule import cosine_annealing_lr
from cross_attention_vit_tpu_torch.train.trainer import Trainer
from torch.distributed.tensor import DTensor

ROOT = Path(__file__).resolve().parent
PER_CARD = 8
WORKER_TIMEOUT_S = 900


MODES = ("ddp", "fsdp", "ep", "sp", "tp", "pp", "tp_fsdp", "tp_sp", "fsdp_ep", "pp_fsdp",
         "tp_ep", "sync_bn", "tp_vit3d", "ddp_vit", "fsdp_vit")
# the modes with an axis of 2 besides 'data', and those with two such axes
PAIRED = ("sp", "tp", "pp", "tp_fsdp", "fsdp_ep", "pp_fsdp", "tp_vit3d")
QUADRUPLED = ("tp_sp", "tp_ep")


def global_batch(size: int, streams: int = len(cs.MODALITIES)) -> tuple[torch.Tensor,
                                                                         torch.Tensor]:
    """``size`` volumes of phase train's distribution, from a seed, on the
    host."""
    rng = np.random.default_rng(1)
    img = (rng.normal(size=(size, streams, 1, *cs.VOLUME)) * 100)
    return torch.from_numpy(img.astype(np.float32)), torch.tensor([0, 1] * (size // 2))


def _no_drop(cfg):
    cs.modify_config(cfg, {"dropout": 0.0, "img_aug": False})
    return cfg


def _with(cfg, **fields):
    cs.modify_config(cfg, fields)
    return cfg


def _bn_init() -> tuple[dict, dict]:
    """ViT3D's weights and BatchNorm state from chip_smoke's seed."""
    from cross_attention_vit_tpu_torch.models.convert import (jax_params_from_model,
                                                              jax_state_from_model)
    from cross_attention_vit_tpu_torch.models.vit3d import ViT3D

    model = ViT3D(cs._bn_cfg(), device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    out = jax_params_from_model(model), jax_state_from_model(model)
    del model
    return out


def mode_spec(mode: str, cards: int) -> dict:
    """A mode's model, its training config, its comparison step's config,
    the one-process reference's config, its mesh axes, whether it runs
    FSDP, its global batch and the K1/K2 launches a step."""
    cross = {"model": ModelCross, "streams": len(cs.MODALITIES), "fsdp": "fsdp" in mode,
             "augments": True}
    half = {"data": cards // 2}
    if mode in ("ddp", "fsdp"):
        return {**cross, "cfg": cs.live_config(use_flash=True), "cmp": cs._dp_cmp_cfg(),
                "ref": cs._dp_cmp_cfg(), "axes": {"data": cards}, "batch": PER_CARD * cards,
                "attention_launches": 12}
    if mode in ("ep", "fsdp_ep", "tp_ep"):
        axes = {"ep": {"data": 1, "expert": cards}, "fsdp_ep": {**half, "expert": 2},
                "tp_ep": {"data": cards // 4, "expert": 2, "model": 2}}[mode]
        return {**cross, "cfg": cs.moe_config(use_flash=True),
                "cmp": _no_drop(cs.moe_config(True)), "ref": _no_drop(cs.moe_config(True)),
                "axes": axes, "batch": PER_CARD * axes["data"], "attention_launches": 12}
    if mode in ("tp", "tp_fsdp"):
        return {**cross, "cfg": cs.live_config(use_flash=True), "cmp": cs._dp_cmp_cfg(),
                "ref": cs._dp_cmp_cfg(), "axes": {**half, "model": 2},
                "batch": PER_CARD * (cards // 2), "attention_launches": 12}
    if mode in ("pp", "pp_fsdp"):
        return {**cross, "model": ModelVIT, "streams": 2, "cfg": cs._pp_config(),
                "cmp": _no_drop(cs._pp_config()),
                "ref": _no_drop(cs.vit_config(("SWI", "DWI"), use_flash=True)),
                "axes": {"pipe": 2, **half}, "batch": PER_CARD * (cards // 2),
                "attention_launches": 2 * cs.PIPE_MB}
    if mode in ("sync_bn", "tp_vit3d"):
        from cross_attention_vit_tpu_torch.models.vit3d import ViT3D

        axes = {"data": cards} if mode == "sync_bn" else {**half, "model": 2}
        return {"model": ViT3D, "streams": 1, "fsdp": False, "augments": False,
                "stateful": True, "cfg": cs._bn_cfg(), "cmp": cs._bn_cfg(), "ref": cs._bn_cfg(),
                "axes": axes, "batch": 8, "attention_launches": 0}
    if mode in ("ddp_vit", "fsdp_vit"):
        vit = ("SWI", "DWI")
        return {**cross, "model": ModelVIT, "streams": 2, "cfg": cs.vit_config(vit, True),
                "cmp": _no_drop(cs.vit_config(vit, True)),
                "ref": _no_drop(cs.vit_config(vit, True)), "axes": {"data": cards},
                "batch": PER_CARD * cards, "attention_launches": 4}
    sp = {"seq_parallel": 2}
    axes = {"data": cards // 2, "seq": 2} if mode == "sp" else {"data": cards // 4, "seq": 2,
                                                                 "model": 2}
    return {**cross, "cfg": _with(cs.live_config(use_flash=True), **sp),
            "cmp": _with(cs._dp_cmp_cfg(), **sp), "ref": _no_drop(cs.live_config(use_flash=False)),
            "axes": axes, "batch": PER_CARD * axes["data"], "attention_launches": 0}


def make_trainer(spec: dict, cfg, mesh=None, init=None):
    """The mode's Trainer (stateful ViT3D from ``init``, the others from
    the Trainer's seed)."""
    if spec.get("stateful"):
        return Trainer(spec["model"], cfg, max_epochs=1, stateful=True, schedule="plateau",
                       mesh=mesh, device="cuda").init_state(*init)
    return Trainer(spec["model"], cfg, max_epochs=1, mesh=mesh, fsdp=spec["fsdp"] and
                   mesh is not None, device="cuda").init_state()


def bn_buffers(t) -> dict[str, torch.Tensor]:
    return {n: b.detach().clone() for n, b in unwrap(t.model).named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def mode_mesh(axes: dict):
    return make_mesh(axes.get("data", -1), model=axes.get("model", 1), pipe=axes.get("pipe", 1),
                     seq=axes.get("seq", 1), expert=axes.get("expert", 1))


def lr_schedule(cfg):
    """The step-time learning rate: the cosine schedule's, or the plateau
    schedule's first (the stateful ViT3D's) throughout."""
    op = cfg.optim_params
    if "T_max" not in op:
        return lambda step: cfg.lr
    return cosine_annealing_lr(cfg.lr, op["T_max"], op["eta_min"])


def references(cards: int, modes: list[str], tmp: Path) -> dict:
    """On card 0, without a mesh: the step ms at batch 8, and for each mode
    the gradients of one step of its global batch, written for the
    workers."""
    cfg = cs.live_config(use_flash=True)
    img, labels = (x.cuda() for x in global_batch(PER_CARD))
    t = Trainer(ModelCross, cfg, max_epochs=1, device="cuda").init_state()
    _, step_ms, _, _ = cs._run_steps(t.train_step, img, labels, lr_schedule(cfg),
                                     torch.Generator().manual_seed(cs.TRAIN_SEED))
    del t
    out = {"step_ms_batch8": step_ms, "step_ms_batch8_steady": statistics.median(step_ms[1:])}
    for mode in modes:
        spec = mode_spec(mode, cards)
        img, labels = (x.cuda() for x in global_batch(spec["batch"], spec["streams"]))
        init = None
        if spec.get("stateful"):
            init = _bn_init()
            torch.save(init, tmp / "bn_init.pt")
        t = make_trainer(spec, spec["ref"], init=init)
        aux, ms = cs._timed_step(t.train_step, img, labels, spec["ref"].lr,
                                 torch.Generator().manual_seed(0))
        cs.check(bool(torch.isfinite(aux["loss"])), f"{mode}: non-finite one-process loss")
        torch.save({n: g.cpu() for n, g in cs._full_grads(t).items()}, tmp / f"grads_{mode}.pt")
        if spec.get("stateful"):
            torch.save({n: b.cpu() for n, b in bn_buffers(t).items()}, tmp / f"bn_{mode}.pt")
        out[f"{mode}_reference"] = {"batch": spec["batch"], "step_ms": ms,
                                    "loss": float(aux["loss"])}
        del t, img, labels
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _param_digest(trainer) -> str:
    """The digest of the whole parameters (FSDP shards and split experts
    gathered: a collective)."""
    digest = hashlib.sha256()
    for _, v in sorted(flatten(trainer.params).items()):
        digest.update(v.tobytes())
    return digest.hexdigest()


def run_mode(mode: str, cards: int, rank: int, tmp: Path) -> dict:
    """One rank's run of a mode (see the module docstring)."""
    spec = mode_spec(mode, cards)
    cfg, fsdp = spec["cfg"], spec["fsdp"]
    init = torch.load(tmp / "bn_init.pt", weights_only=False) if spec.get("stateful") else None
    mesh = mode_mesh(spec["axes"])
    img, labels = (x.cuda() for x in shard_batch(global_batch(spec["batch"], spec["streams"]),
                                                   mesh))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = make_trainer(spec, cfg, mesh, init)
    losses, step_ms, per_step, affine = cs._run_steps(
        t.train_step, img, labels, lr_schedule(cfg), torch.Generator().manual_seed(cs.TRAIN_SEED))
    launches = cs._counts()
    out = {"mesh": spec["axes"], "rows_per_rank": int(img.shape[0]), "losses": losses,
           "step_ms": step_ms, "step_ms_steady": statistics.median(step_ms[1:]),
           "launches": launches, "launches_per_step": per_step,
           "affine_volumes_per_step": affine}
    if mode in ("ep", "fsdp_ep", "tp_ep"):
        out["dispatch_fraction_by_site"] = unwrap(t.model).moe_aux["dispatch_fraction"].tolist()
    if fsdp:
        shards = [(p.numel(), p.to_local().numel(),
                   t.optimizer._opt.state[p]["exp_avg"].to_local().numel(),
                   t.optimizer._opt.state[p]["exp_avg_sq"].to_local().numel())
                  for p in t.model.parameters() if isinstance(p, DTensor)]
        out["sharded_params"] = len(shards)
        out["sharded_elements"] = sum(s[0] for s in shards)
        out["local_fraction"] = sorted({s[1] / s[0] for s in shards} | {s[2] / s[0] for s in shards}
                                       | {s[3] / s[0] for s in shards})
    elif mode == "ddp":     # the step with and without the gradient all-reduce, in turns
        synced, unsynced = [], []
        for sync in (True, False) * 3:
            with contextlib.nullcontext() if sync else t.model.no_sync():
                _, ms = cs._timed_step(t.train_step, img, labels, cfg.lr,
                                       torch.Generator().manual_seed(0))
            (synced if sync else unsynced).append(ms)
        out["step_ms_synced"] = statistics.median(synced)
        out["step_ms_without_grad_allreduce"] = statistics.median(unsynced)
        out["grad_allreduce_share"] = 1.0 - out["step_ms_without_grad_allreduce"] / out[
            "step_ms_synced"]
    out["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del t
    gc.collect()
    torch.cuda.empty_cache()
    # the comparison step from the seeded masters
    t = make_trainer(spec, spec["cmp"], mesh, init)
    cs._zero_counts()
    aux, out["comparison_step_ms"] = cs._timed_step(t.train_step, img, labels, spec["cmp"].lr,
                                                     torch.Generator().manual_seed(0))
    out["comparison_launches"] = cs._counts()
    out["comparison_loss"] = float(aux["loss"])
    grads = cs._full_grads(t)       # a collective when split: every rank
    if rank == 0:
        want = torch.load(tmp / f"grads_{mode}.pt", map_location="cuda")
        errs = cs._leaf_errs(grads, want)
        if spec["model"] is ModelVIT:
            cs._vit_head_bias_by_summand(errs, grads, want, aux)
        zero = cs.BN_ZERO_GRAD if spec.get("stateful") else ()
        gated = {n: e for n, e in errs.items()
                 if not n.endswith(cs.ZERO_GRAD_LEAF) and n not in zero}
        worst = max(gated, key=gated.get)
        out["grad_vs_one_process_worst_leaf"] = max(errs.values())
        out["grad_vs_one_process_worst_gated"] = [worst, gated[worst]]
    del grads
    if spec.get("stateful"):
        got = bn_buffers(t)
        digest = hashlib.sha256()
        for n in sorted(got):
            digest.update(got[n].cpu().numpy().tobytes())
        out["bn_buffers_sha256"] = digest.hexdigest()
        want = torch.load(tmp / f"bn_{mode}.pt", map_location="cuda")
        rel = {n: float((b - want[n]).abs().max() / want[n].abs().max()) for n, b in got.items()}
        out["bn_stat_rel_worst"] = list(max(rel.items(), key=lambda kv: kv[1]))
        out["bn_synchronised"] = sum(getattr(m, "sync_group", None) is not None
                                     for m in unwrap(t.model).modules())
    out["param_sha256"] = _param_digest(t)
    del t
    return out


def worker(rank: int, cards: int, port: int, tmp: Path, modes: list[str]) -> int:
    multihost_init(f"127.0.0.1:{port}", cards, rank, device="cuda",
                   timeout_s=WORKER_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        result = {"rank": rank, "device": str(torch.device("cuda", torch.cuda.current_device())),
                  "backend": torch.distributed.get_backend()}
        for mode in modes:     # written after each mode: a later failure keeps it
            result[mode] = run_mode(mode, cards, rank, tmp)
            (tmp / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def spawn(cards: int, tmp: Path, modes: list[str]) -> tuple[list[dict], str | None]:
    """Every rank's results (the modes it finished) and the first failure."""
    port = cs._free_port()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "dp_cards.py"), "--worker", str(r),
                               str(cards), str(port), str(tmp), ",".join(modes)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(cards)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} exited {p.returncode}:\n{err[-4000:]}"
              for r, (p, err) in enumerate(zip(procs, errs)) if p.returncode != 0]
    ranks = [json.loads(path.read_text()) if (path := tmp / f"rank{r}.json").exists()
             else {"rank": r} for r in range(cards)]
    return ranks, failed[0] if failed else None


def check_mode(mode: str, ranks: list[dict], cards: int) -> None:
    runs = [r[mode] for r in ranks]
    spec = mode_spec(mode, cards)
    n = spec["attention_launches"]
    for r, run in zip(ranks, runs):
        cs.check(all(np.isfinite(run["losses"])), f"{mode} rank {r['rank']}: losses {run['losses']}")
        for i, c in enumerate(run["launches_per_step"]):
            cs.check(c["K1"] == n and c["K2"] == n,
                     f"{mode} rank {r['rank']} step {i}: K1 {c['K1']}, K2 {c['K2']} launches "
                     f"({n} each expected)")
        cs.check((run["launches"]["K3"] > 0) == spec["augments"],
                 f"{mode} rank {r['rank']}: K3 launched {run['launches']['K3']} times")
        c = run["comparison_launches"]
        cs.check(c["K1"] == n and c["K2"] == n, f"{mode} comparison step launches {c}")
    cs.check(len({run["param_sha256"] for run in runs}) == 1,
             f"{mode}: the ranks' parameters differ after the comparison step")
    cs.check(len({tuple(run["losses"]) for run in runs}) == 1,
             f"{mode}: the ranks' replicated losses differ")
    name, err = runs[0]["grad_vs_one_process_worst_gated"]
    cs.check(err <= cs.SERVE_TOL, f"{mode}: gradient of {name} vs the one-process step "
                                  f"{err:.3e} > {cs.SERVE_TOL}")
    if spec["fsdp"]:
        d = spec["axes"]["data"]
        cs.check(runs[0]["sharded_params"] > 0 and runs[0]["local_fraction"] == [1 / d],
                 f"{mode}: local shares {runs[0]['local_fraction']}, expected 1/{d}")
    if spec.get("stateful"):
        cs.check(len({run["bn_buffers_sha256"] for run in runs}) == 1,
                 f"{mode}: the ranks' BatchNorm buffers differ")
        name, rel = runs[0]["bn_stat_rel_worst"]
        cs.check(rel <= cs.BN_STAT_REL_TOL, f"{mode}: running statistic {name} rel {rel:.3e}")
        want = 4 if spec["axes"]["data"] > 1 else 0
        cs.check(runs[0]["bn_synchronised"] == want,
                 f"{mode}: {runs[0]['bn_synchronised']} BatchNorms synchronised, not {want}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=None, help="default: every card of the host")
    p.add_argument("--modes", default=",".join(MODES),
                   help="comma-separated subset of " + ",".join(MODES))
    args = p.parse_args()
    modes = [m for m in args.modes.split(",") if m]
    try:
        device = cs.phase_device()
        cards = args.cards or torch.cuda.device_count()
        cs.check(1 <= cards <= torch.cuda.device_count(),
                 f"--cards {cards}: the host has {torch.cuda.device_count()} cards")
        cs.check(set(modes) <= set(MODES), f"--modes {args.modes}: not a subset of {MODES}")
        for mode in PAIRED + QUADRUPLED:
            need = 4 if mode in QUADRUPLED else 2
            if mode in modes and cards % need:
                cs.emit({"phase": mode, "skipped": f"its axes need a multiple of {need} "
                                                   f"cards, not {cards}"})
                modes.remove(mode)
        for mode, data in (("sync_bn", cards), ("tp_vit3d", cards // 2)):
            if mode in modes and 8 % data:
                cs.emit({"phase": mode, "skipped": f"8 volumes over a data axis of {data}"})
                modes.remove(mode)
        cs.check("ep" not in modes or 4 % cards == 0, f"ep: 4 experts over {cards} cards")
        cs.phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            ref = references(cards, modes, Path(tmp))
            cs.emit({"phase": "one_process", **ref})
            ranks, failure = spawn(cards, Path(tmp), modes)
        for mode in modes:
            if not all(mode in r for r in ranks):
                break                   # the modes every rank finished come first
            check_mode(mode, ranks, cards)
            one = ref[f"{mode}_reference"]["loss"]
            cs.emit({"phase": f"{mode}_{cards}_cards",
                     "per_card_batch": ranks[0][mode]["rows_per_rank"],
                     "comparison_loss_equals_one_process":
                         all(r[mode]["comparison_loss"] == one for r in ranks),
                     "ranks": [{"rank": r["rank"], "device": r["device"],
                                "backend": r["backend"],
                                **{k: v for k, v in r[mode].items() if k != "launches_per_step"}}
                               for r in ranks]})
        cs.check(failure is None, str(failure))
    except cs.SmokeFailure as e:
        print(f"dp_cards: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cs.emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                    "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        code = worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                      Path(sys.argv[5]), sys.argv[6].split(","))
        # leave without the interpreter's teardown, where torch's c10d can
        # abort under load after the group was destroyed (chip_smoke.py's
        # workers do the same)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    sys.exit(main())
