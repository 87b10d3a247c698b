"""One run of one cell: set-up, the measured window, the traced stretch,
then the check of what the window's step produced against the plain
reference.

The program is the port's training step exactly as its ``Trainer`` drives
it: ``make_train_step(model, Adam(model.parameters(), wd), config[, mesh])``
called back to back on batches from a seeded pool, each step with its own
seeded host generator, the aux dict folded into a ``MetricAccumulator`` and
nothing read back to the host inside the window.  The configuration names
a model family, whose files (``families/<family>.py``,
``reference/families/<family>.py``) give the port's model class, the frozen
counts, the launch counters, the weights' layout and the plain forward.

Set-up builds that one step object and drives it through the cell's
``warmup_steps`` steps on distinct batches; those steps are the warm-up (every kernel is
built and every shape seen there) and the steps the reference follows.
From them the run keeps each step's loss, each leaf's first gradient as
Adam took it (its first moment after one step over 1 − β1) and each leaf's
change over the checked steps.  The window then continues from the same
object.  After the window the program is freed and the reference trains
the same weights on the same batches with the same generators; ``compare``
turns both into the numbers compared and their limits.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

import torch

from . import compare, inputs
from .counts import attention as attn_counts
from .counts import flops as flop_counts
from .counts.peaks import card_peaks
from .reference import train as reference
from .trace import Profile, read_profile

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
PROFILE_STEPS = 3
PROFILE_TRIES = 4
# steps between the ranks' agreements on closing the window
AGREE_EVERY = 8
# modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "cross_attention_vit_tpu")
B1 = 0.9
# what each side of a model family's files exposes (families/__init__.py,
# reference/families/__init__.py)
PROGRAM_FAMILY = ("model_class", "forward_flops", "attention_shape", "counters")
REFERENCE_FAMILY = ("shapes", "logits")


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, file=sys.stderr, flush=True)


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass(frozen=True)
class Family:
    """A model family's two files: ``program``, ``families/<name>.py`` (the
    port's model, the frozen counts, the launch counters), and
    ``reference``, ``reference/families/<name>.py`` (the weights' layout and
    the plain forward)."""
    name: str
    program: ModuleType
    reference: ModuleType

    def weights(self, cfg: dict, seed: int, device) -> dict:
        """The initial weights from ``seed``, in the reference's layout."""
        kind = getattr(self.reference, "weight_kind", inputs.weight_kind)
        return inputs.make_weights(self.reference.shapes(cfg), seed, device, kind)


@dataclass
class Cell:
    name: str
    workload: dict
    config_name: str
    family: Family
    cfg: dict            # the configuration's fields as run

    @property
    def world(self) -> int:
        return int(self.workload["chips"])

    @property
    def batch(self) -> int:
        """Rows a data coordinate steps on."""
        return int(self.workload["batch_per_card"])

    @property
    def global_batch(self) -> int:
        return self.batch * self.world


def benchmark() -> dict:
    return _json(REPO / "BENCHMARK.json")


def load_cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell ``workloads/<name>.json`` with its ``configs/<config>.json``;
    ``overrides`` replace configuration fields (the CPU tests' tiny sizes)."""
    workload = _json(HERE / "workloads" / f"{name}.json")
    conf = _json(HERE / "configs" / f"{workload['config']}.json")
    cfg = dict(conf["config"])
    cfg.update(overrides or {})
    cfg["img_aug"] = bool(workload["augment"])
    return Cell(name, workload, workload["config"], family(conf["family"]), cfg)


def metrics_for(cell: str, bench: dict) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that ``cell``
    reports: those listing it, or without a list those whose end-to-end
    metric it reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return e2e, layer


def _load(module_name: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str) -> ModuleType:
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    return _load(f"portbench_metric_{name}", HERE / "metrics" / f"{name}.py")


def family(name: str) -> Family:
    """The model family ``name``: ``families/<name>.py`` and
    ``reference/families/<name>.py``, each with what it has to expose."""
    paths = HERE / "families" / f"{name}.py", HERE / "reference" / "families" / f"{name}.py"
    if not all(p.is_file() for p in paths):
        raise FileNotFoundError(f"model family {name!r} needs both {paths[0]} and {paths[1]}; "
                                f"missing: {[str(p) for p in paths if not p.is_file()]}")
    fam = Family(name, _load(f"portbench_family_{name}", paths[0]),
                 _load(f"portbench_reference_family_{name}", paths[1]))
    for side, wanted, path in (("program", PROGRAM_FAMILY, paths[0]),
                               ("reference", REFERENCE_FAMILY, paths[1])):
        missing = [f for f in wanted if not callable(getattr(getattr(fam, side), f, None))]
        if missing:
            raise AttributeError(f"{path} does not define {missing}")
    return fam


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# --- the program ----------------------------------------------------------------

def port_config(cfg: dict):
    from cross_attention_vit_tpu_torch.configs import Config

    return Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})


class Program:
    """The port's model, Adam and train step for one data coordinate."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, mesh=None):
        from cross_attention_vit_tpu_torch.parallel.sharding import shard_params, unwrap
        from cross_attention_vit_tpu_torch.train.optim import Adam
        from cross_attention_vit_tpu_torch.train.trainer import make_train_step

        self.cell, self.seed, self.device = cell, seed, device
        self.config = port_config(cell.cfg)
        model = cell.family.program.model_class()(self.config, device="meta",
                                                  master_weights=True)
        model = model.to_empty(device=device)
        shapes = cell.family.reference.shapes(cell.cfg)
        mine = {n: tuple(p.shape) for n, p in model.named_parameters()}
        if mine != shapes:
            raise ValueError(f"the program's parameters differ from the reference's layout: "
                             f"{sorted(set(mine.items()) ^ set(shapes.items()))[:6]}")
        weights = cell.family.weights(cell.cfg, seed, device)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(weights.pop(n))
        self.model = shard_params(model, mesh) if mesh is not None else model
        self.names = [n for n, _ in unwrap(self.model).named_parameters()]
        self.params = list(self.model.parameters())
        self.optimizer = Adam(self.params, weight_decay=self.config.weight_decay)
        self.step_fn = make_train_step(self.model, self.optimizer, self.config, mesh=mesh)
        self.coordinate = 0 if mesh is None else torch.distributed.get_rank()
        pool = int(cell.workload["pool_batches"])
        imgs, labels = inputs.make_pool(seed, pool, cell.global_batch,
                                        self.config.num_modalities,
                                        tuple(self.config.img_size), device)
        rows = slice(self.coordinate * cell.batch, (self.coordinate + 1) * cell.batch)
        self.imgs, self.labels = imgs[:, rows].contiguous(), labels[:, rows].contiguous()
        del imgs, labels
        self.lr = float(self.config.lr)
        self.i = 0

    def step(self) -> dict:
        k = self.i % self.imgs.shape[0]
        aux = self.step_fn(self.imgs[k], self.labels[k], self.lr,
                           inputs.step_generator(self.seed, self.i, self.coordinate))
        self.i += 1
        return aux

    def checked_steps(self) -> dict:
        """The first steps, with what the comparison reads from them."""
        start = [p.detach().clone() for p in self.params]
        losses, grads = [], None
        for _ in range(int(self.cell.workload["warmup_steps"])):
            losses.append(self.step()["loss"])
            if grads is None:     # an optimizer that never stepped has zero moments
                grads = ([(m / (1 - B1)).cpu() for m in self.optimizer.moments()[0]]
                         if self.optimizer.step_count
                         else [torch.zeros(p.shape) for p in self.params])
        with torch.no_grad():
            change = [float((p - p0).norm()) for p, p0 in zip(self.params, start)]
        return {"losses": [float(x) for x in losses],
                "grads": dict(zip(self.names, grads)),
                "grad_norms": {n: float(g.norm()) for n, g in zip(self.names, grads)},
                "change_norms": dict(zip(self.names, change))}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(program: Program, seconds: float, keep_going) -> dict:
    """Steps back to back until ``keep_going(elapsed)`` says stop, then one
    synchronisation; the losses stay on the device until then."""
    from cross_attention_vit_tpu_torch.train.metrics import MetricAccumulator

    acc, losses = MetricAccumulator(), []
    synchronize(program.device)
    t0 = time.perf_counter()
    while keep_going(time.perf_counter() - t0):
        aux = program.step()
        acc.update(aux["loss"], aux["counts"], aux["probs"], aux["labels"])
        losses.append(aux["loss"])
    synchronize(program.device)
    wall = time.perf_counter() - t0
    bad = int((~torch.isfinite(torch.stack(losses).float())).sum()) if losses else 0
    return {"steps": len(losses), "wall_s": wall, "non_finite": bad}


def profile_steps(program: Program, any_rank=bool) -> tuple[Profile | None, dict, int]:
    """A short steady stretch under the profiler: (profile, counter deltas,
    empty sessions).  A session that recorded no device operation (on any
    rank: ``any_rank`` ORs a flag over the mesh, so every rank steps alike)
    is tried again, up to ``PROFILE_TRIES`` times; None when every one was
    empty."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if program.device.type == "cuda" else [])
    with profile(activities=acts):          # the profiler's own first-use cost
        program.step()
        synchronize(program.device)
    counters = program.cell.family.program.counters
    empty = 0
    for _ in range(PROFILE_TRIES):
        before = counters()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                program.step()
            synchronize(program.device)
            wall = time.perf_counter() - t0
        after = counters()
        got = read_profile(prof, PROFILE_STEPS, wall)
        if not any_rank(got.empty):
            return got, {k: after[k] - before[k] for k in after}, empty
        empty += 1
    return None, {}, empty


def augment_ms(program: Program, calls: int = 6) -> float:
    """ms of one ``augment.augment_batch`` on this coordinate's batch, as the
    step calls it (bfloat16 volumes), timed by CUDA events over ``calls``
    calls with generators of their own."""
    from cross_attention_vit_tpu_torch.data.augment import augment_batch

    img = program.imgs[0]
    gens = [inputs.step_generator(program.seed, 10 ** 6 + j, program.coordinate)
            for j in range(calls + 1)]
    augment_batch(img, gens[0])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for g in gens[1:]:
        augment_batch(img, g)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


class Context:
    """What a per-layer reader reads: the profiled stretch, the unprofiled
    timed stretch, the program's counters, the frozen counts and peaks."""

    def __init__(self, cell: Cell, program: Program, timed: dict, prof: Profile,
                 counters: dict, device_name: str):
        self.cell, self.timed, self.profile, self.counters = cell, timed, prof, counters
        self.world = cell.world
        self.peak_flops, self.peak_bytes_s = card_peaks(device_name)
        fam = cell.family.program
        self.step_flops = flop_counts.train_step(fam.forward_flops(cell.cfg, cell.global_batch))
        self.attention_shape = fam.attention_shape(cell.cfg, cell.batch)
        self.counts = attn_counts
        self._program = program
        self._augment_ms = None

    def augment_ms(self) -> float:
        if self._augment_ms is None:
            self._augment_ms = augment_ms(self._program)
        return self._augment_ms


# --- one data coordinate's run --------------------------------------------------

def host_threads(device: torch.device, world: int) -> None:
    """The ranks of a mesh share the host: on the card one intra-op thread a
    rank, as torchrun sets for each process it starts; on the CPU an equal
    share of the cores."""
    if world > 1 and device.type == "cuda":
        torch.set_num_threads(1)
    elif device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))


def coordinate_run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
                   t_start: float, layer_metrics: list[dict], mesh=None,
                   stop_group=None) -> dict:
    """Set-up, window (or timed and profiled stretches) and the program's
    readings of one data coordinate; the program is freed before it returns."""
    host_threads(device, cell.world)
    program = Program(cell, seed, device, mesh)
    checked = program.checked_steps()
    rank = program.coordinate

    def any_rank(flag: bool) -> bool:
        if stop_group is None:
            return flag
        t = torch.tensor([int(flag)])
        torch.distributed.all_reduce(t, torch.distributed.ReduceOp.MAX, group=stop_group)
        return bool(t.item())

    steps = [0]

    def keep_going(elapsed: float) -> bool:
        """Rank 0's clock closes the window for every rank at the same step;
        over a mesh the ranks agree every ``AGREE_EVERY`` steps."""
        steps[0] += 1
        if stop_group is not None and (steps[0] - 1) % AGREE_EVERY:
            return True
        return not any_rank(rank == 0 and elapsed >= seconds)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    out = {"rank": rank, "setup_s": setup_s, "checked": checked}
    window = run_steps(program, seconds, keep_going)
    out["window"] = window
    if trace:
        prof, counters, empty = profile_steps(program, any_rank)
        out["profile_empty"] = empty
        if prof is not None:
            name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
            out["busy_s"], out["window_s"] = prof.busy_s(), prof.wall_s
            if rank == 0:
                ctx = Context(cell, program, window, prof, counters, name)
                out["layers"] = read_layers(ctx, layer_metrics)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    out["forbidden"] = forbidden_modules()
    return out


def read_layers(ctx: Context, layer_metrics: list[dict]) -> tuple[dict, dict]:
    """(metrics, breakdown) of a traced run: each reader that found something."""
    metrics = {}
    for m in layer_metrics:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    breakdown = {"device_ops": ctx.profile.top_operations(),
                 "idle_gaps": ctx.profile.idle_gaps()}
    return metrics, breakdown


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(cell: Cell, seed: int, device: torch.device,
                       control: bool = False) -> dict:
    """The reference's losses, first gradients and changes on the checked
    steps of every data coordinate."""
    weights = cell.family.weights(cell.cfg, seed, device)
    imgs, labels = inputs.make_pool(seed, int(cell.workload["pool_batches"]), cell.global_batch,
                                    cell.cfg["num_modalities"], tuple(cell.cfg["img_size"]),
                                    device)
    b, P = cell.batch, imgs.shape[0]
    steps = [[(imgs[i % P, r * b:(r + 1) * b], labels[i % P, r * b:(r + 1) * b],
               inputs.step_generator(seed, i, r)) for r in range(cell.world)]
             for i in range(int(cell.workload["warmup_steps"]))]
    return reference.run_steps(cell.family.reference.logits, cell.cfg, weights, steps,
                               cell.cfg["img_aug"], float(cell.cfg["lr"]),
                               int(cell.workload["reference_rows_per_block"]), control)


def finish(cell: Cell, seed: int, trace: bool, ranks: list[dict], device: torch.device,
           device_name: str, e2e: list[dict]) -> dict:
    """The result line of a run from every coordinate's readings (rank 0's
    first), after the reference has run."""
    zero = ranks[0]
    free(device)
    ref = reference_readings(cell, seed, device)
    checks = compare.checks(zero["checked"]["losses"], [r["checked"] for r in ranks], ref,
                            cell.workload["limits"])
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    window = zero["window"]
    result = {"correct": correct, "attempted": window["steps"],
              "failed": window["non_finite"]}
    if trace:
        metrics, breakdown = zero["layers"]
    else:
        metrics, breakdown = {}, None
        rate = window["steps"] * cell.global_batch / window["wall_s"]
        values = {"train_samples_per_s": rate, "ddp_train_samples_per_s": rate,
                  "setup_s": zero["setup_s"]}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": device_name, "count": cell.world,
                        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    if trace:
        result["device"]["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        result["device"]["window_s"] = zero["window_s"]
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
