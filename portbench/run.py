"""The benchmark's entry point:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root.  It prints one JSON object as the last line of
standard output and the numbers compared for ``correct``, each beside its
limit, as the last lines of standard error.  It exits non-zero and prints
no result where there is no CUDA card, fewer cards than the cell asks for,
or where JAX or the JAX package is loaded once the window has closed.

A cell on several cards runs one process a card: this process is rank 0
and starts the others itself (``--rank``, ``--port``), joined over NCCL by
``parallel.multihost_init``; a gloo group beside it carries rank 0's
decision to close the window and every rank's readings.  ``--device cpu``,
``--overrides`` and ``--fault`` serve the CPU tests only.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from . import harness  # noqa: E402
from .harness import log  # noqa: E402

WORKER_WAIT_S = 240


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--overrides", default="{}", help=argparse.SUPPRESS)
    ap.add_argument("--fault", default="", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(module: str, argv: list[str], world: int, port: int,
                logs: Path) -> list[subprocess.Popen]:
    """Ranks 1 .. world − 1 of ``python3 -m <module> <argv> --rank r --port
    <port>``, each logging to ``logs/rank<r>.log``."""
    procs = []
    for r in range(1, world):
        with open(logs / f"rank{r}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv, "--rank", str(r), "--port", str(port)],
                stdout=out, stderr=subprocess.STDOUT, cwd=harness.REPO))
    return procs


def end_ranks(procs: list[subprocess.Popen], logs: Path) -> list[str]:
    """Wait for every started rank (killing one that outlives the wait);
    the log tails of those that failed."""
    failed = []
    deadline = time.monotonic() + WORKER_WAIT_S
    for r, p in enumerate(procs, start=1):
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.returncode != 0:
            failed.append(f"rank {r} exited {p.returncode}:\n"
                          f"{(logs / f'rank{r}.log').read_text()[-3000:]}")
    return failed


def run(args) -> dict | None:
    """One rank's run; rank 0 returns the result line, other ranks None."""
    cell = harness.load_cell(args.workload, json.loads(args.overrides))
    world = cell.world
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.fault:
        from .tests import faults

        faults.apply(args.fault)
    e2e, layers = harness.metrics_for(cell.name, harness.benchmark())
    if world == 1:
        ranks = [harness.coordinate_run(cell, args.seed, args.seconds, bool(args.trace), device,
                                        T_START, layers)]
        return _result(cell, args, ranks, device, e2e)
    return _run_mesh(cell, args, device, e2e, layers)


def _run_mesh(cell, args, device, e2e, layers) -> dict | None:
    from cross_attention_vit_tpu_torch.parallel.mesh import make_mesh, multihost_init

    world, rank = cell.world, args.rank
    procs, logs = [], None
    port = args.port
    if rank == 0:
        port = free_port()
        logs = Path(tempfile.mkdtemp(prefix="portbench-ranks-"))
        argv = ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                str(args.seconds), "--trace", str(args.trace), "--device", args.device,
                "--overrides", args.overrides, "--fault", args.fault]
        procs = start_ranks("portbench.run", argv, world, port, logs)
    try:
        multihost_init(f"127.0.0.1:{port}", world, rank, device=str(device.type),
                       timeout_s=WORKER_WAIT_S)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        control = torch.distributed.new_group(backend="gloo")
        mesh = make_mesh(data=world)
        mine = harness.coordinate_run(cell, args.seed, args.seconds, bool(args.trace), device,
                                      T_START, layers, mesh=mesh, stop_group=control)
        grads = mine["checked"].pop("grads")      # rank 0's alone is compared whole
        ranks = [None] * world
        torch.distributed.all_gather_object(ranks, mine, group=control)
        ranks[0]["checked"]["grads"] = grads
        torch.distributed.destroy_process_group()
    except BaseException:
        if procs:
            for line in end_ranks(procs, logs):
                log(line)
            shutil.rmtree(logs, ignore_errors=True)
        raise
    if rank != 0:
        return None
    failed = end_ranks(procs, logs)
    shutil.rmtree(logs, ignore_errors=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return _result(cell, args, ranks, device, e2e)


def _result(cell, args, ranks: list[dict], device, e2e) -> dict | None:
    if args.trace and any(r["profile_empty"] for r in ranks):
        log({"profiler": {"empty_sessions": [r["profile_empty"] for r in ranks],
                          "tries": harness.PROFILE_TRIES}})
    if args.trace and any("busy_s" not in r for r in ranks):
        log("every profiler session recorded no device operation: no per-layer metric")
        return None
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if device.type == "cuda":
        limit = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader"
                         ).read().strip().splitlines()
        log({"card": name, "nvidia_smi": limit})
    log({"setup_s": [r["setup_s"] for r in ranks],
         "window": ranks[0]["window"], "checked_losses": ranks[0]["checked"]["losses"]})
    loaded = sorted({m for r in ranks for m in r["forbidden"]})
    if loaded:
        log(f"modules that may not be loaded were: {loaded}")
        return None
    result = harness.finish(cell, args.seed, bool(args.trace), ranks, device, name, e2e)
    loaded = harness.forbidden_modules()
    if loaded:
        log(f"modules that may not be loaded were: {loaded}")
        return None
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cell_chips = harness.load_cell(args.workload).world
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell_chips):
        log(f"this cell needs {cell_chips} CUDA card(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(args)
    if args.rank != 0:
        return 0
    if result is None:
        return 1
    for name, c in result["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
