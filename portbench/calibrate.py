"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size:

    python3 -m portbench.calibrate --workload <cell> --seeds 11 12 ... [--control-seeds 11 12 13]

For each seed the program runs the cell's checked steps (no window: a
training reading needs none) and the reference follows them; for each
control seed the control (the reference with every product's operands in
float8 e4m3) follows the reference.  One JSON line a seed on standard
output, then the largest program reading and the smallest control reading
of each number.  A cell on several cards runs one process a card, started
here as ``portbench.run`` starts them.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import compare, harness
from .run import end_ranks, free_port, start_ranks

NO_LIMITS = dict.fromkeys(("loss_gap", "grad_gap", "update_gap", "grad_diff"), float("inf"))


def _values(checks: dict) -> dict:
    return {k: [c["value"], c.get("leaf", c.get("steps"))] for k, c in checks.items()}


def _program_checks(cell, seed: int, device, mesh, control_group, rank: int):
    program = harness.Program(cell, seed, device, mesh)
    checked = program.checked_steps()
    del program
    harness.free(device)
    ranks = [checked]
    if mesh is not None:
        grads = checked.pop("grads")              # rank 0's alone is compared whole
        ranks = [None] * cell.world
        torch.distributed.all_gather_object(ranks, checked, group=control_group)
        ranks[0]["grads"] = grads
    return ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default="", help="with --fault-seeds: a fault of tests/faults.py")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, json.loads(args.overrides))
    device = torch.device(args.device)
    harness.host_threads(device, cell.world)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = control_group = None
    procs, logs = [], None
    if cell.world > 1:
        from cross_attention_vit_tpu_torch.parallel.mesh import make_mesh, multihost_init

        port = args.port
        if args.rank == 0:
            port = free_port()
            logs = Path(tempfile.mkdtemp(prefix="portbench-calibrate-"))
            procs = start_ranks("portbench.calibrate", sys.argv[1:] if argv is None else argv,
                                cell.world, port, logs)
        multihost_init(f"127.0.0.1:{port}", cell.world, args.rank, device=device.type,
                       timeout_s=600)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        control_group = torch.distributed.new_group(backend="gloo")
        mesh = make_mesh(data=cell.world)
    worst, least, faulted = {}, {}, {}
    for seed in args.seeds + [s for s in args.fault_seeds if s not in args.seeds]:
        t0 = time.perf_counter()
        line = {"seed": seed}
        ref = None
        if seed in args.seeds:
            ranks = _program_checks(cell, seed, device, mesh, control_group, args.rank)
            if args.rank == 0:
                ref = harness.reference_readings(cell, seed, device)
                got = _values(compare.checks(ranks[0]["losses"], ranks, ref, NO_LIMITS))
                line.update(program=got, losses=ranks[0]["losses"], ref_losses=ref["losses"])
                for k, v in got.items():
                    worst[k] = max(worst.get(k, 0.0), v[0])
        if args.rank == 0 and seed in args.control_seeds:
            ctl = harness.reference_readings(cell, seed, device, control=True)
            line["control"] = _values(compare.checks(ctl["losses"], [ctl], ref, NO_LIMITS))
            for k, v in line["control"].items():
                least[k] = min(least.get(k, float("inf")), v[0])
        if seed in args.fault_seeds:
            from .tests import faults

            undo = faults.apply(args.fault)
            ranks = _program_checks(cell, seed, device, mesh, control_group, args.rank)
            undo()
            if args.rank == 0:
                ref = ref or harness.reference_readings(cell, seed, device)
                line["fault"] = _values(compare.checks(ranks[0]["losses"], ranks, ref,
                                                       NO_LIMITS))
                for k, v in line["fault"].items():
                    faulted[k] = min(faulted.get(k, float("inf")), v[0])
        if args.rank == 0:
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
        if mesh is not None:
            torch.distributed.barrier(group=control_group)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if procs:
        failed = end_ranks(procs, logs)
        shutil.rmtree(logs, ignore_errors=True)
        if failed:
            print("\n".join(failed), file=sys.stderr)
            return 1
    if args.rank == 0:
        print(json.dumps({"cell": cell.name, "program_max": worst, "control_min": least,
                          "fault": args.fault, "fault_min": faulted}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
