"""Probe: how often a gloo rank aborts in process teardown after its work.

    python tests/gloo_teardown_probe.py [--loops 8] [--worlds 60] [--leave] [--tcp]

Starts ``--loops`` loops at once (the load of a parallel test run), each
running ``--worlds`` worlds of two ranks one after another.  Each rank joins
a gloo group (a FileStore rendezvous, or TCP on a port picked free with
``--tcp``), all-reduces once, builds a DeviceMesh, destroys the group,
prints "done" and exits: normally, or with ``--leave`` through
``os._exit`` as ``torch_mesh_workers.leave`` does.  Prints one JSON line:
ranks run, ranks that exited non-zero, and each failure's exit code and
stderr tail (an abort after "done" is torch's c10d teardown: "terminate
called without an active exception", exit code -6).  CPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

RANK = r"""
import os, sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
address, rank, leave = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
dist.init_process_group("gloo", init_method=address, world_size=2, rank=rank)
t = torch.ones(4)
dist.all_reduce(t)
mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
dist.all_reduce(t, group=mesh.get_group("data"))
dist.destroy_process_group()
print("done", rank, file=sys.stderr, flush=True)
if leave:
    os._exit(0)
"""


def _address(tmp: Path, tcp: bool) -> str:
    if tcp:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        from torch_mesh_workers import free_port
        return f"tcp://127.0.0.1:{free_port()}"
    return f"file://{tmp / f'rendezvous-{uuid.uuid4().hex}'}"


def _loop(worlds: int, leave: bool, tcp: bool, tmp: Path) -> list[dict]:
    failures = []
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for _ in range(worlds):
        address = _address(tmp, tcp)
        procs = [subprocess.Popen([sys.executable, "-c", RANK, address, str(r), str(int(leave))],
                                  stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
        for r, p in enumerate(procs):
            err = p.communicate(timeout=300)[1]
            if p.returncode != 0:
                failures.append({"rank": r, "code": p.returncode, "stderr": err[-300:]})
    return failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loops", type=int, default=8)
    ap.add_argument("--worlds", type=int, default=60)
    ap.add_argument("--leave", action="store_true", help="end each rank with os._exit")
    ap.add_argument("--tcp", action="store_true", help="TCP rendezvous instead of a FileStore")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(args.loops) as pool:
        runs = [pool.submit(_loop, args.worlds, args.leave, args.tcp, Path(tmp))
                for _ in range(args.loops)]
        failures = [f for run in runs for f in run.result()]
    print(json.dumps({"ranks": 2 * args.loops * args.worlds, "failed": len(failures),
                      "leave": args.leave, "rendezvous": "tcp" if args.tcp else "file",
                      "failures": failures}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
