#!/usr/bin/env python3
"""Time the attention kernels of two checkouts of the port in turns on one
NVIDIA H100: the parent, this tree, this tree, the parent.

    python3 kernels_in_turns.py --parent DIR

Each turn is one process that imports ``cross_attention_vit_tpu_torch`` from
its checkout, builds the kernel libraries from that checkout's sources and
times, by torch.profiler device time per call (``chip_smoke.device_ms``, ten
calls a window, the median of five windows and their spread):

- K5, the public ``flash_attention``'s single-block kernels, at the int8+attn
  serving shapes of ``chip_smoke.py`` (B=8 K=16 D=64, N=513 and 1025, bf16, q,
  k, v as views of one stacked (B, N, 3, K, D) tensor): the forward as
  serving calls it (no row statistics) and the backward (dq and dk/dv
  kernels; a checkout whose backward reads the forward's statistics gets
  them from one forward call);
- as controls, at N=513: K1, K2 on K1's statistics, K6's forward and
  backward on (B, K, D, N) views of (B, K, N, D) tensors, and K8 at H=1024.

Each turn prints one JSON line; the last two lines are the card's name and
power limit as nvidia-smi prints them and a summary: for each kernel the
medians of its turns per checkout and the ratio of this tree's to the
parent's.  A compare of two versions holds only within one call of this
script, on one card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the libraries either checkout may have (the parent's K5 had its own sources)
LIBRARIES = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_single",
             "flash_attention_single_bwd", "fused_qkv_bwd")
ORDER = ("parent", "change", "change", "parent")


def _time_tree(tree: Path) -> dict:
    """One turn: the kernels of the checkout ``tree``, timed on the card."""
    sys.path.insert(0, str(tree))
    import torch

    from chip_smoke import TIMING_WINDOWS, device_ms
    from cross_attention_vit_tpu_torch.kernels import _build
    from cross_attention_vit_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("kernels_in_turns.py needs a CUDA card")
    names = [n for n in LIBRARIES if (_build.CSRC / f"{n}.cu").exists()]
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, scale, K, D = torch.bfloat16, 64 ** -0.5, 16, 64

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf16)

    # the controls first: their operands then lie at the same addresses in
    # both checkouts (K5's allocations differ between them)
    cases = {}
    N = 513
    qkv, dout = randn(8, N, 3, K, D), randn(8, N, K, D)
    out, stats = fa.flash_attention_qkv_fwd(qkv, scale, True)
    cases["K1 N=513"] = lambda: fa.flash_attention_qkv(qkv, scale)
    cases["K2 N=513"] = lambda: fa.flash_attention_qkv_bwd(qkv, out, dout, scale, stats)
    tq, tk, tv, tg = (randn(8, K, N, D).transpose(-1, -2) for _ in range(4))
    _, tn_stats = fa.flash_attention_tn_fwd(tq, tk, tv, scale, True)
    cases["K6 fwd N=513"] = lambda: fa.flash_attention_tn_fwd(tq, tk, tv, scale)
    cases["K6 bwd N=513"] = lambda: fa.flash_attention_tn_bwd(tq, tk, tv, tg, scale, tn_stats)
    H = 1024
    x, w = randn(8, N, H), randn(H, 3, K, D) * 0.03
    cases["K8 N=513"] = lambda: fa.fused_qkv_bwd(x, w, qkv, out, dout, scale, stats)

    k5_stats = "stats" in inspect.signature(fa.flash_attention_single_bwd).parameters
    for n in (513, 1025):
        q, k, v = fa._stream_views(randn(8, n, 3, K, D))
        g5 = randn(8, K, n, D)
        extra = (fa.flash_attention_single_fwd(q, k, v, scale, True)[1],) if k5_stats else ()
        cases[f"K5 fwd N={n}"] = lambda q=q, k=k, v=v: fa.flash_attention_single_fwd(q, k, v, scale)
        cases[f"K5 bwd N={n}"] = (lambda q=q, k=k, v=v, g5=g5, extra=extra:
                                  fa.flash_attention_single_bwd(q, k, v, g5, scale, *extra))
    times = {}
    for label, fn in cases.items():
        got = [device_ms(fn) for _ in range(TIMING_WINDOWS)]
        times[label] = {"ms": statistics.median(got), "spread": [min(got), max(got)]}
    return {"device": torch.cuda.get_device_name(0), "times": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="the parent checkout's root")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)   # one turn, in a child
    args = ap.parse_args()
    if args.tree is not None:
        print(json.dumps(_time_tree(args.tree.resolve())), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    runs = {name: [] for name in trees}
    for turn, name in enumerate(ORDER):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree",
                               str(trees[name])], cwd=trees[name], capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": str(trees[name])})
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[name].append(result["times"])
        print(json.dumps({"turn": turn, "tree": name, **result}), flush=True)
    summary = {}
    for label in runs["change"][0]:
        medians = {name: statistics.median(r[label]["ms"] for r in rs) for name, rs in runs.items()}
        summary[label] = {**medians, "change_over_parent": medians["change"] / medians["parent"]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
