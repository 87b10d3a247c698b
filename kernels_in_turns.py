#!/usr/bin/env python3
"""Time the kernels of two checkouts of the port in turns on one NVIDIA
H100: the parent, this tree, this tree, the parent.

    python3 kernels_in_turns.py --parent DIR

Each turn is one process that imports ``cross_attention_vit_tpu_torch`` from
its checkout, builds the kernel libraries from that checkout's sources and
times, by torch.profiler device time per call (``chip_smoke.device_ms``, ten
calls a window, the median of five windows and their spread), bf16, D=64:

- K3, the LU-affine resample, at its four live passes (L1, the fused axis-2
  pass, U1, U0) and K4 (pass U0 over all taps), on V = 8 and V = 24 bf16
  volumes of 128×128×64 with the cdeltas of ``chip_smoke.corner_matrices``;
- as controls, allocated before the kernels above so that their operands
  lie at the same addresses in both checkouts: K1 and K2 (on K1's
  statistics) at N=513; K6's forward and backward on (B, K, D, N) views; K5's
  forward and backward at N=513 and 1025 (views of a stacked qkv); K7's
  forward at N=1537; K8, the fused QKV backward, at the live ModelCross
  shape (B=8 N=513 K=16 H=1024, W the model's view of a (3H, H) Linear
  weight), the whole call and its dx and dW product kernels apart (by their
  kernel names in each checkout); K7's backward at the 3-stream ModelVIT
  training shape (B=8 K=16 N=1537, q, k, v as views of one stacked
  (B, N, 3, K, D) tensor, on the forward's out and lse, dq, dk, dv written
  into views of a stacked dqkv): the whole call, and its dq and dk/dv
  kernels apart (by their kernel names, which both checkouts share).

Each turn prints one JSON line; the last two lines are the card's name and
power limit as nvidia-smi prints them and a summary: for each kernel the
medians of its turns per checkout and the ratio of this tree's to the
parent's (kernels only one checkout has are listed with that one's
medians).  A compare of two versions holds only within one call of this
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
# the libraries either checkout may have (older K5 and K7 backwards had sources
# of their own)
LIBRARIES = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_single",
             "flash_attention_single_bwd", "flash_attention_stream",
             "flash_attention_stream_bwd", "fused_qkv_bwd", "resample")
ORDER = ("parent", "change", "change", "parent")
# K8's product kernels by name: the wgmma kernels, then the older tile
# product they replaced (<true, ·, bf16> was dx, <false, false, float> dW)
K8_PRODUCT_MARKS = ({"dx": ("qkv_grad_dx_kernel",), "dW": ("qkv_grad_dw_kernel",)},
                    {"dx": ("gemm_nt_kernel<true", "gemm_nt_kernelILb1"),
                     "dW": ("gemm_nt_kernel<false", "gemm_nt_kernelILb0")})
# K7's backward kernels by name (either checkout names them so)
K7_MARKS = {"dq": ("attn_stream_bwd_dq",), "dk/dv": ("attn_stream_bwd_dkdv",)}


def _split_ms(fn, marks: dict[str, tuple[str, ...]], calls: int = 10) -> dict[str, float]:
    """Device ms per call of ``fn``'s kernels whose names hold one of each
    label's marks, from one profiled window (after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _kernel_rows

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a profile now and then records no kernel at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = _kernel_rows(prof)
        split = {label: sum(ms for key, ms, _ in rows if any(m in key for m in ms_marks)) / calls
                 for label, ms_marks in marks.items()}
        if all(ms > 0 for ms in split.values()):
            return split
    raise RuntimeError(f"torch.profiler recorded no {sorted(marks)} kernel in three tries")


def _time_tree(tree: Path) -> dict:
    """One turn: the kernels of the checkout ``tree``, timed on the card."""
    sys.path.insert(0, str(tree))
    import torch

    from chip_smoke import AUG, TIMING_WINDOWS, VOLUME, corner_matrices, device_ms
    from cross_attention_vit_tpu_torch.data import augment
    from cross_attention_vit_tpu_torch.kernels import _build
    from cross_attention_vit_tpu_torch.kernels import flash_attention as fa
    from cross_attention_vit_tpu_torch.kernels import resample as rs

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
    # both checkouts
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
    k5_stats = "stats" in inspect.signature(fa.flash_attention_single_bwd).parameters
    for n in (513, 1025):
        q, k, v = fa._stream_views(randn(8, n, 3, K, D))
        g5 = randn(8, K, n, D)
        extra = (fa.flash_attention_single_fwd(q, k, v, scale, True)[1],) if k5_stats else ()
        cases[f"K5 fwd N={n}"] = lambda q=q, k=k, v=v: fa.flash_attention_single_fwd(q, k, v, scale)
        cases[f"K5 bwd N={n}"] = (lambda q=q, k=k, v=v, g5=g5, extra=extra:
                                  fa.flash_attention_single_bwd(q, k, v, g5, scale, *extra))
    n7 = 1537
    sq, sk, sv = fa._stream_views(randn(8, n7, 3, K, D))
    cases["K7 fwd N=1537"] = lambda: fa.flash_attention_stream_fwd(sq, sk, sv, scale)
    H = 1024
    x = randn(8, N, H)
    w = (randn(3 * K * D, H) * H ** -0.5).t().reshape(H, 3, K, D)

    def k8():
        return fa.fused_qkv_bwd(x, w, qkv, out, dout, scale, stats)
    cases["K8 N=513"] = k8
    # K7's backward on the forward's out and lse, as the 3-stream ModelVIT's
    # training step runs it
    sg = randn(8, n7, K, D).transpose(1, 2)
    s_out, s_lse = fa.flash_attention_stream_fwd(sq, sk, sv, scale)
    s_grads = fa._stream_views(torch.empty(8, n7, 3, K, D, dtype=bf16, device="cuda"))

    def k7_bwd():
        return fa.flash_attention_stream_bwd(sq, sk, sv, s_out, s_lse, sg, scale, grads=s_grads)
    cases["K7 bwd N=1537"] = k7_bwd
    # the redesigned kernels: K3's live passes and K4, as augmentation runs them
    center = tuple((s - 1) / 2.0 for s in VOLUME)
    passes = list(zip(("L1", "fused2", "U1", "U0"), augment.LU_AXES,
                      augment.lu_windows(AUG, VOLUME), augment.lu_spans(AUG, VOLUME), range(4)))
    passes.append(("U0 all taps", augment.LU_AXES[3], augment.lu_windows(AUG, VOLUME)[3], None, 3))
    for V in (8, 24):
        vols = (torch.randn((V, *VOLUME), generator=g, device="cuda") * 100).to(bf16)
        cds = [cd.cuda() for cd in augment.lu_cdeltas(corner_matrices(V, seed=V))]
        for name, axis, window, span, p in passes:
            kind = "K4" if span is None else "K3"
            cases[f"{kind} {name} V={V}"] = (
                lambda vols=vols, axis=axis, cd=cds[p], window=window, span=span:
                rs.resample_axis_windowed_batched(vols, axis, cd, center, window, span))
    times = {}
    for label, fn in cases.items():
        got = [device_ms(fn) for _ in range(TIMING_WINDOWS)]
        times[label] = {"ms": statistics.median(got), "spread": [min(got), max(got)]}
    source = (_build.CSRC / "fused_qkv_bwd.cu").read_text()
    marks = next(m for m in K8_PRODUCT_MARKS if m["dx"][0].split("<")[0] in source)
    for label, fn, parts in (("K8 {} N=513", k8, marks), ("K7 bwd {} N=1537", k7_bwd, K7_MARKS)):
        splits = [_split_ms(fn, parts) for _ in range(TIMING_WINDOWS)]
        for part in parts:
            got = [sp[part] for sp in splits]
            times[label.format(part)] = {"ms": statistics.median(got),
                                         "spread": [min(got), max(got)]}
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
    for label in {**runs["parent"][0], **runs["change"][0]}:
        medians = {name: statistics.median(r[label]["ms"] for r in rs)
                   for name, rs in runs.items() if label in rs[0]}
        if len(medians) == 2:
            medians["change_over_parent"] = medians["change"] / medians["parent"]
        summary[label] = medians
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
