#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cross_attention_vit_tpu_torch``) on
one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed as one JSON line with a ``phase`` key:

1. device  — CUDA present, compute capability (9, 0), the card's name and
             power limit; TF32 switched off for matmuls and cuDNN.
2. build   — compiles every kernel of the serving path from
             ``cross_attention_vit_tpu_torch/kernels/csrc/`` with nvcc.
3. kernels — holds each kernel against its plain PyTorch version on the
             card (normalised max error within the stated tolerance) and
             times kernel, plain version and the library call (yardstick
             only) with CUDA events, beside the card's bound.
4. serve   — the full-width live ModelCross (3 streams, hidden 1024, 16
             heads, N = 513, bf16, tanh GELU; 241.9M random parameters from
             a seed) written as a JAX-layout npz checkpoint, served by the
             port's InferenceServer (buckets 1/2/4/8) and asked 6 requests of
             1, 3 and 8 volumes, one over HTTP.  Checks finite logits, the
             server's answers against a direct forward, 12 kernel launches
             per bucket forward, and the kernel path against the plain path.

Then one line ``{"kernels": [...]}`` with each kernel's launches on the
serving run and its timings, the card's name and power limit as nvidia-smi
prints them, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before the result lines are printed; without CUDA it exits 1.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from cross_attention_vit_tpu_torch.configs import (Params, get_mgmt_cross_config,
                                                   modify_config)
from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer, serve
from cross_attention_vit_tpu_torch.kernels import _build
from cross_attention_vit_tpu_torch.kernels import flash_attention as fa
from cross_attention_vit_tpu_torch.models.convert import jax_params_from_model
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.train.checkpoint import save_config, save_pytree

ROOT = Path(__file__).resolve().parent
MODALITIES = ("DWI", "SWI", "ASL")
LIVE_PARAMS = 241.9e6
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type.
# f32 is the CUDA-core rate: the f32 kernel must not use TF32.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain, normalised by max |plain| (tests_tpu/test_kernels_onchip.py:61,189)
KERNEL_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# flash-path vs plain-path logits at bucket 8, normalised by max |plain|.  Both
# paths are bf16 end to end and share every GEMM; they differ only in where
# the 12 attention layers round (the kernel casts e = exp(s - m) to bf16 and
# normalises after AV, the plain path normalises, then casts).  One bf16
# rounding is 2^-8 = 3.9e-3 relative; 5e-2 allows about a dozen such steps
# compounded through the residual stream.
SERVE_TOL = 5e-2
REQUEST_SIZES = (1, 3, 8, 1, 3, 8)
K1 = {"name": "flash_attention_qkv", "route": "cuda",
      "source": "cross_attention_vit_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
      "replaces": "cross_attention_vit_tpu/kernels/flash_attention.py:759"}


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, runs: int = 20, calls: int = 10, warmup: int = 3) -> float:
    """ms per call: median over `runs` CUDA-event timings of `calls`
    back-to-back calls each (L2 warm).  Back to back, the host enqueues the
    next call while the card runs this one, so host overhead shows only
    where it exceeds the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def attention_bound(B: int, N: int, K: int, D: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time in ms for one launch: read qkv once, write out once; the
    4·B·K·N²·D FLOPs of the two products at the dtype's peak."""
    nbytes = 4 * B * N * K * D * torch.empty((), dtype=dtype).element_size()
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 4 * B * K * N * N * D / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: chip_smoke needs an H100")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0) (Hopper)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "capability": list(cap),
            "nvidia_smi": smi_line, "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    lib, seconds, report = _build.build("flash_attention_fwd", force=True)
    print(report, file=sys.stderr, flush=True)     # ptxas -v: registers, smem, spills
    emit({"phase": "build", "kernel": "flash_attention_fwd",
          "library": str(lib.relative_to(ROOT)), "nvcc_s": seconds,
          "ptxas": [ln.strip() for ln in report.splitlines()
                    if "registers" in ln or "spill" in ln]})


def phase_kernels() -> dict:
    """K1 against its plain version; returns the bucket-8 serving-shape entry."""
    K, D = 16, 64
    # (B, N, dtype, strided): the serving buckets 1/2/4/8 at N = 513 in bf16;
    # strided reads qkv through a (B, 3, K, N, D) buffer permuted to
    # (B, N, 3, K, D) — the f32 path takes any strides
    cases = [(1, 513, torch.bfloat16, False), (2, 513, torch.bfloat16, False),
             (4, 513, torch.bfloat16, False), (8, 513, torch.bfloat16, False),
             (1, 513, torch.float32, False), (8, 513, torch.float32, False),
             (1, 513, torch.float32, True), (8, 1025, torch.bfloat16, False),
             (8, 1041, torch.bfloat16, False)]
    checks = []
    failures = []
    for i, (B, N, dtype, strided) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        if strided:
            qkv = torch.randn((B, 3, K, N, D), generator=g, device="cuda").to(dtype)
            qkv = qkv.permute(0, 3, 1, 2, 4)
        else:
            qkv = torch.randn((B, N, 3, K, D), generator=g, device="cuda").to(dtype)
        scale = D ** -0.5
        plain = fa.flash_attention_qkv_reference(qkv, scale).float()
        out = fa.flash_attention_qkv(qkv, scale).float()
        torch.cuda.synchronize()
        max_abs = (out - plain).abs().max().item()
        norm_err = max_abs / plain.abs().max().item()
        tol = KERNEL_TOL[dtype]
        entry = {"B": B, "K": K, "D": D, "N": N, "dtype": str(dtype).replace("torch.", ""),
                 "strides": list(qkv.stride()),
                 "max_abs_err": max_abs, "norm_err": norm_err, "tol": tol,
                 "finite": bool(torch.isfinite(out).all())}
        if B == 8:
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            entry["kernel_ms"] = cuda_ms(lambda: fa.flash_attention_qkv(qkv, scale))
            entry["plain_ms"] = cuda_ms(lambda: fa.flash_attention_qkv_reference(qkv, scale))
            entry["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            bound_ms, bound_by = attention_bound(B, N, K, D, dtype)
            entry["bound_us"] = bound_ms * 1e3
            entry["bound_by"] = bound_by
        checks.append(entry)
        if not (entry["finite"] and norm_err <= tol):
            failures.append(entry)
    emit({"phase": "kernels", "checks": [{**K1, "cases": checks}]})
    check(not failures, f"kernel disagrees with its plain version: {failures}")
    return next(c for c in checks if (c["B"], c["N"], c["dtype"]) == (8, 513, "bfloat16"))


def live_config(use_flash: bool):
    """bench.py's live configuration: params_list1[0] of the experiment
    grid, bf16 compute and activations, flash attention, tanh GELU."""
    p = Params(lr=1e-4, dropout=0.25, attn_order={"0": "1", "1": "2", "2": "0"},
               optim_params={"T_max": 250, "eta_min": 1e-6}, weight_decay=5e-4,
               img_types=MODALITIES, label_smoothing=0.0, img_aug=True)
    cfg = get_mgmt_cross_config()
    modify_config(cfg, p)
    modify_config(cfg, {"num_modalities": len(MODALITIES), "compute_dtype": "bfloat16",
                        "activation_dtype": "bfloat16", "use_flash_attention": use_flash,
                        "gelu_approx": True})
    return cfg


def _post_predict(port: int, vols: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, vols)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.asarray(json.load(resp)["logits"], np.float32)


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.load(resp)


def _forward(model, vols: np.ndarray) -> torch.Tensor:
    with torch.inference_mode():
        return model(torch.from_numpy(vols).cuda()).float()


def _profile(model, x: torch.Tensor) -> dict:
    """One forward under torch.profiler: device time by kernel, the device's
    busy time against the forward's wall time (its idle share)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, t / 1e3, ev.count))
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {"device_ms_total": busy, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:8]]}


def phase_serve(tmp: Path) -> dict:
    cfg = live_config(use_flash=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    source = ModelCross(cfg, device="cuda", generator=g)
    n_params = source.num_params()
    check(abs(n_params - LIVE_PARAMS) < 0.05e6, f"{n_params} params, expected 241.9M")
    ckpt = tmp / "epoch=00-val_loss=0.0000.npz"
    t0 = time.perf_counter()
    save_pytree(ckpt, {"params": jax_params_from_model(source), "epoch": np.zeros((), np.int32)})
    save_config(tmp, cfg)
    write_s = time.perf_counter() - t0
    del source
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    server = InferenceServer(ckpt, img_types=MODALITIES, buckets=(1, 2, 4, 8), device="cuda")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    httpd = serve(server, host="127.0.0.1", port=0)     # warms up every bucket, starts
    warmup_s = time.perf_counter() - t0
    port = httpd.server_address[1]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    rng = np.random.default_rng(0)
    img = tuple(cfg.img_size)
    requests = [(rng.normal(size=(b, len(MODALITIES), 1, *img)) * 100).astype(np.float32)
                for b in REQUEST_SIZES]
    answers = []
    try:
        health = _get(port, "/healthz")
        check(health["status"] == "ok" and health["params"] == n_params, f"healthz: {health}")
        forwards_before = len(server.stats["device_ms"])
        fa.flash_attention_qkv.launches = 0
        for i, vols in enumerate(requests):
            answers.append(_post_predict(port, vols) if i == 0 else server.predict(vols))
        launches = fa.flash_attention_qkv.launches
        forwards = len(server.stats["device_ms"]) - forwards_before
        stats = _get(port, "/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    check(not server._dispatcher.is_alive(), "dispatcher thread did not stop")

    for vols, got in zip(requests, answers):
        check(got.shape == (vols.shape[0], cfg.num_classes), f"logits shape {got.shape}")
        check(bool(np.isfinite(got).all()), "non-finite logits")
    check(forwards == len(requests), f"{forwards} bucket forwards for {len(requests)} requests")
    check(launches == 12 * forwards,
          f"kernel launched {launches} times in {forwards} bucket forwards (12 each expected)")

    # the server's answers against a direct forward at the same bucket shape
    model = server.model
    direct_diff = 0.0
    for vols, got in zip(requests, answers):
        bucket = next(b for b in server.buckets if b >= vols.shape[0])
        padded = np.concatenate([vols, np.zeros((bucket - vols.shape[0], *vols.shape[1:]),
                                                np.float32)])
        want = _forward(model, padded)[:vols.shape[0]].cpu().numpy()
        direct_diff = max(direct_diff, float(np.abs(got - want).max()))
    check(direct_diff == 0.0, f"served logits differ from a direct forward by {direct_diff}")

    # kernel path against the plain path (and both against f32) at bucket 8
    b8 = requests[2]
    flash8 = torch.from_numpy(answers[2])
    plain = ModelCross(live_config(use_flash=False), device="cuda")
    plain.load_state_dict(model.state_dict())
    plain8 = _forward(plain, b8).cpu()
    del plain
    cfg32 = live_config(use_flash=False)
    modify_config(cfg32, {"compute_dtype": "float32", "activation_dtype": "float32"})
    ref32 = ModelCross(cfg32, device="cuda")
    ref32.load_state_dict(model.state_dict())
    f32_8 = _forward(ref32, b8).cpu()
    del ref32
    torch.cuda.empty_cache()
    scale = plain8.abs().max().item()
    flash_vs_plain = (flash8 - plain8).abs().max().item() / scale
    check(flash_vs_plain <= SERVE_TOL,
          f"bucket-8 logits: kernel path vs plain path {flash_vs_plain:.3e} > {SERVE_TOL}")

    bucket_ms = {}
    for b in server.buckets:
        x = torch.from_numpy(requests[2][:b]).cuda()
        with torch.inference_mode():
            bucket_ms[b] = cuda_ms(lambda: model(x), runs=5, calls=5)
    profiles = {str(b): _profile(model, torch.from_numpy(requests[2][:b]).cuda())
                for b in (1, 8)}

    result = {"phase": "serve", "model": "ModelCross", "params": n_params,
              "streams": len(MODALITIES), "hidden": cfg.hidden_dim, "heads": cfg.num_heads,
              "tokens": server.model.pos_embedding.shape[1], "dtype": "bfloat16", "gelu": "tanh",
              "requests": len(requests), "request_sizes": list(REQUEST_SIZES),
              "http_requests": 1, "answered": len(answers), "bucket_forwards": forwards,
              "kernel_launches": launches, "launches_per_forward": launches / forwards,
              "served_vs_direct_max_abs": direct_diff,
              "flash_vs_plain_norm": flash_vs_plain, "tol": SERVE_TOL,
              "flash_vs_f32_norm": (flash8 - f32_8).abs().max().item() / f32_8.abs().max().item(),
              "plain_vs_f32_norm": (plain8 - f32_8).abs().max().item() / f32_8.abs().max().item(),
              "logit_max_abs": scale,
              "ms_per_bucket_forward": {str(b): ms for b, ms in bucket_ms.items()},
              "server_device_ms": stats["device_ms"], "server_transfer_ms": stats["transfer_ms"],
              "server_latency_ms": stats["latency_ms"],
              "checkpoint_write_s": write_s, "server_load_s": load_s, "warmup_s": warmup_s,
              "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
              "profile": profiles}
    emit(result)
    return result


def main() -> int:
    t_start = time.perf_counter()
    try:
        device = phase_device()
        phase_build()
        k1 = phase_kernels()
        with tempfile.TemporaryDirectory() as tmp:
            served = phase_serve(Path(tmp))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    emit({"kernels": [{
        **K1, "launches": served["kernel_launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_us"] / 1e3, "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "shape": "B=8 K=16 D=64 N=513 bfloat16"}]})
    print(f"# total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
