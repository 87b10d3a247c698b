"""The MViTv2 cell (``mvitv2s.train.b64``, configuration ``mvitv2_s.k400``,
family ``MViTv2``) as new files beside the harness:

* the frozen counts hold the hand figures (128.3 GFLOP a clip, 64.2 G
  multiply-adds; 34.54 M parameters; sixteen pooling-attention calls a
  forward at the blocks' shapes);
* the cell at a tiny size runs through ``portbench.run --device cpu`` to
  correct in float32, where the port's plain path and the reference
  compute the same step, dropout and drop path included;
* the float8 control departs from the reference by at least three times
  the program's median-leaf gradient difference; on the card, at the
  cell's own size, it fails one of the cell's limits;
* the five readers read the profile's K10 kernels, pool convolutions and
  spans, and nothing where there are none."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, harness
from portbench.counts import attention, mvit
from portbench.trace import Profile, kernel_class

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
CELL = "mvitv2s.train.b64"
TINY = {"img_size": [4, 32, 32], "embed_dim": 16, "depth": 4, "dim_mul_blocks": [1, 3],
        "pool_kv_stride_adaptive": [1, 4, 4], "num_classes": 5}
TINY32 = {**TINY, "compute_dtype": "float32", "activation_dtype": "float32",
          "augment_dtype": "float32"}
CPU = torch.device("cpu")


def _cfg() -> dict:
    return json.loads((ROOT / "configs" / "mvitv2_s.k400.json").read_text())["config"]


def test_counts_hold_the_hand_figures():
    cfg = _cfg()
    fwd = mvit.forward_flops(cfg, 1)
    assert fwd == 128_315_649_024 and mvit.forward_flops(cfg, 64) == 64 * fwd
    calls = mvit.pool_attention_calls(cfg, 64)
    assert calls == [(64, 25088, 392, 96, 24), (128, 6272, 1568, 96, 40),
                     (128, 6272, 392, 96, 24), (256, 1568, 1568, 96, 40)] + \
        [(256, 1568, 392, 96, 24)] * 10 + [(512, 392, 1568, 96, 40), (512, 392, 392, 96, 24)]
    attn = sum(mvit.fwd_flops(*c) for c in mvit.pool_attention_calls(cfg, 1))
    assert round(attn / fwd, 3) == 0.224
    # the forward of blocks 0-3 and 14 is bound by its products, of the
    # stage-3 blocks (Nq = 1568, Nk = 392) and the last by its bytes
    bound = [attention.least_seconds(mvit.fwd_flops(*c), mvit.fwd_bytes(*c), 989.4e12,
                                     3.35e12)[1] for c in calls]
    assert bound == ["operations"] * 4 + ["bytes"] * 10 + ["operations", "bytes"]
    shapes = harness.family("MViTv2").reference.shapes(cfg)
    assert sum(math.prod(s) for s in shapes.values()) == 34_537_648


def test_the_family_files_expose_the_kernels_counters_and_shapes():
    fam = harness.load_cell(CELL).family
    assert fam.name == "MViTv2" and fam.program.attention_shape(_cfg(), 64) is None
    assert sorted(fam.program.counters()) == ["mvit_pool_calls", "pool_attention_bwd_calls",
                                              "pool_attention_fwd_calls"]
    assert fam.program.model_class().__name__ == "MViTv2"
    assert len([n for n in fam.reference.shapes(_cfg()) if n.endswith("rel_pos_t")]) == 16


def test_the_kernels_names_fall_in_no_frozen_class():
    for name in ("mvit_attention_fwd_kernel", "mvit_attention_bwd_dq_kernel",
                 "mvit_attention_bwd_dkdv_kernel"):
        assert kernel_class(name) == "other", name


def _run(seed: int, overrides: dict) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", CELL, "--seed", str(seed),
           "--seconds", "1", "--trace", "0", "--device", "cpu", "--overrides",
           json.dumps(overrides)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_cell_reads_correct_through_run_on_the_cpu():
    out = _run(4_000_000_037, TINY32)
    assert out["correct"] and out["failed"] == 0
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert out["checks"]["loss_gap"]["value"] < 1e-5
    assert out["checks"]["grad_gap"]["value"] < 1e-4
    assert out["checks"]["update_gap"]["value"] < 1e-3
    assert out["checks"]["grad_diff"]["value"] < 1e-4


def test_control_in_float8_reads_far_above_the_program():
    cell = harness.load_cell(CELL, TINY)
    cell.workload["batch_per_card"] = 4
    program = harness.Program(cell, 1234, CPU)
    got = program.checked_steps()
    ref = harness.reference_readings(cell, 1234, CPU)
    ctl = harness.reference_readings(cell, 1234, CPU, control=True)
    inf = dict.fromkeys(("loss_gap", "grad_gap", "update_gap", "grad_diff"), float("inf"))
    mine = compare.checks(got["losses"], [got], ref, inf)
    control = compare.checks(ctl["losses"], [ctl], ref, inf)
    assert control["grad_diff"]["value"] >= 3.0 * mine["grad_diff"]["value"]


@pytest.mark.card
def test_control_fails_the_cells_limits_on_the_card():
    """At the cell's own size on the card, on three seeds, the control fails
    at least one of the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.load_cell(CELL)
    dev = torch.device("cuda")
    for seed in (11, 12, 13):
        ref = harness.reference_readings(spec, seed, dev)
        ctl = harness.reference_readings(spec, seed, dev, control=True)
        checks = compare.checks(ctl["losses"], [ctl], ref, spec.workload["limits"])
        assert any(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.card
def test_a_step_of_the_cell_launches_sixteen_k10_calls_each_way_on_the_card():
    """The cell's program, as the harness drives it: each train step makes
    one K10 forward and one backward a block (16 each) and three pools a
    block (48), by the family's counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(CELL)
    cell.workload["batch_per_card"] = 4
    program = harness.Program(cell, 31, torch.device("cuda"))
    program.step()
    before = cell.family.program.counters()
    program.step()
    torch.cuda.synchronize()
    after = cell.family.program.counters()
    assert {k: after[k] - before[k] for k in after} == {
        "pool_attention_fwd_calls": 16, "pool_attention_bwd_calls": 16, "mvit_pool_calls": 48}


# --- the readers ----------------------------------------------------------------

class _Ctx:
    def __init__(self, profile: Profile, counters: dict):
        self.profile, self.counters = profile, counters
        self.cell = harness.load_cell(CELL)
        self.counts = attention
        self.peak_flops, self.peak_bytes_s = 989.4e12, 3.35e12


def _profile(names, durations, host=()) -> Profile:
    starts = np.cumsum([0.0] + list(durations[:-1])) + np.arange(len(durations)) * 1e-4
    prof = Profile(steps=3, wall_s=1.0, names=list(names), starts=starts,
                   ends=starts + np.array(durations))
    if host:
        prof.host_names = [h[0] for h in host]
        prof.host_starts = np.array([h[1] for h in host])
        prof.host_ends = np.array([h[2] for h in host])
    return prof


def test_the_readers_read_the_k10_kernels_pools_and_spans():
    fwd, bwd, pool = 0.060, 0.150, 0.030
    prof = _profile(["mvit_attention_fwd_kernel<1>", "mvit_attention_bwd_dkdv_kernel",
                     "void at::native::conv_depthwise3d_cuda_kernel<c10::BFloat16, float, 3, 3, 3>",
                     "sm80_xmma_fprop_implicit_gemm_g1_", "cudnn::nhwcToNchwKernel<bf16>",
                     "nvjet_gemm"],
                    [fwd, bwd, pool, 0.02, 0.005, 0.01], host=[("mvit:pool_attention", 0.0, 0.3)])
    ctx = _Ctx(prof, {"pool_attention_fwd_calls": 48, "pool_attention_bwd_calls": 48})
    shapes = mvit.pool_attention_calls(ctx.cell.cfg, 64)
    least = sum(attention.least_seconds(mvit.fwd_flops(*s), mvit.fwd_bytes(*s), 989.4e12,
                                        3.35e12)[0] for s in shapes) * 3
    assert harness.reader("pool_attn_fwd_roofline").read(ctx) == pytest.approx(
        100 * least / fwd)
    assert 0 < harness.reader("pool_attn_bwd_roofline").read(ctx) <= 100
    assert harness.reader("pool_attn_ms.train").read(ctx) == pytest.approx(1e3 * (fwd + bwd) / 3)
    # the stem's dense convolution (cuDNN's ``_g1_`` implicit GEMM) and cuDNN's
    # layout transforms are not a pool's
    assert harness.reader("pool_conv_ms.train").read(ctx) == pytest.approx(1e3 * pool / 3)
    # the span covers [0, 0.3): the five gaps of 1e-4 s between the six operations
    assert harness.reader("pool_idle_ms.train").read(ctx) == pytest.approx(1e3 * 5e-4 / 3)


def test_the_readers_read_nothing_without_the_kernels():
    ctx = _Ctx(_profile(["nvjet_gemm"], [0.01]), {})
    for name in ("pool_attn_fwd_roofline", "pool_attn_bwd_roofline", "pool_attn_ms.train",
                 "pool_conv_ms.train", "pool_idle_ms.train"):
        assert harness.reader(name).read(ctx) is None, name
