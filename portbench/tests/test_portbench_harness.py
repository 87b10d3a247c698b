"""CPU tests of the harness: names resolve, a new cell and a new metric are
found by name alone, the result line's keys, the reference against the
port's plain path at a tiny geometry, the planted faults and the control
read as not correct, and the import boundaries.

Runs skip the harness's look for a card with ``--device cpu`` and shrink
the configuration with ``--overrides``; the step, the window and the
comparison are the real ones."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import compare, harness

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
TINY = {"hidden_dim": 32, "mlp_dim": 64, "num_heads": 4, "img_size": [16, 16, 8],
        "patch_size": [8, 8, 4]}
TINY32 = {**TINY, "compute_dtype": "float32", "activation_dtype": "float32",
          "augment_dtype": "float32"}
ONE_CARD = ["cross.train.gb64", "vit2.train.gb64"]
FORBIDDEN = {"jax", "jaxlib", "flax", "cross_attention_vit_tpu"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(cell: str, seed: int, overrides: dict, trace: int = 0, fault: str = "",
         seconds: float = 1.0) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace), "--device", "cpu",
           "--overrides", json.dumps(overrides)]
    if fault:
        cmd += ["--fault", fault]
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)


def _last_line(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# --- names ----------------------------------------------------------------------

def test_every_name_in_the_benchmark_is_found():
    bench = harness.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config_name == w["config"] and cell.world == w["chips"]
        assert cell.workload["why"] == w["why"]
        assert (REPO / configs[w["config"]]["file"]) == ROOT / "configs" / f"{w['config']}.json"
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
        assert all(m["moves"] in {e["name"] for e in harness.metrics_for(w, bench)[0]}
                   for w in m["workloads"])


@pytest.mark.parametrize("path", sorted((ROOT / "metrics").glob("*.py")), ids=lambda p: p.stem)
def test_every_reader_file_has_a_reader(path):
    assert callable(harness.reader(path.stem).read)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        e2e, layers = harness.metrics_for(w["name"], bench)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layers


def test_a_new_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    here = tmp_path / "portbench"
    shutil.copytree(ROOT, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((here / "workloads" / "vit2.train.gb64.json").read_text())
    spec.update(batch_per_card=32, why="a cell added as a file")
    (here / "workloads" / "vit2.train.gb32.json").write_text(json.dumps(spec))
    (here / "metrics" / "steps_profiled.train.py").write_text(
        "def read(ctx):\n    return ctx.profile.steps\n")
    monkeypatch.setattr(harness, "HERE", here)
    cell = harness.load_cell("vit2.train.gb32")
    assert cell.batch == 32 and cell.family.name == "ModelVIT"
    bench = harness.benchmark()
    bench["per_layer"].append({"name": "steps_profiled.train", "unit": "steps",
                               "better": "higher", "source": "device_trace", "layer": "x",
                               "moves": "train_samples_per_s",
                               "workloads": ["vit2.train.gb32"]})
    bench["end_to_end"][0]["workloads"].append("vit2.train.gb32")
    _, layers = harness.metrics_for("vit2.train.gb32", bench)
    assert [m["name"] for m in layers] == ["steps_profiled.train"]
    ctx = type("Ctx", (), {"profile": type("P", (), {"steps": 3})()})()
    assert harness.reader("steps_profiled.train").read(ctx) == 3


# --- runs -------------------------------------------------------------------------

def test_the_last_line_has_the_contracts_keys_in_order():
    proc = _run("cross.train.gb64", 2 ** 33 + 17, TINY)
    out = _last_line(proc)
    assert list(out) == RESULT_KEYS
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "update_gap", "grad_diff"}
    tail = proc.stderr.strip().splitlines()[-4:]
    assert [line.split()[0] for line in tail] == list(out["checks"])
    assert all(" limit " in line for line in tail)


@pytest.mark.parametrize("cell", ONE_CARD)
def test_reference_follows_the_ports_plain_path_in_float32(cell):
    """At float32 the port's CPU path and the reference compute the same
    step: augmentation, dropout masks, forward, loss, backward and Adam."""
    out = _last_line(_run(cell, 4_000_000_000 + len(cell), TINY32))
    assert out["correct"]
    assert out["checks"]["loss_gap"]["value"] < 1e-5
    assert out["checks"]["grad_gap"]["value"] < 1e-4
    assert out["checks"]["update_gap"]["value"] < 1e-3
    assert out["checks"]["grad_diff"]["value"] < 1e-4


def test_mesh_cell_over_four_gloo_ranks():
    """``cross.train.ddp4`` is not in BENCHMARK.json (its rate spread too
    widely on the card to bound); its files keep the four-rank path run."""
    out = _last_line(_run("cross.train.ddp4", 77, TINY32))
    assert out["correct"] and out["device"]["count"] == 4
    assert "setup_s" in out["metrics"]
    assert out["checks"]["grad_gap"]["value"] < 1e-4


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_reads_not_correct(fault):
    out = _last_line(_run("cross.train.gb64", 91, TINY32, fault=fault))
    assert out["correct"] is False


def test_a_dropped_gradient_exchange_reads_not_correct():
    out = _last_line(_run("cross.train.ddp4", 93, TINY32, fault="no_exchange"))
    assert out["correct"] is False
    assert out["checks"]["grad_gap"]["value"] > out["checks"]["grad_gap"]["limit"]


def test_a_traced_run_without_device_operations_prints_no_result():
    proc = _run("cross.train.gb64", 5, TINY, trace=1)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "recorded no device operation" in proc.stderr


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "cross.train.gb64", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_without_the_port_the_benchmark_fails(tmp_path):
    shutil.copytree(ROOT, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "cross.train.gb64", "--seed", "1", "--seconds", "1", "--trace", "0",
                           "--device", "cpu", "--overrides", json.dumps(TINY)],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


# --- the control ------------------------------------------------------------------

def _readings(cell_name: str, seed: int, overrides: dict) -> tuple[dict, dict]:
    cell = harness.load_cell(cell_name, overrides)
    dev = torch.device("cpu")
    program = harness.Program(cell, seed, dev)
    got = program.checked_steps()
    ref = harness.reference_readings(cell, seed, dev)
    ctl = harness.reference_readings(cell, seed, dev, control=True)
    inf = dict.fromkeys(("loss_gap", "grad_gap", "update_gap", "grad_diff"), float("inf"))
    return (compare.checks(got["losses"], [got], ref, inf),
            compare.checks(ctl["losses"], [ctl], ref, inf))


@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_in_float8_reads_far_above_the_program(cell):
    """At a tiny size on the CPU, the reference in float8 departs from the
    reference by three times the bfloat16 program's median-leaf gradient
    difference or more."""
    program, control = _readings(cell, 1234, TINY)
    assert control["grad_diff"]["value"] >= 3.0 * program["grad_diff"]["value"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_fails_the_cells_limits_on_the_card(cell):
    """At the cell's own size on the card, on three seeds, the control fails
    at least one of the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.load_cell(cell)
    dev = torch.device("cuda")
    for seed in (11, 12, 13):
        ref = harness.reference_readings(spec, seed, dev)
        ctl = harness.reference_readings(spec, seed, dev, control=True)
        checks = compare.checks(ctl["losses"], [ctl], ref, spec.workload["limits"])
        assert any(c["value"] > c["limit"] for c in checks.values()), checks


# --- boundaries -------------------------------------------------------------------

def _imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        assert not _imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "reference").rglob("*.py"):
        assert "cross_attention_vit_tpu_torch" not in _imported_tops(path), path


def test_loaded_modules_after_importing_the_benchmark():
    code = ("import sys, portbench.run, portbench.calibrate; "
            "import portbench.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    tops = set(json.loads(subprocess.run([sys.executable, "-c", code], cwd=REPO,
                                         capture_output=True, text=True, timeout=300
                                         ).stdout.replace("'", '"')))
    assert not tops & FORBIDDEN
    code = ("import sys, portbench.reference.train, portbench.reference.model; "
            "print([m for m in sys.modules if m.split('.')[0] == "
            "'cross_attention_vit_tpu_torch'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300).stdout.strip()
    assert out == "[]"


def test_worst_leaf_is_measured_against_the_larger_of_its_norm_and_the_median():
    want = {"a": 1.0, "b": 2.0, "c": 3.0, "tiny": 1e-9}
    got = {"a": 1.1, "b": 2.0, "c": 3.0, "tiny": 1e-6}
    gap, leaf = compare._worst(got, want, want)
    assert leaf == "a" and gap == pytest.approx(0.1 / 1.5)
    assert compare.moved_leaves(want) == ["a", "b", "c"]


# --- reading a profile --------------------------------------------------------

def _event(name, start_us, end_us, device, annotation=False):
    from torch.autograd import DeviceType

    tr = type("TR", (), {"start": start_us, "end": end_us})()
    return type("E", (), {"name": name, "time_range": tr, "is_user_annotation": annotation,
                          "device_type": DeviceType.CUDA if device else DeviceType.CPU})()


def test_profile_leaves_out_ranges_annotated_on_the_device():
    from portbench.trace import read_profile

    events = [_event("gemm_kernel", 0, 100, True), _event("ncclDevKernel_AllReduce", 150, 250, True),
              _event("nccl:all_reduce", 100, 400, True, annotation=True),
              _event("DistributedDataParallel.forward", 0, 400, True),
              _event("DistributedDataParallel.forward", 0, 400, False),
              _event("aten::mm", 90, 300, False)]
    prof = read_profile(type("P", (), {"events": lambda self: events})(), steps=1, wall_s=400e-6)
    assert prof.names == ["gemm_kernel", "ncclDevKernel_AllReduce"]
    assert prof.busy_s() == pytest.approx(200e-6)
    assert prof.exposed_s("NCCL collectives") == pytest.approx(100e-6)
    assert prof.idle_gaps() == [["aten::mm", pytest.approx(50e-6)]]
    assert prof.seconds_by_class() == {"GEMM (cuBLAS)": pytest.approx(100e-6),
                                       "NCCL collectives": pytest.approx(100e-6)}
