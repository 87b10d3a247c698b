"""Model families found by name: a configuration's ``family`` resolves to
``families/<family>.py`` and ``reference/families/<family>.py``.

* For both live configurations, the layout, the weights from a seed, the
  reference's logits and first step, the frozen counts, the attention shape
  and the counter names come out as they did before the families had files
  of their own (literals taken from that tree, on the CPU).
* A family added as new files alone (an alias of ModelVIT) runs a tiny cell
  through the program and the reference to correct; the same alias with
  its reference's head biases dropped reads not correct.
* An unknown family names both of its missing files; no reference family
  imports the port or JAX."""

from __future__ import annotations

import hashlib
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import compare, harness, inputs
from portbench.counts import flops
from portbench.reference import train as ref_train

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
TINY = {"hidden_dim": 32, "mlp_dim": 64, "num_heads": 4, "img_size": [16, 16, 8],
        "patch_size": [8, 8, 4]}
TINY32 = {**TINY, "compute_dtype": "float32", "activation_dtype": "float32",
          "augment_dtype": "float32"}
FORBIDDEN = {"jax", "jaxlib", "flax", "cross_attention_vit_tpu", "cross_attention_vit_tpu_torch"}
CPU = torch.device("cpu")

# name → shape lists as sha256 of json.dumps([[name, list(shape)], ...])
FULL = {
    "cross.train.gb64": dict(
        family="ModelCross", leaves=250, params=241_945_606,
        sha="d834056d2833f700d36b711a782900129865bc463ffeb09162a05b0eee7c64aa",
        fwd1=187_372_265_472, fwd64=11_991_824_990_208, step64=35_975_474_970_624,
        gflop=187.37, attention=(64, 16, 513, 64)),
    "vit2.train.gb64": dict(
        family="ModelVIT", leaves=54, params=57_730_050,
        sha="ab4638f8133a358a611415c1de0b5eaa34d0c173110af414906a95a275cb1262",
        fwd1=124_696_690_688, fwd64=7_980_588_204_032, step64=23_941_764_612_096,
        gflop=124.70, attention=(64, 16, 1025, 64)),
}
# at TINY; weights from seed 2**33 + 5 as sha256 of their float32 bytes in layout
# order; logits of 3 rows (volumes from torch seed 7, masks from torch seed 11)
SMALL = {
    "cross.train.gb64": dict(
        leaves=250, params=168_102,
        sha="24ea9619129616e8a086b1b92c953ec4cd2e0120d7933ad55d743cb91bfe19d1",
        fwd1=2_601_984, step64=499_580_928, attention=(64, 4, 9, 8),
        weights="38bfbb026379509b76db70e3367ad062b804de1745c4bb64e8e40242270a70fa",
        logits=[[0.2935226857662201, -0.056553442031145096],
                [0.1101175919175148, -0.07681036740541458],
                [0.9109341502189636, -0.6074836254119873]],
        losses=[0.9037919640541077, 0.744931697845459, 0.8601852655410767],
        grad_norm_sum=85.59537249805555, change_norm_sum=0.9103155845541551),
    "vit2.train.gb64": dict(
        leaves=54, params=44_898,
        sha="4c4b29da54a0a74fcebf3e32924f6423c4f27ce1b4d12c07167cd0347230dc50",
        fwd1=1_528_576, step64=293_486_592, attention=(64, 4, 17, 8),
        weights="f932e622d3b587f5ff70a4151a7f2a74b34d818f093c9d488219ec6efd887f89",
        logits=[[-0.15662842988967896, 0.0],
                [-0.27368131279945374, -0.4169997274875641],
                [0.24346061050891876, -0.34687918424606323]],
        losses=[0.4050004482269287, 0.5221372842788696, 1.1648573875427246],
        grad_norm_sum=41.3123464807868, change_norm_sum=0.20293633930850774),
}


def _digest(shapes: dict) -> str:
    return hashlib.sha256(json.dumps([[k, list(v)] for k, v in shapes.items()]).encode()
                          ).hexdigest()


# --- the live configurations as before ----------------------------------------

@pytest.mark.parametrize("cell", sorted(FULL))
def test_full_size_layout_counts_and_counters_are_as_before(cell):
    want, c = FULL[cell], harness.load_cell(cell)
    fam = c.family
    assert fam.name == want["family"]
    shapes = fam.reference.shapes(c.cfg)
    assert len(shapes) == want["leaves"] and _digest(shapes) == want["sha"]
    assert sum(math.prod(s) for s in shapes.values()) == want["params"]
    assert list(shapes)[:4] == ["pos_embedding", "cls_token", "patch_to_embedding.weight",
                                "patch_to_embedding.bias"]
    assert fam.program.forward_flops(c.cfg, 1) == want["fwd1"]
    assert fam.program.forward_flops(c.cfg, 1) / 1e9 == pytest.approx(want["gflop"], abs=0.005)
    assert fam.program.forward_flops(c.cfg, 64) == want["fwd64"]
    assert flops.train_step(fam.program.forward_flops(c.cfg, 64)) == want["step64"]
    assert fam.program.attention_shape(c.cfg, 64) == want["attention"]
    assert sorted(fam.program.counters()) == ["k1_calls", "k2_calls"]
    assert fam.program.model_class().__name__ == want["family"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_tiny_weights_logits_and_counts_are_as_before(cell):
    want, c = SMALL[cell], harness.load_cell(cell, TINY)
    fam = c.family
    shapes = fam.reference.shapes(c.cfg)
    assert len(shapes) == want["leaves"] and _digest(shapes) == want["sha"]
    assert sum(math.prod(s) for s in shapes.values()) == want["params"]
    assert fam.program.forward_flops(c.cfg, 1) == want["fwd1"]
    assert flops.train_step(fam.program.forward_flops(c.cfg, 64)) == want["step64"]
    assert fam.program.attention_shape(c.cfg, 64) == want["attention"]
    w = fam.weights(c.cfg, 2 ** 33 + 5, CPU)
    assert list(w) == list(shapes)
    got = hashlib.sha256(torch.cat([w[k].flatten() for k in shapes]).numpy().tobytes())
    assert got.hexdigest() == want["weights"]
    img = torch.randn((3, c.cfg["num_modalities"], 1, *c.cfg["img_size"]),
                      generator=torch.Generator().manual_seed(7))
    masks = ref_train.Masks(torch.Generator().manual_seed(11), float(c.cfg["dropout"]), 3)
    with torch.no_grad():
        logits = fam.reference.logits(w, c.cfg, img, masks, lambda x: x)
    assert logits.flatten().tolist() == pytest.approx(sum(want["logits"], []), rel=1e-5,
                                                      abs=1e-7)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_references_checked_steps_are_as_before(cell):
    """Three reference steps at TINY, 4 rows, seed 2**33 + 9: augmentation,
    dropout, forward, backward and Adam through the family's logits."""
    want, c = SMALL[cell], harness.load_cell(cell, TINY)
    c.workload["batch_per_card"] = 4
    ref = harness.reference_readings(c, 2 ** 33 + 9, CPU)
    assert ref["losses"] == pytest.approx(want["losses"], rel=1e-5)
    assert sum(ref["grad_norms"].values()) == pytest.approx(want["grad_norm_sum"], rel=1e-5)
    assert sum(ref["change_norms"].values()) == pytest.approx(want["change_norm_sum"], rel=1e-3)


# --- a family added as files ----------------------------------------------------

PROGRAM_ALIAS = "from portbench.families.ModelVIT import *  # noqa: F401,F403\n"
REFERENCE_ALIAS = "from portbench.reference.families.ModelVIT import *  # noqa: F401,F403\n"
NO_HEAD_BIAS = REFERENCE_ALIAS + '''from portbench.reference.families import ModelVIT as _vit

HEAD_BIASES = ("mlp_head.1.bias", "mlp_head.4.bias")


def logits(w, cfg, img, masks, q):
    return _vit.logits({**w, **{k: w[k] * 0 for k in HEAD_BIASES}}, cfg, img, masks, q)
'''


def _add_family(tmp_path: Path, monkeypatch, name: str, program: str, reference: str) -> str:
    """A copy of the benchmark with a family, a configuration of it and a
    cell on it added as new files; the harness reads the copy.  Returns the
    cell's name."""
    here = tmp_path / "portbench"
    shutil.copytree(ROOT, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    conf = json.loads((here / "configs" / "model_vit.live2.json").read_text())
    conf["family"] = name
    spec = json.loads((here / "workloads" / "vit2.train.gb64.json").read_text())
    spec.update(config=f"{name}.tiny", batch_per_card=8, why="a family added as files")
    new = {here / "families" / f"{name}.py": program,
           here / "reference" / "families" / f"{name}.py": reference,
           here / "configs" / f"{name}.tiny.json": json.dumps(conf),
           here / "workloads" / f"{name}.train.json": json.dumps(spec)}
    for path, text in new.items():
        assert not path.exists()
        path.write_text(text)
    monkeypatch.setattr(harness, "HERE", here)
    return f"{name}.train"


def _checks(cell_name: str, seed: int) -> dict:
    cell = harness.load_cell(cell_name, TINY32)
    program = harness.Program(cell, seed, CPU)
    got = program.checked_steps()
    ref = harness.reference_readings(cell, seed, CPU)
    return compare.checks(got["losses"], [got], ref, cell.workload["limits"])


def test_a_family_added_as_files_runs_to_correct(tmp_path, monkeypatch):
    cell = _add_family(tmp_path, monkeypatch, "VitAlias", PROGRAM_ALIAS, REFERENCE_ALIAS)
    assert harness.load_cell(cell).family.name == "VitAlias"
    checks = _checks(cell, 2024)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks


def test_the_alias_without_its_references_head_biases_reads_not_correct(tmp_path, monkeypatch):
    cell = _add_family(tmp_path, monkeypatch, "VitAliasNoHeadBias", PROGRAM_ALIAS, NO_HEAD_BIAS)
    checks = _checks(cell, 2024)
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"], checks
    assert checks["grad_gap"]["leaf"].startswith("mlp_head.")


def test_an_unknown_family_names_both_missing_files(tmp_path, monkeypatch):
    here = tmp_path / "portbench"
    shutil.copytree(ROOT, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    conf = json.loads((here / "configs" / "model_vit.live2.json").read_text())
    conf["family"] = "NoSuchFamily"
    (here / "configs" / "model_vit.live2.json").write_text(json.dumps(conf))
    monkeypatch.setattr(harness, "HERE", here)
    with pytest.raises(FileNotFoundError) as err:
        harness.load_cell("vit2.train.gb64")
    assert str(here / "families" / "NoSuchFamily.py") in str(err.value)
    assert str(here / "reference" / "families" / "NoSuchFamily.py") in str(err.value)


def test_a_family_file_without_a_function_is_refused(tmp_path, monkeypatch):
    _add_family(tmp_path, monkeypatch, "Headless", PROGRAM_ALIAS,
                "from portbench.reference.families.ModelVIT import shapes  # noqa: F401\n")
    with pytest.raises(AttributeError, match="logits"):
        harness.family("Headless")


# --- what the weights are made of -------------------------------------------------

def test_a_family_may_give_its_own_weight_kinds():
    shapes = {"embed.weight": (8, 4, 2, 2, 2), "table": (13, 3), "x.weight": (5, 6)}

    def kind(name, shape):
        return {"embed.weight": "xavier", "table": "normal"}.get(name) or inputs.weight_kind(
            name, shape)

    plain = inputs.make_weights(shapes, 3, CPU)
    own = inputs.make_weights(shapes, 3, CPU, kind)
    assert (plain["embed.weight"] == 1).all() and (own["embed.weight"] != 1).all()
    fan_in, fan_out = torch.nn.init._calculate_fan_in_and_fan_out(torch.empty(8, 4, 2, 2, 2))
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    assert own["embed.weight"].abs().max() <= bound
    assert own["embed.weight"].abs().max() > 0.9 * bound
    assert 0.005 < float(own["table"].std()) < 0.05
    assert float(plain["table"].abs().max()) > 0.1    # Xavier over (13, 3)
    with pytest.raises(ValueError, match="unknown weight kind"):
        inputs.make_weights(shapes, 3, CPU, lambda name, shape: "orthogonal")


# --- boundaries -------------------------------------------------------------------

def _imported_tops(path: Path) -> set[str]:
    import ast

    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted((ROOT / "reference" / "families").glob("*.py")),
                         ids=lambda p: p.name)
def test_no_reference_family_imports_the_port_or_jax(path):
    assert not _imported_tops(path) & FORBIDDEN, path


def test_loading_every_family_loads_nothing_of_the_port():
    names = sorted(p.stem for p in (ROOT / "families").glob("*.py") if p.stem != "__init__")
    assert names == sorted(p.stem for p in (ROOT / "reference" / "families").glob("*.py")
                           if p.stem != "__init__")
    code = ("import sys; from portbench import harness; "
            f"[harness.family(n) for n in {names!r}]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert not set(json.loads(proc.stdout.replace("'", '"'))) & FORBIDDEN
