"""The port's experiments and evaluate drivers against the JAX package's, on a
synthetic NIfTI cohort in a temporary directory, at tiny width on the CPU:
``train_full`` and ``train_cv`` give the JAX driver's run names and splits
(row for row), one real ``train_full`` run writes the JAX driver's artifacts,
``evaluate`` reads a JAX-written checkpoint and reproduces the JAX
``evaluate``'s metrics, and the mesh flags the port cannot serve here exit
with a message (tests/test_torch_parallel.py runs them over two processes)."""

import time

import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.drivers import evaluate as jeval
from cross_attention_vit_tpu.drivers import experiments as jexp
from cross_attention_vit_tpu_torch.data.nifti import write_volume
from cross_attention_vit_tpu_torch.drivers import evaluate as teval
from cross_attention_vit_tpu_torch.drivers import experiments as texp

MODS = ("DWI", "SWI", "ASL")
TINY = {"hidden_dim": 16, "mlp_dim": 32, "num_heads": 2, "num_multi_blocks": 1,
        "num_self_blocks": 1, "num_layers": 1, "img_size": (16, 16, 8),
        "patch_size": (8, 8, 8), "img_aug": False, "dropout": 0.0}
SETS = [a for k, v in TINY.items() for a in ("--set", f"{k}={v!r}")]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """20 subjects on disk (IDs unpadded in the CSV), plus a blacklisted and
    an indeterminate row."""
    root = tmp_path_factory.mktemp("cli")
    r = np.random.default_rng(0)
    rows = []
    for i in range(1, 21):
        rows.append(f"UCSF-PDGM-{i},{'positive' if r.random() < 0.4 else 'negative'}")
        case = f"UCSF-PDGM-{i:04d}"
        (root / "data" / f"{case}_nifti").mkdir(parents=True)
        for m in MODS:
            write_volume(root / "data" / f"{case}_nifti" / f"{case}_{m}.nii.gz",
                         r.integers(0, 900, size=(18, 16, 9)).astype(np.int16), scl_slope=1.0)
    rows += ["UCSF-PDGM-175,positive", "UCSF-PDGM-21,indeterminate"]
    (root / "labels.csv").write_text("ID,MGMT status\n" + "\n".join(rows) + "\n")
    return root


def _recorded(monkeypatch, module):
    """Replace a driver's _run_one by a recorder of (run name, train IDs,
    val IDs, model class name, seed)."""
    calls = []

    def record(model, cfg, params, train_df, val_df, **kw):
        calls.append((kw["run_name"], list(train_df["ID"]), list(val_df["ID"]),
                      getattr(model, "__name__", ""), kw["seed"]))
        return None, [{"train_loss": 0.0}]

    monkeypatch.setattr(module, "_run_one", record)
    return calls


@pytest.mark.parametrize("mode", ["full", "cv"])
def test_run_names_and_splits_match_jax(cohort, monkeypatch, mode):
    jcalls, tcalls = _recorded(monkeypatch, jexp), _recorded(monkeypatch, texp)
    kw = dict(labels_csv=str(cohort / "labels.csv"), folder=str(cohort / "data"),
              out_dir=str(cohort / "unused"), only_available=True, verbose=False)
    if mode == "full":
        jres = jexp.train_full(test_seeds=(2004, 4444), **kw)
        tres = texp.train_full(test_seeds=(2004, 4444), device="cpu", **kw)
    else:
        jres = jexp.train_cv(cv_seeds=(6253,), k=3, **kw)
        tres = texp.train_cv(cv_seeds=(6253,), k=3, device="cpu", **kw)
    assert list(tres) == list(jres) and len(tcalls) == len(jcalls) > 0
    for t, j in zip(tcalls, jcalls):
        assert t[:3] == j[:3] and t[4] == j[4]
        assert t[3] == {"model_cross": "ModelCross", "model_vit": "ModelVIT"}[j[3].split(".")[-1]]


@pytest.mark.parametrize("model", ["cross", "vit"])
def test_cli_sets_reach_the_model(cohort, monkeypatch, model):
    """``--set dropout_bits=16 --set remat=True --set remat_policy=...``
    through the experiments CLI: the model the run builds draws 16-bit masks
    and rematerialises under that policy (JAX's CLI applies the same fields
    through ``apply_config_knobs`` and ``remat_wrap``)."""
    seen = []

    def build(model_cls, cfg, params, train_df, val_df, **kw):
        seen.append(model_cls(cfg, device="cpu").opts)
        return None, [{"train_loss": 0.0}]

    monkeypatch.setattr(texp, "_run_one", build)
    texp.main(["--model", model, "--grid-index", "0", "--seeds", "2004", "--epochs", "1",
               "--only-available", "--labels", str(cohort / "labels.csv"), "--data",
               str(cohort / "data"), "--out", str(cohort / "unused"), *SETS,
               "--set", "dropout_bits=16", "--set", "remat=True",
               "--set", "remat_policy='save_attn_masks'"], device="cpu")
    assert len(seen) == 1
    assert seen[0].dropout_bits == 16
    assert seen[0].remat == ("attn_out", "dropout_mask")


@pytest.fixture(scope="module")
def trained(cohort):
    """One real run of each driver (grid point 0 of the ModelCross list, one
    epoch, tiny width) into its own directory."""
    args = ["--model", "cross", "--grid-index", "0", "--seeds", "2004", "--batch-size", "4",
            "--epochs", "1", "--only-available", "--labels", str(cohort / "labels.csv"),
            "--data", str(cohort / "data"), *SETS]
    jres = jexp.main([*args, "--out", str(cohort / "jax"), "--dp", "0", "--no-compile-cache"])
    tres = texp.main([*args, "--out", str(cohort / "port")], device="cpu")
    return jres, tres


def _artifacts(out):
    """Run artifacts by relative path, with the TensorBoard files' time and
    host stripped and the decoded-volume cache left out."""
    names = set()
    for p in out.rglob("*"):
        if p.is_file() and "vol_cache" not in p.parts:
            rel = str(p.relative_to(out))
            names.add(rel.split("events.out.tfevents")[0] + "events" if "tfevents" in rel else rel)
    return names


def test_train_full_writes_the_jax_artifacts(cohort, trained):
    jres, tres = trained
    assert list(tres) == list(jres) == ["test_200_0_0_0"]
    assert len(tres["test_200_0_0_0"]) == 1
    assert set(tres["test_200_0_0_0"][0]) == set(jres["test_200_0_0_0"][0])
    port, jax_ = _artifacts(cohort / "port"), _artifacts(cohort / "jax")
    # the top-k checkpoint's name carries the run's val_loss: same pattern
    strip = {n if not n.startswith("checkpoints/cross/epoch=") else "ckpt" for n in port}
    assert strip == {n if not n.startswith("checkpoints/cross/epoch=") else "ckpt" for n in jax_}
    assert "latest/test_200_0_0_0/step=4.npz" in port
    assert sorted(p.name for p in (cohort / "port" / "vol_cache").iterdir()) == \
        sorted(p.name for p in (cohort / "jax" / "vol_cache").iterdir())


def test_evaluate_reads_a_jax_checkpoint(cohort, trained):
    ckpt = next((cohort / "jax" / "checkpoints" / "cross").glob("epoch=*.npz"))
    args = ["--checkpoint", str(ckpt), "--model", "cross", "--labels",
            str(cohort / "labels.csv"), "--data", str(cohort / "data"), "--only-available",
            "--batch-size", "4"]
    want = jeval.main(args)
    got = teval.main(args, device="cpu")
    assert set(got) == set(want) and got["n"] == want["n"] == 20
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    # and the port's own full-state checkpoint
    own = next((cohort / "port" / "checkpoints" / "cross").glob("epoch=*.npz"))
    assert teval.main([*args[:1], str(own), *args[2:]], device="cpu")["n"] == 20


@pytest.fixture(scope="module")
def trained_vit(cohort):
    """One JAX run of the ModelVIT grid (point 1: SWI and DWI, augmentation
    on), one epoch, tiny width."""
    args = ["--model", "vit", "--grid-index", "1", "--seeds", "2004", "--batch-size", "4",
            "--epochs", "1", "--only-available", "--labels", str(cohort / "labels.csv"),
            "--data", str(cohort / "data"), *SETS]
    return jexp.main([*args, "--out", str(cohort / "jax_vit"), "--dp", "0",
                      "--no-compile-cache"])


def test_evaluate_reads_a_jax_vit_checkpoint(cohort, trained_vit):
    """``evaluate --model vit`` on a JAX-written ModelVIT checkpoint: the JAX
    ``evaluate``'s metrics within 1e-6."""
    ckpt = next((cohort / "jax_vit" / "checkpoints" / "cross").glob("epoch=*.npz"))
    args = ["--checkpoint", str(ckpt), "--model", "vit", "--labels",
            str(cohort / "labels.csv"), "--data", str(cohort / "data"), "--only-available",
            "--batch-size", "4", "--img-types", "SWI", "DWI"]
    want = jeval.main(args)
    got = teval.main(args, device="cpu")
    assert set(got) == set(want) and got["n"] == want["n"] == 20
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


# the flags of each case, what each must raise and with which words
_MESH_FLAG_CASES = {
    # data parallelism needs a process group of that size
    "--dp": (["--dp", "2"], SystemExit, "world size"),
    # tensor parallelism needs a process group of data × model
    "--tp": (["--tp", "2"], SystemExit, "world size 2"),
    # sequence and expert parallelism need a process group of data × expert × seq
    "--sp": (["--sp", "2"], SystemExit, "world size 2"),
    "--ep": (["--ep", "2", "--set", "moe_experts=4"], SystemExit, "world size 2"),
    "--sp --dp 0": (["--sp", "2", "--dp", "0"], SystemExit, "require a mesh"),
    "--fsdp": (["--fsdp", "--dp", "0"], SystemExit, "requires a mesh"),
    # nothing listens on port 1: the rendezvous gives up within its timeout
    "--coordinator": (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
                       "--process-id", "1", "--dist-timeout", "2"], RuntimeError, "127.0.0.1"),
}


@pytest.mark.parametrize("flags", [["--dp"], ["--tp"], ["--sp"], ["--fsdp"], ["--coordinator"],
                                   ["--ep"], ["--sp --dp 0"]])
def test_unported_mesh_flags_exit(flags):
    """The mesh flags that still exit, and the two that now start work but
    cannot finish it here."""
    argv, error, words = _MESH_FLAG_CASES[flags[0]]
    t0 = time.perf_counter()
    with pytest.raises(error, match=words):
        texp.main(["--epochs", "1", *argv], device="cpu")
    assert time.perf_counter() - t0 < 30
    assert not torch.distributed.is_initialized()


def test_evaluate_mesh_flag_exits():
    """A model axis is ported (tests/test_torch_sharded_serving.py); without a
    process group the mesh flag exits naming multihost_init."""
    with pytest.raises(SystemExit, match="multihost_init"):
        teval.main(["--checkpoint", "x.npz", "--mesh", "data=1,model=2"], device="cpu")
