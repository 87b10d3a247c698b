"""The port's host data path against the JAX package's, on synthetic NIfTI
cohorts written to a temporary directory: label hygiene and the splits
against pandas and sklearn row for row (train_test_split and the k-fold of
``train_cv``), ``BrainDataset`` items, batches and the disk cache bit for
bit, the weighted sampler's draws, the native decoder against the Python
reader, and the prefetch loader (same batches as the JAX loader, bf16
transfer, a batch sharding, an abandoned iteration that does not hang).  Everything compares
exactly: the two packages run the same numpy arithmetic."""

import socket
import threading
import types

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.model_selection import StratifiedKFold
from sklearn.model_selection import train_test_split as sk_split

from cross_attention_vit_tpu.configs import get_mgmt_config as jax_config
from cross_attention_vit_tpu.data import dataset as jds
from cross_attention_vit_tpu.data import labels as jlabels
from cross_attention_vit_tpu.data import loader as jloader
from cross_attention_vit_tpu_torch.configs import get_mgmt_config, modify_config
from cross_attention_vit_tpu_torch.data import dataset as tds
from cross_attention_vit_tpu_torch.data import labels as tlabels
from cross_attention_vit_tpu_torch.data import loader as tloader
from cross_attention_vit_tpu_torch.data import native
from cross_attention_vit_tpu_torch.data.nifti import write_volume

TYPES = ("DWI", "SWI")
IMG = (16, 16, 8)
TARGET = "MGMT status"


def _labels_csv(path, n=14, seed=0):
    """A labels CSV in the UCSF layout: unpadded IDs, blacklisted IDs,
    indeterminate and empty targets, an extra numeric column."""
    r = np.random.default_rng(seed)
    rows = []
    for i in range(1, n + 1):
        rows.append((f"UCSF-PDGM-{i}", ["positive", "negative"][int(r.integers(2))], i * 3))
    rows += [("UCSF-PDGM-138", "positive", 1), ("UCSF-PDGM-2781", "negative", 2),
             ("UCSF-PDGM-77", "indeterminate", 4), ("UCSF-PDGM-78", "", 5),
             ("UCSF-PDGM-79", "NA", 6)]
    path.write_text("ID,MGMT status,Age\n" + "".join(f"{a},{b},{c}\n" for a, b, c in rows))
    return path


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    labels = _labels_csv(root / "labels.csv")
    r = np.random.default_rng(1)
    for i in range(1, 15):
        case = f"UCSF-PDGM-{i:04d}"
        (root / "data" / f"{case}_nifti").mkdir(parents=True)
        for t in TYPES:
            vol = r.integers(-300, 3000, size=(20, 14, 11)).astype(np.int16)
            write_volume(root / "data" / f"{case}_nifti" / f"{case}_{t}.nii.gz", vol,
                         scl_slope=0.5, scl_inter=3.0)
    return root, labels


def _cfgs():
    cfg = get_mgmt_config()
    modify_config(cfg, {"img_size": IMG})
    jcfg = jax_config()
    jcfg.img_size = IMG
    return cfg, jcfg


def test_clean_data_matches_pandas(cohort):
    _, labels = cohort
    want = jlabels.clean_data(jlabels.load_labels(str(labels)), TARGET)
    got = tlabels.clean_data(tlabels.load_labels(labels), TARGET)
    assert list(got["ID"]) == list(want["ID"])
    np.testing.assert_array_equal(got[TARGET], want[TARGET].to_numpy())
    assert got[TARGET].dtype == np.float64
    assert "UCSF-PDGM-0001" in list(got["ID"]) and len(got) == 14


@pytest.mark.parametrize("n,test_size,seed", [(14, 0.15, 2004), (13, 0.18, 2004),
                                              (501, 0.15, 4444), (426, 0.18, 9780),
                                              (7, 0.5, 0)])
def test_split_matches_sklearn(n, test_size, seed):
    df = pd.DataFrame({"ID": [f"s{i}" for i in range(n)], TARGET: np.arange(n) % 2})
    want_rest, want_test = sk_split(df, test_size=test_size, random_state=seed)
    table = tlabels.Table({"ID": df["ID"].to_numpy(), TARGET: df[TARGET].to_numpy()})
    rest, test = tlabels.train_test_split(table, test_size, seed)
    assert list(rest["ID"]) == list(want_rest["ID"])
    assert list(test["ID"]) == list(want_test["ID"])


@pytest.mark.parametrize("n,k,seed", [(20, 5, 6253), (37, 5, 9253), (11, 3, 0)])
def test_stratified_kfold_matches_sklearn(n, k, seed):
    y = (np.random.default_rng(seed % 97).random(n) < 0.4).astype(float)
    want = list(StratifiedKFold(n_splits=k, shuffle=True, random_state=seed)
                .split(np.zeros(n), y))
    got = list(tlabels.stratified_kfold(y, k, seed))
    assert len(got) == len(want)
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


def _datasets(cohort, **kw):
    root, labels = cohort
    cfg, jcfg = _cfgs()
    jdf = jlabels.clean_data(jlabels.load_labels(str(labels)), TARGET)
    tdf = tlabels.clean_data(tlabels.load_labels(labels), TARGET)
    return (tds.BrainDataset(tdf, cfg, types=TYPES, folder=root / "data", **kw),
            jds.BrainDataset(jdf, jcfg, types=TYPES, folder=str(root / "data"), **kw))


@pytest.mark.parametrize("use_native", [False, True])
def test_dataset_items_and_batches_match_jax(cohort, use_native):
    """The port's dataset, with its native decoder or its Python reader,
    against the JAX dataset on JAX's Python reader.  JAX's own native
    decoder is held equal to that reader by tests/test_native.py; it is not
    used here because its build writes the library in place, so xdist
    workers that build it at once can load a half-written file."""
    if use_native and not native.available():
        pytest.skip("the native decoder did not build here (no g++ or libdeflate)")
    port, _ = _datasets(cohort, use_native=use_native, cache=False)
    _, ref = _datasets(cohort, use_native=False, cache=False)
    assert len(port) == len(ref) == 14 and port.use_native == use_native
    for i in (0, 5, 13):
        (a, la), (b, lb) = port[i], ref[i]
        assert a.dtype == np.float32 and a.shape == (2, 1, *IMG) and la == lb
        np.testing.assert_array_equal(a, b)
    ia, la = port.batch([3, 1, 3])
    ib, lb = ref.batch([3, 1, 3])
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(la, lb)
    assert la.dtype == np.int32


def test_disk_cache_matches_jax(cohort, tmp_path):
    port, ref = _datasets(cohort, use_native=False, cache=False)
    port._disk_cache = tmp_path / "port"
    ref._disk_cache = tmp_path / "jax"
    for d in (port._disk_cache, ref._disk_cache):
        d.mkdir()
    first = port.batch([0, 2])
    np.testing.assert_array_equal(first[0], ref.batch([0, 2])[0])
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert not any(n.endswith(".tmp.npy") for n in names)
    for n in names:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n))
    # a second read comes from the cache, not the NIfTI files
    np.testing.assert_array_equal(port.batch([0, 2])[0], first[0])


def test_sampler_draws_match_jax(cohort):
    _, labels = cohort
    jdf = jlabels.clean_data(jlabels.load_labels(str(labels)), TARGET)
    tdf = tlabels.clean_data(tlabels.load_labels(labels), TARGET)
    wt = tds.create_sampler_weights(tdf, TARGET)
    np.testing.assert_array_equal(wt, jds.create_sampler_weights(jdf, TARGET))
    for epoch in (0, 1, 7):
        np.testing.assert_array_equal(
            tds.WeightedRandomSampler(wt, len(tdf), seed=2004).epoch_indices(epoch),
            jds.WeightedRandomSampler(wt, len(jdf), seed=2004).epoch_indices(epoch))


def test_native_decoder_matches_python_reader(cohort):
    if not native.available():
        pytest.skip("the native decoder did not build here (no g++ or libdeflate)")
    from cross_attention_vit_tpu_torch.data.nifti import read_volume_cropped, volume_path

    root, _ = cohort
    paths = [volume_path(root / "data", "UCSF-PDGM-0003", t) for t in TYPES]
    for p in paths:
        np.testing.assert_array_equal(native.decode_crop(p, IMG), read_volume_cropped(p, IMG))
    batch = native.decode_crop_batch(paths, IMG, num_threads=2)
    np.testing.assert_array_equal(batch[1], read_volume_cropped(paths[1], IMG))


@pytest.mark.parametrize("transfer", [None, "bfloat16"])
def test_loader_batches_match_jax(cohort, transfer):
    port, ref = _datasets(cohort, use_native=False)
    order = [4, 0, 9, 3, 12, 1, 7]
    got = list(tloader.PrefetchLoader(port, batch_size=3, transfer_dtype=transfer,
                                      device="cpu")(order))
    want = list(jloader.PrefetchLoader(ref, batch_size=3, transfer_dtype=transfer)(order))
    assert [len(lb) for _, lb in got] == [3, 3, 1]
    for (a, la), (b, lb) in zip(got, want):
        assert a.dtype == (torch.bfloat16 if transfer else torch.float32)
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
        np.testing.assert_array_equal(la.numpy(), np.asarray(lb))
    assert tloader.transfer_dtype_for({"compute_dtype": "bfloat16"}) == "bfloat16"


def test_loader_survives_an_abandoned_iteration(cohort):
    port, _ = _datasets(cohort, use_native=False)
    loader = tloader.PrefetchLoader(port, batch_size=1, prefetch=1, device="cpu")
    before = threading.active_count()
    for _ in loader(range(14)):
        break                          # the producer holds a full queue here
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before
    assert sum(len(lb) for _, lb in loader(range(14))) == 14


def test_loader_rejects_sharding_and_defaults_to_cuda(cohort):
    """A loader with a batch sharding iterates: over a one-process gloo mesh
    its batches are the JAX loader's over a one-device mesh, and a process
    that fed two data shards would pad each odd batch by wrap-around to an
    even size, as the JAX loader does on a two-device mesh."""
    from jax.sharding import Mesh

    import jax
    from cross_attention_vit_tpu.parallel import batch_sharding as jax_batch_sharding
    from cross_attention_vit_tpu_torch.parallel import batch_sharding, make_mesh, multihost_init

    port, ref = _datasets(cohort, use_native=False)
    order = [4, 0, 9, 3, 12, 1, 7]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    multihost_init(addr, 1, 0, device="cpu", timeout_s=30)
    try:
        cases = [(batch_sharding(make_mesh(), 6), 1),
                 (types.SimpleNamespace(batch_divisor=lambda: 2), 2)]
        for sharding, data in cases:
            got = list(tloader.PrefetchLoader(port, batch_size=3, sharding=sharding,
                                              device="cpu")(order))
            mesh = Mesh(np.array(jax.devices()[:data]), ("data",))
            want = list(jloader.PrefetchLoader(ref, batch_size=3,
                                               sharding=jax_batch_sharding(mesh, 6))(order))
            assert [len(lb) for _, lb in got] == [-(-n // data) * data for n in (3, 3, 1)]
            for (a, la), (b, lb) in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                np.testing.assert_array_equal(la.numpy(), np.asarray(lb))
    finally:
        torch.distributed.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tloader.PrefetchLoader(port, batch_size=2)
