"""The port's DICOM path (``data/dicom.py``, ``data/dataset_rsna.py``) and
legacy drivers (``drivers/legacy.py``) against the JAX package's.

* The reader and writer, VOI-LUT windowing, natural sort and the brain crop
  equal JAX's on the same synthetic part-10 files.
* ``RSNADataset`` items equal JAX's bit for bit on the same files, for the
  train (biggest slice) and eval (middle slice) windows, each rotation,
  depth padding and multi-type stacking with the availability filter, at
  the slices' own size (the resize is then the identity in both).  Resized,
  the port's bilinear resize (numpy) and JAX's (OpenCV) agree within 1e-5
  on the [0, 1] slices.
* Tiny ``train_vit3d`` and ``train_rsna`` histories (dropout 0) equal the
  JAX drivers' within 1e-4 from the same weights, and so do train_rsna's
  predictions.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cross_attention_vit_tpu.data import dataset_rsna as jrsna
from cross_attention_vit_tpu.data import dicom as jdicom
from cross_attention_vit_tpu.drivers import legacy as jlegacy
from cross_attention_vit_tpu.train import trainer as jtrainer
from cross_attention_vit_tpu_torch.data import dataset_rsna as trsna
from cross_attention_vit_tpu_torch.data import dicom as tdicom
from cross_attention_vit_tpu_torch.data.labels import Table
from cross_attention_vit_tpu_torch.data.nifti import write_volume
from cross_attention_vit_tpu_torch.drivers import legacy as tlegacy
from cross_attention_vit_tpu_torch.train import trainer as ttrainer


def test_dicom_roundtrip_and_fields_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i, px in enumerate([rng.integers(0, 4000, size=(32, 24)).astype(np.uint16),
                            (np.arange(64, dtype=np.int16) - 32).reshape(8, 8)]):
        p = tmp_path / f"{i}.dcm"
        tdicom.write_dicom(p, px, window_center=500, window_width=1200, instance_number=7)
        assert p.read_bytes() == _jax_written(tmp_path / f"j{i}.dcm", px)
        got, want = tdicom.read_dicom(p), jdicom.read_dicom(p)
        np.testing.assert_array_equal(got.pixel_array, px)
        assert {k: v for k, v in vars(got).items() if k != "pixel_bytes"} == \
            {k: v for k, v in vars(want).items() if k != "pixel_bytes"}
        np.testing.assert_array_equal(tdicom.apply_voi_lut(got.pixel_array, got),
                                      jdicom.apply_voi_lut(want.pixel_array, want))
    bad = tmp_path / "bad.dcm"
    bad.write_bytes(b"\x00" * 200)
    with pytest.raises(ValueError, match="DICM"):
        tdicom.read_dicom(bad)


def _jax_written(path, px):
    jdicom.write_dicom(path, px, window_center=500, window_width=1200, instance_number=7)
    return path.read_bytes()


def test_voi_lut_regimes():
    img = tdicom.DicomImage(rows=1, cols=5, window_center=100.0, window_width=50.0)
    x = np.array([0, 80, 100, 120, 4000], dtype=np.uint16)
    y = tdicom.apply_voi_lut(x, img)
    assert y[0] == 0.0 and y[4] == 65535.0
    assert y[2] == pytest.approx(((100 - 99.5) / 49 + 0.5) * 65535)
    np.testing.assert_array_equal(tdicom.apply_voi_lut(x, tdicom.DicomImage(rows=1, cols=5)), x)


def test_natural_sort_and_crop_match_jax():
    from pathlib import Path
    names = [Path(f"Image-{i}.dcm") for i in [10, 2, 1, 30, 9]]
    assert trsna.natural_sort(names) == jrsna.natural_sort(names)
    assert [p.name for p in trsna.natural_sort(names)][:3] == ["Image-1.dcm", "Image-2.dcm",
                                                               "Image-9.dcm"]
    img = np.zeros((10, 12), np.float32)
    img[3:7, 4:9] = 5.0
    np.testing.assert_array_equal(trsna.crop_img(img), jrsna.crop_img(img))
    assert trsna.cropped_area(img) == jrsna.cropped_area(img) == 20
    assert trsna.crop_img(np.zeros((4, 4))).shape == (4, 4)


def test_rotate_matches_jax():
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    for choice in range(4):
        np.testing.assert_array_equal(trsna.rotate(img, choice), jrsna._rotate(img, choice))


def _make_case(root, case_id, n_slices=9, peak=5, mri_type="FLAIR", size=40):
    """A series whose centred blob is largest at slice ``peak``."""
    d = root / case_id / mri_type
    d.mkdir(parents=True)
    c = size // 2
    yy, xx = np.mgrid[:size, :size]
    for i in range(n_slices):
        px = np.zeros((size, size), np.uint16)
        r = max(2.0, size / 10 + size / 4 * (1 - abs(i - peak) / n_slices))
        px[(yy - c) ** 2 + (xx - c) ** 2 < r ** 2] = 1000 + 10 * i
        px[c, : size // 4] = 300 + i            # an off-centre feature: rotations differ
        tdicom.write_dicom(d / f"Image-{i}.dcm", px, window_center=500, window_width=1200,
                           instance_number=i)


def _pair(root, ids, labels, **kw):
    """The port's and JAX's datasets over the same rows, each with its own
    biggest-slice cache file."""
    t = trsna.RSNADataset(Table({"ID": np.array(ids, dtype=object),
                                 "MGMT_value": np.array([str(v) for v in labels],
                                                        dtype=object)}),
                          folder=root, cache_file=root / "port_cache.json", **kw)
    j = jrsna.RSNADataset(pd.DataFrame({"ID": ids, "MGMT_value": labels}), folder=root,
                          cache_file=root / "jax_cache.json", **kw)
    return t, j


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("rotate", [0, 1, 2, 3])
def test_rsna_items_equal_jax(tmp_path, is_train, rotate):
    _make_case(tmp_path, "00001", n_slices=9, peak=6)
    _make_case(tmp_path, "00002", n_slices=3, peak=1)         # fewer slices than num_imgs
    t, j = _pair(tmp_path, ["00001", "00002"], [1, 0], num_imgs=6, size=40,
                 is_train=is_train, rotate=rotate)
    assert len(t) == len(j) == 2
    for i in range(2):
        (tv, tl), (jv, jl) = t[i], j[i]
        assert tv.dtype == jv.dtype == np.float32 and tl == jl
        np.testing.assert_array_equal(tv, jv)
    imgs, labels = t.batch([1, 0])
    jimgs, jlabels = j.batch([1, 0])
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    assert labels.dtype == np.int32
    if is_train:
        assert t.prepare_biggest_images() == j.prepare_biggest_images() == {"00001": 6,
                                                                            "00002": 1}
        assert json.loads((tmp_path / "port_cache.json").read_text()) == {"00001": 6,
                                                                          "00002": 1}


def test_rsna_resized_items_match_jax_within_float_rounding(tmp_path):
    _make_case(tmp_path, "00001", n_slices=5, peak=2, size=48)
    for size in (32, 64):
        t, j = _pair(tmp_path, ["00001"], [1], num_imgs=4, size=size, is_train=False)
        tv, jv = t[0][0], j[0][0]
        assert tv.shape == jv.shape == (1, 1, size, size, 4)
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)


def test_rsna_multi_type_and_filter_match_jax(tmp_path):
    _make_case(tmp_path, "00001", peak=5, mri_type="FLAIR")
    _make_case(tmp_path, "00001", peak=3, mri_type="T1w")
    _make_case(tmp_path, "00002", peak=2, mri_type="FLAIR")      # T1w missing: dropped
    t, j = _pair(tmp_path, ["00001", "00002"], [1, 0], mri_types=("FLAIR", "T1w"),
                 num_imgs=4, size=40)
    assert len(t) == len(j) == 1
    (tv, tl), (jv, jl) = t[0], j[0]
    assert tv.shape == (2, 1, 40, 40, 4) and tl == jl == 1
    np.testing.assert_array_equal(tv, jv)
    assert json.loads((tmp_path / "port_cache_T1w.json").read_text()) == {"00001": 3}


def test_rsna_missing_case_raises_as_jax(tmp_path):
    t, j = _pair(tmp_path, ["99999"], [0])
    with pytest.raises(FileNotFoundError):
        j[0]
    with pytest.raises(FileNotFoundError):
        t[0]


def test_rsna_shared_cache_merges_under_threads(tmp_path):
    """Two datasets share one cache file; eight threads append cases
    through both at once: every case lands on disk (no lost update)."""
    ids = [f"{i:05d}" for i in range(8)]
    for i, c in enumerate(ids):
        _make_case(tmp_path, c, n_slices=5, peak=i % 5, size=16)
    table = Table({"ID": np.array(ids[:1], dtype=object), "MGMT_value": np.array(["0"],
                                                                                 dtype=object)})
    a = trsna.RSNADataset(table, folder=tmp_path, num_imgs=2, size=16)
    b = trsna.RSNADataset(table, folder=tmp_path, num_imgs=2, size=16)
    a.prepare_biggest_images()
    b.prepare_biggest_images()
    threads = [threading.Thread(target=(a if k % 2 else b)._biggest_for, args=(c, "FLAIR"))
               for k, c in enumerate(ids[1:] * 2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    on_disk = json.loads((tmp_path / "biggest_FLAIR.json").read_text())
    assert on_disk == {c: i % 5 for i, c in enumerate(ids)}


# -- the legacy drivers ----------------------------------------------------------

@pytest.fixture
def same_start(monkeypatch):
    """The JAX Trainer starts from the port Trainer's weights (its own init
    draws from jax.random): the port driver runs first and records them.
    A conv bias that feeds a BatchNorm starts at 1, not 0, in both: at 0 its
    gradient is rounding noise whose Adam step has either sign
    (tests/test_torch_legacy_models.py); at 1 weight decay fixes it."""
    box = {}
    port_init, jax_init = ttrainer.Trainer.init_state, jtrainer.Trainer.init_state

    def port(self, params=None, model_state=None):
        port_init(self, params, model_state)
        if self.stateful:
            with torch.no_grad():
                for i in range(1, 5):
                    getattr(self.model.encoder, f"conv{i}").bias.fill_(1.0)
        box["params"], box["state"] = self.params, self.model_state
        return self

    def jax_(self, params=None, model_state=None):
        tree = jax.tree.map(jnp.asarray, box["params"])
        state = None if box["state"] is None else jax.tree.map(jnp.asarray, box["state"])
        return jax_init(self, tree, state)

    monkeypatch.setattr(ttrainer.Trainer, "init_state", port)
    monkeypatch.setattr(jtrainer.Trainer, "init_state", jax_)


def _close_histories(hist, jhist):
    assert len(hist) == len(jhist)
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        for k in row:
            if k != "epoch_time_s":
                assert abs(row[k] - jrow[k]) <= 1e-4, (k, row[k], jrow[k])


def test_train_vit3d_matches_jax(tmp_path, same_start):
    data = tmp_path / "ucsf-data"
    ids = [f"UCSF-PDGM-{n}" for n in range(1, 9)]
    (tmp_path / "labels.csv").write_text(
        "ID,MGMT status\n" + "".join(f"{i},{'positive' if k % 2 else 'negative'}\n"
                                     for k, i in enumerate(ids)))
    rng = np.random.default_rng(0)
    for n in range(1, 9):
        case = f"UCSF-PDGM-{n:04d}"
        (data / f"{case}_nifti").mkdir(parents=True)
        write_volume(data / f"{case}_nifti" / f"{case}_T1c.nii.gz",
                     rng.integers(0, 800, size=(40, 36, 20)).astype(np.int16))
    over = dict(hidden_dim=32, num_heads=4, num_layers=1, img_size=(32, 32, 16), dropout=0.0)
    kw = dict(labels_csv=tmp_path / "labels.csv", folder=data, max_epochs=2, batch_size=2,
              seed=5, verbose=False, overrides=over)
    trainer, hist = tlegacy.train_vit3d(out_dir=tmp_path / "port", device="cpu", **kw)
    jt, jhist = jlegacy.train_vit3d(out_dir=tmp_path / "jax", **kw)
    _close_histories(hist, jhist)
    assert trainer.stateful and trainer.plateau is not None
    assert len(list((tmp_path / "port" / "checkpoints" / "vit3d").glob("*train_loss=*.npz"))) \
        == len(list((tmp_path / "jax" / "checkpoints" / "vit3d").glob("*train_loss=*.npz"))) == 2


def test_train_rsna_matches_jax(tmp_path, same_start):
    ids = [f"{n:05d}" for n in range(8)]
    for k, c in enumerate(ids):
        _make_case(tmp_path / "rsna", c, n_slices=10 + k, peak=3 + k % 4, size=32)
    (tmp_path / "train.csv").write_text(
        "ID,MGMT_value\n" + "".join(f"{c},{k % 2}\n" for k, c in enumerate(ids)))
    over = dict(hidden_dim=32, mlp_dim=64, num_heads=4, num_layers=1, patch_size=(16, 16, 8),
                dropout=0.0)
    kw = dict(labels_csv=tmp_path / "train.csv", folder=tmp_path / "rsna", num_imgs=8,
              size=32, max_epochs=2, batch_size=2, seed=1, verbose=False, overrides=over)
    _, hist, preds = tlegacy.train_rsna(out_dir=tmp_path / "port", device="cpu", **kw)
    _, jhist, jpreds = jlegacy.train_rsna(out_dir=tmp_path / "jax", **kw)
    _close_histories(hist, jhist)
    assert preds.shape == jpreds.shape == (2,)
    np.testing.assert_allclose(preds, jpreds, atol=1e-4, rtol=0)
    assert ((0 <= preds) & (preds <= 1)).all()
