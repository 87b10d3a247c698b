"""The port's small tools against the JAX package's: ``utils/misc.py``'s
``accum_tensor``, ``utils/profiling.py`` (``StageTimer``, ``profile_trace``
on the CPU), ``models/surgery.py`` (a shape trace on the meta device, the
parameter count and summary equal to JAX's for the same weights), and the
small public functions ported beside them: ``nifti.read_header``,
``preprocess.resize_with_pad_or_crop``, ``patchify.unpatchify_3d`` and
``Config.copy`` / ``keys`` / ``del``."""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.configs import get_mgmt_config as jax_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.data import nifti as jnifti
from cross_attention_vit_tpu.data import preprocess as jpre
from cross_attention_vit_tpu.models import model_vit as jmodel_vit
from cross_attention_vit_tpu.models import surgery as jsurgery
from cross_attention_vit_tpu.models import vit3d as jvit3d
from cross_attention_vit_tpu.ops import patchify as jpatch
from cross_attention_vit_tpu.utils import misc as jmisc
from cross_attention_vit_tpu_torch.configs import get_mgmt_config, modify_config
from cross_attention_vit_tpu_torch.data import nifti as tnifti
from cross_attention_vit_tpu_torch.data import preprocess as tpre
from cross_attention_vit_tpu_torch.models import surgery as tsurgery
from cross_attention_vit_tpu_torch.models.convert import jax_params_from_model
from cross_attention_vit_tpu_torch.models.densenet import DenseNet121
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.models.vit3d import ViT3D
from cross_attention_vit_tpu_torch.ops import patchify as tpatch
from cross_attention_vit_tpu_torch.utils import misc as tmisc
from cross_attention_vit_tpu_torch.utils.profiling import StageTimer, profile_trace

VIT = dict(hidden_dim=32, mlp_dim=64, num_heads=4, num_layers=1, img_size=(16, 16, 8),
           patch_size=(8, 8, 8), num_modalities=1, dropout=0.0)


def _cfgs(fields):
    cfg, jcfg = get_mgmt_config(), jax_config()
    modify_config(cfg, fields)
    jax_modify(jcfg, fields)
    return cfg, jcfg


def test_accum_tensor_matches_jax():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = a[::-1].copy()
    fn = lambda x, y: x * y + 1     # noqa: E731
    assert tmisc.accum_tensor(a, b, fn) == jmisc.accum_tensor(a, b, fn)
    assert tmisc.accum_tensor(torch.from_numpy(a), torch.from_numpy(b), fn) == \
        jmisc.accum_tensor(a, b, fn)
    with pytest.raises(ValueError, match="shape mismatch"):
        tmisc.accum_tensor(a, b[:1], fn)
    assert tmisc.compute_metrics is not None


def test_stage_timer_accumulates():
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("decode", block_on=torch.zeros(1)):
            time.sleep(0.01)
    with timer.stage("step"):
        pass
    assert timer.counts == {"decode": 2, "step": 1}
    assert timer.totals["decode"] >= 0.02
    assert timer.summary().splitlines()[0].startswith("decode")


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profile_trace(tmp_path / "trace", device="cpu") as prof:
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    assert any("mm" in ev.key for ev in prof.key_averages())


def test_trace_shapes_on_the_meta_device_matches_jax():
    cfg, jcfg = _cfgs(VIT)
    params = jmodel_vit.init(jax.random.key(0), jcfg)
    want, _ = jsurgery.trace_shapes(lambda p, x: jmodel_vit.apply(p, jcfg, x), params,
                                    jnp.zeros((2, 1, 1, 16, 16, 8)))
    model = ModelVIT(cfg, device="meta")
    got, records = tsurgery.trace_shapes(model, torch.empty(2, 1, 1, 16, 16, 8, device="meta"))
    assert got == want == ((2, 2), "float32")
    # one layer: the patch embedding, QKV, two attention products, the
    # output projection, two FFN GEMMs, then the head's two
    assert [r[0] for r in records if r[0] == "matmul"] == ["matmul"] * 9
    assert ("softmax", (2, 4, 5, 5), "float32") in records
    assert records[-1] == ("matmul", (2, 2), "float32")
    text = tsurgery.inspect_model(model, torch.empty(2, 1, 1, 16, 16, 8, device="meta"),
                                  quiet=True)
    assert "-> output" in text


def test_trace_shapes_refuses_real_tensors_and_flash_models():
    cfg, _ = _cfgs(VIT)
    with pytest.raises(ValueError, match="meta device"):
        tsurgery.trace_shapes(ModelVIT(cfg, device="cpu"), torch.zeros(1, 1, 1, 16, 16, 8))
    cfg.use_flash_attention = True
    with pytest.raises(ValueError, match="use_flash_attention=False"):
        tsurgery.trace_shapes(ModelVIT(cfg, device="meta"),
                              torch.empty(1, 1, 1, 16, 16, 8, device="meta"))


def test_shape_probe_records_only_inside_a_trace():
    x = torch.empty(3, 4, device="meta")
    assert tsurgery.shape_probe("outside", x) is x
    _, records = tsurgery.trace_shapes(lambda t: tsurgery.shape_probe("inside", t * 2), x)
    assert records == [("inside", (3, 4), "float32")]
    # a leaf module called as a module records under its dotted name
    seq = torch.nn.Sequential(torch.nn.Linear(4, 5, device="meta"), torch.nn.ReLU())
    _, records = tsurgery.trace_shapes(seq, x)
    assert ("0", (3, 5), "float32") in records and ("1", (3, 5), "float32") in records


def test_truncate_apply_on_a_meta_densenet():
    model = DenseNet121(device="meta")
    cut = tsurgery.truncate_apply(model, "features.pool0")
    out, records = tsurgery.trace_shapes(cut, torch.empty(1, 1, 32, 32, 32, device="meta"))
    assert out == ((1, 64, 8, 8, 8), "float32")
    assert cut.__name__.endswith("__upto__features.pool0")


@pytest.mark.parametrize("family", ["vit", "vit3d"])
def test_param_count_and_summary_equal_jax(family):
    if family == "vit":
        cfg, jcfg = _cfgs(VIT)
        model = ModelVIT(cfg, device="cpu")
        jparams = jmodel_vit.init(jax.random.key(0), jcfg)
    else:
        cfg, jcfg = _cfgs(dict(hidden_dim=32, num_heads=4, num_layers=2, img_size=(32, 32, 16),
                               num_modalities=2))
        model = ViT3D(cfg, device="cpu")
        jparams = jvit3d.init(jax.random.key(0), jcfg)[0]
    assert tsurgery.param_count(model) == jsurgery.param_count(jparams)
    assert tsurgery.param_count(jax_params_from_model(model)) == jsurgery.param_count(jparams)
    for depth in (1, 2):
        assert tsurgery.param_summary(model, depth) == jsurgery.param_summary(jparams, depth)
    meta = (ModelVIT if family == "vit" else ViT3D)(cfg, device="meta")
    assert tsurgery.param_summary(meta) == jsurgery.param_summary(jparams)


def test_read_header_matches_jax(tmp_path):
    vol = np.random.default_rng(0).integers(-500, 3000, size=(17, 13, 9)).astype(np.int16)
    for name in ("a.nii", "a.nii.gz"):
        p = tmp_path / name
        tnifti.write_volume(p, vol, pixdim=(1.0, 2.0, 0.5))
        got, want = tnifti.read_header(p), jnifti.read_header(p)
        assert got.shape == want.shape == (17, 13, 9)
        assert got.pixdim == want.pixdim == (1.0, 2.0, 0.5)
        assert vars(got) == vars(want)


@pytest.mark.parametrize("shape,target", [((2, 1, 30, 17, 23), (24, 24, 16)),
                                          ((1, 4, 4, 4), (4, 4, 4)),
                                          ((3, 5, 9), (8, 4))])
def test_resize_with_pad_or_crop_matches_jax(shape, target):
    vol = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jpre.resize_with_pad_or_crop(jnp.asarray(vol), target, fill=-1.0))
    got = tpre.resize_with_pad_or_crop(torch.from_numpy(vol), target, fill=-1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tpre.resize_with_pad_or_crop_np(vol, target))


def test_unpatchify_matches_jax_and_inverts_patchify():
    vol = np.random.default_rng(1).normal(size=(1, 3, 8, 8, 8)).astype(np.float32)
    patch = (4, 4, 2)
    tok = tpatch.patchify_3d(torch.from_numpy(vol), patch)
    back = tpatch.unpatchify_3d(tok, patch, (8, 8, 8), channels=3)
    np.testing.assert_array_equal(back.numpy(), vol)
    want = jpatch.unpatchify_3d(jnp.asarray(tok.numpy()), patch, (8, 8, 8), channels=3)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


def test_config_copy_keys_and_delattr_match_jax():
    cfg, jcfg = get_mgmt_config(), jax_config()
    assert list(cfg.keys()) == list(jcfg.keys())
    for c in (cfg, jcfg):
        c.optim_params = {"T_max": 1}
        d = c.copy()
        d.optim_params["T_max"] = 2         # a deep copy
        del d.hidden_dim
        assert c.optim_params["T_max"] == 1 and "hidden_dim" in c and "hidden_dim" not in d
        with pytest.raises(AttributeError):
            d.hidden_dim
    assert cfg.copy().to_dict() == jcfg.copy().to_dict()
