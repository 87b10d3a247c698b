"""The port's checkpoint migration CLI (``drivers/convert.py``) against the
JAX package's: the same torch checkpoint (bare, Lightning and legacy
containers, a ``model.`` prefix) gives an npz equal to the JAX CLI's key by
key and bit for bit, with the same config JSON, for ModelCross and ModelVIT;
``--export`` returns the original state dict bit for bit; the port's server
reads the npz and answers as the model it came from."""

import json

import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.drivers import convert as jconvert_cli
from cross_attention_vit_tpu_torch.configs import (get_mgmt_config, get_mgmt_cross_config,
                                                   modify_config)
from cross_attention_vit_tpu_torch.drivers import convert as tconvert_cli
from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.train.checkpoint import restore_flat

TINY = ["--set", "hidden_dim=32", "--set", "mlp_dim=64", "--set", "num_heads=4",
        "--set", "img_size=(16,16,8)", "--set", "patch_size=(8,8,8)"]
FAMILIES = {"cross": (ModelCross, get_mgmt_cross_config,
                      ["--set", "num_multi_blocks=1", "--set", "num_self_blocks=1",
                       "--attn-order", "0:1,1:0"]),
            "vit": (ModelVIT, get_mgmt_config, ["--set", "num_layers=2"])}
CONTAINERS = {"bare": lambda sd: sd,
              "lightning": lambda sd: {"state_dict": {f"model.{k}": v for k, v in sd.items()},
                                       "epoch": 3},
              "legacy": lambda sd: {"model_state_dict": sd, "optimizer_state_dict": {}}}


def _source(family: str) -> tuple[torch.nn.Module, dict]:
    model_cls, factory, _ = FAMILIES[family]
    cfg = factory()
    modify_config(cfg, dict(hidden_dim=32, mlp_dim=64, num_heads=4, img_size=(16, 16, 8),
                            patch_size=(8, 8, 8), num_modalities=2, num_multi_blocks=1,
                            num_self_blocks=1, num_layers=2, attn_order={"0": "1", "1": "0"}))
    model = model_cls(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("container", list(CONTAINERS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_equals_the_jax_cli_and_export_round_trips(tmp_path, family, container):
    model, sd = _source(family)
    ckpt = tmp_path / "ref.ckpt"
    torch.save(CONTAINERS[container](sd), ckpt)
    flags = ["--model", family, "--torch-ckpt", str(ckpt), "--img-types", "T1c", "T2", *TINY,
             *FAMILIES[family][2]]
    jconvert_cli.main([*flags, "--out", str(tmp_path / "jax" / "m.npz")])
    out = tconvert_cli.main([*flags, "--out", str(tmp_path / "port" / "m.npz")], device="cpu")
    got, want = restore_flat(out), restore_flat(tmp_path / "jax" / "m.npz")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads((tmp_path / "port" / "config_m.json").read_text()) == \
        json.loads((tmp_path / "jax" / "config_m.json").read_text())

    back = tconvert_cli.main(["--model", family, "--checkpoint", str(out), "--export",
                              "--out", str(tmp_path / "back.pt")], device="cpu")
    exported = torch.load(back)
    assert set(exported) == set(sd)
    for k, v in sd.items():
        assert torch.equal(exported[k], v), k


def test_the_port_server_reads_the_converted_npz(tmp_path):
    model, sd = _source("cross")
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, tmp_path / "ref.ckpt")
    out = tconvert_cli.main(["--model", "cross", "--torch-ckpt", str(tmp_path / "ref.ckpt"),
                             "--img-types", "T1c", "T2", *TINY, *FAMILIES["cross"][2],
                             "--out", str(tmp_path / "m.npz")], device="cpu")
    server = InferenceServer(out, img_types=("T1c", "T2"), device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 2, 1, 16, 16, 8)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(server._run_padded(x, 2), want)


def test_a_mismatched_state_dict_fails_the_strict_load(tmp_path):
    _, sd = _source("cross")
    sd.pop("cls_token")
    torch.save(sd, tmp_path / "ref.ckpt")
    with pytest.raises(KeyError, match="cls_token"):
        tconvert_cli.main(["--model", "cross", "--torch-ckpt", str(tmp_path / "ref.ckpt"),
                           "--img-types", "T1c", "T2", *TINY, *FAMILIES["cross"][2],
                           "--out", str(tmp_path / "m.npz")], device="cpu")
    assert not (tmp_path / "m.npz").exists()
