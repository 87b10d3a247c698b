"""The port's ModelVIT against the JAX package's ``model_vit`` on the same
weights and inputs: eval logits, one f32 train step, the weight mapping,
stochastic depth and serving (``InferenceServer(model="vit")`` on the CPU).

Geometry: img (64, 64, 32), patch (8, 8, 4) → 512 patches per modality, so
M = 1, 2, 3 streams give N = 513, 1025 (K1/K2) and 1537 tokens (above the
switch at 1040: the streaming kernels K7).  The JAX flash path runs its
Pallas kernels in interpret mode, the port's runs their plain versions.

Tolerance: logits within 1e-4 absolute, f32 on both sides (ten times
tighter than the repo's 1e-3 parity contract, PARITY.md); one train step's
loss within 1e-5 and every gradient within 1e-4 of max |JAX gradient|."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.configs import get_mgmt_config as jax_vit_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.models import convert as jconvert
from cross_attention_vit_tpu.models import model_vit as jmv
from cross_attention_vit_tpu.train.checkpoint import CheckpointManager
from cross_attention_vit_tpu_torch.configs import get_mgmt_config, modify_config
from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer
from cross_attention_vit_tpu_torch.models import convert as tconvert
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.ops.layers import stochastic_depth_row
from cross_attention_vit_tpu_torch.train.optim import Adam
from cross_attention_vit_tpu_torch.train.trainer import make_train_step

ATOL = 1e-4


def _fields(**kw):
    f = dict(hidden_dim=32, mlp_dim=64, num_heads=2, num_layers=1, img_size=(64, 64, 32),
             patch_size=(8, 8, 4), num_modalities=3, dropout=0.0, use_flash_attention=True,
             lr=1e-3, weight_decay=5e-4, label_smoothing=0.0, img_aug=False,
             optim_params={"T_max": 10, "eta_min": 1e-6})
    f.update(kw)
    return f


def _pair(**kw):
    """(jax config, port config, jax params as numpy) for the same fields."""
    jc, tc = jax_vit_config(), get_mgmt_config()
    jax_modify(jc, _fields(**kw))
    modify_config(tc, _fields(**kw))
    return jc, tc, jax.tree.map(np.asarray, jmv.init(jax.random.key(0), jc))


def _img(cfg, b=1, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, cfg.num_modalities, 1, *cfg.img_size)) * 100).astype(np.float32)


def _port(tc, params, **kw):
    model = ModelVIT(tc, device="cpu", **kw)
    tconvert.load_jax_params(model, params)
    return model


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("M", [1, 2, 3])
def test_logits_match_jax(M, flash):
    jc, tc, params = _pair(num_modalities=M, use_flash_attention=flash)
    model = _port(tc, params)
    assert model.pos_embedding.shape == (1, 512 * M + 1, 32)
    img = _img(tc, seed=M)
    want = np.asarray(jmv.apply(params, jc, jnp.asarray(img), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_single_head_identity_quirk_matches_jax():
    jc, tc, params = _pair(num_heads=1)
    assert "out" not in params["layers"][0]["attn"]
    model = _port(tc, params)
    assert model.transformer.layers[0]["0"].fn.to_out is None
    img = _img(tc, seed=4)
    want = np.asarray(jmv.apply(params, jc, jnp.asarray(img), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_tanh_gelu_trunk_with_erf_head_matches_jax(monkeypatch):
    """gelu_approx switches the trunk's GELU to tanh; the head's stays erf
    (JAX model_vit.py:189).  The JAX package reads the knob from its module
    global, the port from the config."""
    from cross_attention_vit_tpu.ops import layers

    monkeypatch.setattr(layers, "GELU_APPROX", True)
    jc, tc, params = _pair(gelu_approx=True)
    img = _img(tc, seed=5)
    want = np.asarray(jmv.apply(params, jc, jnp.asarray(img), train=False))
    with torch.inference_mode():
        got = _port(tc, params)(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_head_gelu_is_erf_whatever_gelu_approx_says(monkeypatch):
    from cross_attention_vit_tpu_torch.models import model_vit
    from cross_attention_vit_tpu_torch.ops import layers

    calls = {"head": [], "trunk": []}
    for mod, key in ((model_vit, "head"), (layers, "trunk")):
        fn = mod.gelu
        monkeypatch.setattr(mod, "gelu", lambda x, approximate=False, _fn=fn, _k=key:
                            calls[_k].append(approximate) or _fn(x, approximate))
    _, tc, params = _pair(num_modalities=1, num_layers=2, gelu_approx=True)
    with torch.inference_mode():
        _port(tc, params)(torch.from_numpy(_img(tc)))
    assert calls == {"head": [False], "trunk": [True, True]}


def test_labels_return_logits_and_unsmoothed_loss():
    jc, tc, params = _pair(num_modalities=1, label_smoothing=0.1)
    img = _img(tc, b=3, seed=6)
    labels = np.array([0, 1, 1])
    want_logits, want_loss = jmv.apply(params, jc, jnp.asarray(img), jnp.asarray(labels))
    with torch.inference_mode():
        logits, loss = _port(tc, params)(torch.from_numpy(img), torch.from_numpy(labels))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=0)
    assert abs(float(loss) - float(want_loss)) <= ATOL


@pytest.mark.parametrize("M", [2, 3])
def test_one_f32_train_step_matches_jax(M):
    """Loss and per-tensor gradients of one step (dropout 0, drop path 0,
    augmentation off) against JAX's train objective, at N = 1025 (K1/K2)
    and N = 1537 (K7).  Adam given equal gradients is held to JAX's update in
    tests/test_torch_train.py."""
    jc, tc, params = _pair(num_modalities=M)
    img = _img(tc, b=1, seed=7)
    labels = np.array([1], np.int32)

    def loss_fn(p):
        logits, loss = jmv.apply(p, jc, jnp.asarray(img), jnp.asarray(labels), train=True,
                                 rng=jax.random.key(1))
        return loss, logits

    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = _port(tc, params, master_weights=True)
    step = make_train_step(model, Adam(model.parameters(), tc.weight_decay), tc)
    aux = step(torch.from_numpy(img), torch.from_numpy(labels), 1e-3,
               torch.Generator().manual_seed(0))
    assert abs(float(aux["loss"]) - float(want_loss)) <= 1e-5
    grads = tconvert.state_dict_from_jax(jax.tree.map(np.asarray, want_grads), tc)
    assert sorted(grads) == sorted(n for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        w, g = grads[name], p.grad.numpy()
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)


def test_train_mode_with_dropout_and_drop_path_trains_on_the_cpu():
    _, tc, params = _pair(num_modalities=1, num_layers=2, dropout=0.1, drop_path_rate=0.5)
    model = _port(tc, params, master_weights=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, Adam(model.parameters(), tc.weight_decay), tc)
    aux = step(torch.from_numpy(_img(tc, b=4, seed=8)), torch.tensor([0, 1, 0, 1]), 1e-3,
               torch.Generator().manual_seed(1))
    assert np.isfinite(float(aux["loss"]))
    assert all(not torch.equal(before[n], p) for n, p in model.named_parameters())
    with pytest.raises(ValueError, match="Generator"):
        model(torch.from_numpy(_img(tc)), train=True)


def test_train_mode_at_rate_zero_is_the_eval_forward():
    _, tc, params = _pair(num_modalities=1)
    model = _port(tc, params)
    x = torch.from_numpy(_img(tc, seed=9))
    with torch.no_grad():
        torch.testing.assert_close(model(x, train=True), model(x), rtol=0, atol=0)


# --- stochastic depth ---------------------------------------------------------

def test_stochastic_depth_row_is_the_identity_in_eval_and_at_rate_zero():
    x = torch.randn(4, 3, 5)
    assert stochastic_depth_row(x, 0.3, None, train=False) is x
    assert stochastic_depth_row(x, 0.0, None, train=True) is x
    with pytest.raises(ValueError, match="Generator"):
        stochastic_depth_row(x, 0.3, None, train=True)


@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_stochastic_depth_row_drops_whole_samples(rate):
    x = torch.rand(4000, 3, 5) + 1.0
    y = stochastic_depth_row(x, rate, torch.Generator().manual_seed(0), train=True)
    kept = (y != 0).reshape(len(x), -1)
    assert bool((kept.all(1) | ~kept.any(1)).all())          # whole sample kept or zeroed
    keep = kept.all(1)
    torch.testing.assert_close(y[keep], x[keep] / (1 - rate), rtol=1e-6, atol=0)
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.03


# --- the weight mapping -----------------------------------------------------------

def test_state_dict_mapping_matches_jax_export_and_import():
    jc, tc, params = _pair(num_modalities=2)
    want = jconvert.export_model_vit(params, jc)
    got = tconvert.state_dict_from_jax(params, tc)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = ModelVIT(tc, device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in want.items()}
    back = tconvert.jax_params_from_state_dict(got, tc)
    jax.tree.map(np.testing.assert_array_equal, back, jconvert.import_model_vit(want, jc))
    jax.tree.map(np.testing.assert_array_equal,
                 tconvert.jax_params_from_model(_port(tc, params)), params)


def test_single_head_mapping_skips_the_absent_projection():
    """JAX's export_model_vit raises KeyError on a heads==1 tree (it reads
    the absent "out" params); the port's mapping skips them both ways."""
    jc, tc, params = _pair(num_heads=1)
    with pytest.raises(KeyError):
        jconvert.export_model_vit(params, jc)
    sd = tconvert.state_dict_from_jax(params, tc)
    assert not any("to_out" in k for k in sd)
    jax.tree.map(np.testing.assert_array_equal, tconvert.jax_params_from_state_dict(sd, tc),
                 params)


@pytest.mark.parametrize("fields,match", [({"moe_experts": 4}, "item 13"),
                                          ({"pipeline_stages": 2}, "items 11-13")])
def test_unported_options_raise(fields, match):
    """The MoE trunk and the pipeline layout (``pipeline_stages``), which this
    test once held unported (``match`` names the ROADMAP items that held
    them), now build and give JAX's logits and loss: the MoE since item 13's
    EP slice, the pipeline (its serial schedule, from JAX's stacked
    checkpoint layout) since item 13's PP slice."""
    jc, tc, params = _pair(num_modalities=1, **fields)
    model = _port(tc, params)
    img, labels = _img(tc, b=2), np.array([1, 0], np.int32)
    with torch.no_grad():
        logits, loss = model(torch.from_numpy(img), torch.from_numpy(labels).long())
    want, want_loss = jmv.apply(jax.tree.map(jnp.asarray, params), jc, jnp.asarray(img),
                                jnp.asarray(labels))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert abs(float(loss) - float(want_loss)) <= 1e-4


# --- serving ---------------------------------------------------------------

@pytest.fixture(scope="module")
def vit_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_vit_ckpt")
    jc = jax_vit_config()
    jax_modify(jc, _fields(num_modalities=2, img_size=(16, 16, 8),
                           patch_size=(8, 8, 4), gelu_approx=True))
    params = jmv.init(jax.random.key(0), jc)
    mgr = CheckpointManager(d, monitor="val_loss", save_top_k=1, config=jc)
    path = mgr.save(0, 0.5, {"params": params, "epoch": jnp.zeros((), jnp.int32)})
    return path, jc, jax.tree.map(np.asarray, params)


def test_server_answers_as_jax_and_as_a_direct_forward(vit_ckpt, monkeypatch):
    from cross_attention_vit_tpu.ops import layers

    monkeypatch.setattr(layers, "GELU_APPROX", True)    # the checkpoint's gelu_approx
    path, jc, params = vit_ckpt
    srv = InferenceServer(path, "vit", img_types=("T1c", "T2"), buckets=(2, 4),
                          max_wait_ms=1.0, device="cpu")
    assert srv.health()["model"] == "vit" and isinstance(srv.model, ModelVIT)
    srv.start()
    try:
        vols = _img(jc, b=3, seed=10)
        got = srv.predict(vols)
    finally:
        srv.stop()
    np.testing.assert_allclose(got, np.asarray(jmv.apply(params, jc, jnp.asarray(vols))),
                               atol=ATOL, rtol=0)
    with torch.inference_mode():
        direct = srv.model(torch.from_numpy(np.concatenate([vols, np.zeros_like(vols[:1])])))
    np.testing.assert_array_equal(got, direct[:3].numpy())


def test_server_without_a_config_sidecar_uses_the_vit_preset(vit_ckpt, tmp_path):
    path, jc, _ = vit_ckpt
    bare = tmp_path / path.name
    bare.write_bytes(path.read_bytes())
    overrides = {k: jc[k] for k in ("hidden_dim", "mlp_dim", "num_heads", "num_layers",
                                    "img_size", "patch_size")}
    srv = InferenceServer(bare, "vit", img_types=("T1c", "T2"), config_overrides=overrides,
                          device="cpu")
    assert srv.cfg.num_modalities == 2 and "num_layers" in srv.cfg
    assert "num_multi_blocks" not in srv.cfg


def test_serve_cli_accepts_the_vit_family(vit_ckpt, monkeypatch):
    from cross_attention_vit_tpu_torch.drivers import serve as tserve

    made = {}

    class Stop(Exception):
        pass

    def fake_serve(server, host, port):
        made["server"] = server
        raise Stop

    monkeypatch.setattr(tserve, "serve", fake_serve)
    with pytest.raises(Stop):
        tserve.main(["--checkpoint", str(vit_ckpt[0]), "--model", "vit", "--img-types", "T1c",
                     "T2", "--device", "cpu"])
    assert made["server"].model_name == "vit"
    with pytest.raises(SystemExit):
        tserve.main(["--checkpoint", str(vit_ckpt[0]), "--model", "cnn"])
