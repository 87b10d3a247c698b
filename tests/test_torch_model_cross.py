"""The port's ModelCross against the JAX package's ``model_cross.apply`` on
the same weights and inputs, at a tiny geometry in float32 eval mode:
hidden 64, 4 heads, img (32, 32, 8), patch (8, 8, 8), so N = 16 + 1 = 17
tokens (a ragged tile for the attention kernel).

Tolerance: logits within 1e-4 absolute — ten times tighter than the repo's
1e-3 parity contract (PARITY.md); both sides compute in f32 and differ only
in summation order."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu import configs as jconfigs
from cross_attention_vit_tpu.configs import get_mgmt_cross_config as jax_cross_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.models import convert as jconvert
from cross_attention_vit_tpu.models import model_cross as jmc
from cross_attention_vit_tpu.ops import patchify as jpatch
from cross_attention_vit_tpu_torch import configs as tconfigs
from cross_attention_vit_tpu_torch.configs import get_mgmt_cross_config, modify_config
from cross_attention_vit_tpu_torch.models import convert as tconvert
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross

ATOL = 1e-4
ORDERS = {"cycle": {"0": "1", "1": "2", "2": "0"}, "chain": {"0": "1", "1": "2"}, "none": {}}


def _fields(**kw):
    f = dict(hidden_dim=64, mlp_dim=128, num_heads=4, num_multi_blocks=2, num_self_blocks=1,
             img_size=(32, 32, 8), patch_size=(8, 8, 8), num_modalities=3,
             attn_order=ORDERS["cycle"], dropout=0.0, label_smoothing=0.1,
             use_flash_attention=False)
    f.update(kw)
    return f


def _pair(**kw):
    """(jax config, port config, jax params as numpy) for the same fields."""
    fields = _fields(**kw)
    jc = jax_cross_config()
    jax_modify(jc, fields)
    tc = get_mgmt_cross_config()
    modify_config(tc, fields)
    params = jax.tree.map(np.asarray, jmc.init(jax.random.key(0), jc))
    return jc, tc, params


@pytest.mark.parametrize("preset", ["get_mgmt_config", "get_mgmt_cross_config"])
def test_presets_match_jax_field_for_field(preset):
    assert getattr(tconfigs, preset)().to_dict() == getattr(jconfigs, preset)().to_dict()


def test_modify_config_takes_params_in_place():
    p = dict(lr=1e-4, dropout=0.25, attn_order={"0": "1"}, optim_params={"T_max": 5},
             weight_decay=5e-4, img_types=("DWI", "SWI"), label_smoothing=0.1, img_aug=True)
    want = jax_modify(jax_cross_config(), jconfigs.Params(**p))
    cfg = get_mgmt_cross_config()
    assert modify_config(cfg, tconfigs.Params(**p)) is cfg
    assert cfg.to_dict() == want.to_dict()
    assert modify_config(cfg, {"num_heads": 8}).num_heads == 8 == cfg["num_heads"]


def _img(cfg, b=2, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, cfg.num_modalities, 1, *cfg.img_size)) * 100).astype(np.float32)


def _port(tc, params):
    model = ModelCross(tc, device="cpu")
    tconvert.load_jax_params(model, params)
    return model


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("flash", [False, True])
def test_logits_match_jax(order, flash):
    jc, tc, params = _pair(attn_order=ORDERS[order], use_flash_attention=flash)
    img = _img(tc)
    want = np.asarray(jmc.apply(params, jc, jnp.asarray(img), train=False))
    with torch.inference_mode():
        got = _port(tc, params)(torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("flash", [False, True])
def test_single_head_identity_quirk_matches_jax(flash):
    jc, tc, params = _pair(num_heads=1, num_multi_blocks=1, use_flash_attention=flash)
    assert "out" not in params["multi_blocks"][0]["self_blocks"][0][0]["attn"]
    model = _port(tc, params)
    assert model.transformer[0].blocks[0][0].attn.fn.to_out is None
    img = _img(tc, b=1, seed=3)
    want = np.asarray(jmc.apply(params, jc, jnp.asarray(img), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_labels_return_logits_and_smoothed_loss():
    jc, tc, params = _pair(num_multi_blocks=1)
    img = _img(tc, b=3, seed=5)
    labels = np.array([0, 1, 1])
    want_logits, want_loss = jmc.apply(params, jc, jnp.asarray(img), jnp.asarray(labels))
    with torch.inference_mode():
        logits, loss = _port(tc, params)(torch.from_numpy(img), torch.from_numpy(labels))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=0)
    assert abs(float(loss) - float(want_loss)) <= ATOL


def test_state_dict_mapping_matches_jax_export_and_import():
    jc, tc, params = _pair()
    want = jconvert.export_model_cross(params, jc)
    got = tconvert.state_dict_from_jax(params, tc)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's module names are the reference names, shape for shape
    model = ModelCross(tc, device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in want.items()}
    # and the inverse mapping is JAX's import
    back = tconvert.jax_params_from_state_dict(got, tc)
    ref = jconvert.import_model_cross(want, jc)
    jax.tree.map(np.testing.assert_array_equal, back, ref)


def test_params_round_trip_through_the_model():
    _, tc, params = _pair(attn_order=ORDERS["chain"])
    back = tconvert.jax_params_from_model(_port(tc, params))
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_init_distributions():
    _, tc, _ = _pair(hidden_dim=256, mlp_dim=512, num_heads=4, num_multi_blocks=1)
    model = ModelCross(tc, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    w = sd["transformer.0.blocks.0.0.attn.fn.to_qkv.weight"]   # (3H, H)
    bound = (6.0 / (256 + 768)) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.95 * bound
    assert float(sd["transformer.0.blocks.0.0.ffn.fn.net.0.bias"].abs().max()) == 0.0
    assert abs(float(sd["pos_embedding"].std()) - 0.02) < 2e-3
    assert float((sd["norm.0.weight"] - 1).abs().max()) == 0.0
    again = ModelCross(tc, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


def test_bf16_gemm_weights_are_cast_once():
    _, tc, params = _pair(compute_dtype="bfloat16")
    model = _port(tc, params)
    qkv = model.transformer[0].blocks[0][0].attn.fn.to_qkv.weight
    assert qkv.dtype == torch.bfloat16
    assert model.pos_embedding.dtype == torch.float32
    assert model.transformer[0].blocks[0][0].ffn.fn.net["0"].bias.dtype == torch.float32
    want = torch.from_numpy(tconvert.state_dict_from_jax(params, tc)[
        "transformer.0.blocks.0.0.attn.fn.to_qkv.weight"]).to(torch.bfloat16)
    assert torch.equal(qkv, want)


def test_out_of_range_attn_order_raises():
    fields = _fields(attn_order={"0": "5"})
    jc = jax_cross_config()
    jax_modify(jc, fields)
    with pytest.raises(ValueError, match="out of range"):
        jmc.init(jax.random.key(0), jc)
    tc = get_mgmt_cross_config()
    modify_config(tc, fields)
    with pytest.raises(ValueError, match="out of range"):
        ModelCross(tc, device="cpu")


def test_stacked_streams_raises():
    fields = _fields(stacked_streams=True)
    jc = jax_cross_config()
    jax_modify(jc, fields)
    with pytest.raises(ValueError, match="stacked_streams"):
        jmc.init(jax.random.key(0), jc)
    tc = get_mgmt_cross_config()
    modify_config(tc, fields)
    with pytest.raises(ValueError, match="stacked_streams"):
        ModelCross(tc, device="cpu")


def test_non_divisible_patch_raises():
    with pytest.raises(ValueError):
        jpatch.patchify_3d(jnp.zeros((1, 1, 30, 32, 8)), (8, 8, 8))
    tc = get_mgmt_cross_config()
    modify_config(tc, _fields(img_size=(30, 32, 8)))
    with pytest.raises(ValueError, match="divisible"):
        ModelCross(tc, device="cpu")


@pytest.mark.parametrize("fields", [{"moe_experts": 4}, {"seq_parallel": 2}])
def test_unported_options_raise(fields):
    """The two options this test once held unported, the MoE FFN and
    sequence parallelism, now build and give JAX's logits and loss (no
    mesh: every expert here, the dense attention)."""
    jc, tc, params = _pair(**fields)
    model = _port(tc, params)
    img = _img(tc)
    labels = np.array([0, 1], np.int32)
    with torch.no_grad():
        logits, loss = model(torch.from_numpy(img), torch.from_numpy(labels).long())
    want, want_loss = jmc.apply(params, jc, jnp.asarray(img), jnp.asarray(labels))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert abs(float(loss) - float(want_loss)) <= ATOL


def test_train_mode_raises():
    """Train mode with dropout needs a generator (JAX raises for a missing
    key the same way)."""
    _, tc, params = _pair(num_multi_blocks=1, dropout=0.25)
    with pytest.raises(ValueError, match="Generator"):
        _port(tc, params)(torch.from_numpy(_img(tc)), train=True)


@pytest.mark.parametrize("flash", [False, True])
def test_train_mode_at_dropout_zero_is_the_eval_forward(flash):
    _, tc, params = _pair(num_multi_blocks=1, use_flash_attention=flash)
    img = torch.from_numpy(_img(tc))
    model = _port(tc, params)
    with torch.no_grad():
        assert torch.equal(model(img, train=True), model(img))


def test_train_mode_drops_out_deterministically_under_a_generator():
    _, tc, params = _pair(num_multi_blocks=1, dropout=0.25)
    img = torch.from_numpy(_img(tc))
    model = _port(tc, params)
    with torch.no_grad():
        a = model(img, train=True, generator=torch.Generator().manual_seed(0))
        b = model(img, train=True, generator=torch.Generator().manual_seed(0))
        c = model(img, train=True, generator=torch.Generator().manual_seed(1))
        ev = model(img)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ev)


def test_master_weights_stay_f32_and_forward_like_the_cast_once_model():
    """A training model keeps f32 parameters and casts per call; its bf16
    forward equals the serving model's, whose weights were cast once."""
    _, tc, params = _pair(compute_dtype="bfloat16", activation_dtype="bfloat16",
                          num_multi_blocks=1)
    master = ModelCross(tc, device="cpu", master_weights=True)
    tconvert.load_jax_params(master, params)
    assert all(p.dtype == torch.float32 for p in master.parameters())
    img = torch.from_numpy(_img(tc))
    with torch.inference_mode():
        assert torch.equal(master(img), _port(tc, params)(img))


def test_master_params_round_trip_exactly_both_ways():
    """JAX f32 params → the master model → JAX params is the identity, also
    at bf16 compute, so a test can compare parameters after a step."""
    _, tc, params = _pair(compute_dtype="bfloat16", attn_order=ORDERS["chain"])
    model = ModelCross(tc, device="cpu", master_weights=True)
    tconvert.load_jax_params(model, params)
    back = tconvert.jax_params_from_model(model)
    jax.tree.map(np.testing.assert_array_equal, back, params)
