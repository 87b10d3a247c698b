"""The port's int8 serving (``ops/quant.py``, ``models/quantize.py``, the
int8 branch of ``self_attention``) against the JAX package's on the same
weights and inputs, made from numpy seeds.

Bit for bit: int8 weights, their scales and quantized activations
(quantization is exact arithmetic and round half to even on both sides), and
the int8 products with their rescale (exact int32 sums, then the same f32
operations in the same order).  Calibrated activation scales within 1e-6
relative (Python floats on both sides).  Model logits within 1e-3 at f32
compute (the repo's parity contract, PARITY.md) with the same argmax: the
attention and the float GEMMs around the int8 ones differ in summation order,
and an int8 rounding can flip on that difference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.configs import get_mgmt_config as jax_vit_config
from cross_attention_vit_tpu.configs import get_mgmt_cross_config as jax_cross_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.models import model_cross as jmc
from cross_attention_vit_tpu.models import model_vit as jmv
from cross_attention_vit_tpu.models import quantize as jquantize
from cross_attention_vit_tpu.ops import attention as jattention
from cross_attention_vit_tpu.ops import quant as jquant
from cross_attention_vit_tpu.ops.layers import RngStream
from cross_attention_vit_tpu_torch.configs import get_mgmt_config, get_mgmt_cross_config
from cross_attention_vit_tpu_torch.configs import modify_config
from cross_attention_vit_tpu_torch.kernels import flash_attention as tfa
from cross_attention_vit_tpu_torch.models import quantize as tquantize
from cross_attention_vit_tpu_torch.models.convert import load_jax_params, state_dict_from_jax
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT
from cross_attention_vit_tpu_torch.ops import quant as tquant
from cross_attention_vit_tpu_torch.ops.attention import self_attention
from cross_attention_vit_tpu_torch.ops.layers import linear, linear_layer

MIN_SIZE = 4096        # quantizes every eligible layer of the tiny models
ATOL = 1e-3
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _layer(kernel_2d, bias=None):
    """A QuantLinear from a JAX-layout (F, G) kernel (torch weight = kernelᵀ)."""
    wq, scale = tquant.quantize_weight(_t(kernel_2d.T))
    return tquant.QuantLinear(wq, scale, None if bias is None else _t(bias))


# --- weights, activations, products --------------------------------------------

def _kernel_with_edges(F, G, seed):
    """Gaussian (F, G) kernel with an all-zero channel, a grid-valued one
    (multiples of a dyadic scale 0.5, amax 63.5) and one whose values sit
    exactly on rounding ties of that scale (w/scale = k + 0.5)."""
    k = (np.random.default_rng(seed).normal(size=(F, G)) * 0.05).astype(np.float32)
    k[:, 1] = 0.0
    k[:, 2] = (np.arange(F) % 255 - 127) * 0.5
    k[:, 2][0] = 63.5
    k[:, 3] = np.resize(np.array([0.25, 0.75, 1.25, -0.25, -1.25, 63.5], np.float32), F)
    return k


def test_quantize_weight_matches_jax_on_a_2d_kernel():
    kernel = _kernel_with_edges(256, 40, seed=0)
    want = jquant.quantize_weight(kernel)
    wq, scale = tquant.quantize_weight(_t(kernel.T))
    assert wq.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy().T, want["kernel_q"])
    np.testing.assert_array_equal(scale.numpy(), want["kernel_scale"])
    assert scale[1] == 1.0 and (wq[1] == 0).all()                 # the all-zero channel
    np.testing.assert_array_equal(wq[3, :6].numpy(), [0, 2, 2, 0, -2, 127])  # half to even


@pytest.mark.parametrize("which", ["qkv", "out"])
def test_quantize_weight_matches_jax_nd_layouts(which):
    """One per-row quantize_weight on the torch weight is JAX's
    quantize_weight_nd on the heads-axis kernel: qkv (H, 3, K, D) with axis
    0 contracted, out (K, D, H) with axes (0, 1)."""
    H, K, D = 32, 4, 8
    r = np.random.default_rng(1)
    if which == "qkv":
        kernel = (r.normal(size=(H, 3, K, D)) * 0.1).astype(np.float32)
        kernel[:, 1, 2, :] = 0.0                    # all-zero output channels
        want = jquant.quantize_weight_nd(kernel, (0,))
        weight = kernel.reshape(H, -1).T            # (3H, H)
    else:
        kernel = (r.normal(size=(K, D, H)) * 0.1).astype(np.float32)
        kernel[:, :, 5] = 0.0
        want = jquant.quantize_weight_nd(kernel, (0, 1))
        weight = kernel.reshape(-1, H).T            # (H, K·D)
    wq, scale = tquant.quantize_weight(_t(weight))
    np.testing.assert_array_equal(wq.numpy().T.reshape(kernel.shape), want["kernel_q"])
    np.testing.assert_array_equal(scale.numpy(), want["kernel_scale"].reshape(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dynamic_quantize_matches_jax(dtype):
    x = (np.random.default_rng(2).normal(size=(6, 40)) * 3).astype(np.float32)
    x[2] = 0.0                                                       # a zero row
    x[3, :7] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5]              # scale 1: ties
    x = np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))  # dtype's values
    want_q, want_s = jquant.dynamic_quantize(jnp.asarray(x, JDT[dtype]))
    xq, s = tquant.dynamic_quantize(_t(x, dtype))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(xq[3, :7].numpy(), [127, 0, 2, 2, 0, -2, 4])
    assert (xq[2] == 0).all() and s[2] == 1.0


def _jax_params(layer: tquant.QuantLinear, shape=None, static=None):
    """The JAX param node of a QuantLinear: kernel_q in the JAX layout."""
    kq = layer.weight_q.numpy().T
    sc = layer.weight_scale.numpy()
    p = {"kernel_q": kq if shape is None else kq.reshape(shape[0]),
         "kernel_scale": sc if shape is None else sc.reshape(shape[1])}
    if layer.bias is not None:
        p["bias"] = layer.bias.numpy()
    if static is not None:
        p["act_scale"] = np.float32(static)
        layer.act_scale = torch.tensor(np.float32(static))
    return p


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qlinear_matches_jax(dtype, static):
    r = np.random.default_rng(3)
    layer = _layer(_kernel_with_edges(64, 96, seed=4), r.normal(size=96).astype(np.float32))
    params = _jax_params(layer, static=0.021 if static else None)
    x = r.normal(size=(2, 7, 64)).astype(np.float32)
    x[0, 3] = 0.0
    want = jquant.qlinear(params, jnp.asarray(x, JDT[dtype]))
    got = tquant.qlinear(_t(x, dtype), layer)
    assert got.dtype == dtype and got.shape == (2, 7, 96)
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))
    assert torch.equal(linear_layer(layer, _t(x, dtype)), got)     # the dispatch


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qkv_projection_matches_jax(dtype, static):
    B, N, H, K, D = 2, 9, 32, 4, 8
    r = np.random.default_rng(5)
    kernel = (r.normal(size=(H, 3, K, D)) * 0.2).astype(np.float32)
    layer = _layer(kernel.reshape(H, -1))
    params = _jax_params(layer, ((H, 3, K, D), (3, K, D)), static=0.03 if static else None)
    x = r.normal(size=(B, N, H)).astype(np.float32)
    want = np.asarray(jquant.qkv_projection(params, jnp.asarray(x, JDT[dtype]))
                      .astype(jnp.float32))                         # (3, B, K, N, D)
    got = tquant.qkv_projection(_t(x, dtype), layer)
    assert got.dtype == dtype and got.shape == (B, N, 3 * H)
    np.testing.assert_array_equal(_np(got).reshape(B, N, 3, K, D).transpose(2, 0, 3, 1, 4), want)


@pytest.mark.parametrize("static", [False, True])
def test_attn_out_projection_matches_jax(static):
    B, N, H, K, D = 2, 9, 32, 4, 8
    r = np.random.default_rng(6)
    kernel = (r.normal(size=(K, D, H)) * 0.2).astype(np.float32)
    layer = _layer(kernel.reshape(-1, H), r.normal(size=H).astype(np.float32))
    params = _jax_params(layer, ((K, D, H), (H,)), static=0.05 if static else None)
    out = r.normal(size=(B, K, N, D)).astype(np.float32)
    out[1, :, 4] = 0.0                      # a token whose (K, D) slice is zero
    want = np.asarray(jquant.attn_out_projection(params, jnp.asarray(out)))
    got = tquant.attn_out_projection(_t(out.transpose(0, 2, 1, 3).reshape(B, N, K * D)), layer)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int_mm_pads_few_rows_and_stays_exact():
    layer = _layer(_kernel_with_edges(16, 24, seed=7))
    xq = torch.randint(-127, 128, (3, 5, 16), generator=torch.Generator().manual_seed(0),
                       dtype=torch.int8)
    got = layer.int_mm(xq)
    assert got.dtype == torch.int32 and got.shape == (3, 5, 24)
    assert torch.equal(got, (xq.long() @ layer.weight_q.long().t()).int())


# --- selection, calibration, models ---------------------------------------------

def _cross_fields(**kw):
    f = dict(hidden_dim=64, mlp_dim=128, num_heads=4, num_multi_blocks=1, num_self_blocks=1,
             img_size=(16, 16, 8), patch_size=(8, 8, 4), num_modalities=3,
             attn_order={"0": "1", "1": "2", "2": "0"}, dropout=0.0, label_smoothing=0.0,
             use_flash_attention=False)
    f.update(kw)
    return f


def _vit_fields(**kw):
    f = dict(hidden_dim=64, mlp_dim=128, num_heads=4, num_layers=1, img_size=(16, 16, 8),
             patch_size=(8, 8, 4), num_modalities=2, dropout=0.0, use_flash_attention=False)
    f.update(kw)
    return f


_FAMILIES = {"cross": (jax_cross_config, get_mgmt_cross_config, jmc, ModelCross, _cross_fields),
             "vit": (jax_vit_config, get_mgmt_config, jmv, ModelVIT, _vit_fields)}


def _pair(family, **kw):
    """(jax config, port config, jax module, port model with the JAX params
    loaded, the params as numpy) for the same fields."""
    jfactory, tfactory, jmod, tcls, fields = _FAMILIES[family]
    jc, tc = jfactory(), tfactory()
    jax_modify(jc, fields(**kw))
    modify_config(tc, fields(**kw))
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(0), jc))
    model = tcls(tc, device="cpu")
    load_jax_params(model, params)
    return jc, tc, jmod, model, params


def _img(cfg, b=2, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, cfg.num_modalities, 1, *cfg.img_size)) * 100).astype(np.float32)


def _as_state_dict(qparams, cfg, leaf):
    """A state dict of the JAX quantized tree with each quantized node's
    kernel replaced by ``leaf(node)`` broadcast to the kernel's shape, in the
    torch layout (the port's convert mapping)."""
    def walk(node):
        if isinstance(node, dict):
            if "kernel_q" in node:
                k = np.broadcast_to(np.asarray(leaf(node), np.float32), node["kernel_q"].shape)
                return {"kernel": np.array(k), "bias": node.get("bias", np.zeros(1))}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    return state_dict_from_jax(walk(qparams), cfg)


def _scale_leaf(node):
    """The per-output-channel scale, broadcast along the contracted axes."""
    s = np.asarray(node["kernel_scale"])
    return s.reshape((1,) * (node["kernel_q"].ndim - s.ndim) + s.shape)


# (family, fields, attn) → JAX count_quantized at the live structure with
# min_size scaled: ModelCross 2 multi × 3 streams × 2 self blocks, 3 cross
# pairs, 3 heads; ModelVIT 4 layers
@pytest.mark.parametrize("family,attn,want", [("cross", False, 39), ("cross", True, 63),
                                              ("vit", False, 9), ("vit", True, 17)])
def test_selection_matches_jax(family, attn, want):
    kw = dict(num_multi_blocks=2, num_self_blocks=2) if family == "cross" else dict(num_layers=4)
    jc, tc, _, model, params = _pair(family, **kw)
    qparams = jquantize.quantize_for_inference(params, min_size=MIN_SIZE, attn=attn)
    assert jquantize.count_quantized(qparams)[0] == want
    tquantize.quantize_for_inference(model, attn=attn, min_size=MIN_SIZE, source=params)
    assert tquantize.count_quantized(model) == jquantize.count_quantized(qparams)
    wq = _as_state_dict(qparams, tc, lambda n: n["kernel_q"])
    sc = _as_state_dict(qparams, tc, _scale_leaf)
    layers = {n: m for n, m in model.named_modules() if isinstance(m, tquant.QuantLinear)}
    for name, layer in layers.items():
        np.testing.assert_array_equal(layer.weight_q.numpy(), wq[f"{name}.weight"], name)
        np.testing.assert_array_equal(layer.weight_scale.numpy(), sc[f"{name}.weight"][:, 0])
    # excluded layers stay float
    assert isinstance(model.patch_to_embedding, torch.nn.Linear)
    head_fc2 = model.mlp_head[0]["3"] if family == "cross" else model.mlp_head["4"]
    assert isinstance(head_fc2, torch.nn.Linear)
    if family == "cross":
        fn = model.transformer[0].fusion[0].attn.fn
        assert all(isinstance(getattr(fn, n), torch.nn.Linear) for n in ("wq", "wk", "wv", "proj"))
    attn0 = (model.transformer[0].blocks[0][0].attn.fn if family == "cross"
             else model.transformer.layers[0]["0"].fn)
    assert isinstance(attn0.to_qkv, tquant.QuantLinear) == attn
    assert not any(isinstance(p, torch.Tensor) and p.dtype == torch.int8
                   for p in model.parameters())


def test_quantizes_from_the_source_not_the_cast_weights():
    """A bf16 serving model holds its weights rounded to bf16; quantizing
    from the f32 checkpoint gives JAX's int8 weights, quantizing the model's
    own weights other ones."""
    jc, tc, _, _, params = _pair("cross", compute_dtype="bfloat16")
    bf16 = ModelCross(tc, device="cpu")
    load_jax_params(bf16, params)
    own = ModelCross(tc, device="cpu")
    load_jax_params(own, params)
    tquantize.quantize_for_inference(bf16, min_size=MIN_SIZE, source=params)
    tquantize.quantize_for_inference(own, min_size=MIN_SIZE)
    want = _as_state_dict(jquantize.quantize_for_inference(params, min_size=MIN_SIZE), tc,
                          lambda n: n["kernel_q"])
    name = "transformer.0.blocks.0.0.ffn.fn.net.0"
    got = bf16.get_submodule(name).weight_q.numpy()
    np.testing.assert_array_equal(got, want[f"{name}.weight"])
    assert not np.array_equal(own.get_submodule(name).weight_q.numpy(), got)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("mode", ["int8", "int8+attn"])
@pytest.mark.parametrize("family", ["cross", "vit"])
def test_quantized_logits_match_jax(family, mode, flash):
    jc, tc, jmod, model, params = _pair(family, use_flash_attention=flash)
    attn = mode == "int8+attn"
    qparams = jquantize.quantize_for_inference(params, min_size=MIN_SIZE, attn=attn)
    tquantize.quantize_for_inference(model, attn=attn, min_size=MIN_SIZE, source=params)
    img = _img(tc, seed=len(mode))
    want = np.asarray(jmod.apply(qparams, jc, jnp.asarray(img), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    # the float model's logits differ: the quantized layers ran
    assert not np.allclose(got, np.asarray(jmod.apply(params, jc, jnp.asarray(img))), atol=1e-6)


@pytest.mark.parametrize("flash", [False, True])
def test_single_head_int8_attn_matches_jax(flash):
    """heads==1: the reference's Identity to_out — no output projection."""
    jc, tc, _, model, params = _pair("cross", num_heads=1, use_flash_attention=flash)
    qparams = jquantize.quantize_for_inference(params, min_size=MIN_SIZE, attn=True)
    tquantize.quantize_for_inference(model, attn=True, min_size=MIN_SIZE, source=params)
    fn = model.transformer[0].blocks[0][0].attn.fn
    assert isinstance(fn.to_qkv, tquant.QuantLinear) and fn.to_out is None
    img = _img(tc, seed=9)
    want = np.asarray(jmc.apply(qparams, jc, jnp.asarray(img), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_float_out_projection_under_min_size_matches_jax():
    """int8+attn with the qkv projection over min_size and the out projection
    under it: JAX's float einsum branch (hidden 48: 6912 ≥ 4096 > 2304)."""
    jc, tc, _, model, params = _pair("cross", hidden_dim=48, num_heads=3)
    qparams = jquantize.quantize_for_inference(params, min_size=MIN_SIZE, attn=True)
    tquantize.quantize_for_inference(model, attn=True, min_size=MIN_SIZE, source=params)
    fn = model.transformer[0].blocks[0][0].attn.fn
    assert isinstance(fn.to_qkv, tquant.QuantLinear)
    assert isinstance(fn.to_out["0"], torch.nn.Linear)
    img = _img(tc, seed=10)
    want = np.asarray(jmc.apply(qparams, jc, jnp.asarray(img), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_calibrate_matches_jax_and_leaves_no_capture_state():
    jc, tc, _, model, params = _pair("cross")
    qparams = jquantize.quantize_for_inference(params, min_size=MIN_SIZE, attn=True)
    tquantize.quantize_for_inference(model, attn=True, min_size=MIN_SIZE, source=params)
    img = _img(tc, seed=11)
    want_tree = jquantize.calibrate(qparams, lambda p, x: jmc.apply(p, jc, x), jnp.asarray(img),
                                    margin=1.1)
    tquantize.calibrate(model, torch.from_numpy(img), margin=1.1)
    want = _as_state_dict(want_tree, tc, lambda n: n["act_scale"])
    layers = tquantize.quantized_layers(model)
    assert len(layers) == 2 * 3 + 2 * 3 + 3 + 3 * 2    # FFNs, cross FFNs, heads, attn
    for name, layer in ((n, m) for n, m in model.named_modules() if m in layers):
        assert layer.act_scale.dtype == torch.float32
        np.testing.assert_allclose(float(layer.act_scale), want[f"{name}.weight"].flat[0],
                                   rtol=1e-6, err_msg=name)
        assert not layer.capturing and layer.calib_amax is None
    # the static scales serve: logits as JAX's with the same act_scales
    img2 = _img(tc, seed=12)
    with torch.inference_mode():
        got = model(torch.from_numpy(img2)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmc.apply(want_tree, jc, jnp.asarray(img2))),
                               atol=ATOL, rtol=0)


def test_int8_self_attention_routes_to_k7_above_1040(monkeypatch):
    """An int8+attn self-attention at N = 1041: the public op takes K7 (its
    plain version here), as the JAX op does, and matches JAX's branch."""
    ran = []
    for name in ("flash_attention_single_reference", "flash_attention_stream_reference"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _n=name: ran.append(_n) or _fn(*a))
    B, N, H, K, D = 1, 1041, 16, 2, 8
    r = np.random.default_rng(13)
    qkv_k = (r.normal(size=(H, 3, K, D)) * 0.3).astype(np.float32)
    out_k = (r.normal(size=(K, D, H)) * 0.3).astype(np.float32)
    bias = r.normal(size=H).astype(np.float32)
    to_qkv, to_out = _layer(qkv_k.reshape(H, -1)), _layer(out_k.reshape(-1, H), bias)
    params = {"qkv": _jax_params(to_qkv, ((H, 3, K, D), (3, K, D))),
              "out": _jax_params(to_out, ((K, D, H), (H,)))}
    x = r.normal(size=(B, N, H)).astype(np.float32)
    want = np.asarray(jattention.self_attention(params, jnp.asarray(x), K, 0.0, RngStream(None),
                                                False, impl="flash"))
    got = self_attention(_t(x), to_qkv, to_out, K, impl="flash")
    assert ran == ["flash_attention_stream_reference"]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_linear_layer_is_linear_on_a_float_layer():
    lin = torch.nn.Linear(8, 4)
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(14))
    assert torch.equal(linear_layer(lin, x), linear(x, lin.weight, lin.bias))
