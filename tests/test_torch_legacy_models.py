"""The port's legacy families (``models/vit3d.py``, ``models/cnn_vit.py``,
``models/densenet.py``) against the JAX package's, at
``tests/test_legacy_models.py``'s geometry.

The port's models are made from a seed; ``models.convert`` carries their
weights and BatchNorm state into JAX's layout, whose tree structure and
shapes must be JAX ``init``'s, and the JAX functions run on those arrays.
f32 eval logits within 1e-4, the BatchNorm state a train forward leaves
within 1e-5 relative, and one stateful Adam step (dropout 0) with its loss,
gradients, parameters and state held to JAX's ``make_stateful_train_step``.

One difference is intended: a DenseNet truncated inside a dense block moves
the running statistics of every BatchNorm it ran, as torch's truncated
``nn.Sequential`` does; the JAX ``densenet.apply`` drops the truncated
block's new statistics (its block state is assigned after the block's loop,
which the truncation leaves).  The state tests hold every other block to
JAX and that block to the torch behaviour.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.configs import get_mgmt_config as jax_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.models import cnn_vit as jcnn
from cross_attention_vit_tpu.models import densenet as jdense
from cross_attention_vit_tpu.models import vit3d as jvit3d
from cross_attention_vit_tpu.train import optim as joptim
from cross_attention_vit_tpu_torch.configs import get_mgmt_config, modify_config
from cross_attention_vit_tpu_torch.models import convert as tconvert
from cross_attention_vit_tpu_torch.models.cnn_vit import CNNViT
from cross_attention_vit_tpu_torch.models.densenet import DenseNet121
from cross_attention_vit_tpu_torch.models.vit3d import DENSENET_TRUNCATION, ViT3D
from cross_attention_vit_tpu_torch.train.optim import Adam
from cross_attention_vit_tpu_torch.train.trainer import make_stateful_train_step

VIT3D = dict(hidden_dim=32, num_heads=4, num_layers=2, img_size=(32, 32, 16), num_modalities=2,
             dropout=0.0, label_smoothing=0.1, lr=1e-3, weight_decay=0.0,
             optim_params={"T_max": 10, "eta_min": 1e-6})
DENSE_STEM = dict(pretrained_cnn=True, num_modalities=1, hidden_dim=64)
CNN_VIT = dict(img_size=(32, 32, 32), num_modalities=2, patches_grid=(2, 2, 2), hidden_size=64,
               transformer_num_layers=2, transformer_num_heads=4, transformer_mlp_dim=128)


def _cfgs(base: dict, **over):
    cfg, jcfg = get_mgmt_config(), jax_config()
    modify_config(cfg, {**base, **over})
    jax_modify(jcfg, {**base, **over})
    return cfg, jcfg


def _img(cfg, b=2, seed=0, scale=10.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, cfg.num_modalities, 1, *cfg.img_size)) * scale).astype(np.float32)


def _same_layout(got, want_shapes):
    """A tree of arrays has JAX init's structure and shapes."""
    assert jax.tree.structure(got) == jax.tree.structure(want_shapes)
    jax.tree.map(lambda a, s: np.testing.assert_equal(np.shape(a), s.shape), got, want_shapes)


def _close_state(got: dict, want: dict, skip: str | None = None):
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want)):
        if skip is not None and skip in jax.tree_util.keystr(path):
            continue
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def _vit3d_pair(**over):
    cfg, jcfg = _cfgs(VIT3D, **over)
    model = ViT3D(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params, state = tconvert.jax_params_from_model(model), tconvert.jax_state_from_model(model)
    return cfg, jcfg, model, params, state


VIT3D_CASES = {"cls": {}, "mean_pool": {"add_cls_token": False}, "densenet": DENSE_STEM}


@pytest.mark.parametrize("case", list(VIT3D_CASES))
def test_vit3d_matches_jax(case):
    """Layout, eval logits and loss, then a train-mode forward's logits and
    the BatchNorm state it leaves (the stem's statistics chain across the
    modalities); eval leaves the state alone."""
    cfg, jcfg, model, params, state = _vit3d_pair(**VIT3D_CASES[case])
    _same_layout((params, state), jax.eval_shape(lambda k: jvit3d.init(k, jcfg),
                                                 jax.random.key(0)))
    img, labels = _img(cfg), np.array([0, 1])
    apply = jax.jit(lambda p, s, x, y, train: jvit3d.apply(p, s, jcfg, x, y, train=train),
                    static_argnums=4)
    logits, loss, _ = apply(params, state, img, labels, False)
    with torch.no_grad():
        got, got_loss = model(torch.from_numpy(img), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=1e-4, rtol=0)
    assert abs(float(got_loss) - float(loss)) <= 1e-5
    _close_state(tconvert.jax_state_from_model(model), state)   # eval moved nothing

    logits, _, new_state = apply(params, state, img, labels, True)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(img), torch.from_numpy(labels), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=1e-4, rtol=0)
    ported = tconvert.jax_state_from_model(model)
    skip = "'denseblock3'" if case == "densenet" else None
    _close_state(ported, new_state, skip)
    if case == "densenet":
        # the truncated block's BatchNorms ran in train mode: they moved here
        moved = ported["encoder"]["features"]["denseblock3"]["denselayer24"]["norm1"]["mean"]
        before = state["encoder"]["features"]["denseblock3"]["denselayer24"]["norm1"]["mean"]
        assert not np.allclose(moved, before)
    else:
        assert not np.allclose(ported["encoder"]["bn1"]["mean"], state["encoder"]["bn1"]["mean"])


def test_vit3d_bf16_compute_matches_jax():
    """compute_dtype bfloat16: the transformer's GEMMs in bf16 with f32
    accumulation (the QKV bias added in f32, one cast), the stem in f32."""
    cfg, jcfg, model, params, state = _vit3d_pair(compute_dtype="bfloat16")
    img = _img(cfg, seed=3)
    logits, _ = jax.jit(lambda p, s, x: jvit3d.apply(p, s, jcfg, x))(params, state, img)
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=2e-2, rtol=0)


@pytest.mark.parametrize("case", ["cls", "densenet"])
def test_one_stateful_adam_step_matches_jax(case):
    """The port's make_stateful_train_step against the JAX one's math
    (``train/trainer.py:234-274``: value_and_grad of the train-mode apply
    with the new state as aux, then ``optim.update``): the loss, each
    gradient normalised by its tensor's maximum within 1e-4, the new
    BatchNorm state within 1e-5 relative, and the parameters within 1e-5
    relative of JAX's Adam given the port's gradients (an Adam step turns a
    gradient element at rounding-noise size into up to lr of movement, so
    the update is held on equal gradients).

    A conv bias that feeds a BatchNorm (the CNN3DEncoder's) has a zero
    gradient in exact arithmetic (train-mode BN subtracts the batch mean):
    both packages' gradients there are noise, held to vanishing instead."""
    cfg, jcfg, model, params, state = _vit3d_pair(**VIT3D_CASES[case])
    img, labels, lr = _img(cfg, seed=1), np.array([1, 0], np.int32), 1e-3
    jparams, jstate = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)

    def loss_fn(p):
        _, loss, new_state = jvit3d.apply(p, jstate, jcfg, img, labels, train=True,
                                          rng=jax.random.key(0))
        return loss, new_state

    (want_loss, want_state), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    step = make_stateful_train_step(model, Adam(model.parameters(), cfg.weight_decay), cfg)
    got = step(torch.from_numpy(img), torch.from_numpy(labels), lr,
               torch.Generator().manual_seed(0))
    assert abs(float(got["loss"]) - float(want_loss)) <= 1e-5
    _close_state(tconvert.jax_state_from_model(model), want_state,
                 "'denseblock3'" if case == "densenet" else None)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    zero_grad = {f"encoder.conv{i}.bias" for i in range(1, 5)} if case == "cls" else set()
    want_grads = tconvert.state_dict_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    top = max(np.abs(w).max() for w in want_grads.values())
    for name, want in want_grads.items():
        if name in zero_grad:
            conv = name[:-len("bias")]
            assert np.abs(grads[name]).max() <= 1e-4 * np.abs(grads[conv + "weight"]).max()
            continue
        # a gradient below a hundredth of the model's largest is a sum that
        # cancels (the affine gradients of the BatchNorm nearest the input,
        # through the whole DenseNet): its own maximum is not its scale, and it
        # is held to 1e-5 of the largest gradient.  The DenseNet's layers past
        # the truncation get JAX's zero gradient.
        scale = np.abs(want).max()
        err = np.abs(grads[name] - want).max()
        assert (err <= 1e-4 * scale) or (scale < 1e-2 * top and err <= 1e-5 * top), \
            (name, err, scale, top)
    # one compiled update: eagerly, the DenseNet's ~700 leaves take a minute
    adam = jax.jit(lambda g, p: joptim.update(g, joptim.init(p), p, lr,
                                              weight_decay=cfg.weight_decay)[0])
    want_p = adam(tconvert.jax_params_from_state_dict(grads, cfg), jparams)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7),
                 tconvert.jax_params_from_model(model), want_p)


def test_cnn_vit_matches_jax():
    cfg, jcfg = _cfgs(CNN_VIT)
    model = CNNViT(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = tconvert.jax_params_from_model(model)
    _same_layout(params, jax.eval_shape(lambda k: jcnn.init(k, jcfg), jax.random.key(0)))
    img, labels = _img(cfg, scale=1.0), np.array([0.0, 1.0], np.float32)
    logits, loss = jax.jit(lambda p, x, y: jcnn.apply(p, jcfg, x, y))(params, img, labels)
    with torch.no_grad():
        got, got_loss = model(torch.from_numpy(img), torch.from_numpy(labels))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=1e-4, rtol=0)
    assert abs(float(got_loss) - float(loss)) <= 1e-5
    # the CLS only from stream 0: (1 + N) + (M - 1)·N tokens, N = (32 / (4·2))³
    assert model.pos_embed.shape == (1, 65, 64)


def test_cnn_vit_init_distributions():
    """A zero CLS, an N(0, 1) positional embedding, zero biases."""
    cfg, _ = _cfgs(CNN_VIT, hidden_size=128)
    model = CNNViT(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    assert torch.count_nonzero(model.cls_token) == 0
    assert abs(model.pos_embed.std().item() - 1.0) < 0.05
    assert all(torch.count_nonzero(m.bias) == 0 for m in model.modules()
               if isinstance(m, (torch.nn.Conv3d, torch.nn.Linear)))


@pytest.fixture(scope="module")
def dense():
    model = DenseNet121(growth_rate=16, device="cpu", generator=torch.Generator().manual_seed(0))
    box = {}

    def init(k):
        p, s, box["meta"] = jdense.init(k, growth_rate=16)
        return p, s

    shapes = jax.eval_shape(init, jax.random.key(0))
    return model, shapes, box["meta"]


def test_densenet_layout_paths_and_channels(dense):
    model, shapes, meta = dense
    params, state = tconvert.jax_params_from_model(model), tconvert.jax_state_from_model(model)
    _same_layout((params, state), shapes)
    assert model.paths == meta["paths"]
    assert model.out_channels == meta["out_channels"] == 516
    names = dict(model.named_modules())
    assert DENSENET_TRUNCATION in names and all(p in names for p in model.paths)


@pytest.mark.parametrize("upto,shape", [(None, (1, 2)), (DENSENET_TRUNCATION, (1, 64, 2, 2, 2)),
                                        ("features.pool0", (1, 64, 8, 8, 8)),
                                        ("features.transition1.conv", (1, 80, 8, 8, 8)),
                                        ("features.transition1.pool", (1, 80, 4, 4, 4)),
                                        ("features.denseblock1.denselayer2.layers.norm2",
                                         (1, 64, 8, 8, 8))])
def test_densenet_forward_and_truncation_match_jax(dense, upto, shape):
    model, _, _ = dense
    params, state = tconvert.jax_params_from_model(model), tconvert.jax_state_from_model(model)
    x = np.random.default_rng(2).normal(size=(1, 1, 32, 32, 32)).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: jdense.apply(p, s, x, upto=upto))(params, state, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), upto=upto)
    assert tuple(got.shape) == shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_densenet_unknown_path_raises(dense):
    model, _, _ = dense
    with pytest.raises(KeyError, match="features.nope"):
        model(torch.zeros(1, 1, 32, 32, 32), upto="features.nope")


@pytest.mark.parametrize("case", list(VIT3D_CASES))
def test_load_without_state_raises_and_with_state_is_exact(case):
    """A ViT3D's params without JAX's state tree raise (JAX cannot apply the
    model without it); with it every running statistic is the tree's and
    num_batches_tracked keeps the model's count."""
    cfg, _, _, params, state = _vit3d_pair(**VIT3D_CASES[case])
    other = ViT3D(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    with pytest.raises(ValueError, match="state tree"):
        tconvert.load_jax_params(other, params)
    state = jax.tree.map(lambda a: a + 0.25, state)
    tconvert.load_jax_params(other, params, state)
    jax.tree.map(np.testing.assert_array_equal, tconvert.jax_state_from_model(other), state)
    assert all(int(v) == 0 for k, v in other.state_dict().items()
               if k.endswith("num_batches_tracked"))


def test_cnn_vit_has_no_state_and_loads_without_one():
    cfg, _ = _cfgs(CNN_VIT)
    model = CNNViT(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    other = CNNViT(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    assert tconvert.jax_state_from_model(model) == {}
    tconvert.load_jax_params(other, tconvert.jax_params_from_model(model))
    for (k, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=k)


def test_vit3d_init_errors_match_jax():
    for over, match in ((dict(pretrained_cnn=True, num_modalities=1, hidden_dim=32),
                         "stem output channels"),
                        (dict(pretrained_cnn=True, num_modalities=2, hidden_dim=64),
                         "num_modalities")):
        cfg, jcfg = _cfgs(VIT3D, **over)
        with pytest.raises(ValueError, match=match):
            jvit3d.init(jax.random.key(0), jcfg)
        with pytest.raises(ValueError, match=match):
            ViT3D(cfg, device="cpu")


def test_vit3d_parameter_names_are_the_reference_modules():
    cfg, _ = _cfgs(VIT3D)
    names = {n for n, _ in ViT3D(cfg, device="cpu").named_parameters()}
    assert {"encoder.conv1.weight", "encoder.bn4.bias", "pos_embed", "cls_token",
            "transformer.layers.1.self_attn.in_proj_weight",
            "transformer.layers.1.self_attn.in_proj_bias",
            "transformer.layers.1.self_attn.out_proj.weight", "transformer.layers.0.linear1.bias",
            "transformer.layers.0.norm2.weight", "mlp_head.2.weight"} <= names
    buffers = {n for n, _ in ViT3D(cfg, device="cpu").named_buffers()}
    assert {"encoder.bn1.running_mean", "encoder.bn1.running_var"} <= buffers


def test_vit3d_state_dict_loads_into_torch_transformer_encoder_layer():
    """The transformer's names and layouts are nn.TransformerEncoderLayer's:
    its eval forward on the same weights agrees with the port's layer."""
    cfg, _ = _cfgs(VIT3D, num_layers=1)
    model = ViT3D(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    layer = torch.nn.TransformerEncoderLayer(32, 4, 128, dropout=0.0, batch_first=True).eval()
    layer.load_state_dict({k[len("transformer.layers.0."):]: v for k, v in
                           model.state_dict().items() if k.startswith("transformer.layers.0.")})
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 9, 32)).astype(np.float32))
    with torch.no_grad():
        got = model._layer(model.transformer.layers[0], x, None, False)
        want = layer(x)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
