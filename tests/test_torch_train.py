"""The port's training slice against the JAX package: the train and eval
steps, Adam, the schedules and the metrics.

Geometry: hidden 64, 4 heads, 1 multi × 1 self block, 2 streams, img
(16, 16, 8), patch (8, 8, 8) → N = 5 tokens, f32, dropout 0, augmentation
off, the flash path (K1/K2's plain versions here, Pallas interpret mode on
the JAX side).  Tolerances: loss within 1e-5; per-tensor gradients within
1e-4 of max |JAX gradient|; Adam, given the same gradients, within 1e-6
relative (both sides compute in f32, the gap is rounding order); the 8-step
loss curve within the 5e-3 relative band of
tests/test_train_parity_dynamics.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.configs import get_mgmt_cross_config as jax_cross_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.models import model_cross as jmc
from cross_attention_vit_tpu.train import metrics as jmetrics
from cross_attention_vit_tpu.train import optim as joptim
from cross_attention_vit_tpu.train import schedule as jschedule
from cross_attention_vit_tpu.train.trainer import make_eval_step as jax_eval_step
from cross_attention_vit_tpu.train.trainer import make_train_step as jax_train_step
from cross_attention_vit_tpu_torch.configs import get_mgmt_cross_config, modify_config
from cross_attention_vit_tpu_torch.models import convert as tconvert
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.train import metrics as tmetrics
from cross_attention_vit_tpu_torch.train import schedule as tschedule
from cross_attention_vit_tpu_torch.train.optim import Adam
from cross_attention_vit_tpu_torch.train.trainer import make_eval_step, make_train_step


def _fields(**kw):
    f = dict(hidden_dim=64, mlp_dim=128, num_heads=4, num_multi_blocks=1, num_self_blocks=1,
             img_size=(16, 16, 8), patch_size=(8, 8, 8), num_modalities=2,
             attn_order={"0": "1", "1": "0"}, dropout=0.0, label_smoothing=0.0, lr=1e-3,
             weight_decay=5e-4, optim_params={"T_max": 10, "eta_min": 1e-6}, img_aug=False,
             use_flash_attention=True)
    f.update(kw)
    return f


def _pair(**kw):
    jc, tc = jax_cross_config(), get_mgmt_cross_config()
    jax_modify(jc, _fields(**kw))
    modify_config(tc, _fields(**kw))
    params = jax.tree.map(np.asarray, jmc.init(jax.random.key(0), jc))
    return jc, tc, params


def _port(tc, params):
    model = ModelCross(tc, device="cpu", master_weights=True)
    tconvert.load_jax_params(model, params)
    return model


def _batch(cfg, b=4, seed=0):
    r = np.random.default_rng(seed)
    img = (r.normal(size=(b, cfg.num_modalities, 1, *cfg.img_size)) * 100).astype(np.float32)
    return img, np.array([0, 1] * (b // 2), np.int32)


def test_one_f32_step_matches_jax():
    """Loss, aux and per-tensor gradients of one step against JAX's train
    objective with augmentation off and dropout 0.  (The update itself is
    held to JAX's ``optim.update`` on equal gradients below: Adam's first
    step is ±lr wherever |g| is near eps, so it would amplify the gradients'
    rounding noise.)"""
    jc, tc, params = _pair()
    img, labels = _batch(tc)
    lr = 1e-3

    def loss_fn(p):
        logits, loss = jmc.apply(p, jc, jnp.asarray(img), jnp.asarray(labels), train=True,
                                 rng=jax.random.key(1))
        return loss, logits

    (want_loss, logits), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = _port(tc, params)
    step = make_train_step(model, Adam(model.parameters(), tc.weight_decay), tc)
    aux = step(torch.from_numpy(img), torch.from_numpy(labels), lr,
               torch.Generator().manual_seed(0))

    assert abs(float(aux["loss"]) - float(want_loss)) <= 1e-5
    np.testing.assert_allclose(aux["probs"].numpy(),
                               np.asarray(jax.nn.softmax(logits, axis=1)[:, 1]), atol=1e-5)
    want_counts = jmetrics.confusion_counts(jnp.argmax(logits, 1), jnp.asarray(labels))
    assert {k: int(v) for k, v in aux["counts"].items()} == \
        {k: int(v) for k, v in want_counts.items()}
    grads = tconvert.state_dict_from_jax(jax.tree.map(np.asarray, want_grads), tc)
    for name, p in model.named_parameters():
        w, g = grads[name], p.grad.numpy()
        if name.endswith("wk.bias"):
            # zero in exact arithmetic: a key bias shifts every score of a
            # query by the same amount, which the softmax ignores
            assert np.abs(g).max() <= 1e-6 and np.abs(w).max() <= 1e-6, name
            continue
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)


def test_adam_given_equal_gradients_matches_jax():
    """Two updates with L2 weight decay, f32 moments, bias corrections."""
    r = np.random.default_rng(3)
    params = {"a": r.normal(size=(7, 5)).astype(np.float32),
              "b": r.normal(size=(5,)).astype(np.float32)}
    grads = [{k: r.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    jp, js = params, joptim.init(params)
    tp = [torch.tensor(params[k]) for k in ("a", "b")]
    opt = Adam(tp, weight_decay=5e-4)
    for g, lr in zip(grads, (1e-3, 5e-4)):
        jp, js = joptim.update(g, js, jp, lr, weight_decay=5e-4)
        for i, k in enumerate(("a", "b")):
            tp[i].grad = torch.tensor(g[k])
        opt.step(lr)
    mu, nu = opt.moments()
    for i, k in enumerate(("a", "b")):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(mu[i].numpy(), np.asarray(js.mu[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(nu[i].numpy(), np.asarray(js.nu[k]), rtol=1e-6, atol=1e-12)
    assert opt.step_count == int(js.step) == 2


def test_adam_rejects_low_precision_parameters():
    with pytest.raises(TypeError, match="master_weights"):
        Adam([torch.zeros(3, dtype=torch.bfloat16)])


def test_eight_step_loss_curve_stays_in_the_band():
    """8 steps of the JAX train step and of the port's, with the cosine lr,
    on synthetic volumes: per-step relative loss difference < 5e-3."""
    jc, tc, params = _pair()
    img, labels = _batch(tc, b=6, seed=5)
    lr_at = tschedule.cosine_annealing_lr(tc.lr, 10, 1e-6)
    jstep = jax_train_step(jmc.apply, jc, donate=False)
    jp, js = params, joptim.init(params)
    model = _port(tc, params)
    step = make_train_step(model, Adam(model.parameters(), tc.weight_decay), tc)
    gen = torch.Generator().manual_seed(0)
    jl, tl = [], []
    for e in range(8):
        jp, js, aux = jstep(jp, js, jnp.asarray(img), jnp.asarray(labels), lr_at(e),
                            jax.random.key(e))
        jl.append(float(aux["loss"]))
        aux = step(torch.from_numpy(img), torch.from_numpy(labels), lr_at(e), gen)
        tl.append(float(aux["loss"]))
    jl, tl = np.asarray(jl), np.asarray(tl)
    assert (np.abs(jl - tl) / np.abs(jl)).max() < 5e-3
    assert tl[-1] < tl[0]


def test_eval_step_matches_jax():
    jc, tc, params = _pair(use_flash_attention=False, label_smoothing=0.1)
    img, labels = _batch(tc, seed=7)
    want = jax_eval_step(jmc.apply, jc)(params, jnp.asarray(img), jnp.asarray(labels))
    got = make_eval_step(_port(tc, params), tc)(torch.from_numpy(img), torch.from_numpy(labels))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-4)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-5)


def test_bf16_train_step_with_augmentation_and_dropout_is_deterministic():
    """The live path's shape at tiny width on the CPU: bf16 compute and
    activations, bf16 augmentation, dropout 0.25, the flash path.  Finite
    losses, moving parameters, the same result from the same seed."""
    _, tc, params = _pair(compute_dtype="bfloat16", activation_dtype="bfloat16",
                          augment_dtype="bfloat16", dropout=0.25, img_aug=True, gelu_approx=True,
                          num_modalities=3, attn_order={"0": "1", "1": "2", "2": "0"})
    img, labels = _batch(tc, b=4, seed=9)

    def run():
        model = _port(tc, params)
        step = make_train_step(model, Adam(model.parameters(), tc.weight_decay), tc)
        gen = torch.Generator().manual_seed(1)
        losses = [float(step(torch.from_numpy(img), torch.from_numpy(labels), 1e-3, gen)["loss"])
                  for _ in range(3)]
        return losses, model.state_dict(), step.augmented

    (la, sa, aug), (lb, sb, _) = run(), run()
    assert np.isfinite(la).all() and la == lb
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert set(aug) == {"flip", "rot90", "affine", "contrast", "noise", "smooth", "shuffle",
                        "coarse_dropout", "zoom"}
    moved = tconvert.state_dict_from_jax(params, tc)
    assert any(not np.array_equal(sa[k].numpy(), moved[k]) for k in sa)
    assert all(v.dtype == torch.float32 for v in sa.values())


def test_train_step_refuses_what_it_does_not_port():
    _, tc, params = _pair()
    model = _port(tc, params)
    opt = Adam(model.parameters())
    # gradient accumulation is ported (tests/test_torch_trainer.py); what the
    # step still refuses is an invalid count or loop form
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(model, opt, tc, grad_accum=0)
    with pytest.raises(ValueError, match="accum_impl"):
        make_train_step(model, opt, tc, grad_accum=2, accum_impl="while")
    with pytest.raises(ValueError, match="master_weights"):
        make_train_step(ModelCross(tc, device="cpu"), opt,
                        modify_config(tc, {"compute_dtype": "bfloat16"}))


# --- schedules and metrics -----------------------------------------------------

def test_cosine_schedule_matches_jax_and_is_periodic():
    want = jschedule.cosine_annealing_lr(1e-4, 250, 1e-6)
    got = tschedule.cosine_annealing_lr(1e-4, 250, 1e-6)
    for e in (0, 1, 100, 249, 250, 251, 400, 500, 600):
        assert got(e) == want(e)
    assert got(0) == 1e-4 and abs(got(500) - 1e-4) < 1e-12 and got(250) == pytest.approx(1e-6)


def test_reduce_on_plateau_matches_jax():
    want = jschedule.ReduceLROnPlateau(1e-3, factor=0.5, patience=2, min_lr=1e-4)
    got = tschedule.ReduceLROnPlateau(1e-3, factor=0.5, patience=2, min_lr=1e-4)
    for metric in (1.0, 0.9, 0.95, 0.95, 0.95, 0.8, 0.81, 0.81, 0.81, 0.81, 0.81, 0.81, 0.81):
        assert got.step(metric) == want.step(metric)


@pytest.mark.parametrize("case", ["mixed", "all_negative", "empty_positive_preds"])
def test_confusion_counts_and_metrics_match_jax(case):
    preds = {"mixed": [1, 0, 1, 1, 0, 0], "all_negative": [0, 0, 0, 0, 0, 0],
             "empty_positive_preds": [0, 0, 0, 0, 0, 0]}[case]
    labels = {"mixed": [1, 0, 0, 1, 1, 0], "all_negative": [0, 0, 0, 0, 0, 0],
              "empty_positive_preds": [1, 1, 1, 1, 1, 1]}[case]
    want_c = jmetrics.confusion_counts(jnp.asarray(preds), jnp.asarray(labels))
    got_c = tmetrics.confusion_counts(torch.tensor(preds), torch.tensor(labels))
    assert {k: int(v) for k, v in got_c.items()} == {k: int(v) for k, v in want_c.items()}
    want = jmetrics.metrics_from_counts(want_c)
    got = tmetrics.metrics_from_counts(got_c)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k])), k


@pytest.mark.parametrize("case", ["ties", "distinct", "one_class"])
def test_binary_auroc_matches_jax(case):
    scores = {"ties": [0.1, 0.4, 0.4, 0.8, 0.4, 0.1, 0.9],
              "distinct": [0.3, 0.1, 0.7, 0.2, 0.9, 0.6, 0.5],
              "one_class": [0.3, 0.1, 0.7, 0.2, 0.9, 0.6, 0.5]}[case]
    labels = {"ties": [0, 1, 0, 1, 1, 0, 1], "distinct": [0, 0, 1, 0, 1, 1, 0],
              "one_class": [1] * 7}[case]
    want = float(jmetrics.binary_auroc(jnp.asarray(scores), jnp.asarray(labels)))
    got = float(tmetrics.binary_auroc(torch.tensor(scores), torch.tensor(labels)))
    assert got == pytest.approx(want, abs=1e-7)
