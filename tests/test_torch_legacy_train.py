"""The port's stateful ``Trainer`` (the BatchNorm families) against the JAX
package's: a ViT3D ``Trainer.fit`` under the plateau schedule from the same
weights, BatchNorm state, batches and sampler draws gives JAX's history
within 1e-4; checkpoints carry ``model_state`` and ``plateau`` in JAX's
layout, so each package resumes the other's; ``grad_accum`` > 1 is refused
for a stateful model, and a mesh of one rank gives the no-mesh step."""

import socket

import jax
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.configs import get_mgmt_config as jax_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.data import dataset as jds
from cross_attention_vit_tpu.data.loader import PrefetchLoader as JaxLoader
from cross_attention_vit_tpu.models import vit3d as jvit3d
from cross_attention_vit_tpu.train import checkpoint as jckpt
from cross_attention_vit_tpu.train import trainer as jtrainer
from cross_attention_vit_tpu_torch.configs import get_mgmt_config, modify_config
from cross_attention_vit_tpu_torch.data import dataset as tds
from cross_attention_vit_tpu_torch.data.loader import PrefetchLoader
from cross_attention_vit_tpu_torch.models import convert as tconvert
from cross_attention_vit_tpu_torch.models.vit3d import ViT3D
from cross_attention_vit_tpu_torch.parallel import make_mesh, multihost_init
from cross_attention_vit_tpu_torch.train import checkpoint as tckpt
from cross_attention_vit_tpu_torch.train import trainer as ttrainer

TINY = dict(hidden_dim=32, num_heads=4, num_layers=1, img_size=(32, 32, 16), num_modalities=2,
            dropout=0.0, label_smoothing=0.0, lr=1e-4, weight_decay=5e-4, img_aug=False,
            optim_params={"factor": 0.5, "patience": 0})


class FakeDataset:
    def __init__(self, imgs, labels):
        self.imgs, self.labels = imgs, labels

    def __len__(self):
        return len(self.labels)

    def batch(self, indices):
        idx = np.asarray(indices)
        return self.imgs[idx], self.labels[idx]


def _data(n=8, seed=0):
    r = np.random.default_rng(seed)
    labels = (np.arange(n) % 3 == 0).astype(np.int32)
    imgs = (r.normal(size=(n, 2, 1, 32, 32, 16)) * 4
            + labels[:, None, None, None, None, None]).astype(np.float32)
    return FakeDataset(imgs, labels)


def _setup(**extra):
    """Weights from a seed, with the stem's conv biases at 1: a conv bias
    that feeds a BatchNorm has a zero gradient in exact arithmetic, so at
    zero its Adam step is the sign of rounding noise (see
    test_torch_legacy_models.py); at 1 weight decay gives it the same
    gradient in both packages."""
    cfg, jcfg = get_mgmt_config(), jax_config()
    modify_config(cfg, {**TINY, **extra})
    jax_modify(jcfg, {**TINY, **extra})
    model = ViT3D(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i in range(1, 5):
            getattr(model.encoder, f"conv{i}").bias.fill_(1.0)
    return cfg, jcfg, tconvert.jax_params_from_model(model), tconvert.jax_state_from_model(model)


def _port(cfg, params, state, **kw):
    t = ttrainer.Trainer(ViT3D, cfg, device="cpu", stateful=True, schedule="plateau",
                         **{"max_epochs": 2, "seed": 3, **kw})
    return t.init_state(params, state)


def _jax(jcfg, params, state, **kw):
    t = jtrainer.Trainer(jvit3d, jcfg, stateful=True, schedule="plateau",
                         **{"max_epochs": 2, "seed": 3, **kw})
    return t.init_state(jax.tree.map(jax.numpy.asarray, params),
                        jax.tree.map(jax.numpy.asarray, state))


def test_stateful_fit_history_matches_jax():
    """Two epochs of 2 weighted-sampler steps and an eval pass each: every
    history value within 1e-4, the plateau's learning rate cut after the
    first epoch's val_loss (patience 0) in both, and the running statistics
    at the end within 1e-5 relative (train_vit3d's lr and weight decay)."""
    cfg, jcfg, params, state = _setup()
    ds = _data()
    w = (ds.labels == 0) * 1.0 + 2.0
    jt = _jax(jcfg, params, state)
    jhist = jt.fit(JaxLoader(ds, batch_size=4), JaxLoader(ds, batch_size=4),
                   sampler=jds.WeightedRandomSampler(w, len(ds), seed=3), verbose=False)
    t = _port(cfg, params, state)
    hist = t.fit(PrefetchLoader(ds, batch_size=4, device="cpu"),
                 PrefetchLoader(ds, batch_size=4, device="cpu"),
                 sampler=tds.WeightedRandomSampler(w, len(ds), seed=3), verbose=False)
    assert len(hist) == len(jhist) == 2
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        for k in row:
            if k != "epoch_time_s":
                assert abs(row[k] - jrow[k]) <= 1e-4, (k, row[k], jrow[k])
    assert t.plateau.lr == jt.plateau.lr and t.plateau.num_bad == jt.plateau.num_bad
    assert t.global_step == jt.global_step == 4
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6),
                 t.model_state, jt.model_state)


def test_eval_step_reads_the_running_statistics():
    """The stateful eval step equals a direct eval forward and moves no
    buffer; the train step moves them."""
    cfg, _, params, state = _setup()
    t = _port(cfg, params, state)
    ds = _data(n=4)
    img, labels = torch.from_numpy(ds.imgs), torch.from_numpy(ds.labels).long()
    aux = t.eval_step(img, labels)
    with torch.no_grad():
        want = t.model(img)
    torch.testing.assert_close(aux["logits"], want, rtol=0, atol=0)
    jax.tree.map(np.testing.assert_array_equal, t.model_state, state)
    t.train_step(img, labels, 1e-3, torch.Generator().manual_seed(0))
    assert not np.array_equal(t.model_state["encoder"]["bn1"]["mean"],
                              state["encoder"]["bn1"]["mean"])


def test_checkpoints_cross_between_packages(tmp_path):
    """A JAX stateful checkpoint resumes the port's Trainer with its
    params, model_state, plateau and moments; the port's snapshot restores
    in JAX against JAX's own checkpoint structure, bit for bit."""
    cfg, jcfg, params, state = _setup()
    ds = _data()
    jt = _jax(jcfg, params, state, max_epochs=1,
              latest=jckpt.LatestCheckpointer(tmp_path / "jax"))
    jt.fit(JaxLoader(ds, batch_size=4), JaxLoader(ds, batch_size=4), verbose=False)
    t = _port(cfg, params, state, max_epochs=1, latest=tckpt.LatestCheckpointer(tmp_path / "jax"))
    assert t.maybe_resume() == 1 and t.global_step == jt.global_step
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                 t.params, jt.params)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                 t.model_state, jt.model_state)
    # the checkpoint holds the plateau's lr and best as float32
    assert (t.plateau.lr, t.plateau.best, t.plateau.num_bad) == \
        (pytest.approx(jt.plateau.lr), pytest.approx(jt.plateau.best), jt.plateau.num_bad)

    snapshot = t._ckpt_state(0)
    tckpt.save_pytree(tmp_path / "port.npz", snapshot)
    got = jckpt.restore_pytree(tmp_path / "port.npz", jt._ckpt_state(0))
    jckpt.save_pytree(tmp_path / "back.npz", got)      # JAX's own key layout
    back = tckpt.restore_flat(tmp_path / "back.npz")
    assert set(back) == set(snapshot)
    for key, want in back.items():
        np.testing.assert_array_equal(snapshot[key], want, err_msg=key)
    assert {k.split("/")[0] for k in snapshot} == {"params", "opt", "epoch", "model_state",
                                                   "plateau"}


def test_port_resume_restores_model_state_and_plateau(tmp_path):
    cfg, _, params, state = _setup()
    ds = _data()
    ld = PrefetchLoader(ds, batch_size=4, device="cpu")
    lc = tckpt.LatestCheckpointer(tmp_path / "latest")
    first = _port(cfg, params, state, max_epochs=1, latest=lc)
    first.fit(ld, ld, verbose=False)
    resumed = _port(cfg, params, state, max_epochs=2, latest=lc)
    assert resumed.maybe_resume() == 1
    jax.tree.map(np.testing.assert_array_equal, resumed.model_state, first.model_state)
    assert (resumed.plateau.lr, resumed.plateau.best, resumed.plateau.num_bad) == \
        (pytest.approx(first.plateau.lr), pytest.approx(first.plateau.best),
         first.plateau.num_bad)


def test_stateful_refusals():
    cfg, jcfg, _, _ = _setup()
    with pytest.raises(ValueError, match="grad_accum"):
        jtrainer.Trainer(jvit3d, jcfg, max_epochs=1, stateful=True, grad_accum=2)
    with pytest.raises(ValueError, match="grad_accum"):
        ttrainer.Trainer(ViT3D, cfg, max_epochs=1, stateful=True, grad_accum=2, device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # a mesh is no refusal: over a world of one the step is the no-mesh step
    # bit for bit (the synchronised BatchNorm over two ranks:
    # test_torch_sync_bn.py)
    ds = _data()
    img, lab = torch.from_numpy(ds.imgs[:4]), torch.from_numpy(ds.labels[:4]).long()
    one = _port(cfg, *_setup()[2:], max_epochs=1)
    one.train_step(img, lab, cfg.lr, torch.Generator().manual_seed(0))
    multihost_init(f"127.0.0.1:{port}", 1, 0, device="cpu", timeout_s=30)
    try:
        t = _port(cfg, *_setup()[2:], max_epochs=1, mesh=make_mesh())
        t.train_step(img, lab, cfg.lr, torch.Generator().manual_seed(0))
        for (k, a), b in zip(t.model.state_dict().items(), one.model.state_dict().values()):
            assert torch.equal(a, b), k
    finally:
        torch.distributed.destroy_process_group()


def _one_step_grads(model_cls, cfg, stateful, img):
    t = ttrainer.Trainer(model_cls, cfg, max_epochs=1, seed=1, device="cpu",
                         stateful=stateful, schedule="plateau").init_state()
    t.train_step(torch.from_numpy(img), torch.tensor([0, 1]), cfg.lr, torch.Generator())
    return {n: p.grad for n, p in t.model.named_parameters()}


def test_stateful_step_gives_unreached_parameters_a_zero_gradient():
    """The truncated DenseNet stem's tail never runs: the stateful Trainer's
    step gives its parameters JAX's zero gradient (so Adam's moments and
    weight decay move them as JAX's do); the rest have a gradient."""
    cfg = get_mgmt_config()
    modify_config(cfg, {**TINY, "pretrained_cnn": True, "num_modalities": 1, "hidden_dim": 64})
    img = _data(2).imgs[:, :1]
    grads = _one_step_grads(ViT3D, cfg, True, img)
    tail = [n for n in grads if "denseblock4" in n or "class_layers" in n]
    assert tail and all(bool((grads[n] == 0).all()) for n in tail)
    assert all(g is not None for g in grads.values())
    assert any(bool(g.abs().sum() > 0) for n, g in grads.items() if "denseblock1" in n)


@pytest.mark.parametrize("family", ["cross", "vit"])
def test_stateless_families_reach_every_parameter(family):
    """ModelCross and ModelVIT reach every parameter in a train forward, so
    their step needs no zero gradients for unreached ones."""
    from cross_attention_vit_tpu_torch.configs import get_mgmt_cross_config
    from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
    from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT

    cfg = get_mgmt_cross_config() if family == "cross" else get_mgmt_config()
    modify_config(cfg, dict(hidden_dim=32, mlp_dim=64, num_heads=4, num_multi_blocks=1,
                            num_self_blocks=1, num_layers=2, img_size=(16, 16, 8),
                            patch_size=(8, 8, 8), num_modalities=2,
                            attn_order={"0": "1", "1": "0"}, dropout=0.1, lr=1e-3,
                            weight_decay=5e-4, label_smoothing=0.0, img_aug=False,
                            optim_params={"factor": 0.5, "patience": 0}))
    img = np.random.default_rng(0).normal(size=(2, 2, 1, 16, 16, 8)).astype(np.float32)
    grads = _one_step_grads(ModelCross if family == "cross" else ModelVIT, cfg, False, img)
    assert [n for n, g in grads.items() if g is None] == []
