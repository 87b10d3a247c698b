"""The port's epoch ``Trainer`` and what it writes, against the JAX package's.

* A tiny f32 ModelCross (dropout 0, no augmentation) started from the same
  JAX-initialised parameters gives ``Trainer.fit`` histories equal to the JAX
  ``Trainer.fit``'s within 1e-4 over 2 epochs (same batches, same sampler
  draws; the gap is f32 summation order through forward, backward and Adam).
* ``grad_accum=2`` equals one full-batch step within 1e-5 (f32; the two
  microbatch gradients are summed in another order).
* Resume, early stopping, top-k pruning, partial ``.tmp.npz`` files and the
  CSV logger's resume behave as the JAX ``tests/test_train.py:156-462``
  requires; checkpoints carry the JAX npz key layout, so each package
  restores the other's.
"""

import csv
import socket

import jax
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.configs import get_mgmt_cross_config as jax_cross_config
from cross_attention_vit_tpu.configs import modify_config as jax_modify
from cross_attention_vit_tpu.data import dataset as jds
from cross_attention_vit_tpu.data.loader import PrefetchLoader as JaxLoader
from cross_attention_vit_tpu.models import model_cross
from cross_attention_vit_tpu.train import checkpoint as jckpt
from cross_attention_vit_tpu.train import trainer as jtrainer
from cross_attention_vit_tpu_torch.configs import get_mgmt_cross_config, modify_config
from cross_attention_vit_tpu_torch.data import dataset as tds
from cross_attention_vit_tpu_torch.data.loader import PrefetchLoader
from cross_attention_vit_tpu_torch.models.convert import jax_params_from_model
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.parallel import make_mesh, multihost_init
from cross_attention_vit_tpu_torch.train import checkpoint as tckpt
from cross_attention_vit_tpu_torch.train import loggers as tloggers
from cross_attention_vit_tpu_torch.train import trainer as ttrainer

TINY = dict(hidden_dim=32, mlp_dim=64, num_heads=4, num_multi_blocks=1, num_self_blocks=1,
            img_size=(16, 16, 8), patch_size=(8, 8, 8), num_modalities=2,
            attn_order={"0": "1", "1": "0"}, dropout=0.0, lr=1e-3, weight_decay=5e-4,
            label_smoothing=0.0, img_aug=False, optim_params={"T_max": 10, "eta_min": 1e-6})


class FakeDataset:
    """In-memory dataset with the BrainDataset batch interface."""

    def __init__(self, imgs, labels):
        self.imgs, self.labels = imgs, labels

    def __len__(self):
        return len(self.labels)

    def batch(self, indices):
        idx = np.asarray(indices)
        return self.imgs[idx], self.labels[idx]


def _cfgs(**extra):
    cfg = get_mgmt_cross_config()
    modify_config(cfg, {**TINY, **extra})
    jcfg = jax_cross_config()
    jax_modify(jcfg, {**TINY, **extra})
    return cfg, jcfg


def _data(n=10, seed=0):
    r = np.random.default_rng(seed)
    labels = (np.arange(n) % 3 == 0).astype(np.int32)
    imgs = (r.normal(size=(n, 2, 1, 16, 16, 8)) + labels[:, None, None, None, None, None]
            ).astype(np.float32)
    return FakeDataset(imgs, labels)


def _port_trainer(cfg, params=None, **kw):
    t = ttrainer.Trainer(ModelCross, cfg, device="cpu", **{"max_epochs": 2, **kw})
    return t.init_state(params)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def test_fit_history_matches_jax():
    cfg, jcfg = _cfgs()
    ds = _data()
    w = (ds.labels == 0) * 1.0 + 2.0
    jt = jtrainer.Trainer(model_cross, jcfg, max_epochs=2, seed=3)
    jt.init_state()
    params = _np_tree(jt.params)
    jhist = jt.fit(JaxLoader(ds, batch_size=4), JaxLoader(ds, batch_size=4),
                   sampler=jds.WeightedRandomSampler(w, len(ds), seed=3), verbose=False)
    t = _port_trainer(cfg, params, seed=3)
    hist = t.fit(PrefetchLoader(ds, batch_size=4, device="cpu"),
                 PrefetchLoader(ds, batch_size=4, device="cpu"),
                 sampler=tds.WeightedRandomSampler(w, len(ds), seed=3), verbose=False)
    assert len(hist) == len(jhist) == 2
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        for k in row:
            if k != "epoch_time_s":
                assert abs(row[k] - jrow[k]) <= 1e-4, (k, row[k], jrow[k])
    assert t.global_step == jt.global_step == 6


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
def test_vit_fit_history_matches_jax(moe):
    """A tiny f32 ModelVIT (and its MoE trunk) through ``Trainer.fit``: the
    JAX Trainer's history within 1e-4 over 2 epochs from the same
    parameters, batches and sampler draws."""
    from cross_attention_vit_tpu.configs import get_mgmt_config as jax_vit_config
    from cross_attention_vit_tpu.models import model_vit
    from cross_attention_vit_tpu_torch.configs import get_mgmt_config
    from cross_attention_vit_tpu_torch.models.model_vit import ModelVIT

    fields = {**TINY, "num_layers": 2, "moe_experts": moe}
    cfg, jcfg = get_mgmt_config(), jax_vit_config()
    modify_config(cfg, fields)
    jax_modify(jcfg, fields)
    ds = _data()
    w = (ds.labels == 0) * 1.0 + 2.0
    jt = jtrainer.Trainer(model_vit, jcfg, max_epochs=2, seed=3)
    jt.init_state()
    params = _np_tree(jt.params)
    jhist = jt.fit(JaxLoader(ds, batch_size=4), JaxLoader(ds, batch_size=4),
                   sampler=jds.WeightedRandomSampler(w, len(ds), seed=3), verbose=False)
    t = ttrainer.Trainer(ModelVIT, cfg, max_epochs=2, seed=3, device="cpu").init_state(params)
    hist = t.fit(PrefetchLoader(ds, batch_size=4, device="cpu"),
                 PrefetchLoader(ds, batch_size=4, device="cpu"),
                 sampler=tds.WeightedRandomSampler(w, len(ds), seed=3), verbose=False)
    assert len(hist) == len(jhist) == 2
    for row, jrow in zip(hist, jhist):
        assert set(row) == set(jrow)
        for k in row:
            if k != "epoch_time_s":
                assert abs(row[k] - jrow[k]) <= 1e-4, (k, row[k], jrow[k])
    assert (t.model.moe_aux is None) == (not moe)


def test_grad_accum_equals_full_batch_step():
    cfg, _ = _cfgs()
    ds = _data(n=4, seed=1)
    img, labels = torch.from_numpy(ds.imgs), torch.from_numpy(ds.labels).long()
    after = []
    for g in (1, 2):
        t = _port_trainer(cfg, grad_accum=g, seed=5)
        aux = t.train_step(img, labels, 1e-3, torch.Generator().manual_seed(0))
        after.append((float(aux["loss"]), aux["probs"].clone(),
                      {n: p.grad.clone() for n, p in t.model.named_parameters()}))
    (l1, p1, g1), (l2, p2, g2) = after
    assert abs(l1 - l2) <= 1e-5
    torch.testing.assert_close(p1, p2, atol=1e-5, rtol=0)
    # the gradients the one Adam update consumed (the updates themselves
    # amplify noise: the key biases' gradients are zero in exact arithmetic)
    for n in g1:
        assert (g1[n] - g2[n]).abs().max().item() <= 1e-5, n


def test_grad_accum_rejects_an_indivisible_batch():
    cfg, _ = _cfgs()
    t = _port_trainer(cfg, grad_accum=3)
    with pytest.raises(ValueError, match="not divisible"):
        t.train_step(torch.zeros(4, 2, 1, 16, 16, 8), torch.zeros(4, dtype=torch.long), 1e-3,
                     torch.Generator())
    with pytest.raises(ValueError, match="accum_impl"):
        ttrainer.make_train_step(t.model, t.optimizer, cfg, accum_impl="loop")


def test_resume_from_latest_continues_the_run(tmp_path):
    """A run stopped after epoch 1 and resumed to epoch 3 ends where the
    uninterrupted run ends, and a finished run resumes at its end."""
    cfg, _ = _cfgs()
    ds = _data()
    ld = PrefetchLoader(ds, batch_size=4, device="cpu")
    full = _port_trainer(cfg, seed=1, max_epochs=3)
    full_hist = full.fit(ld, ld, verbose=False)
    lc = tckpt.LatestCheckpointer(tmp_path / "latest")
    part = _port_trainer(cfg, seed=1, max_epochs=2, latest=lc)
    part.fit(ld, ld, verbose=False)
    resumed = _port_trainer(cfg, seed=1, max_epochs=3, latest=lc)
    hist = resumed.fit(ld, ld, verbose=False)
    assert len(hist) == 1 and resumed.global_step == full.global_step
    for k in ("train_loss", "val_loss", "val_auc_roc"):
        assert abs(hist[0][k] - full_hist[2][k]) <= 1e-6, k
    for (n, p), q in zip(resumed.model.named_parameters(), full.model.parameters()):
        assert torch.equal(p, q), n
    again = _port_trainer(cfg, seed=1, max_epochs=3, latest=lc)
    assert again.maybe_resume() == 3


def test_checkpoints_cross_between_packages(tmp_path):
    """A port checkpoint restores in JAX (every key and shape of its state),
    and a JAX checkpoint resumes the port's Trainer with the same params,
    moments and step."""
    cfg, jcfg = _cfgs()
    ds = _data()
    jt = jtrainer.Trainer(model_cross, jcfg, max_epochs=1, seed=2,
                          latest=jckpt.LatestCheckpointer(tmp_path / "jax"))
    jt.fit(JaxLoader(ds, batch_size=4), JaxLoader(ds, batch_size=4), verbose=False)
    t = _port_trainer(cfg, max_epochs=1, latest=tckpt.LatestCheckpointer(tmp_path / "jax"))
    assert t.maybe_resume() == 1 and t.global_step == jt.global_step
    for a, b in zip(jax.tree.leaves(t.params), jax.tree.leaves(jt.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    state = t._ckpt_state(0)
    for key, want in tckpt.flatten({"opt": {"mu": _np_tree(jt.opt_state.mu)}}).items():
        np.testing.assert_array_equal(state[key], want)
    assert int(state["opt/step"]) == int(jt.opt_state.step) == 3

    tckpt.save_pytree(tmp_path / "port.npz", state)
    got = jckpt.restore_pytree(tmp_path / "port.npz", jt._ckpt_state(0))
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(jt.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_init_state_from_jax_params_matches_the_jax_model():
    cfg, jcfg = _cfgs()
    params = _np_tree(model_cross.init(jax.random.key(0), jcfg))
    t = _port_trainer(cfg, params)
    for a, b in zip(jax.tree.leaves(jax_params_from_model(t.model)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode,delta,values,stops", [
    ("min", 0.0, [1.0, 0.5, 0.6, 0.4, 0.6, 0.5], [False] * 5 + [True]),
    ("max", 0.1, [0.5, 0.55], [False, True]),
])
def test_early_stopping_unit(mode, delta, values, stops):
    es = ttrainer.EarlyStopping(patience=2 if mode == "min" else 1, mode=mode, min_delta=delta)
    assert [es.step(v) for v in values] == stops


def test_trainer_early_stopping_halts():
    cfg, _ = _cfgs()
    ds = _data(n=4)
    ld = PrefetchLoader(ds, batch_size=2, device="cpu")
    es = ttrainer.EarlyStopping(monitor="val_loss", patience=2, min_delta=100.0)
    assert len(_port_trainer(cfg, max_epochs=20, early_stopping=es).fit(ld, ld, verbose=False)) == 3
    assert len(_port_trainer(cfg, max_epochs=4).fit(ld, ld, verbose=False)) == 4


def test_trainer_rejects_unported_options():
    """A mesh and FSDP build (over a one-process gloo group here); FSDP
    without a mesh is refused as in JAX; a stateful Trainer over a mesh
    builds (its BatchNorms take the global batch's statistics,
    ``test_torch_sync_bn.py``)."""
    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="requires a mesh"):
        ttrainer.Trainer(ModelCross, cfg, max_epochs=1, device="cpu", fsdp=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost_init(f"127.0.0.1:{port}", 1, 0, device="cpu", timeout_s=30)
    try:
        t = ttrainer.Trainer(ModelCross, cfg, max_epochs=1, device="cpu", stateful=True,
                             mesh=make_mesh()).init_state()
        assert t.stateful and t.world == 1 and t.eval_step is not None
        for fsdp in (False, True):
            t = ttrainer.Trainer(ModelCross, cfg, max_epochs=1, device="cpu", mesh=make_mesh(),
                                 fsdp=fsdp).init_state()
            assert t.data_sharding.spec[0] == "data" and t.world == 1
            aux = t.train_step(torch.zeros(2, 2, 1, 16, 16, 8), torch.tensor([0, 1]), 1e-3,
                               torch.Generator())
            assert aux["probs"].shape == (2,) and torch.isfinite(aux["loss"])
    finally:
        torch.distributed.destroy_process_group()


def test_checkpoint_manager_topk_and_replay(tmp_path):
    state = {"w": np.ones(2, np.float32)}
    mgr = tckpt.CheckpointManager(tmp_path, save_top_k=2)
    assert mgr.save(0, 1.0, state) is not None
    assert mgr.save(1, 0.5, state) is not None
    assert mgr.save(2, 2.0, state) is None           # worse than both kept
    assert mgr.save(3, 0.1, state) is not None       # evicts 1.0
    assert len(list(tmp_path.glob("*.npz"))) == 2
    assert "val_loss=0.1000" in mgr.best_path().name
    # a resumed run replays epoch 1: the manifest replaces, not duplicates
    mgr2 = tckpt.CheckpointManager(tmp_path, save_top_k=4)
    mgr2.save(1, 0.5, state)
    mgr2.save(4, 0.7, state)
    assert sorted(e["epoch"] for e in mgr2._entries) == [1, 3, 4]
    assert len(list(tmp_path.glob("*.npz"))) == 3


def test_async_writes_and_partial_files(tmp_path):
    state = {"w": np.arange(100.0)}
    mgr = tckpt.CheckpointManager(tmp_path / "topk", save_top_k=2, async_write=True,
                                  tag="run", config=get_mgmt_cross_config())
    for e, m in enumerate((1.0, 0.5, 0.2)):
        mgr.save(e, m, state)
    lc = tckpt.LatestCheckpointer(tmp_path / "latest", keep=1, async_write=True)
    lc.save(10, state)
    lc.save(20, state)
    tckpt.wait_for_writes()
    assert sorted(p.name for p in (tmp_path / "topk").glob("*.npz")) == [
        "epoch=01-val_loss=0.5000run.npz", "epoch=02-val_loss=0.2000run.npz"]
    assert (tmp_path / "topk" / "config_run.json").exists()
    assert [p.name for p in (tmp_path / "latest").glob("step=*.npz")] == ["step=20.npz"]
    # a truncated partial from a killed writer, numerically newest
    (tmp_path / "latest" / "step=30.tmp.npz").write_bytes(b"PK\x03\x04 truncated")
    step, got = lc.restore_latest()
    assert step == 20 and not (tmp_path / "latest" / "step=30.tmp.npz").exists()
    np.testing.assert_array_equal(got["w"], np.arange(100.0))
    assert tckpt.write_seconds() > 0


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_csv_logger_resume_fresh_and_torn_write(tmp_path, monkeypatch):
    lg = tloggers.CSVLogger(tmp_path, "run")
    lg.log_metrics({"train_loss": 1.0}, 0)
    lg.log_metrics({"train_loss": 0.8}, 1)
    lg2 = tloggers.CSVLogger(tmp_path, "run", resume=True)
    lg2.log_metrics({"train_loss": 0.8}, 1)          # replayed epoch
    lg2.log_metrics({"train_loss": 0.6, "val_loss": 0.9}, 2)
    rows = _csv_rows(tmp_path / "run" / "metrics.csv")
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2] and float(rows[2]["val_loss"]) == 0.9
    monkeypatch.setattr(tloggers.os, "replace",
                        lambda *a: (_ for _ in ()).throw(KeyboardInterrupt()))
    with pytest.raises(KeyboardInterrupt):
        lg2.log_metrics({"train_loss": 0.5}, 3)
    monkeypatch.undo()
    assert [int(r["epoch"]) for r in _csv_rows(tmp_path / "run" / "metrics.csv")] == [0, 1, 2]
    tloggers.CSVLogger(tmp_path, "run").log_metrics({"train_loss": 2.0}, 0)   # no resume
    assert len(_csv_rows(tmp_path / "run" / "metrics.csv")) == 1


def test_tensorboard_events_parse(tmp_path):
    """The hand-written event file reads back through tensorboardX's
    protobufs, CRCs included."""
    import struct

    from tensorboardX.crc32c import crc32c
    from tensorboardX.proto import event_pb2

    lg = tloggers.TensorBoardLogger(tmp_path, "run")
    lg.log_metrics({"train_loss": 0.25, "val_acc": 0.5}, 3)
    lg.finalize()
    data = lg.path.read_bytes()
    events, pos = [], 0
    while pos < len(data):
        (n,) = struct.unpack("<Q", data[pos:pos + 8])
        masked = struct.unpack("<I", data[pos + 8:pos + 12])[0]
        payload = data[pos + 12:pos + 12 + n]
        crc = crc32c(data[pos:pos + 8])
        assert masked == (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
        events.append(event_pb2.Event.FromString(payload))
        pos += 16 + n
    assert events[0].file_version == "brain.Event:2"
    assert [(e.step, e.summary.value[0].tag, e.summary.value[0].simple_value)
            for e in events[1:]] == [(3, "train_loss", 0.25), (3, "val_acc", 0.5)]


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    cfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.Trainer(ModelCross, cfg, max_epochs=1)
