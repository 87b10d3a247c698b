"""The composed axes through the port's entry points — the counterpart of
``tests/test_drivers.py::test_train_full_tiny_fsdp_grad_accum`` (a
``Trainer`` over a (data × model) mesh with FSDP and gradient accumulation)
and of JAX's server over a mesh with an 'expert' axis.

Over four gloo ranks (``tests/torch_mesh_workers.py``, mode composed_fit):

* ``Trainer.fit`` of ModelCross over (data 2 × model 2), ``fsdp=True``,
  ``grad_accum=2``, two epochs of one global batch of 8: every rank's
  history equals JAX's ``Trainer.fit`` over its own (data 2 × model 2) mesh
  with FSDP and grad_accum 2 within 1e-5, and the one-process port's;
  the rolling checkpoint is whole in the JAX layout (JAX's
  ``restore_pytree`` reads it), and a world of one resumes its second
  epoch from the first epoch's checkpoint into the four ranks' row.
* ``experiments.main --tp 2 --fsdp`` over the same four processes: one
  finite history on every rank, a whole checkpoint.
* ``InferenceServer(mesh=)`` over (data 1 × expert 2 × model 2) on a MoE
  checkpoint: each rank holds 2 of the 4 experts of every MoE site (the
  router whole) and half the heads; rank 0's answers equal
  ``model_cross.apply``'s on the padded bucket (the MoE's capacity counts
  its rows) and JAX's server's over the same mesh within 1e-5.
"""

import json
import shutil

import jax
import numpy as np
import pytest

from cross_attention_vit_tpu import parallel as jpar
from cross_attention_vit_tpu.data.loader import PrefetchLoader as JaxLoader
from cross_attention_vit_tpu.drivers.serve import InferenceServer as JaxServer
from cross_attention_vit_tpu.models import model_cross as jmc
from cross_attention_vit_tpu.train import optim as joptim
from cross_attention_vit_tpu.train import trainer as jtrainer
from cross_attention_vit_tpu.train.checkpoint import restore_pytree
from cross_attention_vit_tpu_torch.train.checkpoint import (flatten, restore_flat, save_config,
                                                            save_pytree)
from torch_mesh_workers import (COMPOSED_FIT, CROSS, GLOBAL_BATCH, MOE, Data,
                                composed_fit_loaders, composed_fit_trainer, history_rows,
                                load, port_config, serve_volumes, spawn, write_cohort)
from torch_split_reference import TOL, jax_config, jax_init


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("composed_fit")
    (tmp / "serve_moe").mkdir()
    save_pytree(tmp / "serve_moe" / "ckpt.npz", {"params": jax_init("cross", seed=3, **MOE)})
    save_config(tmp / "serve_moe", port_config("cross", **MOE))
    save_pytree(tmp / "fit_init.npz", {"params": jax_init("cross", seed=5, **COMPOSED_FIT)})
    write_cohort(tmp)
    spawn("composed_fit", tmp, 4)
    hists = [json.loads((tmp / f"composed_fit_{r}.json").read_text()) for r in range(4)]
    return tmp, hists, load(tmp, "serve_ep", 4)


def _jax_fit() -> list[dict]:
    t = jtrainer.Trainer(jmc, jax_config("cross", **COMPOSED_FIT), max_epochs=2, seed=3,
                         mesh=jpar.make_mesh(2, 2), fsdp=True, grad_accum=2)
    t.init_state(jax.tree.map(jax.numpy.asarray, jax_init("cross", seed=5, **COMPOSED_FIT)))
    ds = Data(n=8)
    return history_rows(t.fit(JaxLoader(ds, batch_size=GLOBAL_BATCH),
                              JaxLoader(ds, batch_size=GLOBAL_BATCH), verbose=False))


def _assert_rows_close(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for row, ref in zip(got, want):
        assert set(row) == set(ref)
        for k, v in row.items():
            assert np.isfinite(v) and abs(v - ref[k]) <= TOL, (k, v, ref[k])


def test_fit_over_data_model_fsdp_accum_matches_jax_and_one_process(runs, tmp_path):
    """The four ranks' histories are one; they equal JAX's fit over its own
    mesh and the one-process port's fit (batch 8, grad_accum 2)."""
    tmp, hists, _ = runs
    assert all(h == hists[0] for h in hists[1:])
    _assert_rows_close(hists[0], _jax_fit())
    one = composed_fit_trainer(tmp_path / "one", tmp / "fit_init.npz")
    _assert_rows_close(hists[0], history_rows(one.fit(*composed_fit_loaders(GLOBAL_BATCH),
                                                      verbose=False)))


def test_fsdp_tp_checkpoint_is_whole_and_a_world_of_one_resumes_it(runs, tmp_path):
    """Rank 0's rolling checkpoint after epoch 0: JAX restores it against
    ``init`` (whole tensors, the JAX layout); a one-process Trainer resumes
    it and runs the second epoch into the four ranks' second row."""
    tmp, hists, _ = runs
    ckpt = tmp / "fit0" / "latest" / "step=1.npz"
    assert not list((tmp / "fit1").rglob("*.npz"))        # rank 0 alone writes
    like_params = jmc.init(jax.random.key(1), jax_config("cross", **COMPOSED_FIT))
    state = restore_pytree(ckpt, {"params": like_params, "opt": joptim.init(like_params),
                                  "epoch": jax.numpy.zeros((), jax.numpy.int32)})
    flat = restore_flat(ckpt)
    assert int(state["epoch"]) == 0 and int(state["opt"].step) == 1
    for k, v in flatten(jax.tree.map(np.asarray, state["params"])).items():
        np.testing.assert_array_equal(v, flat[f"params/{k}"])
    (tmp_path / "one" / "latest").mkdir(parents=True)
    shutil.copy(ckpt, tmp_path / "one" / "latest")
    one = composed_fit_trainer(tmp_path / "one", tmp / "fit_init.npz")
    rows = history_rows(one.fit(*composed_fit_loaders(GLOBAL_BATCH), verbose=False))
    assert one.global_step == 2
    _assert_rows_close(rows, hists[0][1:])


def test_experiments_cli_composes_tp_and_fsdp(runs):
    """``experiments.main --tp 2 --fsdp`` over the four processes (data 2 ×
    model 2): one finite history, the same on every rank, and a checkpoint
    whole in the JAX layout."""
    tmp, _, _ = runs
    hists = [json.loads((tmp / f"composed_cli_{r}.json").read_text()) for r in range(4)]
    assert all(h == hists[0] for h in hists[1:]) and len(hists[0]) == 1
    (rows,) = hists[0].values()
    assert len(rows) == 1 and all(np.isfinite(v) for v in rows[0].values())
    ckpt = restore_flat(next((tmp / "cli_tp_fsdp" / "checkpoints" / "cross").glob("epoch=*.npz")))
    assert ckpt["params/multi_blocks/0/self_blocks/0/0/ffn/fc1/kernel"].shape == (16, 2048)
    assert ckpt["params/multi_blocks/0/self_blocks/0/0/attn/qkv/kernel"].shape == (16, 3, 2, 8)


def test_server_over_expert_and_model_axes_matches_apply_and_jax_server(runs):
    tmp, _, ranks = runs
    params = jax_init("cross", seed=3, **MOE)
    cfg = jax_config("cross", **MOE)
    H, mlp = CROSS["hidden_dim"], CROSS["mlp_dim"]
    for rank in ranks:
        assert tuple(rank["local/experts"]) == (2, mlp, H)
        assert tuple(rank["local/router"]) == (4, H)
        assert tuple(rank["local/qkv"]) == (3 * H // 2, H)
    r0 = ranks[0]
    assert json.loads(str(r0["health_mesh"])) == {"data": 1, "expert": 2, "model": 2}
    server = JaxServer(tmp / "serve_moe" / "ckpt.npz", "cross", buckets=(2, 4),
                       mesh=jpar.make_mesh(1, 2, expert=2))
    server.start()
    try:
        for n, seed in ((3, 7), (4, 8)):
            vols = serve_volumes(n, seed=seed)
            # the MoE routes the whole padded bucket: its capacity counts 4 volumes
            bucket = np.concatenate([vols, np.zeros((4 - n, *vols.shape[1:]), vols.dtype)])
            want = np.asarray(jmc.apply(jax.tree.map(jax.numpy.asarray, params), cfg,
                                        bucket))[:n]
            np.testing.assert_allclose(r0[str(n)], want, atol=TOL, rtol=TOL)
            np.testing.assert_allclose(r0[str(n)], server.predict(vols), atol=TOL, rtol=TOL)
    finally:
        server.stop()
