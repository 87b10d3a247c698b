"""The port's ``serve --mesh`` CLI (``drivers/serve.py`` ``main``), the
counterpart of JAX's ``drivers/serve.py`` ``main`` with ``--mesh``.

Two gloo ranks (``tests/torch_mesh_workers.py``, mode serve_cli) each run
``main(["--checkpoint", <tiny ModelCross>, "--mesh", "data=1,model=2",
"--device", "cpu", ...])`` under torchrun's environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK), then the same with ``--mesh data=2``: rank 0
serves HTTP, rank 1 runs the server's worker loop.  Once ``/healthz``
answers with the mesh, one ``POST /predict`` of 3 volumes (padded to the
4 bucket) is answered with the logits of the one-process port model's
forward and of JAX's ``model_cross.apply`` on the same weights within 1e-3
(f32, PARITY.md).  SIGINT to rank 0 ends its ``serve_forever`` as Ctrl-C
does; its ``stop()`` ends the worker rank's loop, and both exit 0.
"""

import io
import json
import os
import signal
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cross_attention_vit_tpu.models import model_cross as jmc
from cross_attention_vit_tpu_torch.models.convert import load_jax_params
from cross_attention_vit_tpu_torch.models.model_cross import ModelCross
from cross_attention_vit_tpu_torch.train.checkpoint import save_config, save_pytree
from torch_mesh_workers import (WORKER_TIMEOUT_S, free_port, launch, port_config, serve_volumes,
                                wait_world)
from torch_split_reference import jax_config, jax_init

ATOL = 1e-3                   # PARITY.md's f32 serving band
MESHES = {"data=1,model=2": {"data": 1, "model": 2}, "data=2": {"data": 2}}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny ModelCross checkpoint with its config beside it, its JAX
    params, and the direct forward's and JAX's logits on 3 volumes."""
    tmp = tmp_path_factory.mktemp("serve_cli")
    params = jax_init("cross", seed=5)
    save_pytree(tmp / "ckpt.npz", {"params": params})
    save_config(tmp, port_config("cross"))
    vols = serve_volumes(3)
    model = ModelCross(port_config("cross"), device="cpu")
    load_jax_params(model, params)
    with torch.no_grad():
        direct = model(torch.from_numpy(vols)).numpy()
    want = np.asarray(jax.jit(lambda p, x: jmc.apply(p, jax_config("cross"), x))(params, vols))
    return tmp / "ckpt.npz", vols, direct, want


def _get(url: str) -> dict | None:
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return json.load(r)
    except (urllib.error.URLError, ConnectionError):
        return None


def _health(url: str, world) -> dict:
    """``/healthz`` once rank 0 serves; fails if a rank exits first."""
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    while time.monotonic() < deadline:
        for r, p in enumerate(world.procs):
            assert p.poll() is None, f"rank {r} exited {p.returncode}:\n{world.tail(r)}"
        got = _get(url)
        if got is not None:
            return got
        time.sleep(0.2)
    raise AssertionError(f"no /healthz within {WORKER_TIMEOUT_S} s:\n{world.tail(0)}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_serve_mesh_cli_answers_the_direct_forward(ckpt, mesh, tmp_path):
    path, vols, direct, want = ckpt
    http = free_port()
    (tmp_path / "serve_cli_argv.json").write_text(json.dumps(
        ["--checkpoint", str(path), "--model", "cross", "--mesh", mesh, "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(http), "--buckets", "2", "4",
         "--max-wait-ms", "1"]))
    world = launch("serve_cli", tmp_path, 2, address=f"127.0.0.1:{free_port()}")
    try:
        health = _health(f"http://127.0.0.1:{http}/healthz", world)
        buf = io.BytesIO()
        np.save(buf, vols)
        req = urllib.request.Request(f"http://127.0.0.1:{http}/predict", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=WORKER_TIMEOUT_S) as r:
            logits = np.array(json.load(r)["logits"])
        os.kill(world.procs[0].pid, signal.SIGINT)
        wait_world(world)              # both ranks exit 0
    finally:
        for p in world.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert health["mesh"] == MESHES[mesh]
    assert logits.shape == want.shape and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, direct, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits, want, atol=ATOL, rtol=0)
