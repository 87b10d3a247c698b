"""The serving slice as a whole: a checkpoint written by the JAX package's
CheckpointManager, served by the port's InferenceServer on the CPU
(device="cpu"), answers as the JAX ``model_cross.apply`` does — bucket
padding, micro-batching, backpressure, the HTTP surface, shape validation
and the NIfTI subject path (mirrors tests/test_serve.py) — and int8 serving
answers as ``apply`` on the JAX ``quantize_for_inference`` params.

Tolerance: logits within 1e-4 absolute of JAX (f32 on both sides); int8
logits within 1e-3 (the parity contract: an int8 rounding can flip on a
summation-order difference) with the same argmax, and equal to a direct
forward of the server's model."""

import gzip
import io
import json
import threading
import time
import urllib.error
import urllib.request
from dataclasses import asdict

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.configs import get_mgmt_config, get_mgmt_cross_config, modify_config
from cross_attention_vit_tpu.data import nifti as jnifti
from cross_attention_vit_tpu.data import preprocess as jpre
from cross_attention_vit_tpu.models import model_cross, model_vit
from cross_attention_vit_tpu.models.quantize import count_quantized, quantize_for_inference
from cross_attention_vit_tpu.train.checkpoint import CheckpointManager, restore_pytree
from cross_attention_vit_tpu_torch.data import nifti as tnifti
from cross_attention_vit_tpu_torch.data import preprocess as tpre
from cross_attention_vit_tpu_torch.drivers.serve import InferenceServer, Overloaded, serve
from cross_attention_vit_tpu_torch.train import checkpoint as tckpt

ATOL = 1e-4
TYPES = ("T1c", "T2")


def _tiny_cfg():
    cfg = get_mgmt_cross_config()
    modify_config(cfg, dict(
        hidden_dim=32, mlp_dim=64, num_heads=4, num_multi_blocks=1,
        num_self_blocks=1, img_size=(16, 16, 8), patch_size=(8, 8, 8),
        num_modalities=2, attn_order={"0": "1", "1": "0"},
        dropout=0.0, lr=1e-3, weight_decay=1e-4, label_smoothing=0.0,
        img_aug=False, optim_params={"T_max": 10, "eta_min": 1e-6},
        gelu_approx=True))
    return cfg


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve_ckpt")
    cfg = _tiny_cfg()
    params = model_cross.init(jax.random.key(0), cfg)
    mgr = CheckpointManager(d, monitor="val_loss", save_top_k=1, config=cfg)
    state = {"params": params, "opt": {"unused": jnp.zeros((1,))},
             "epoch": jnp.zeros((), jnp.int32)}
    path = mgr.save(0, 0.5, state)
    return path, cfg, jax.tree.map(np.asarray, params)


@pytest.fixture
def gelu_tanh(monkeypatch):
    """The JAX server applies the checkpoint's gelu_approx to its module
    global (apply_config_knobs); the port reads it from the config."""
    from cross_attention_vit_tpu.ops import layers

    monkeypatch.setattr(layers, "GELU_APPROX", True)


def _vols(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, cfg.num_modalities, 1, *cfg.img_size)) * 100
            ).astype(np.float32)


def _jax(params, cfg, vols):
    return np.asarray(model_cross.apply(params, cfg, jnp.asarray(vols), train=False))


def _server(path, **kw):
    return InferenceServer(path, "cross", img_types=TYPES, device="cpu", **kw)


def test_predict_matches_jax_apply_and_pads_buckets(ckpt, gelu_tanh):
    path, cfg, params = ckpt
    srv = _server(path, buckets=(2, 4), max_wait_ms=1.0)
    srv.start()
    try:
        vols = _vols(cfg, 3)     # b=3 pads up to bucket 4
        got = srv.predict(vols)
        assert got.shape == (3, 2)
        np.testing.assert_allclose(got, _jax(params, cfg, vols), atol=ATOL, rtol=0)
        assert srv.stats_view()["batch_histogram"] == {3: 1}
    finally:
        srv.stop()


def test_oversized_burst_splits_at_largest_bucket(ckpt, gelu_tanh):
    path, cfg, params = ckpt
    srv = _server(path, buckets=(1, 2), max_wait_ms=1.0)
    srv.start()
    try:
        vols = _vols(cfg, 5, seed=4)
        np.testing.assert_allclose(srv.predict(vols), _jax(params, cfg, vols),
                                   atol=ATOL, rtol=0)
        assert len(srv.stats["device_ms"]) == 3     # 2 + 2 + 1
    finally:
        srv.stop()


def test_microbatching_coalesces_concurrent_requests(ckpt, gelu_tanh):
    path, cfg, params = ckpt
    srv = _server(path, buckets=(1, 2, 4, 8), max_wait_ms=200.0)
    srv.warmup()
    srv.start()
    try:
        results = {}

        def hit(i):
            results[i] = srv.predict(_vols(cfg, 1, seed=i))

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert sorted(results) == [0, 1, 2, 3]
        view = srv.stats_view()
        assert view["requests"] == 4 and view["volumes"] == 4
        assert sum(view["batch_histogram"].values()) <= 2
        for i in range(4):   # each result is its own volume's logits (no swap)
            np.testing.assert_allclose(results[i], _jax(params, cfg, _vols(cfg, 1, seed=i)),
                                       atol=ATOL, rtol=0)
    finally:
        srv.stop()


def test_backpressure_sheds_when_queue_full(ckpt):
    path, cfg, _ = ckpt
    srv = _server(path, buckets=(1, 2, 4), max_wait_ms=1.0, max_queue_volumes=4)
    # dispatcher NOT started: the queue can only fill
    try:
        def hit(b, seed):
            try:
                srv.predict(_vols(cfg, b, seed=seed), timeout=30)
            except Exception:
                pass

        waiters = [threading.Thread(target=hit, args=(2, i), daemon=True) for i in range(2)]
        for t in waiters:
            t.start()
        deadline = time.monotonic() + 5
        while srv._pending_volumes < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv._pending_volumes == 4

        with pytest.raises(Overloaded) as ei:
            srv.predict(_vols(cfg, 1, seed=9))
        assert ei.value.retry_after_s > 0
        view = srv.stats_view()
        assert view["shed_requests"] == 1 and view["shed_volumes"] == 1
        assert view["pending_volumes"] == 4 and view["queue_limit_volumes"] == 4

        srv.start()     # drain re-opens admission
        for t in waiters:
            t.join(timeout=30)
        deadline = time.monotonic() + 10
        while srv._pending_volumes and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.predict(_vols(cfg, 1, seed=10), timeout=30).shape == (1, 2)
        view = srv.stats_view()
        assert view["pending_volumes"] == 0
        assert view["device_ms"]["p50"] is not None
        assert view["transfer_ms"]["p50"] is not None
    finally:
        srv.stop()


def _post(port, vols, path="/predict", timeout=10):
    buf = io.BytesIO()
    np.save(buf, vols)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=buf.getvalue(),
                                 method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def test_http_503_retry_after_on_overload(ckpt):
    path, cfg, _ = ckpt
    srv = _server(path, buckets=(1, 2), max_wait_ms=1.0, max_queue_volumes=1)
    httpd = serve(srv, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        srv._stop.set()                      # dispatcher stopped after warmup
        srv._dispatcher.join(timeout=5)

        def blocker():
            try:
                _post(port, _vols(cfg, 1, seed=2), timeout=5)
            except Exception:
                pass

        threading.Thread(target=blocker, daemon=True).start()
        deadline = time.monotonic() + 5
        while srv._pending_volumes < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, _vols(cfg, 1, seed=3))
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert "queue full" in json.loads(ei.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()


def test_shape_validation(ckpt):
    path, cfg, _ = ckpt
    srv = _server(path)
    with pytest.raises(ValueError):
        srv.predict(np.zeros((1, 3, 1, *cfg.img_size), np.float32))   # M=3
    with pytest.raises(ValueError):
        srv.predict(np.zeros((2, 1, *cfg.img_size), np.float32))      # no batch axis


def test_http_surface(ckpt, gelu_tanh):
    path, cfg, params = ckpt
    srv = _server(path, buckets=(1, 2), max_wait_ms=1.0)
    httpd = serve(srv, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    try:
        health = json.load(urllib.request.urlopen(f"{base}/healthz"))
        assert health["status"] == "ok" and health["model"] == "cross"
        assert health["params"] == srv.n_params == sum(
            int(np.prod(p.shape)) for p in jax.tree.leaves(params))
        assert health["device"] == "cpu"

        vols = _vols(cfg, 1)[0]   # single item, no batch axis
        out = json.load(_post(port, vols))
        np.testing.assert_allclose(np.asarray(out["logits"]), _jax(params, cfg, vols[None]),
                                   atol=ATOL, rtol=0)
        assert 0.0 <= out["prob_class1"][0] <= 1.0

        with pytest.raises(urllib.error.HTTPError) as ei:   # bad shape → 400
            _post(port, np.zeros((3, 1, 4, 4, 4), np.float32))
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope")
        assert ei.value.code == 404

        stats = json.load(urllib.request.urlopen(f"{base}/stats"))
        assert stats["requests"] == 1 and stats["latency_ms"]["p50"] is not None
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()


def _write_subject(root, case, shape, seed, slope):
    d = root / f"{case}_nifti"
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for t in TYPES:
        raw = rng.integers(-500, 3000, size=shape).astype(np.int16)
        jnifti.write_volume(jnifti.volume_path(root, case, t), raw, scl_slope=slope,
                            scl_inter=3.0)


def test_nifti_reader_matches_jax(tmp_path):
    for shape in [(20, 14, 11), (12, 18, 6)]:
        for slope in (0.0, 0.5):
            case = f"C{shape[0]}_{int(slope * 10)}"
            _write_subject(tmp_path, case, shape, seed=shape[1], slope=slope)
            p = jnifti.volume_path(tmp_path, case, "T2")
            assert tnifti.volume_path(tmp_path, case, "T2") == p
            with gzip.open(p, "rb") as f:
                raw = f.read()
            assert asdict(tnifti.parse_header(raw)) == asdict(jnifti.parse_header(raw))
            np.testing.assert_array_equal(tnifti.read_volume(p), jnifti.read_volume(p))
            np.testing.assert_array_equal(tnifti.read_volume_cropped(p, (16, 16, 8)),
                                          jnifti.read_volume_cropped(p, (16, 16, 8)))
            vol = jnifti.read_volume(p)
            assert tpre.crop_bounds(vol.shape, (16, 16, 8)) == jpre.crop_bounds(vol.shape,
                                                                                (16, 16, 8))
            np.testing.assert_array_equal(tpre.resize_with_pad_or_crop_np(vol, (16, 16, 8)),
                                          jpre.resize_with_pad_or_crop_np(vol, (16, 16, 8)))


def test_predict_subject_matches_jax_pipeline(ckpt, tmp_path, gelu_tanh):
    path, cfg, params = ckpt
    _write_subject(tmp_path, "UCSF-PDGM-0001", (20, 14, 11), seed=1, slope=0.5)
    srv = _server(path, data_folder=str(tmp_path), buckets=(1,), max_wait_ms=1.0)
    srv.start()
    try:
        got = srv.predict_subject("UCSF-PDGM-0001")
    finally:
        srv.stop()
    vols = np.stack([jnifti.read_volume_cropped(
        jnifti.volume_path(tmp_path, "UCSF-PDGM-0001", t), tuple(cfg.img_size),
        fill=-1.0)[None] for t in TYPES])[None]
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(params, cfg, vols)[0], atol=ATOL, rtol=0)


def test_checkpoint_layout_round_trips_with_jax(ckpt, tmp_path):
    path, cfg, params = ckpt
    flat = tckpt.restore_flat(path)
    assert any(k.startswith("params/multi_blocks/0/self_blocks/1/0/") for k in flat)
    tree = tckpt.unflatten(flat)
    jax.tree.map(np.testing.assert_array_equal, tree["params"], params)
    # a checkpoint the port writes restores through the JAX reader
    out = tmp_path / "port.npz"
    tckpt.save_pytree(out, {"params": params, "epoch": np.zeros((), np.int32)})
    like = {"params": jax.eval_shape(lambda: model_cross.init(jax.random.key(0), cfg))}
    back = restore_pytree(out, like)["params"]
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert tckpt.load_config_for(path).to_dict() == json.loads(
        next(path.parent.glob("config*.json")).read_text())
    saved = tckpt.save_config(tmp_path, tckpt.load_config_for(path))
    assert tckpt.load_config_for(out) == tckpt.load_config_for(path)
    assert saved.name == "config.json"


# the case ids are fixed so that each case keeps its name as the list changes
@pytest.mark.parametrize("kw,exc,match", [({"mesh": object()}, TypeError, "DeviceMesh"),
                                          ({"quantize": "int4"}, ValueError,
                                           "unknown quantize mode")],
                         ids=["kw0-NotImplementedError-later slice",
                              "kw1-ValueError-unknown quantize mode"])
def test_unported_serving_modes_raise(ckpt, kw, exc, match):
    """A mesh that is not a ``parallel.make_mesh`` DeviceMesh raises (sharded
    serving itself: tests/test_torch_sharded_serving.py); an unknown
    quantize mode raises as in the JAX server (its two modes are served:
    test_quantized_server_*)."""
    path, _, _ = ckpt
    kw = {"img_types": TYPES, "device": "cpu", **kw}
    model = kw.pop("model", "cross")
    with pytest.raises(exc, match=match):
        InferenceServer(path, model, **kw)


# --- int8 serving ------------------------------------------------------------------

_Q_FIELDS = dict(hidden_dim=256, mlp_dim=1024, num_heads=4, img_size=(16, 16, 8),
                 num_modalities=2, dropout=0.0, lr=1e-3, weight_decay=1e-4, img_aug=False,
                 optim_params={"T_max": 10, "eta_min": 1e-6})


@pytest.fixture(scope="module")
def qckpts(tmp_path_factory):
    """One checkpoint per family, wide enough (hidden 256, MLP 1024) that the
    JAX default min_size (2**16) quantizes the FFNs, the head fc1 and, under
    int8+attn, both self-attention projections."""
    out = {}
    for family, factory, module, extra in (
            ("cross", get_mgmt_cross_config, model_cross,
             dict(num_multi_blocks=1, num_self_blocks=1, patch_size=(8, 8, 8),
                  attn_order={"0": "1", "1": "0"}, label_smoothing=0.0)),
            ("vit", get_mgmt_config, model_vit, dict(num_layers=1, patch_size=(8, 8, 4)))):
        cfg = factory()
        modify_config(cfg, {**_Q_FIELDS, **extra})
        params = module.init(jax.random.key(1), cfg)
        mgr = CheckpointManager(tmp_path_factory.mktemp(f"torch_q_{family}"), monitor="val_loss",
                                save_top_k=1, config=cfg)
        path = mgr.save(0, 0.5, {"params": params, "epoch": jnp.zeros((), jnp.int32)})
        out[family] = (path, cfg, module, jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("family,mode,kernels", [("cross", "int8", 10), ("cross", "int8+attn", 14),
                                                 ("vit", "int8", 3), ("vit", "int8+attn", 5)])
def test_quantized_server_matches_jax_and_a_direct_forward(qckpts, family, mode, kernels):
    path, cfg, module, params = qckpts[family]
    srv = InferenceServer(path, family, img_types=TYPES, buckets=(2, 4), max_wait_ms=1.0,
                          quantize=mode, device="cpu")
    health = srv.health()
    qparams = quantize_for_inference(params, attn=mode == "int8+attn")
    assert health["quantize"] == mode and health["quantized_kernels"] == kernels
    assert count_quantized(qparams)[0] == kernels
    assert health["params"] == sum(int(np.prod(p.shape)) for p in jax.tree.leaves(qparams))
    srv.start()
    try:
        vols = _vols(cfg, 3, seed=5)
        got = srv.predict(vols)
    finally:
        srv.stop()
    want = np.asarray(module.apply(qparams, cfg, jnp.asarray(vols), train=False))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    with torch.inference_mode():
        direct = srv.model(torch.from_numpy(np.concatenate([vols, np.zeros_like(vols[:1])])))
    np.testing.assert_array_equal(got, direct[:3].numpy())


def test_float_server_reports_no_quantization(ckpt):
    health = _server(ckpt[0]).health()
    assert health["quantize"] is None and health["quantized_kernels"] == 0


def test_serve_cli_accepts_quantize(qckpts, monkeypatch):
    from cross_attention_vit_tpu_torch.drivers import serve as tserve

    made = {}

    class Stop(Exception):
        pass

    def fake_serve(server, host, port):
        made["server"] = server
        raise Stop

    monkeypatch.setattr(tserve, "serve", fake_serve)
    with pytest.raises(Stop):
        tserve.main(["--checkpoint", str(qckpts["cross"][0]), "--img-types", *TYPES,
                     "--quantize", "int8+attn", "--device", "cpu"])
    assert made["server"].health()["quantize"] == "int8+attn"
    with pytest.raises(SystemExit):
        tserve.main(["--checkpoint", str(qckpts["cross"][0]), "--quantize", "int4"])
