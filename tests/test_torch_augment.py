"""The port's augmentation (``cross_attention_vit_tpu_torch/data/augment.py``)
against the JAX package's transforms.

torch's generators cannot reproduce ``jax.random``, so each transform's apply
step is held against the JAX function at the parameters JAX drew from its key
(the test derives them with JAX's own key splits and hands them to the port),
and the pipeline is tested for distribution only: apply rates, shapes,
dtypes, and determinism under one seed.

Tolerances: geometric copies, hole shuffles and hole fills are exact; the
f32 arithmetic transforms (contrast, noise, smoothing, zoom, the LU affine
through the plain resample) agree to atol 1e-5 on unit-scale volumes (the
same ops in another summation order); bf16 pipelines round the same f32
results, so they agree to one bf16 ulp (2^-8 relative)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.data import augment as jaug
from cross_attention_vit_tpu_torch.data import augment as taug

SHAPE = (24, 24, 16)
JCFG = jaug.AugmentConfig()
TCFG = taug.AugmentConfig()
ATOL = 1e-5


def _vols(V=3, seed=0, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=(V, *shape)).astype(np.float32)


def _keys(V, seed=1):
    return jax.random.split(jax.random.key(seed), V)


def _jax_each(fn, keys, vols):
    return np.asarray(jax.vmap(fn)(keys, jnp.asarray(vols)))


def test_config_matches_jax_field_for_field():
    assert vars(TCFG) == vars(JCFG)


def test_flip_and_rot90_match_jax():
    vols, keys = _vols(), _keys(3)
    t = torch.from_numpy(vols)
    np.testing.assert_array_equal(taug.apply_flip(t).numpy(), _jax_each(jaug._flip0, keys, vols))
    np.testing.assert_array_equal(taug.apply_rot90(t).numpy(),
                                  _jax_each(jaug._rot90, keys, vols))


def test_affine_matrix_and_lu_affine_match_jax():
    vols, keys = _vols(4, seed=2), _keys(4, seed=2)
    m = jax.vmap(lambda k: jaug._affine_matrix(JCFG, k))(keys)
    k_rot = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
    k_scale = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    ang = jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=-0.1, maxval=0.1))(k_rot)
    scale = 1.0 + jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=-0.1,
                                                        maxval=0.1))(k_scale)
    tm = taug.affine_matrix(torch.tensor(np.asarray(ang)), torch.tensor(np.asarray(scale)))
    np.testing.assert_allclose(tm.numpy(), np.asarray(m), atol=1e-6)
    want = np.asarray(jaug._affine_lu_batched(JCFG)(keys, jnp.asarray(vols)))
    got = taug.apply_affine(torch.from_numpy(vols), torch.tensor(np.asarray(m)), TCFG)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("shape", [SHAPE, (13, 17, 9)])
def test_exact_affine_matches_jax(shape):
    """``affine_backend="exact"``: the single-pass trilinear warp against
    JAX's ``_affine`` at the matrices its ``_affine_matrix`` draws from the
    same keys, f32, within 1e-5 × max |vol|; the reflect fold of the corner
    indices is exercised by sources that leave the volume."""
    vols, keys = _vols(4, seed=3, shape=shape) * 100, _keys(4, seed=3)
    cfg = jaug.AugmentConfig(affine_backend="exact")
    want = _jax_each(jaug._affine(cfg), keys, vols)
    m = np.asarray(jax.vmap(lambda k: jaug._affine_matrix(cfg, k))(keys))
    got = taug.apply_affine_exact(torch.from_numpy(vols), torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(vols).max(), rtol=0)


def test_exact_affine_folds_indices_as_scipy_reflect():
    """Large scales send sources far outside the volume: the corner indices
    fold as ``map_coordinates(mode="reflect")``'s; bf16 volumes round the f32
    result once (one bf16 ulp of JAX's)."""
    from jax.scipy.ndimage import map_coordinates

    vols = _vols(1, seed=4, shape=(10, 12, 8))
    m = np.array([[[1.9, 0.2, 0.1], [0.0, 0.6, 0.3], [0.1, -0.2, 1.7]]], np.float32)
    D, H, W = vols.shape[1:]
    center = np.array([(D - 1) / 2.0, (H - 1) / 2.0, (W - 1) / 2.0], np.float32)
    coords = np.stack(np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij"))
    src = np.einsum("rk,kdhw->rdhw", m[0], coords.astype(np.float32) - center[:, None, None, None])
    src = src + center[:, None, None, None]
    assert src.min() < -3 and src.max() > max(D, H, W) + 2     # both sides of the volume
    for dtype, jdtype, atol in ((torch.float32, jnp.float32, 1e-5),
                                (torch.bfloat16, jnp.bfloat16, 2 ** -8)):
        want = np.asarray(map_coordinates(jnp.asarray(vols[0]).astype(jdtype), list(src),
                                          order=1, mode="reflect").astype(jnp.float32))
        got = taug.apply_affine_exact(torch.from_numpy(vols).to(dtype), torch.from_numpy(m))
        assert got.dtype == dtype
        np.testing.assert_allclose(got[0].float().numpy(), want,
                                   atol=atol * np.abs(want).max(), rtol=0)


def test_pipeline_dispatches_the_affine_on_its_backend():
    """``augment_batch`` with the affine alone at p = 1: 'lu' warps through
    the LU passes, 'exact' through the trilinear pass, each on the matrices
    the same host generator draws; bf16 batches keep bf16."""
    none = {f: 0.0 for f in ("flip_prob", "rot90_prob", "contrast_prob", "noise_prob",
                             "smooth_prob", "shuffle_prob", "dropout_prob", "zoom_prob")}
    imgs = _batch(B=2)
    gen = torch.Generator().manual_seed(9)      # augment_batch's draws, in its order:
    torch.randint(0, 2 ** 62, (), generator=gen)    # the field generator's seed,
    torch.rand(4, generator=gen)                     # the affine's gates,
    m = taug.draw_affine(4, TCFG, gen)               # its matrices
    for backend, warp in (("lu", lambda v: taug.apply_affine(v, m, TCFG)),
                          ("exact", lambda v: taug.apply_affine_exact(v, m))):
        cfg = taug.AugmentConfig(**none, affine_prob=1.0, affine_backend=backend)
        for dtype in (torch.float32, torch.bfloat16):
            out = taug.augment_batch(imgs.to(dtype), torch.Generator().manual_seed(9), cfg)
            want = warp(imgs.to(dtype).reshape(4, *imgs.shape[3:])).to(dtype)
            assert out.dtype == dtype
            assert torch.equal(out.reshape(want.shape), want), (backend, dtype)


def test_lu_tables_match_jax():
    for shape in (SHAPE, (128, 128, 64), (16, 16, 8)):
        l_wins, u_wins, fused2 = jaug._lu_windows(JCFG, shape)
        assert taug.lu_windows(TCFG, shape) == (l_wins[1], fused2, u_wins[1], u_wins[0])
        assert taug.lu_spans(TCFG, shape) == jaug._lu_spans(JCFG, shape)
    # the live geometry's tables: the windows and spans of the four LU passes
    assert taug.lu_windows(TCFG, (128, 128, 64)) == (10, 20, 14, 21)
    assert taug.lu_spans(TCFG, (128, 128, 64)) == (7, 18, 26, 29)


def test_contrast_matches_jax():
    vols, keys = _vols(seed=3), _keys(3, seed=3)
    gamma = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.7, maxval=1.3))(keys)
    want = _jax_each(jaug._contrast(JCFG), keys, vols)
    got = taug.apply_contrast(torch.from_numpy(vols), torch.tensor(np.asarray(gamma)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


def test_contrast_bf16_keeps_the_jax_type_promotion():
    """bf16 volumes: the normalisation rounds to bf16, the power runs in f32
    (gamma is f32); after the step boundary's cast both sides agree."""
    vols, keys = _vols(seed=4) * 50, _keys(3, seed=4)
    gamma = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.7, maxval=1.3))(keys)
    want = np.asarray(jax.vmap(jaug._contrast(JCFG))(keys, jnp.asarray(vols, jnp.bfloat16))
                      .astype(jnp.bfloat16).astype(jnp.float32))
    got = taug.apply_contrast(torch.from_numpy(vols).to(torch.bfloat16),
                              torch.tensor(np.asarray(gamma))).to(torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=2 ** -8)


def test_noise_matches_jax():
    vols, keys = _vols(seed=5), _keys(3, seed=5)
    split = jax.vmap(jax.random.split)(keys)
    std = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.0, maxval=0.1))(split[:, 0])
    field = jax.vmap(lambda k: jax.random.normal(k, SHAPE))(split[:, 1])
    want = _jax_each(jaug._noise(JCFG), keys, vols)
    got = taug.apply_noise(torch.from_numpy(vols), torch.tensor(np.asarray(std)),
                           torch.tensor(np.asarray(field)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_gaussian_kernel_and_smooth_match_jax():
    sig = np.array([0.3, 0.7, 1.5], np.float32)
    r = taug.smooth_radius(TCFG)
    want = np.stack([np.asarray(jaug._gaussian_kernel(jnp.float32(s), r)) for s in sig])
    # tail taps are differences of two erf values near 1 (ulp 6e-8): the two
    # erf implementations leave a few ulps there
    np.testing.assert_allclose(taug.gaussian_kernel(torch.from_numpy(sig), r).numpy(), want,
                               atol=1e-6)
    vols, keys = _vols(seed=6), _keys(3, seed=6)
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    bounds = (JCFG.sigma_x, JCFG.sigma_yz, JCFG.sigma_yz)
    sigmas = np.stack([np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=lo, maxval=hi))(ks[:, a])) for a, (lo, hi) in enumerate(bounds)], axis=-1)
    want = _jax_each(jaug._smooth(JCFG), keys, vols)
    got = taug.apply_smooth(torch.from_numpy(vols), torch.from_numpy(sigmas), r)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _jax_corners(keys, size, holes):
    hs = jaug._clip_hole(size, SHAPE)
    c = jax.vmap(lambda k: jnp.stack(jaug._hole_corners(k, SHAPE, hs, holes), -1))(keys)
    return np.asarray(c)


def test_coarse_shuffle_matches_jax():
    vols, keys = _vols(seed=7), _keys(3, seed=7)
    hs = jaug._clip_hole(JCFG.shuffle_size, SHAPE)
    split = jax.vmap(jax.random.split)(keys)
    corners = _jax_corners(split[:, 0], JCFG.shuffle_size, JCFG.shuffle_holes)
    bits = jax.vmap(lambda kp: jax.vmap(lambda k: jax.random.bits(
        k, (hs[0] * hs[1] * hs[2],), dtype=jnp.uint32))(
            jax.random.split(kp, JCFG.shuffle_holes)))(split[:, 1])
    perms = np.argsort(np.asarray(bits), axis=-1, kind="stable")
    want = _jax_each(jaug._coarse_shuffle(JCFG), keys, vols)
    got = taug.apply_shuffle(torch.from_numpy(vols), torch.from_numpy(corners),
                             torch.from_numpy(perms), TCFG.shuffle_size)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, vols)


def test_coarse_dropout_matches_jax():
    vols, keys = _vols(seed=8), _keys(3, seed=8)
    corners = _jax_corners(keys, JCFG.dropout_size, JCFG.dropout_holes)
    want = _jax_each(jaug._coarse_dropout(JCFG), keys, vols)
    got = taug.apply_coarse_dropout(torch.from_numpy(vols), torch.from_numpy(corners),
                                    TCFG.dropout_size, TCFG.dropout_fill)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == -1).any()


def test_zoom_matrix_and_zoom_match_jax():
    z = np.array([0.9, 1.0, 1.1], np.float32)
    for size in (16, 24):
        want = np.stack([np.asarray(jaug._zoom_matrix(size, jnp.float32(v))) for v in z])
        np.testing.assert_allclose(taug.zoom_matrix(size, torch.from_numpy(z)).numpy(), want,
                                   atol=1e-7)
    vols, keys = _vols(seed=9), _keys(3, seed=9)
    zs = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.9, maxval=1.1))(keys)
    want = _jax_each(jaug._zoom(JCFG), keys, vols)
    got = taug.apply_zoom(torch.from_numpy(vols), torch.tensor(np.asarray(zs)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# --- the pipeline, for distribution only -------------------------------------

def _batch(B=60, M=2, shape=(8, 8, 4), dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, M, 1, *shape), generator=g).to(dtype)


def test_pipeline_apply_rates_match_the_probabilities():
    """Each transform is drawn by a Binomial(V, p) number of volumes: over
    5 batches of 120 volumes the total lies within 5 standard deviations."""
    probs = {"flip": 0.5, "rot90": 0.2, "affine": 0.2, "contrast": 0.3, "noise": 0.2,
             "smooth": 0.2, "shuffle": 0.2, "coarse_dropout": 0.2, "zoom": 0.2}
    totals = dict.fromkeys(probs, 0)
    g = torch.Generator().manual_seed(11)
    imgs = _batch()
    for _ in range(5):
        applied = {}
        taug.augment_batch(imgs, g, applied=applied)
        for k in probs:
            totals[k] += applied[k]
    n = 5 * imgs.shape[0] * imgs.shape[1]
    for k, p in probs.items():
        assert abs(totals[k] - n * p) < 5 * (n * p * (1 - p)) ** 0.5, (k, totals[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipeline_keeps_shape_and_dtype_and_is_deterministic(dtype):
    imgs = _batch(B=4, dtype=dtype)
    a = taug.augment_batch(imgs, torch.Generator().manual_seed(5))
    b = taug.augment_batch(imgs, torch.Generator().manual_seed(5))
    c = taug.augment_batch(imgs, torch.Generator().manual_seed(6))
    assert a.shape == imgs.shape and a.dtype == dtype
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(torch.isfinite(a.float()).all())


def test_pipeline_transforms_only_the_volumes_that_drew_the_transform():
    """With only the flip enabled at p = 1 every volume flips; at p = 0
    nothing changes — the gate indexes volumes, it does not select values."""
    none = {f: 0.0 for f in ("flip_prob", "rot90_prob", "affine_prob", "contrast_prob",
                             "noise_prob", "smooth_prob", "shuffle_prob", "dropout_prob",
                             "zoom_prob")}
    imgs = _batch(B=3)
    flip = taug.AugmentConfig(**{**none, "flip_prob": 1.0})
    out = taug.augment_batch(imgs, torch.Generator().manual_seed(0), flip)
    assert torch.equal(out, imgs.flip(3))
    out = taug.augment_batch(imgs, torch.Generator().manual_seed(0), taug.AugmentConfig(**none))
    assert torch.equal(out, imgs) and out is not imgs


def test_pipeline_rejects_rot90_on_non_square_volumes():
    with pytest.raises(ValueError, match="D == H"):
        taug.augment_batch(_batch(B=1, shape=(8, 4, 4)), torch.Generator())
