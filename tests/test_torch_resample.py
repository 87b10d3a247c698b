"""The port's windowed resample (kernels K3/K4: the plain version, which the
wrapper runs for CPU tensors) against the JAX package's
``resample_axis_windowed_batched``, which runs here in Pallas interpret mode.

Shapes: (16, 16, 8) volumes with the LU augmentation's own windows and
spans at that geometry (``_lu_windows`` / ``_lu_spans``: every span is below
its 2W+2, so JAX takes the tiled v2 kernel), the same passes with span None
(v1, all taps), and cdelta at the corners of the affine parameter box, where
rel comes nearest ±W.  Tolerance: f32 atol 1e-5, rtol 1e-5, as
tests/test_augment.py:290 (both sides accumulate the same taps in f32 and
may differ in the last ulp); bf16: the outputs round the same f32 sums, so
they differ by at most one bf16 ulp where those sums differ in the last f32
bit."""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cross_attention_vit_tpu.data import augment as jaug
from cross_attention_vit_tpu.kernels import resample as jrs
from cross_attention_vit_tpu_torch.data import augment as taug
from cross_attention_vit_tpu_torch.kernels import resample as trs

SHAPE = (16, 16, 8)
CENTER = tuple((s - 1) / 2.0 for s in SHAPE)
CFG = jaug.AugmentConfig()


def _corner_cdeltas(V, seed):
    """Per-pass cdelta (4 × (V, 3)) of sampling matrices at box corners."""
    corners = np.array(list(itertools.product((-1.0, 1.0), repeat=6)))
    pick = corners[np.random.default_rng(seed).permutation(64)[:V]]
    m = taug.affine_matrix(torch.tensor(pick[:, :3] * 0.1, dtype=torch.float32),
                           torch.tensor(1.0 + pick[:, 3:] * 0.1, dtype=torch.float32))
    return [c.numpy() for c in taug.lu_cdeltas(m)]


def _both(vols, axis, cd, window, span):
    want = np.asarray(jrs.resample_axis_windowed_batched(
        jnp.asarray(vols), axis, jnp.asarray(cd), CENTER, window, span=span))
    got = trs.resample_axis_windowed_batched(torch.from_numpy(vols), axis,
                                             torch.from_numpy(cd), CENTER, window, span)
    return got, want


def test_live_tables_take_the_tiled_kernel():
    windows = jaug._lu_windows(CFG, SHAPE)
    spans = jaug._lu_spans(CFG, SHAPE)
    assert taug.lu_windows(taug.AugmentConfig(), SHAPE) == (windows[0][1], windows[2],
                                                            windows[1][1], windows[1][0])
    assert taug.lu_spans(taug.AugmentConfig(), SHAPE) == spans
    for w, s in zip(taug.lu_windows(taug.AugmentConfig(), SHAPE), spans):
        assert s < 2 * w + 2


@pytest.mark.parametrize("span_mode", ["v2", "v1"])
@pytest.mark.parametrize("p", range(4))
def test_plain_resample_matches_jax_at_box_corners(p, span_mode):
    vols = np.random.default_rng(p).normal(size=(4, *SHAPE)).astype(np.float32)
    cd = _corner_cdeltas(4, seed=p)[p]
    window = taug.lu_windows(taug.AugmentConfig(), SHAPE)[p]
    span = taug.lu_spans(taug.AugmentConfig(), SHAPE)[p] if span_mode == "v2" else None
    got, want = _both(vols, taug.LU_AXES[p], cd, window, span)
    # the corners drive |rel| to at least half the window's displacement
    # bound W − 2 (W is that bound × 1.05 plus two voxels)
    half = np.array([(s - 1) / 2.0 for s in SHAPE])
    assert (np.abs(cd) @ half).max() > 0.5 * (window - 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("axis,window,span", [(0, 3, 4), (1, 6, 5), (2, 2, 3), (2, 3, None)])
def test_plain_resample_matches_jax_random_coefficients(axis, window, span):
    r = np.random.default_rng(axis * 10 + window)
    vols = r.normal(size=(3, *SHAPE)).astype(np.float32)
    cd = r.uniform(-0.3, 0.3, size=(3, 3)).astype(np.float32)
    got, want = _both(vols, axis, cd, window, span)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_narrow_span_drops_taps_like_jax():
    """A span too small for the tile's rel range drops the same taps."""
    r = np.random.default_rng(5)
    vols = r.normal(size=(2, *SHAPE)).astype(np.float32)
    cd = np.array([[0.2, -0.3, 0.25], [-0.25, 0.1, 0.3]], np.float32)
    got, want = _both(vols, 2, cd, 6, 2)
    full, _ = _both(vols, 2, cd, 6, None)
    assert not np.allclose(got.numpy(), full.numpy())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plain_resample_bf16_matches_jax():
    vols = (np.random.default_rng(9).normal(size=(3, *SHAPE)) * 100).astype(np.float32)
    cd = _corner_cdeltas(3, seed=9)[1]
    window, span = taug.lu_windows(taug.AugmentConfig(), SHAPE)[1], \
        taug.lu_spans(taug.AugmentConfig(), SHAPE)[1]
    want = np.asarray(jrs.resample_axis_windowed_batched(
        jnp.asarray(vols, jnp.bfloat16), 2, jnp.asarray(cd), CENTER, window, span=span)
        .astype(jnp.float32))
    got = trs.resample_axis_windowed_batched(torch.from_numpy(vols).to(torch.bfloat16), 2,
                                             torch.from_numpy(cd), CENTER, window, span)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3, rtol=2 ** -8)


@pytest.mark.parametrize("n,before,after", [(3, 5, 6), (8, 3, 4), (16, 10, 11)])
def test_symmetric_pad_index_is_numpy_symmetric(n, before, after):
    want = np.pad(np.arange(n), (before, after), mode="symmetric")
    np.testing.assert_array_equal(trs.symmetric_pad_index(n, before, after).numpy(), want)


def test_cpu_calls_do_not_count_as_launches():
    vols = torch.zeros(1, *SHAPE)
    cd = torch.zeros(1, 3)
    trs.resample_axis_windowed_batched(vols, 0, cd, CENTER, 2, 3)
    trs.resample_axis_windowed_batched(vols, 0, cd, CENTER, 2)
    assert trs.resample_axis_windowed_batched.launches == 0
    assert trs.resample_axis_windowed_batched.full_launches == 0


@pytest.mark.parametrize("kwargs", [dict(axis=3), dict(cdelta=torch.zeros(2, 3)),
                                    dict(vols=torch.zeros(2, *SHAPE, dtype=torch.int32)),
                                    dict(vols=torch.zeros(1, *SHAPE, device="meta"))])
def test_bad_inputs_raise(kwargs):
    args = dict(vols=torch.zeros(1, *SHAPE), axis=0, cdelta=torch.zeros(1, 3), center=CENTER,
                window=2)
    args.update(kwargs)
    with pytest.raises(ValueError):
        trs.resample_axis_windowed_batched(**args)
