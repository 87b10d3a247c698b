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
bit.

The second half emulates the CUDA kernel's staging (boxes of the source in
shared memory, reflection at read time) in plain PyTorch, bit for bit
against the plain version, and checks the box geometry the wrapper hands the
kernel."""

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


# --- the kernel's staging (csrc/resample.cu), emulated in plain PyTorch ---
#
# A block of the kernel stages one box of the source in shared memory: the
# resample axis whole and a cross-section of the other dims inside one tile
# (``box_geometry``), each row padded to its pitch.  Every tap
# it reads is an index into that slab, reflected along the axis at read time,
# and the box's window comes from its tile's corner.  The emulation below
# repeats that indexing box by box, voxel for voxel, and must equal the plain
# version bit for bit: the box's own lines cover every tap.

UNALIGNED = ((3, (40, 24, 20)), (1, (48, 36, 60)))


def _reflect(p: torch.Tensor, n: int) -> torch.Tensor:
    p = torch.remainder(p, 2 * n)
    return torch.where(p >= n, 2 * n - 1 - p, p)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _box_window(cd, t0, t1, shape, axis, center, window, taps):
    """The kernel's (d_lo, span) of the box at (t0, t1): rel at its tile's
    corner, in f32 scalars."""
    if taps is None:
        return -window, 2 * window + 2
    b0, b1 = trs._tiles(shape, axis)
    t0, t1 = t0 // b0 * b0, t1 // b1 * b1
    y = [t0 if cd[0] >= 0 else t0 + b0 - 1, t1 if cd[1] >= 0 else t1 + b1 - 1,
         0 if cd[2] >= 0 else shape[2] - 1]
    g = [_f32(float(yi)) - _f32(c) for yi, c in zip(y, center)]
    rmin = (cd[0] * g[0] + cd[1] * g[1]) + cd[2] * g[2]
    d_lo = torch.clamp(torch.floor(rmin), -window, window + 2 - taps)
    return int(d_lo), taps


def _staged(vols: torch.Tensor, axis: int, cdelta: torch.Tensor, center: tuple, window: int,
            span) -> torch.Tensor:
    V, D, H, W = vols.shape
    shape, n = (D, H, W), vols.shape[1 + axis]
    e0, e1, cw, pitch, _ = trs.box_geometry(shape, axis, vols.element_size())
    taps = trs._window_taps(window, span)
    c0, c1, c2 = (_f32(c) for c in center)
    out = torch.empty_like(vols)
    for v in range(V):
        cd = cdelta[v].float()
        for t0, t1, t2 in itertools.product(range(0, D, e0), range(0, H, e1), range(0, W, cw)):
            wb = min(cw, W - t2)
            slab = torch.zeros(e0, e1, pitch, dtype=vols.dtype)
            slab[:, :, :wb] = vols[v, t0:t0 + e0, t1:t1 + e1, t2:t2 + wb]
            slab = slab.reshape(-1)
            d_lo, taps_n = _box_window(cd, t0, t1, shape, axis, center, window, taps)
            i0, i1, col = torch.meshgrid(torch.arange(e0), torch.arange(e1), torch.arange(wb),
                                         indexing="ij")
            x = (t0 + i0, t1 + i1, t2 + col)
            part = cd[0] * (x[0].float() - c0) + cd[1] * (x[1].float() - c1)
            rel = part + cd[2] * (x[2].float() - c2)
            d0f = torch.floor(rel)
            d0 = d0f.long()
            w0 = 1.0 - torch.abs(rel - d0f)
            w1 = 1.0 - torch.abs(rel - (d0f + 1.0))
            # a tap at axis position p reads slab[base + p·stride]
            base, stride = ((i1 * pitch + col, e1 * pitch), (i0 * e1 * pitch + col, pitch),
                            ((i0 * e1 + i1) * pitch, 1))[axis]
            p0 = x[axis] + d0
            s0 = slab[base + _reflect(p0, n) * stride].float()
            s1 = slab[base + _reflect(p0 + 1, n) * stride].float()
            k0 = (d0 >= d_lo) & (d0 < d_lo + taps_n)
            k1 = (d0 + 1 >= d_lo) & (d0 + 1 < d_lo + taps_n)
            acc = (0.0 + torch.where(k0, w0 * s0, 0.0)) + torch.where(k1, w1 * s1, 0.0)
            out[v, t0:t0 + e0, t1:t1 + e1, t2:t2 + wb] = acc.to(vols.dtype)
    return out


def _staging_cases():
    for V, shape in ((4, SHAPE), *UNALIGNED):
        for dtype in ((torch.float32,) if shape == SHAPE else (torch.float32, torch.bfloat16)):
            for p in range(5):   # the four LU passes, then K4 on the last one
                yield pytest.param(V, shape, dtype, p, id=f"{shape}-{dtype}-{p}")


@pytest.mark.parametrize("V,shape,dtype,p", _staging_cases())
def test_staged_boxes_equal_the_plain_version_bit_for_bit(V, shape, dtype, p):
    cfg = taug.AugmentConfig()
    center = tuple((s - 1) / 2.0 for s in shape)
    rng = np.random.default_rng(100 + p + sum(shape))
    vols = torch.from_numpy((rng.normal(size=(V, *shape)) * 100).astype(np.float32)).to(dtype)
    corners = np.array(list(itertools.product((-1.0, 1.0), repeat=6)))
    pick = corners[rng.permutation(64)[:V]]
    m = taug.affine_matrix(torch.tensor(pick[:, :3] * cfg.affine_rotate, dtype=torch.float32),
                           torch.tensor(1.0 + pick[:, 3:] * cfg.affine_scale,
                                        dtype=torch.float32))
    q = min(p, 3)
    cd = taug.lu_cdeltas(m)[q]
    axis, window = taug.LU_AXES[q], taug.lu_windows(cfg, shape)[q]
    span = taug.lu_spans(cfg, shape)[q] if p < 4 else None
    want = trs.resample_axis_windowed_reference(vols, axis, cd, center, window, span)
    got = _staged(vols, axis, cd, center, window, span)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_staged_boxes_drop_the_narrow_window_s_taps():
    """The window test at read time, where a span too small for the tile
    drops taps with nonzero weight."""
    r = np.random.default_rng(5)
    vols = torch.from_numpy(r.normal(size=(2, *SHAPE)).astype(np.float32))
    cd = torch.tensor([[0.2, -0.3, 0.25], [-0.25, 0.1, 0.3]])
    want = trs.resample_axis_windowed_reference(vols, 2, cd, CENTER, 6, 2)
    assert torch.equal(_staged(vols, 2, cd, CENTER, 6, 2), want)


GEOMETRY_SHAPES = ((128, 128, 64), SHAPE, (40, 24, 20), (48, 36, 60), (7, 5, 3), (96, 160, 33),
                   (1024, 8, 8), (8, 8, 4096))


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_box_geometry_stays_in_one_tile_and_in_shared_memory(shape):
    for axis, itemsize in itertools.product(range(3), (2, 4)):
        e0, e1, cw, pitch, smem = trs.box_geometry(shape, axis, itemsize)
        b0, b1 = trs._tiles(shape, axis)
        assert (e0, e1, cw)[axis] == shape[axis]          # the axis whole
        assert b0 % e0 == 0 and b1 % e1 == 0               # inside one tile
        assert axis == 2 or (cw % 8 == 0 and cw < shape[2] + 8)
        assert pitch * itemsize % 16 == 0 and cw <= pitch  # rows of whole 16-byte copies
        assert axis < 2 or pitch * itemsize % 128 == 16   # the rows' banks differ
        assert smem == trs.RING_SLOTS * e0 * e1 * pitch * itemsize <= trs.SMEM_BYTES
        if shape == (128, 128, 64):
            assert e0 * e1 * cw * itemsize == trs.BOX_BYTES


def test_live_boxes():
    """The live passes' boxes in bf16: 1024 of 8192 voxels over 8 volumes,
    three slots of 16 KB (18 KB on axis 2, whose rows are padded) a block;
    in f32 boxes of 4096 voxels."""
    shape = (128, 128, 64)
    assert [trs.box_geometry(shape, a, 2) for a in range(3)] == [
        (128, 1, 64, 64, 49152), (1, 128, 64, 64, 49152), (4, 32, 64, 72, 55296)]
    assert [trs.box_geometry(shape, a, 4) for a in range(3)] == [
        (128, 1, 32, 32, 49152), (1, 128, 32, 32, 49152), (2, 32, 64, 68, 52224)]


@pytest.mark.parametrize("shape,axis", [((4000, 8, 8), 0), ((8, 4000, 8), 1), ((8, 8, 30000), 2)])
def test_box_geometry_raises_where_no_box_fits(shape, axis):
    with pytest.raises(ValueError, match="shared memory"):
        trs.box_geometry(shape, axis, 4)
    if axis < 2:
        trs.box_geometry(shape, axis, 2)     # bf16's half-size slab still fits
