"""Training augmentations: the 9-transform pipeline of
``cross_attention_vit_tpu/data/augment.py`` as batched PyTorch ops.

Transform order and parameters (the reference list, JAX ``:17-26``):
  1. RandFlip        p=0.5,  spatial axis 0
  2. RandRotate90    p=0.2,  k=1, axes (0,1)        [requires D == H]
  3. RandAffine      p=0.2,  rotate U(±0.1 rad)/axis, scale 1+U(±0.1)/axis,
                     the gather-free LU warp: 4 windowed 1-D resamples
                     through the hand-written kernel (kernels/resample.py);
                     ``affine_backend="exact"``: one trilinear pass
                     (``apply_affine_exact``, JAX ``_affine``)
  4. RandAdjustContrast p=0.3, gamma U(0.7, 1.3)
  5. RandGaussianNoise  p=0.2, std U(0, 0.1)
  6. RandGaussianSmooth p=0.2, sigma_x U(0.5,1.5), sigma_y/z U(0.25,1.5)
  7. RandCoarseShuffle  p=0.2, 5 holes of 20³ (voxels permuted per hole)
  8. RandCoarseDropout  p=0.2, 3 holes of 15³, fill −1
  9. RandZoom           p=0.2, isotropic U(0.9, 1.1), keep_size (edge clamp)

Each transform is split in two: ``draw_<name>`` draws its parameters from
torch generators, and ``apply_<name>`` applies it to a (V, D, H, W) batch of
volumes at given parameters — so the tests hold each apply against the JAX
function at the parameters JAX drew.  torch's generators cannot reproduce
``jax.random``; the pipeline matches JAX in distribution only.

``augment_batch`` runs the pipeline per (batch, modality) volume.  Each volume
draws a Bernoulli per transform; the volumes that drew it are indexed out,
transformed and written back (the JAX package's compaction gating without its
cap).  The gates, scalar parameters and hole corners come from a host
generator, so choosing the volumes never waits for the card; the noise field
and the shuffle permutations are drawn on the volumes' device.  Each host
draw reaches the card through ``utils.profiling.to_device``, a copy that
blocks the host (a ``sync:h2d`` span under a profiler): on a card, with
every transform drawn, 25 a batch (9 gate indices, the affine's 4 pass
coefficients, the contrast, noise, smooth and zoom parameters, one copy of
corners a hole: 5 shuffled, 3 dropped).  Every
transform's output is cast back to the batch dtype, so a bf16 batch keeps
bf16 step boundaries (JAX ``:573-581``) while each transform computes as the
JAX one does.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.resample import resample_axis_windowed_batched
from ..utils.profiling import to_device


@dataclass(frozen=True)
class AugmentConfig:
    flip_prob: float = 0.5
    rot90_prob: float = 0.2
    affine_prob: float = 0.2
    affine_rotate: float = 0.1
    affine_scale: float = 0.1
    # 'lu' = the LU-factored warp through K3 (the default, the main path);
    # anything else = the single-pass trilinear warp (JAX's 'exact')
    affine_backend: str = "lu"
    contrast_prob: float = 0.3
    gamma_low: float = 0.7
    gamma_high: float = 1.3
    noise_prob: float = 0.2
    noise_std: float = 0.1
    smooth_prob: float = 0.2
    sigma_x: tuple[float, float] = (0.5, 1.5)
    sigma_yz: tuple[float, float] = (0.25, 1.5)
    shuffle_prob: float = 0.2
    shuffle_holes: int = 5
    shuffle_size: tuple[int, int, int] = (20, 20, 20)
    dropout_prob: float = 0.2
    dropout_holes: int = 3
    dropout_size: tuple[int, int, int] = (15, 15, 15)
    dropout_fill: float = -1.0
    zoom_prob: float = 0.2
    zoom_low: float = 0.9
    zoom_high: float = 1.1


def _uniform(shape, low: float, high: float, generator: torch.Generator) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=generator)


# --- geometric -------------------------------------------------------------

def apply_flip(vols: torch.Tensor) -> torch.Tensor:
    return vols.flip(1)


def apply_rot90(vols: torch.Tensor) -> torch.Tensor:
    """MONAI RandRotate90(max_k=1): k=1 on spatial axes (0, 1)."""
    return torch.rot90(vols, 1, dims=(1, 2))


def draw_affine(n: int, cfg: AugmentConfig, generator: torch.Generator) -> torch.Tensor:
    """(n, 3, 3) sampling matrices from rotations U(±affine_rotate) and scales
    1 + U(±affine_scale) per axis."""
    ang = _uniform((n, 3), -cfg.affine_rotate, cfg.affine_rotate, generator)
    scale = 1.0 + _uniform((n, 3), -cfg.affine_scale, cfg.affine_scale, generator)
    return affine_matrix(ang, scale)


def affine_matrix(ang: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """MONAI AffineGrid rotates then scales: m = Rx·Ry·Rz·diag(scale), f32,
    per row of the (n, 3) angles and scales (JAX ``_affine_matrix``)."""
    ang, scale = ang.float(), scale.float()
    c, s = torch.cos(ang), torch.sin(ang)
    one, zero = torch.ones_like(c[:, 0]), torch.zeros_like(c[:, 0])

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rx = mat([[one, zero, zero], [zero, c[:, 0], -s[:, 0]], [zero, s[:, 0], c[:, 0]]])
    ry = mat([[c[:, 1], zero, s[:, 1]], [zero, one, zero], [-s[:, 1], zero, c[:, 1]]])
    rz = mat([[c[:, 2], -s[:, 2], zero], [s[:, 2], c[:, 2], zero], [zero, zero, one]])
    return rx @ ry @ rz @ torch.diag_embed(scale)


@functools.lru_cache(maxsize=8)
def _lu_row_bounds(cfg: AugmentConfig) -> tuple[np.ndarray, np.ndarray]:
    """max |L − I| and |U − I| of the Doolittle factors of m over the whole
    (angle, scale) box, scanned on its corner/midpoint grid (JAX
    ``_lu_row_bounds``, kept here as a private copy)."""
    r, sc = cfg.affine_rotate, cfg.affine_scale
    lmax = np.zeros((3, 3))
    umax = np.zeros((3, 3))
    for ax in np.ndindex(3, 3, 3):
        ang = np.array([(-r, 0.0, r)[a] for a in ax])
        for sgn in np.ndindex(2, 2, 2):
            s = 1.0 + np.array([(-sc, sc)[g] for g in sgn])
            cx, cy, cz = np.cos(ang)
            sx, sy, sz = np.sin(ang)
            rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
            ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            m = rx @ ry @ rz @ np.diag(s)
            l10, l20 = m[1, 0] / m[0, 0], m[2, 0] / m[0, 0]
            u11 = m[1, 1] - l10 * m[0, 1]
            u12 = m[1, 2] - l10 * m[0, 2]
            l21 = (m[2, 1] - l20 * m[0, 1]) / u11
            u22 = m[2, 2] - l20 * m[0, 2] - l21 * u12
            L = np.array([[1, 0, 0], [l10, 1, 0], [l20, l21, 1.0]])
            U = np.array([[m[0, 0], m[0, 1], m[0, 2]], [0, u11, u12], [0, 0, u22]])
            lmax = np.maximum(lmax, np.abs(L - np.eye(3)))
            umax = np.maximum(umax, np.abs(U - np.eye(3)))
    return lmax, umax


def lu_windows(cfg: AugmentConfig, shape) -> tuple[int, int, int, int]:
    """Tap windows W of the four LU passes (L axis 1, fused axis 2, U axis 1,
    U axis 0): the displacement bound over the parameter box, ×1.05, plus one
    interpolation and one margin voxel (JAX ``_lu_windows``)."""
    h = np.array([(s - 1) / 2.0 for s in shape])
    lmax, umax = _lu_row_bounds(cfg)

    def win(dev_row):
        return int(np.ceil(float(dev_row @ h) * 1.05)) + 2
    return win(lmax[1]), win(lmax[2] + umax[2]), win(umax[1]), win(umax[0])


def lu_spans(cfg: AugmentConfig, shape, block: int = 32) -> tuple[int, int, int, int]:
    """Active-tap bounds of the same four passes within one kernel tile (the
    axis and dim 2 whole, the other dims of {0, 1} blocked at ``block``)
    (JAX ``_lu_spans``)."""
    lmax, umax = _lu_row_bounds(cfg)

    def span(row, axis):
        ext = [float(shape[0] - 1), float(shape[1] - 1), float(shape[2] - 1)]
        for dim in (0, 1):
            if dim != axis:
                ext[dim] = float(min(block, shape[dim]) - 1)
        return int(np.ceil(float(row @ np.array(ext)) * 1.05)) + 3
    return (span(lmax[1], 1), span(lmax[2] + umax[2], 2), span(umax[1], 1),
            span(umax[0], 0))


LU_AXES = (1, 2, 1, 0)   # resample axis of each LU pass


def lu_cdeltas(m: torch.Tensor) -> list[torch.Tensor]:
    """Per-pass cdelta (coefficients − e_axis), each (n, 3) f32, of the four
    LU passes for sampling matrices m (n, 3, 3): L axis 1, the fused L∘U
    axis-2 pass, U axis 1, U axis 0 (JAX ``_affine_lu_batched``)."""
    m = m.float()
    l10, l20 = m[:, 1, 0] / m[:, 0, 0], m[:, 2, 0] / m[:, 0, 0]
    u11 = m[:, 1, 1] - l10 * m[:, 0, 1]
    u12 = m[:, 1, 2] - l10 * m[:, 0, 2]
    l21 = (m[:, 2, 1] - l20 * m[:, 0, 1]) / u11
    u22 = m[:, 2, 2] - l20 * m[:, 0, 2] - l21 * u12
    one, zero = torch.ones_like(l10), torch.zeros_like(l10)
    coefs = [(l10, one, zero), (l20, l21, u22), (zero, u11, u12),
             (m[:, 0, 0], m[:, 0, 1], m[:, 0, 2])]
    out = []
    for (c0, c1, c2), axis in zip(coefs, LU_AXES):
        e = torch.zeros(3)
        e[axis] = 1.0
        out.append(torch.stack([c0, c1, c2], dim=-1) - e)
    return out


def apply_affine(vols: torch.Tensor, m: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """Warp each volume by its sampling matrix m (V, 3, 3) as 4 windowed 1-D
    resamples (K3), each returning the input dtype."""
    shape = tuple(vols.shape[1:])
    center = tuple((s - 1) / 2.0 for s in shape)
    out = vols
    for cd, axis, window, span in zip(lu_cdeltas(m), LU_AXES, lu_windows(cfg, shape),
                                      lu_spans(cfg, shape)):
        out = resample_axis_windowed_batched(out, axis, to_device(cd, vols.device), center, window,
                                             span=span)
    return out


def _reflect_index(index: torch.Tensor, size: int) -> torch.Tensor:
    """scipy's 'reflect' mode (half-sample symmetric) on integer indices, as
    ``jax.scipy.ndimage.map_coordinates`` folds them (its
    ``_reflect_index_fixer``): index i of a line of ``size`` samples."""
    s = 2 * size    # the half-wavelength of the triangle wave on 2i + 1
    mirrored = torch.abs(torch.remainder(2 * index + 1 + s, 2 * s) - s)
    return torch.div(mirrored - 1, 2, rounding_mode="floor")


def apply_affine_exact(vols: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Warp each volume by its sampling matrix m (V, 3, 3) in one trilinear
    pass (JAX ``_affine``: ``map_coordinates(order=1, mode="reflect")``).

    Source coordinates m·(i − c) + c in f32 about the centre
    c = ((D−1)/2, (H−1)/2, (W−1)/2), each row summed in index order; per
    axis the floor and the next sample with weights (1 − t, t), their
    indices folded by ``_reflect_index``; the eight corners' weight products
    times the f32 samples summed in JAX's corner order, cast once to the
    volumes' dtype.  Plain PyTorch gathers, as JAX's were plain XLA; one
    volume at a time bounds the index tensors."""
    V, D, H, W = vols.shape
    dev = vols.device
    m = to_device(m, dev, torch.float32)
    center = [(D - 1) / 2.0, (H - 1) / 2.0, (W - 1) / 2.0]
    grid = torch.meshgrid(*(torch.arange(n, device=dev, dtype=torch.float32)
                            for n in (D, H, W)), indexing="ij")
    rel = [g.reshape(-1) - c for g, c in zip(grid, center)]
    strides = (H * W, W, 1)
    out = torch.empty_like(vols)
    for v in range(V):
        flat = vols[v].reshape(-1)
        taps = []       # per axis: [(flat offset, weight) of the floor, of the next]
        for r, size in enumerate((D, H, W)):
            src = (m[v, r, 0] * rel[0] + m[v, r, 1] * rel[1]) + m[v, r, 2] * rel[2] + center[r]
            lo = torch.floor(src)
            upper = src - lo
            i = lo.long()
            taps.append([(_reflect_index(i, size) * strides[r], 1 - upper),
                         (_reflect_index(i + 1, size) * strides[r], upper)])
        acc = None
        for (o0, w0), (o1, w1), (o2, w2) in itertools.product(*taps):
            term = (w0 * w1 * w2) * flat[o0 + o1 + o2].float()
            acc = term if acc is None else acc + term
        out[v] = acc.reshape(D, H, W).to(vols.dtype)
    return out


def zoom_matrix(size: int, z: torch.Tensor) -> torch.Tensor:
    """(n, size, size) 1-D linear-interpolation matrices for a keep-size zoom
    by factors z (n,) about the centre, edge-clamped, rows renormalised where
    the clamped edge double-counts (JAX ``_zoom_matrix``)."""
    c = (size - 1) / 2.0
    i = torch.arange(size, dtype=torch.float32, device=z.device)
    src = torch.clamp((i - c) / z.float()[:, None] + c, 0.0, size - 1.0)
    lo = torch.floor(src)
    frac = src - lo
    lo_i = lo.long()
    hi_i = torch.clamp(lo_i + 1, max=size - 1)
    cols = torch.arange(size, device=z.device)
    a = (cols == lo_i[..., None]) * (1.0 - frac[..., None]) \
        + (cols == hi_i[..., None]) * frac[..., None]
    return a / a.sum(dim=-1, keepdim=True)


def draw_zoom(n: int, cfg: AugmentConfig, generator: torch.Generator) -> torch.Tensor:
    return _uniform((n,), cfg.zoom_low, cfg.zoom_high, generator)


def apply_zoom(vols: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Separable keep-size zoom: three f32 contractions with the zoom
    matrices, cast back to the input dtype once at the end."""
    _, D, H, W = vols.shape
    z = to_device(z, vols.device)
    out = torch.einsum("vab,vbhw->vahw", zoom_matrix(D, z), vols.float())
    out = torch.einsum("vab,vdbw->vdaw", zoom_matrix(H, z), out)
    out = torch.einsum("vab,vdhb->vdha", zoom_matrix(W, z), out)
    return out.to(vols.dtype)


# --- intensity ----------------------------------------------------------------

def _per_volume(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return to_device(x, like.device, torch.float32)[:, None, None, None]


def draw_contrast(n: int, cfg: AugmentConfig, generator: torch.Generator) -> torch.Tensor:
    return _uniform((n,), cfg.gamma_low, cfg.gamma_high, generator)


def apply_contrast(vols: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """MONAI AdjustContrast: ((x − min)/(range + eps))^gamma · range + min.
    The normalisation runs in the volumes' dtype and the power in f32, as
    the JAX function's type promotion does."""
    vmin = vols.amin(dim=(1, 2, 3), keepdim=True)
    vrange = vols.amax(dim=(1, 2, 3), keepdim=True) - vmin
    t = (vols - vmin) / (vrange + 1e-7)
    return t.float() ** _per_volume(gamma, vols) * vrange.float() + vmin.float()


def draw_noise(n: int, shape, cfg: AugmentConfig, generator: torch.Generator,
               field_generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """(std (n,), unit normal field (n, D, H, W) f32 on the field generator's
    device)."""
    std = _uniform((n,), 0.0, cfg.noise_std, generator)
    field = torch.randn((n, *shape), generator=field_generator,
                        device=field_generator.device)
    return std, field


def apply_noise(vols: torch.Tensor, std: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    return vols.float() + _per_volume(std, vols) * field.to(vols.device)


def smooth_radius(cfg: AugmentConfig) -> int:
    return int(4 * max(cfg.sigma_x[1], cfg.sigma_yz[1]) + 0.5)


def gaussian_kernel(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """MONAI's erf-form discrete Gaussian per row of sigma (n,):
    0.5·(erf((x+.5)/σ√2) − erf((x−.5)/σ√2)), clamped ≥ 0 and normalised."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    s = sigma.float()[:, None] * float(np.sqrt(np.float32(2.0)))
    k = 0.5 * (torch.erf((x + 0.5) / s) - torch.erf((x - 0.5) / s))
    k = torch.clamp(k, min=0.0)
    return k / k.sum(dim=-1, keepdim=True)


def draw_smooth(n: int, cfg: AugmentConfig, generator: torch.Generator) -> torch.Tensor:
    """(n, 3) sigmas: axis 0 from sigma_x, axes 1 and 2 from sigma_yz."""
    return torch.stack([_uniform((n,), *cfg.sigma_x, generator),
                        _uniform((n,), *cfg.sigma_yz, generator),
                        _uniform((n,), *cfg.sigma_yz, generator)], dim=-1)


def apply_smooth(vols: torch.Tensor, sigmas: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable Gaussian smoothing with zero padding, one banded (S, S)
    contraction per axis: band[i, j] = k[j − i + radius]; the band is cast to
    the volumes' dtype and each pass rounds once to it."""
    out = vols
    subs = ("vij,vjhw->vihw", "vij,vdjw->vdiw", "vij,vdhj->vdhi")
    sigmas = to_device(sigmas, vols.device)
    for axis in range(3):
        kern = gaussian_kernel(sigmas[:, axis], radius)
        size = vols.shape[1 + axis]
        idx = torch.arange(size, device=vols.device)
        off = idx[None, :] - idx[:, None]                       # j − i
        taps = kern[:, torch.clamp(off + radius, 0, 2 * radius)]
        band = torch.where(off.abs() <= radius, taps, torch.zeros((), device=vols.device))
        out = torch.einsum(subs[axis], band.to(vols.dtype), out)
    return out


# --- coarse (hole-based) -----------------------------------------------------

def _clip_hole(hs, shape) -> tuple[int, int, int]:
    return tuple(min(h, s) for h, s in zip(hs, shape))


def draw_holes(n: int, holes: int, size, shape, generator: torch.Generator) -> torch.Tensor:
    """(n, holes, 3) hole corners, uniform over the valid positions."""
    hs = _clip_hole(size, shape)
    return torch.stack([torch.randint(0, max(s - h, 0) + 1, (n, holes), generator=generator)
                        for s, h in zip(shape, hs)], dim=-1)


def _hole_index(corners: torch.Tensor, hs, device):
    """Advanced-index tuple selecting one (h0, h1, h2) hole per volume."""
    c = to_device(corners, device)
    v = torch.arange(c.shape[0], device=device)[:, None, None, None]
    r = [c[:, d, None] + torch.arange(hs[d], device=device) for d in range(3)]
    return v, r[0][:, :, None, None], r[1][:, None, :, None], r[2][:, None, None, :]


def draw_shuffle(n: int, cfg: AugmentConfig, shape, generator: torch.Generator,
                 field_generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """(corners (n, holes, 3), permutations (n, holes, hole voxels) on the
    field generator's device)."""
    hs = _clip_hole(cfg.shuffle_size, shape)
    corners = draw_holes(n, cfg.shuffle_holes, cfg.shuffle_size, shape, generator)
    keys = torch.rand((n, cfg.shuffle_holes, hs[0] * hs[1] * hs[2]),
                      generator=field_generator, device=field_generator.device)
    return corners, torch.argsort(keys, dim=-1)


def apply_shuffle(vols: torch.Tensor, corners: torch.Tensor, perms: torch.Tensor,
                  size) -> torch.Tensor:
    """Permute the voxels of each hole, holes in order: the flattened hole
    becomes flat[perm] (JAX sorts by random keys: perm = their stable argsort)."""
    hs = _clip_hole(size, vols.shape[1:])
    out = vols.clone()
    perms = perms.to(vols.device)
    for i in range(corners.shape[1]):
        index = _hole_index(corners[:, i], hs, vols.device)
        block = out[index].reshape(vols.shape[0], -1)
        out[index] = block.gather(1, perms[:, i]).reshape(vols.shape[0], *hs)
    return out


def draw_coarse_dropout(n: int, cfg: AugmentConfig, shape,
                        generator: torch.Generator) -> torch.Tensor:
    return draw_holes(n, cfg.dropout_holes, cfg.dropout_size, shape, generator)


def apply_coarse_dropout(vols: torch.Tensor, corners: torch.Tensor, size,
                         fill: float) -> torch.Tensor:
    hs = _clip_hole(size, vols.shape[1:])
    out = vols.clone()
    for i in range(corners.shape[1]):
        out[_hole_index(corners[:, i], hs, vols.device)] = fill
    return out


# --- pipeline ------------------------------------------------------------------

def _steps(cfg: AugmentConfig, shape):
    """(name, prob, run) in reference order; run(vols, host_gen, field_gen)
    draws the parameters for len(vols) volumes and applies the transform.
    The affine's backend follows ``cfg.affine_backend`` (JAX ``_steps``,
    :499-503)."""
    radius = smooth_radius(cfg)

    def n(v):
        return v.shape[0]

    def affine(v, g, fg):
        m = draw_affine(n(v), cfg, g)
        return apply_affine(v, m, cfg) if cfg.affine_backend == "lu" else apply_affine_exact(v, m)

    return [
        ("flip", cfg.flip_prob, lambda v, g, fg: apply_flip(v)),
        ("rot90", cfg.rot90_prob, lambda v, g, fg: apply_rot90(v)),
        ("affine", cfg.affine_prob, affine),
        ("contrast", cfg.contrast_prob,
         lambda v, g, fg: apply_contrast(v, draw_contrast(n(v), cfg, g))),
        ("noise", cfg.noise_prob,
         lambda v, g, fg: apply_noise(v, *draw_noise(n(v), shape, cfg, g, fg))),
        ("smooth", cfg.smooth_prob,
         lambda v, g, fg: apply_smooth(v, draw_smooth(n(v), cfg, g), radius)),
        ("shuffle", cfg.shuffle_prob,
         lambda v, g, fg: apply_shuffle(v, *draw_shuffle(n(v), cfg, shape, g, fg),
                                        cfg.shuffle_size)),
        ("coarse_dropout", cfg.dropout_prob,
         lambda v, g, fg: apply_coarse_dropout(v, draw_coarse_dropout(n(v), cfg, shape, g),
                                               cfg.dropout_size, cfg.dropout_fill)),
        ("zoom", cfg.zoom_prob, lambda v, g, fg: apply_zoom(v, draw_zoom(n(v), cfg, g))),
    ]


def augment_batch(imgs: torch.Tensor, generator: torch.Generator,
                  cfg: AugmentConfig = AugmentConfig(),
                  applied: dict | None = None) -> torch.Tensor:
    """Augment a (B, M, C, D, H, W) batch, independently per (batch, modality,
    channel) volume; returns a new tensor of the same shape and dtype.

    ``generator`` is a CPU generator: it draws every gate, scalar parameter
    and hole corner, and seeds the generator on the volumes' device that
    draws the noise field and shuffle permutations, so one seed fixes the
    whole result.  If ``applied`` is given, it receives for each transform
    the number of volumes that drew it."""
    if generator.device.type != "cpu":
        raise ValueError("augment_batch draws its gates on the host: pass a CPU generator")
    B, M, C, D, H, W = imgs.shape
    if cfg.rot90_prob > 0 and D != H:
        raise ValueError(f"RandRotate90 on axes (0,1) needs D == H (got {(D, H, W)})")
    flat = imgs.reshape(B * M * C, D, H, W).clone()
    field_gen = torch.Generator(device=imgs.device)
    field_gen.manual_seed(int(torch.randint(0, 2 ** 62, (), generator=generator)))
    for name, prob, run in _steps(cfg, (D, H, W)):
        if prob <= 0:
            continue
        sel = torch.nonzero(torch.rand(flat.shape[0], generator=generator) < prob).flatten()
        if applied is not None:
            applied[name] = int(sel.numel())
        if sel.numel():
            sel = to_device(sel, flat.device)
            flat[sel] = run(flat[sel], generator, field_gen).to(flat.dtype)
    return flat.reshape(imgs.shape)
