"""The nine training transforms in plain float32 PyTorch, drawn from the
same generators as the training step draws them.

Semantics (the reference repository's MONAI list, in order; each volume
draws a gate per transform from the host generator, and the volumes that
drew it take the transform together, their parameters drawn in one call):

  1. flip of spatial axis 0, p 0.5
  2. rotation by 90 degrees in the plane of spatial axes (0, 1), p 0.2
  3. affine, p 0.2: rotations U(±0.1) about each axis and scales 1 + U(±0.1),
     sampling matrix m = Rx·Ry·Rz·diag(s), warped as four 1-D linear
     resamples (the Doolittle factors m = L·U: L along axis 1, the L and U
     rows of axis 2 in one pass, U along axis 1, U along axis 0), each
     about the volume's centre with the edge voxel repeated past the border
  4. contrast, p 0.3: ((x − min)/(range + 1e-7))^γ · range + min, γ U(0.7, 1.3)
  5. Gaussian noise, p 0.2: std U(0, 0.1) times a unit normal field
  6. Gaussian smoothing, p 0.2: separable erf-form kernels of radius 6,
     σ U(0.5, 1.5) on axis 0 and U(0.25, 1.5) on axes 1 and 2, zero padding
  7. coarse shuffle, p 0.2: 5 holes of 20³ whose voxels are permuted by
     the argsort of uniform keys
  8. coarse dropout, p 0.2: 3 holes of 15³ filled with −1
  9. zoom, p 0.2: isotropic U(0.9, 1.1) about the centre, keep size,
     linear, source coordinates clamped to the volume

Random draws: first one seed (an integer below 2^62) from the host
generator seeds a generator on the volumes' device, which draws the noise
fields and the shuffle keys; the host generator draws the gates and every
other parameter.  Everything is computed in float32 from the volumes given.
"""

from __future__ import annotations

import math

import torch

PROBS = (("flip", 0.5), ("rot90", 0.2), ("affine", 0.2), ("contrast", 0.3), ("noise", 0.2),
         ("smooth", 0.2), ("shuffle", 0.2), ("coarse_dropout", 0.2), ("zoom", 0.2))
SMOOTH_RADIUS = 6
SHUFFLE_HOLES, SHUFFLE_SIZE = 5, 20
DROP_HOLES, DROP_SIZE, DROP_FILL = 3, 15, -1.0


def _u(shape, low: float, high: float, gen: torch.Generator) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=gen)


def _rotation_scale(ang: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(n, 3, 3) = Rx·Ry·Rz·diag(scale) in float64."""
    ang, scale = ang.double(), scale.double()
    n = ang.shape[0]
    c, s = torch.cos(ang), torch.sin(ang)
    rx, ry, rz = (torch.eye(3, dtype=torch.float64).repeat(n, 1, 1) for _ in range(3))
    rx[:, 1, 1], rx[:, 1, 2], rx[:, 2, 1], rx[:, 2, 2] = c[:, 0], -s[:, 0], s[:, 0], c[:, 0]
    ry[:, 0, 0], ry[:, 0, 2], ry[:, 2, 0], ry[:, 2, 2] = c[:, 1], s[:, 1], -s[:, 1], c[:, 1]
    rz[:, 0, 0], rz[:, 0, 1], rz[:, 1, 0], rz[:, 1, 1] = c[:, 2], -s[:, 2], s[:, 2], c[:, 2]
    return rx @ ry @ rz @ torch.diag_embed(scale)


def _lu_passes(m: torch.Tensor) -> list[tuple[int, torch.Tensor]]:
    """(axis, coefficients (n, 3)) of the four passes: output voxel x of a
    pass reads its input along ``axis`` at centre + coefficients·(x − centre)."""
    l10, l20 = m[:, 1, 0] / m[:, 0, 0], m[:, 2, 0] / m[:, 0, 0]
    u11 = m[:, 1, 1] - l10 * m[:, 0, 1]
    u12 = m[:, 1, 2] - l10 * m[:, 0, 2]
    l21 = (m[:, 2, 1] - l20 * m[:, 0, 1]) / u11
    u22 = m[:, 2, 2] - l20 * m[:, 0, 2] - l21 * u12
    one, zero = torch.ones_like(l10), torch.zeros_like(l10)
    return [(1, torch.stack([l10, one, zero], -1)), (2, torch.stack([l20, l21, u22], -1)),
            (1, torch.stack([zero, u11, u12], -1)),
            (0, torch.stack([m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]], -1))]


def _resample_axis(vols: torch.Tensor, axis: int, coef: torch.Tensor) -> torch.Tensor:
    """Linear interpolation along ``axis`` at c_a + coef·(x − c); indices
    past either end fold back symmetrically (the edge voxel repeats)."""
    V, D, H, W = vols.shape
    dev = vols.device
    rel = [torch.arange(n, device=dev, dtype=torch.float64) - (n - 1) / 2.0 for n in (D, H, W)]
    coef = coef.to(dev, torch.float64)
    pos = (coef[:, 0, None, None, None] * rel[0][None, :, None, None]
           + coef[:, 1, None, None, None] * rel[1][None, None, :, None]
           + coef[:, 2, None, None, None] * rel[2][None, None, None, :]
           + ((D, H, W)[axis] - 1) / 2.0)
    lo = torch.floor(pos)
    t = (pos - lo).float()
    n = (D, H, W)[axis]

    def fold(i: torch.Tensor) -> torch.Tensor:
        i = torch.remainder(i, 2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)

    i0 = fold(lo.long())
    i1 = fold(lo.long() + 1)
    a = vols.float()
    return (1 - t) * torch.gather(a, 1 + axis, i0) + t * torch.gather(a, 1 + axis, i1)


def _affine(vols: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    n = vols.shape[0]
    ang = _u((n, 3), -0.1, 0.1, gen)
    scale = 1.0 + _u((n, 3), -0.1, 0.1, gen)
    out = vols
    for axis, coef in _lu_passes(_rotation_scale(ang, scale)):
        out = _resample_axis(out, axis, coef)
    return out


def _contrast(vols: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    gamma = _u((vols.shape[0],), 0.7, 1.3, gen).to(vols.device)[:, None, None, None]
    lo = vols.amin(dim=(1, 2, 3), keepdim=True)
    span = vols.amax(dim=(1, 2, 3), keepdim=True) - lo
    return ((vols - lo) / (span + 1e-7)) ** gamma * span + lo


def _noise(vols: torch.Tensor, gen: torch.Generator, field_gen: torch.Generator):
    std = _u((vols.shape[0],), 0.0, 0.1, gen).to(vols.device)[:, None, None, None]
    field = torch.randn(tuple(vols.shape), generator=field_gen, device=field_gen.device)
    return vols + std * field.to(vols.device)


def _kernel1d(sigma: torch.Tensor) -> torch.Tensor:
    """(n, 2r+1) erf-form discrete Gaussians, clamped at 0 and normalised."""
    x = torch.arange(-SMOOTH_RADIUS, SMOOTH_RADIUS + 1, dtype=torch.float64)
    s = sigma.double()[:, None] * math.sqrt(2.0)
    k = (0.5 * (torch.erf((x + 0.5) / s) - torch.erf((x - 0.5) / s))).clamp(min=0.0)
    return k / k.sum(-1, keepdim=True)


def _smooth(vols: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    n = vols.shape[0]
    sig = [_u((n,), 0.5, 1.5, gen), _u((n,), 0.25, 1.5, gen), _u((n,), 0.25, 1.5, gen)]
    out = vols
    r = SMOOTH_RADIUS
    for axis in range(3):
        k = _kernel1d(sig[axis]).float().to(vols.device)
        pad = [0] * 6
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = r     # F.pad lists the last dim first
        padded = torch.nn.functional.pad(out, pad)
        size = out.shape[1 + axis]
        acc = torch.zeros_like(out)
        for j in range(2 * r + 1):
            acc += k[:, j, None, None, None] * padded.narrow(1 + axis, j, size)
        out = acc
    return out


def _corners(n: int, holes: int, size: int, shape, gen: torch.Generator) -> torch.Tensor:
    """(n, holes, 3) corners, uniform over the positions where the hole fits."""
    return torch.stack([torch.randint(0, max(s - min(size, s), 0) + 1, (n, holes), generator=gen)
                        for s in shape], -1)


def _hole(c, size: int, shape):
    return tuple(slice(int(c[d]), int(c[d]) + min(size, shape[d])) for d in range(3))


def _shuffle(vols: torch.Tensor, gen: torch.Generator, field_gen: torch.Generator):
    n, shape = vols.shape[0], tuple(vols.shape[1:])
    corners = _corners(n, SHUFFLE_HOLES, SHUFFLE_SIZE, shape, gen)
    voxels = math.prod(min(SHUFFLE_SIZE, s) for s in shape)
    keys = torch.rand((n, SHUFFLE_HOLES, voxels), generator=field_gen, device=field_gen.device)
    perm = torch.argsort(keys, dim=-1).to(vols.device)
    out = vols.clone()
    for v in range(n):
        for h in range(SHUFFLE_HOLES):
            box = (v,) + _hole(corners[v, h], SHUFFLE_SIZE, shape)
            block = out[box]
            out[box] = block.reshape(-1)[perm[v, h]].reshape(block.shape)
    return out


def _coarse_dropout(vols: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    n, shape = vols.shape[0], tuple(vols.shape[1:])
    corners = _corners(n, DROP_HOLES, DROP_SIZE, shape, gen)
    out = vols.clone()
    for v in range(n):
        for h in range(DROP_HOLES):
            out[(v,) + _hole(corners[v, h], DROP_SIZE, shape)] = DROP_FILL
    return out


def _zoom_weights(size: int, z: torch.Tensor) -> torch.Tensor:
    """(n, size, size): output i reads c + (i − c)/z clamped to [0, size − 1]."""
    c = (size - 1) / 2.0
    src = ((torch.arange(size, dtype=torch.float64) - c) / z.double()[:, None] + c)
    src = src.clamp(0.0, size - 1.0)
    lo = torch.floor(src)
    t = src - lo
    lo = lo.long()
    hi = (lo + 1).clamp(max=size - 1)
    w = torch.zeros(z.shape[0], size, size, dtype=torch.float64)
    w.scatter_add_(2, lo[..., None], (1 - t)[..., None])
    w.scatter_add_(2, hi[..., None], t[..., None])
    return w.float()


def _zoom(vols: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    z = _u((vols.shape[0],), 0.9, 1.1, gen)
    _, D, H, W = vols.shape
    dev = vols.device
    out = torch.einsum("vab,vbhw->vahw", _zoom_weights(D, z).to(dev), vols)
    out = torch.einsum("vab,vdbw->vdaw", _zoom_weights(H, z).to(dev), out)
    return torch.einsum("vab,vdhb->vdha", _zoom_weights(W, z).to(dev), out)


def augment(imgs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """(B, M, C, D, H, W) float32 → the augmented batch, float32."""
    B, M, C, D, H, W = imgs.shape
    flat = imgs.float().reshape(B * M * C, D, H, W).clone()
    field_gen = torch.Generator(device=imgs.device)
    field_gen.manual_seed(int(torch.randint(0, 2 ** 62, (), generator=gen)))
    apply = {"flip": lambda v: v.flip(1),
             "rot90": lambda v: torch.rot90(v, 1, dims=(1, 2)),
             "affine": lambda v: _affine(v, gen),
             "contrast": lambda v: _contrast(v, gen),
             "noise": lambda v: _noise(v, gen, field_gen),
             "smooth": lambda v: _smooth(v, gen),
             "shuffle": lambda v: _shuffle(v, gen, field_gen),
             "coarse_dropout": lambda v: _coarse_dropout(v, gen),
             "zoom": lambda v: _zoom(v, gen)}
    for name, p in PROBS:
        sel = torch.nonzero(torch.rand(flat.shape[0], generator=gen) < p).flatten()
        if sel.numel():
            sel = sel.to(flat.device)
            flat[sel] = apply[name](flat[sel])
    return flat.reshape(imgs.shape)
