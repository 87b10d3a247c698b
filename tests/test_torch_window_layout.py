"""Swin's window layout (``kernels/window_layout.py``) on the CPU: a plain
mirror of the index rule that the gathers of ``csrc/window_layout.cu``
compute, used with ``index_select``, against PyTorch's chain (pad, roll,
partition; reverse, roll back, crop) bit for bit; ``window_pack`` and
``window_unpack`` differentiated against autograd through the chain;
each the other's adjoint in float64; their checks; and the benchmark's
reader of the layout's device time.  The geometries are Swin UNETR's four
stages at 128³ (64³ to 8³ tokens in 7³ windows), shifted and unshifted,
and a grid with clipped axes, at C = 48 and 96."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cross_attention_vit_tpu_torch.kernels import window_layout as wl
from cross_attention_vit_tpu_torch.ops.window_attention import geometry
from portbench import harness
from portbench.trace import Profile

WINDOW = (7, 7, 7)
GRIDS = {"stage1": (64, 64, 64), "stage2": (32, 32, 32), "stage3": (16, 16, 16),
         "stage4": (8, 8, 8), "clipped": (4, 9, 13)}
CASES = [pytest.param(dims, shifted, C, id=f"{name}-{'shifted' if shifted else 'unshifted'}-C{C}")
         for name, dims in GRIDS.items() for shifted in (False, True) for C in (48, 96)]


def _batch(dims) -> int:
    """Two samples, one at the first stage's grid (a 64³ × 96 sample in f64
    is 200 MB)."""
    return 1 if dims == GRIDS["stage1"] else 2


def _x(dims, C, dtype=torch.float32, seed=0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((_batch(dims), *dims, C), generator=g, dtype=dtype)


def _o(geom, dims, C, dtype=torch.float32, seed=1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((_batch(dims) * geom.windows, geom.n, C), generator=g, dtype=dtype)


def _coords(flat: torch.Tensor, extents) -> list[torch.Tensor]:
    """Row-major coordinates of ``flat`` over ``extents``."""
    out = []
    for e in reversed(extents):
        out.append(flat % e)
        flat = flat // e
    return out[::-1]


def pack_index(geom, dims, batch: int) -> torch.Tensor:
    """The pack's rule: for each token of the windows (B·windows·n), the row
    of x (B·d·h·w) it reads, or B·d·h·w, a zero row, for a padded token."""
    n, real = geom.n, int(np.prod(dims))
    b, gz, gy, gx, iz, iy, ix = _coords(torch.arange(batch * geom.windows * n),
                                        (batch, *geom.grid, *geom.window))
    q = [(g * w + i + s) % p for g, i, w, s, p in zip((gz, gy, gx), (iz, iy, ix), geom.window,
                                                       geom.shift, geom.padded)]
    live = (q[0] < dims[0]) & (q[1] < dims[1]) & (q[2] < dims[2])
    row = ((b * dims[0] + q[0]) * dims[1] + q[1]) * dims[2] + q[2]
    return torch.where(live, row, batch * real)


def unpack_index(geom, dims, batch: int) -> torch.Tensor:
    """The unpack's rule: for each real token (B·d·h·w), the row of the
    windows (B·windows·n) it reads."""
    b, *z = _coords(torch.arange(batch * int(np.prod(dims))), (batch, *dims))
    p = [(za - s) % P for za, s, P in zip(z, geom.shift, geom.padded)]
    g = [pa // w for pa, w in zip(p, geom.window)]
    i = [pa % w for pa, w in zip(p, geom.window)]
    row = ((b * geom.grid[0] + g[0]) * geom.grid[1] + g[1]) * geom.grid[2] + g[2]
    return row * geom.n + (i[0] * geom.window[1] + i[1]) * geom.window[2] + i[2]


def _mirror_pack(x: torch.Tensor, geom) -> torch.Tensor:
    B, C = x.shape[0], x.shape[-1]
    rows = torch.cat([x.reshape(-1, C), x.new_zeros(1, C)])
    return rows.index_select(0, pack_index(geom, x.shape[1:4], B)).view(-1, geom.n, C)


def _mirror_unpack(o: torch.Tensor, geom, dims) -> torch.Tensor:
    B, C = o.shape[0] // geom.windows, o.shape[-1]
    return o.reshape(-1, C).index_select(0, unpack_index(geom, dims, B)).view(B, *dims, C)


@pytest.mark.parametrize("dims, shifted, C", CASES)
def test_the_index_rule_is_pytorchs_chain_bit_for_bit(dims, shifted, C):
    geom = geometry(dims, WINDOW, shifted)
    x, o = _x(dims, C), _o(geom, dims, C)
    packed = wl.window_pack_reference(x, geom)
    assert packed.shape == (_batch(dims) * geom.windows, geom.n, C)
    assert torch.equal(_mirror_pack(x, geom), packed)
    assert torch.equal(_mirror_unpack(o, geom, dims), wl.window_unpack_reference(o, geom, dims))
    assert torch.equal(wl.window_pack(x, geom), packed)
    assert torch.equal(wl.window_unpack(o, geom, dims), _mirror_unpack(o, geom, dims))


@pytest.mark.parametrize("dims, shifted, C", CASES)
def test_the_gradients_are_autograds_through_the_chain(dims, shifted, C):
    geom = geometry(dims, WINDOW, shifted)
    x, o = _x(dims, C).requires_grad_(), _o(geom, dims, C).requires_grad_()
    dy, dz = torch.randn_like(_o(geom, dims, C)), torch.randn_like(_x(dims, C))
    grads = []
    for pack, unpack in ((wl.window_pack, wl.window_unpack),
                         (wl.window_pack_reference, wl.window_unpack_reference)):
        grads.append(torch.autograd.grad([pack(x, geom), unpack(o, geom, dims)], [x, o],
                                         [dy, dz]))
    (gx, go), (want_gx, want_go) = grads
    assert torch.equal(gx, want_gx) and torch.equal(go, want_go)


@pytest.mark.parametrize("dims, shifted, C", CASES)
def test_pack_and_unpack_are_adjoint(dims, shifted, C):
    """⟨pack(x), y⟩ = ⟨x, unpack(y)⟩ in float64: each sum adds the same
    products, in other orders."""
    geom = geometry(dims, WINDOW, shifted)
    x, y = _x(dims, C, torch.float64), _o(geom, dims, C, torch.float64)
    lhs = float((wl.window_pack(x, geom) * y).sum())
    rhs = float((x * wl.window_unpack(y, geom, dims)).sum())
    assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-9)


def test_the_wrappers_check_their_operands():
    geom = geometry((10, 9, 6), WINDOW, True)
    x = torch.zeros(2, 10, 9, 6, 8)
    with pytest.raises(ValueError, match="5 axes"):
        wl.window_pack(x[0], geom)
    with pytest.raises(ValueError, match="contiguous"):
        wl.window_pack(x.transpose(1, 2), geom)
    with pytest.raises(ValueError, match="does not fill"):
        wl.window_pack(torch.zeros(2, 20, 9, 6, 8), geom)
    o = wl.window_pack(x, geom)
    with pytest.raises(ValueError, match="3 axes"):
        wl.window_unpack(o[None], geom, (10, 9, 6))
    with pytest.raises(ValueError, match=r"B·4, 294"):
        wl.window_unpack(o[1:], geom, (10, 9, 6))
    with pytest.raises(ValueError, match="does not fill"):
        wl.window_unpack(o, geom, (6, 9, 6))


# --- the benchmark's reader -----------------------------------------------------

class _Ctx:
    def __init__(self, names, durations):
        starts = np.cumsum([0.0] + list(durations[:-1]))
        self.profile = Profile(steps=3, wall_s=1.0, names=list(names), starts=starts,
                               ends=starts + np.array(durations))


def test_the_layout_reader_reads_the_roll_and_the_gathers():
    reader = harness.reader("window_layout_ms.train")
    parent = _Ctx(["void at::native::roll_cuda_kernel<c10::BFloat16>(...)",
                   "void at::native::elementwise_kernel<128, 4, direct_copy>", "nvjet_gemm"],
                  [0.060, 0.075, 0.010])
    assert reader.read(parent) == pytest.approx(1e3 * 0.060 / 3)
    change = _Ctx(["void (anonymous namespace)::window_layout_pack_kernel<uint4>(...)",
                   "void (anonymous namespace)::window_layout_unpack_kernel<uint4>(...)",
                   "nvjet_gemm"], [0.006, 0.005, 0.010])
    assert reader.read(change) == pytest.approx(1e3 * 0.011 / 3)
    assert reader.read(_Ctx(["nvjet_gemm"], [0.010])) is None
