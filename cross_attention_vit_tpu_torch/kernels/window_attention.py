"""Shifted-window attention with a learned relative-position bias (K9),
forward and backward: Swin UNETR's ``WindowAttention`` (MONAI
``monai.networks.nets.swin_unetr``) on the windows of one block.

No TPU kernel corresponds: the JAX package has no windowed model.  K1/K2
(``flash_attention.py``) take neither a bias nor a mask and are tiled for
D = 64 at N ∈ {513, 1025}; Swin attends over 7³ = 343 tokens at D = 16.

For a window w, a head h and the window's n tokens, with qkv the output of
the block's qkv Linear (BW, n, 3, K, D) and ``table`` its (T, K) f32 bias
table (T = ∏(2·W − 1) rows for the configured window W, 13³ = 2197):

    s   = q·kᵀ·scale + table[index(i, j), h] (+ mask_w(i, j))     f32
    lse = logsumexp_j s;   o = softmax(s)·v                         o in qkv's dtype

``index`` is MONAI's relative index built for the configured window and
cut to ``[:n, :n]``: code_i − code_j + c0, with code_t a token's place in
the configured window (``token_codes``); ``mask`` is MONAI's
``compute_mask``: −100 where two tokens of a shifted window came from
different regions of the cyclically rolled volume, else 0.  The kernels
(``csrc/window_attention.cu``, CUDA C++ built by ``_build`` at first call)
read each token's code and region and gather the bias from the head's
column of the table in shared memory: no (n, n) bias and no (nW, n, n)
mask is ever stored.  The backward gives dq, dk and dv in one (BW, n, 3,
K, D) tensor, and the table's f32 gradient: dS summed over the batch and
every window in a fixed order (per-group partial planes, then for each
table row its (i, j) pairs over the groups, a warp's lanes meeting in a
fixed tree), with no atomics, so two calls give the same bits.  The kernels take bf16 at D = 16 (Swin UNETR's
every stage).

Bound: a window-head reads q, k and v and writes o, 4·n·D values, for
4·n²·D operations: n/2 = 171 FLOP a byte at bf16, under the card's 295, so
the roofline is the bytes.  The exponentials bind first: n² = 117,649 a
window-head at about 3.9·10¹² a second against 44 KB at 3.35 TB/s, so the
kernels reach at most about 40% of the roofline.  The forward, the dq
pass (which also writes each row's Σ do·o) and the dk/dv pass each give
one block to a window-head, with its operands in shared memory and the
scores in registers (mma.sync, online softmax in the forward); the bias
pass sums dS over groups of windows into partial planes (64 × 64 tiles,
the windows' operands on a cp.async ring), which a last small kernel adds
row by row of the table.

``window_attention_fwd`` and ``window_attention_bwd`` are the wrappers: on
a CUDA tensor each launches the kernels, on a CPU tensor each runs its
plain PyTorch version (``window_attention_reference``,
``window_attention_backward_reference``), which rounds where the kernels
round.  ``window_attention_fwd.launches`` and
``window_attention_bwd.launches`` count calls.  ``WindowAttention`` is the
autograd function over the two.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import _build

# the kernels' head size
HEAD_DIM = 16
# the bias pass's tile (query rows, keys), as csrc/window_attention.cu has it
BIAS_ROWS, BIAS_COLS = 64, 64
# blocks the bias pass aims at: windows are split into groups so that
# (heads × tiles × groups) reaches about this many
_BIAS_PROGRAMS = 2048
MASK_VALUE = -100.0
_LIB = _build.Library("window_attention", "window_attention_error_string", {
    # qkv, table, codes, regions, o, lse, BW, n, K, T, windows, c0, scale
    "window_attention_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_float],
    # qkv, table, codes, regions, o, do, lse, delta, dqkv, part, pairs, dtable,
    # BW, n, K, T, windows, c0, scale, per_group, nb, slots
    "window_attention_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_float] + [ctypes.c_int] * 3})


@dataclass(frozen=True)
class WindowGeometry:
    """Where a block's windows lie.  ``window``: the window's extent on each
    axis (MONAI's ``get_window_size``: an axis no longer than the configured
    window is one window); ``grid``: windows on each axis of the padded
    volume; ``shift``: the cyclic shift (all 0 for an unshifted block);
    ``index_window``: the configured window, which MONAI's relative index
    and the bias table are built for."""
    window: tuple[int, int, int]
    grid: tuple[int, int, int]
    shift: tuple[int, int, int]
    index_window: tuple[int, int, int]

    @property
    def n(self) -> int:
        return math.prod(self.window)

    @property
    def windows(self) -> int:
        """Windows in one sample."""
        return math.prod(self.grid)

    @property
    def padded(self) -> tuple[int, int, int]:
        return tuple(g * w for g, w in zip(self.grid, self.window))

    @property
    def shifted(self) -> bool:
        return any(self.shift)

    @property
    def table_rows(self) -> int:
        return math.prod(2 * w - 1 for w in self.index_window)

    def codes(self) -> tuple[int, int, int]:
        """(E0, E1, C0): a token's index code is its (a, b, c) place in the
        configured window as a·E0 + b·E1 + c, and index(i, j) = code_i −
        code_j + C0."""
        W0, W1, W2 = self.index_window
        e0, e1 = (2 * W1 - 1) * (2 * W2 - 1), 2 * W2 - 1
        return e0, e1, (W0 - 1) * e0 + (W1 - 1) * e1 + (W2 - 1)


def token_codes(geom: WindowGeometry) -> torch.Tensor:
    """(n,) int64: each token's index code (``WindowGeometry.codes``)."""
    W1, W2 = geom.index_window[1:]
    e0, e1, _ = geom.codes()
    t = torch.arange(geom.n)
    return (t // (W1 * W2)) * e0 + ((t // W2) % W1) * e1 + t % W2


def relative_index(geom: WindowGeometry) -> torch.Tensor:
    """(n, n) int64: MONAI's ``relative_position_index`` for the configured
    window, cut to the block's n tokens."""
    code = token_codes(geom)
    return code[:, None] - code[None, :] + geom.codes()[2]


def region_ids(geom: WindowGeometry) -> torch.Tensor:
    """(windows, n) int64: the region of the rolled volume each token of
    each window came from (MONAI ``compute_mask``'s labels up to
    renumbering: on a shifted axis [0, L − w), [L − w, L − s), [L − s, L);
    an unshifted axis is one region)."""
    coords = []
    for axis in range(3):
        g, w, s, L = geom.grid[axis], geom.window[axis], geom.shift[axis], geom.padded[axis]
        pos = (torch.arange(g)[:, None] * w + torch.arange(w)[None, :]).flatten()   # (L,)
        coords.append((pos >= L - w).long() + (pos >= L - s).long() if s else pos * 0)
    rd, rh, rw = coords
    volume = rd[:, None, None] * 9 + rh[None, :, None] * 3 + rw[None, None, :]
    (gd, gh, gw), (w0, w1, w2) = geom.grid, geom.window
    volume = volume.view(gd, w0, gh, w1, gw, w2).permute(0, 2, 4, 1, 3, 5)
    return volume.reshape(geom.windows, geom.n)


def window_mask(geom: WindowGeometry) -> torch.Tensor | None:
    """(windows, n, n) f32: −100 between tokens of different regions, 0
    within one; None for an unshifted block."""
    if not geom.shifted:
        return None
    r = region_ids(geom)
    return torch.where(r[:, :, None] == r[:, None, :], 0.0, MASK_VALUE)


def _split(qkv: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(BW, n, 3, K, D) → q, k, v (BW, K, n, D), f32."""
    q, k, v = qkv.float().unbind(2)
    return tuple(t.transpose(1, 2) for t in (q, k, v))


def _scores(q: torch.Tensor, k: torch.Tensor, table: torch.Tensor, geom: WindowGeometry,
            scale: float) -> torch.Tensor:
    """s (BW, K, n, n) f32: the products, the gathered bias and the mask."""
    n = geom.n
    bias = table.float()[relative_index(geom).to(table.device).flatten()]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + bias.view(n, n, -1).permute(2, 0, 1)
    mask = window_mask(geom)
    if mask is not None:
        BW, K = s.shape[:2]
        s = (s.view(BW // geom.windows, geom.windows, K, n, n)
             + mask.to(s.device)[None, :, None]).view(BW, K, n, n)
    return s


def window_attention_reference(qkv: torch.Tensor, table: torch.Tensor, geom: WindowGeometry,
                               scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (o (BW, n, K·D) in qkv's dtype,
    lse (BW, K, n) f32).  The probabilities are rounded to qkv's dtype before
    the product with v, as the kernel rounds them."""
    BW, n, _, K, D = qkv.shape
    q, k, v = _split(qkv)
    s = _scores(q, k, table, geom, scale)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None]).to(qkv.dtype).float()
    o = torch.matmul(p, v).to(qkv.dtype)
    return o.transpose(1, 2).reshape(BW, n, K * D), lse


def window_attention_backward_reference(qkv: torch.Tensor, table: torch.Tensor,
                                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                                        geom: WindowGeometry,
                                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dqkv (BW, n, 3, K, D) in
    qkv's dtype, dtable (T, K) f32).  P and dS are rounded to qkv's dtype
    before their products, as the kernels round them; the table's gradient
    is the f32 dS summed over the windows and scattered to the table rows."""
    BW, n, _, K, D = qkv.shape
    dtype = qkv.dtype
    q, k, v = _split(qkv)
    go = do.float().view(BW, n, K, D).transpose(1, 2)
    delta = (go * o.float().view(BW, n, K, D).transpose(1, 2)).sum(-1)
    p = torch.exp(_scores(q, k, table, geom, scale) - lse[..., None])
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), go)
    ds = p * (torch.matmul(go, v.transpose(-1, -2)) - delta[..., None])
    ds_lowp = ds.to(dtype).float()
    dq = torch.matmul(ds_lowp, k) * scale
    dk = torch.matmul(ds_lowp.transpose(-1, -2), q) * scale
    dqkv = torch.stack([t.transpose(1, 2) for t in (dq, dk, dv)], 2).to(dtype)
    dtable = torch.zeros(geom.table_rows, K, dtype=torch.float32, device=qkv.device)
    dtable.index_add_(0, relative_index(geom).to(qkv.device).flatten(),
                      ds.sum(0).reshape(K, n * n).t())
    return dqkv, dtable


# --- the kernels ------------------------------------------------------------------

@lru_cache(maxsize=None)
def _codes(geom: WindowGeometry, device: str) -> torch.Tensor:
    return token_codes(geom).to(torch.int32).to(device)


@lru_cache(maxsize=None)
def _regions(geom: WindowGeometry, device: str) -> torch.Tensor:
    """Each window's token regions, (windows, n) int32."""
    return region_ids(geom).to(torch.int32).to(device)


@lru_cache(maxsize=None)
def _pairs_host(geom: WindowGeometry, nb: int) -> np.ndarray:
    """(slots, T) int32: column r lists the flat places i·nb + j of the
    (i, j) pairs whose relative index is r, in row-major order, then −1."""
    n = geom.n
    idx = relative_index(geom).numpy().ravel()
    order = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=geom.table_rows)
    out = np.full((int(counts.max()), geom.table_rows), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(order.size) - np.repeat(starts, counts)
    i, j = np.divmod(order, n)
    out[slot, idx[order]] = (i * nb + j).astype(np.int32)
    return out


@lru_cache(maxsize=None)
def _pairs(geom: WindowGeometry, nb: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_pairs_host(geom, nb)).to(device)


def _check(qkv: torch.Tensor, table: torch.Tensor, geom: WindowGeometry) -> None:
    if qkv.dim() != 5 or qkv.shape[1] != geom.n or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (BW, {geom.n}, 3, K, D), got {tuple(qkv.shape)}")
    if qkv.shape[0] % geom.windows:
        raise ValueError(f"{qkv.shape[0]} windows is not a whole number of samples of "
                         f"{geom.windows}")
    if table.shape != (geom.table_rows, qkv.shape[3]) or table.dtype != torch.float32:
        raise ValueError(f"the bias table must be float32 ({geom.table_rows}, {qkv.shape[3]}), "
                         f"got {tuple(table.shape)} {table.dtype}")


def _check_card(qkv: torch.Tensor) -> None:
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"the window-attention kernels take bfloat16, not {qkv.dtype}")
    if qkv.shape[-1] != HEAD_DIM:
        raise ValueError(f"the window-attention kernels take a head size of {HEAD_DIM}, "
                         f"got {qkv.shape[-1]}")


def _geometry_args(geom: WindowGeometry, device: torch.device) -> tuple:
    """codes, regions (None unshifted), T, windows, c0 as the library takes them."""
    regions = _regions(geom, str(device)).data_ptr() if geom.shifted else None
    return (_codes(geom, str(device)).data_ptr(), regions, geom.table_rows, geom.windows,
            geom.codes()[2])


def window_attention_fwd(qkv: torch.Tensor, table: torch.Tensor, geom: WindowGeometry,
                         scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """qkv (BW, n, 3, K, D), the block's (T, K) f32 bias table.  Returns (o
    (BW, n, K·D) in qkv's dtype, lse (BW, K, n) f32)."""
    _check(qkv, table, geom)
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, table, geom, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"window attention runs on cuda or cpu tensors, got {qkv.device}")
    _check_card(qkv)
    qkv, table = qkv.contiguous(), table.contiguous()
    BW, n, _, K, D = qkv.shape
    o = torch.empty((BW, n, K * D), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((BW, K, n), dtype=torch.float32, device=qkv.device)
    codes, regions, T, windows, c0 = _geometry_args(geom, qkv.device)
    _LIB.launch("window_attention_fwd", qkv.device,
                qkv.data_ptr(), table.data_ptr(), codes, regions, o.data_ptr(), lse.data_ptr(),
                BW, n, K, T, windows, c0, scale)
    window_attention_fwd.launches += 1
    return o, lse


def window_attention_bwd(qkv: torch.Tensor, table: torch.Tensor, o: torch.Tensor,
                         do: torch.Tensor, lse: torch.Tensor, geom: WindowGeometry,
                         scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The cotangent do (BW, n, K·D) of ``window_attention_fwd``'s o, with
    its o and lse.  Returns (dqkv (BW, n, 3, K, D) in qkv's dtype, dtable
    (T, K) f32)."""
    _check(qkv, table, geom)
    if qkv.device.type == "cpu":
        return window_attention_backward_reference(qkv, table, o, do, lse, geom, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"window attention runs on cuda or cpu tensors, got {qkv.device}")
    _check_card(qkv)
    qkv, table, o, lse = qkv.contiguous(), table.contiguous(), o.contiguous(), lse.contiguous()
    do = do.to(qkv.dtype).contiguous()
    BW, n, _, K, D = qkv.shape
    nb = _cdiv(n, BIAS_COLS) * BIAS_COLS
    tiles = (nb // BIAS_ROWS) * (nb // BIAS_COLS)
    per_group = _cdiv(BW, max(1, _BIAS_PROGRAMS // (K * tiles)))
    groups = _cdiv(BW, per_group)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((BW, K, n), dtype=torch.float32, device=qkv.device)
    part = torch.empty((groups, K, nb, nb), dtype=torch.float32, device=qkv.device)
    dtable = torch.empty((geom.table_rows, K), dtype=torch.float32, device=qkv.device)
    pairs = _pairs(geom, nb, str(qkv.device))
    codes, regions, T, windows, c0 = _geometry_args(geom, qkv.device)
    _LIB.launch("window_attention_bwd", qkv.device,
                qkv.data_ptr(), table.data_ptr(), codes, regions, o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), part.data_ptr(),
                pairs.data_ptr(), dtable.data_ptr(), BW, n, K, T, windows, c0, scale, per_group,
                nb, pairs.shape[0])
    window_attention_bwd.launches += 1
    return dqkv, dtable


window_attention_fwd.launches = 0
window_attention_bwd.launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class WindowAttention(torch.autograd.Function):
    """o = window attention of qkv (BW, n, 3, K, D) with the block's bias
    table, through ``window_attention_fwd`` and ``window_attention_bwd``."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, table: torch.Tensor, geom: WindowGeometry,
                scale: float) -> torch.Tensor:
        o, lse = window_attention_fwd(qkv, table, geom, scale)
        ctx.save_for_backward(qkv, table, o, lse)
        ctx.geom, ctx.scale = geom, scale
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qkv, table, o, lse = ctx.saved_tensors
        dqkv, dtable = window_attention_bwd(qkv, table, o, do, lse, ctx.geom, ctx.scale)
        return dqkv, dtable, None, None
