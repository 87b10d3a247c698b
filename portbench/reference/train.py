"""The training step in plain float32 PyTorch: augmentation, forward,
cross-entropy, backward and Adam, from the inputs and generators the
benchmark hands the program.

The model is a family's ``logits`` (``reference/families/<family>.py``).
One step on a data coordinate's rows: ``augment`` draws from the step's
host generator; then one seed (an integer below 2^62) from the same
generator seeds the dropout generator on the device; the forward draws its
keep masks from it site by site at the coordinate's batch shape (``Masks``);
the loss is the mean cross-entropy over the coordinate's rows.  Over several
data coordinates the gradients are averaged.  Adam (torch.optim.Adam's
update, L2 weight decay added to the gradient, β = (0.9, 0.999), ε = 1e-8)
steps the float32 weights.

The rows go through the forward and backward a block at a time, so the
float32 activations of a full batch need not fit at once; the masks are
drawn whole at the first block and sliced for the others.

TF32 is switched off while the reference runs: its float32 products are
float32.  ``fp8`` is the control: every product's operands rounded to
float8 e4m3 with one scale a tensor (its largest magnitude at 448).
"""

from __future__ import annotations

import contextlib

import torch

from . import augment as ref_augment
from . import model as ref_model

B1, B2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def float32_products():
    """TF32 off for matmuls and convolutions, restored after."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale; the gradient passes
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def mask_bits(keep: float) -> int | None:
    """Random bits a keep mask draws per element: 8 where keep·256 is an
    integer, else 16; None (a uniform float against keep) where the 16-bit
    threshold would round up to 2^16."""
    bits = 8 if keep * 256 == int(keep * 256) else 16
    return bits if round(keep * (1 << bits)) < (1 << bits) else None


class Masks:
    """Keep masks in the order a forward asks for them, drawn at the full
    batch's shapes from ``gen`` by the first block of rows and sliced to the
    rows of each block."""

    def __init__(self, gen: torch.Generator | None, rate: float, batch: int):
        self.gen, self.keep, self.batch = gen, 1.0 - rate, batch
        self.drawn: list[torch.Tensor] = []
        self.i, self.rows = 0, slice(0, batch)

    def start(self, rows: slice) -> None:
        self.i, self.rows = 0, rows

    def _draw(self, shape) -> torch.Tensor:
        bits = mask_bits(self.keep)
        dev = self.gen.device
        if bits is None:
            return torch.rand(shape, generator=self.gen, device=dev) < self.keep
        dtype = torch.uint8 if bits == 8 else torch.int32
        r = torch.randint(0, 1 << bits, shape, generator=self.gen, device=dev, dtype=dtype)
        return r < round(self.keep * (1 << bits))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.keep == 1.0:
            return x
        if self.i == len(self.drawn):
            self.drawn.append(self._draw((self.batch,) + tuple(x.shape[1:])))
        m = self.drawn[self.i][self.rows].to(x.device)
        self.i += 1
        return torch.where(m, x / self.keep, torch.zeros((), device=x.device))


def coordinate_grads(logits, w: dict, cfg: dict, img: torch.Tensor, labels: torch.Tensor,
                     host_gen: torch.Generator, augment: bool, rows_per_block: int,
                     control: bool = False) -> float:
    """One data coordinate's step: its loss, and its gradients added into
    each weight's ``.grad``."""
    dev = img.device
    img = img.float()
    if augment:
        img = ref_augment.augment(img, host_gen)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(torch.randint(0, 2 ** 62, (), generator=host_gen)))
    B = img.shape[0]
    masks = Masks(gen, float(cfg.get("dropout", 0.0)), B)
    q = fp8 if control else ref_model._ident
    loss_sum = 0.0
    for a in range(0, B, rows_per_block):
        rows = slice(a, min(B, a + rows_per_block))
        masks.start(rows)
        out = logits(w, cfg, img[rows], masks, q)
        loss = torch.nn.functional.cross_entropy(
            out, labels[rows].long(), reduction="sum",
            label_smoothing=float(cfg.get("label_smoothing", 0.0))) / B
        loss.backward()
        loss_sum += float(loss.detach())
    return loss_sum


class Adam:
    """torch.optim.Adam's update on float32 weights."""

    def __init__(self, weights: dict, lr: float, weight_decay: float):
        self.w, self.lr, self.wd, self.t = weights, lr, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.v = {k: torch.zeros_like(v) for k, v in weights.items()}

    @torch.no_grad()
    def step(self, keep: bool = False) -> dict:
        """Update every weight from its ``.grad``; returns each gradient as
        the update took it (weight decay added): a host copy with ``keep``,
        else its norm."""
        self.t += 1
        taken = {}
        for k, p in self.w.items():
            g = p.grad + self.wd * p
            taken[k] = g.cpu() if keep else float(g.norm())
            self.m[k].mul_(B1).add_(g, alpha=1 - B1)
            self.v[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            mhat = self.m[k] / (1 - B1 ** self.t)
            vhat = self.v[k] / (1 - B2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + EPS))
            p.grad = None
        return taken


def run_steps(logits, cfg: dict, weights: dict, batches, augment: bool, lr: float,
              rows_per_block: int, control: bool = False) -> dict:
    """Train a float32 copy of ``weights`` through the steps of
    ``batches``: one entry per step, a list over data coordinates of (img,
    labels, host generator).  Returns each step's loss (the mean over the
    coordinates), the first step's gradients as Adam took them (host
    copies) and their per-leaf norms, and the per-leaf norms of each
    weight's change over all the steps."""
    w = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in w.items()}
    opt = Adam(w, lr, float(cfg["weight_decay"]))
    losses, first = [], None
    with float32_products():
        for coords in batches:
            loss = 0.0
            for img, labels, gen in coords:
                loss += coordinate_grads(logits, w, cfg, img, labels, gen, augment,
                                         rows_per_block, control)
            for p in w.values():
                p.grad.div_(len(coords))
            taken = opt.step(keep=first is None)
            first = taken if first is None else first
            losses.append(loss / len(coords))
    with torch.no_grad():
        change = {k: float((w[k] - start[k]).norm()) for k in w}
    return {"losses": losses, "grads": first,
            "grad_norms": {k: float(g.norm()) for k, g in first.items()},
            "change_norms": change}
