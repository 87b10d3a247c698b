"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the initial weights, a pool of batches and each step's
host generator.  The same seed gives the same inputs on every call.

Weights follow the reference repository's initialisation: Xavier-uniform
Linear weights, zero biases, LayerNorm weights one, the positional
embedding and the CLS token N(0, 0.02) (``weight_kind``; a model family's
reference may give its own rule).  They are made on the device in two
calls (one uniform, one normal buffer) and sliced into leaves by name and
shape.  Volumes are unit normal noise rounded to bfloat16, the dtype
the step augments in; labels are balanced 0/1 in a seeded order.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch


def sub_seed(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose, fixed by (seed, purpose)."""
    words = [seed % (1 << 64)] + [p if isinstance(p, int) else zlib.crc32(p.encode())
                                  for p in purpose]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def weight_kind(name: str, shape) -> str:
    """How a leaf starts: "xavier", "normal" (N(0, 0.02)), "ones" or "zeros"."""
    if name in ("pos_embedding", "cls_token"):
        return "normal"
    if len(shape) == 2:
        return "xavier"
    return "ones" if name.endswith(".weight") else "zeros"


def _xavier_bound(shape) -> float:
    """Xavier-uniform's bound, with fans as ``torch.nn.init`` counts them
    (a convolution's receptive field multiplies both)."""
    return math.sqrt(6.0 / ((shape[0] + shape[1]) * math.prod(shape[2:])))


def make_weights(shapes: dict, seed: int, device, kind=weight_kind) -> dict:
    """name → float32 leaf on ``device`` for every (name, shape) of
    ``shapes``, each started as ``kind(name, shape)`` says."""
    sizes = {"xavier": 0, "normal": 0}
    kinds = {name: kind(name, shape) for name, shape in shapes.items()}
    for name, shape in shapes.items():
        if kinds[name] in sizes:
            sizes[kinds[name]] += math.prod(shape)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    uniform = torch.rand(sizes["xavier"], generator=gen, device=device)
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    at = {"xavier": 0, "normal": 0}
    out = {}
    for name, shape in shapes.items():
        k, n = kinds[name], math.prod(shape)
        if k == "xavier":
            out[name] = (uniform[at[k]:at[k] + n].view(shape) * 2 - 1) * _xavier_bound(shape)
        elif k == "normal":
            out[name] = normal[at[k]:at[k] + n].view(shape) * 0.02
        elif k in ("ones", "zeros"):
            out[name] = torch.full(shape, 1.0 if k == "ones" else 0.0, device=device)
            continue
        else:
            raise ValueError(f"unknown weight kind {k!r} for {name}")
        at[k] += n
    return out


def make_pool(seed: int, batches: int, batch: int, streams: int, volume, device):
    """(images (batches, batch, streams, 1, D, H, W) bfloat16, labels
    (batches, batch) int64), both on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "volumes"))
    imgs = torch.randn((batches, batch, streams, 1, *volume), generator=gen, device=device)
    imgs = imgs.to(torch.bfloat16)
    host = torch.Generator().manual_seed(sub_seed(seed, "labels"))
    base = torch.arange(batch) % 2
    labels = torch.stack([base[torch.randperm(batch, generator=host)] for _ in range(batches)])
    return imgs, labels.to(device)


def step_generator(seed: int, step: int, coordinate: int) -> torch.Generator:
    """The host generator of one step of one data coordinate."""
    return torch.Generator().manual_seed(sub_seed(seed, "step", step, coordinate))
