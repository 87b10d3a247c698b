"""Small utilities mirroring the reference's utils.py surface — port of
``cross_attention_vit_tpu/utils/misc.py``.

``compute_metrics`` is re-exported from ``train.metrics`` (the reference's
utils.compute_metrics, utils.py:18-62).  ``accum_tensor`` is the reference's
recursive element fold (utils.py:6-14) as a flat host loop.  The JAX
module's ``enable_compilation_cache`` (a persistent XLA compilation cache)
has no counterpart here: the port runs eagerly, compiles no graph, and its
hand-written kernels are built once per checkout by ``kernels/_build.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.metrics import compute_metrics  # noqa: F401


def accum_tensor(t1, t2, func) -> float:
    """sum(func(a, b) for paired scalars a, b) of two equally shaped arrays
    or tensors; ``func`` is any Python callable on scalars, so the fold stays
    a host loop."""
    a, b = (np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t).ravel()
            for t in (t1, t2))
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(sum(func(x, y) for x, y in zip(a.tolist(), b.tolist())))
