"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``.
Asking for CUDA on a host without it raises: the port never quietly runs on
the CPU.  Tests pass ``device="cpu"``.  Under a process group (one process
per card, ``parallel.multihost_init``) a bare ``"cuda"`` is the card the
process was given.
"""

from __future__ import annotations

import torch
import torch.distributed


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and there is
    none.  Under a process group, ``"cuda"`` without an index is the current
    card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available on this "
            "host; pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
