"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``.
Asking for CUDA on a host without it raises: the port never quietly runs on
the CPU.  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available on this "
            "host; pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
