"""Profiling and tracing utilities — port of
``cross_attention_vit_tpu/utils/profiling.py``.

The reference's tooling was forward-hook shape prints and wall-clock prints
(modify_model.py:7-55, other_model.py:255-312).  Here:

  * ``profile_trace(logdir)``: a context manager around ``torch.profiler``
    that records the host and, when the device is a card, the CUDA kernels,
    and writes a Chrome trace (``trace.json``, viewable in Perfetto or
    chrome://tracing) into ``logdir`` on exit; it yields the profiler, whose
    ``key_averages()`` sums the kernels by name;
  * ``span(name)``: a named host range in whatever profiler session is
    recording (``torch.profiler.record_function``), on the clock of its CUDA
    kernels; with no profiler recording, one shared null context, so the
    spans cost a check each and there is nothing to switch on.  The train
    step opens ``step:augment``, ``step:forward``, ``step:backward`` and
    ``step:optimizer`` (``train/trainer.py``);
  * ``to_device(t, device, dtype)``: ``Tensor.to`` for the copies of host
    data to the device, inside ``span("sync:h2d")`` when it copies from host
    memory to a card, which blocks the host until the stream drains (the
    augmentation's draws, the train step's inputs);
  * shape tracing lives in ``models.surgery`` (``trace_shapes``,
    ``inspect_model``).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

from .device import resolve_device


@contextlib.contextmanager
def profile_trace(logdir: str | Path, device: str | torch.device = "cuda"):
    """Profile the body; the trace lands in ``logdir/trace.json``.  CUDA
    activity is recorded when ``device`` is a card (default CUDA; raises
    without it)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / "trace.json"))


SYNC_H2D = "sync:h2d"
_OFF = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else the shared null context: ``with span("step:forward"): ...``."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def _host_to_card(t: torch.Tensor, device: str | torch.device) -> bool:
    """A copy of ``t`` to ``device`` goes from host memory to a card: without
    ``non_blocking`` it synchronises the stream (``cudaMemcpyAsync``, then
    ``cudaStreamSynchronize``)."""
    return t.device.type == "cpu" and torch.device(device).type == "cuda"


def to_device(t: torch.Tensor, device: str | torch.device,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """``t.to(device=device, dtype=dtype)``, spanned ``sync:h2d`` when it
    blocks the host on a copy from host memory to a card."""
    if _host_to_card(t, device):
        with span(SYNC_H2D):
            return t.to(device=device, dtype=dtype)
    return t.to(device=device, dtype=dtype)
