"""Profiling and tracing utilities — port of
``cross_attention_vit_tpu/utils/profiling.py``.

The reference's tooling was forward-hook shape prints and wall-clock prints
(modify_model.py:7-55, other_model.py:255-312).  Here:

  * ``profile_trace(logdir)``: a context manager around ``torch.profiler``
    that records the host and, when the device is a card, the CUDA kernels,
    and writes a Chrome trace (``trace.json``, viewable in Perfetto or
    chrome://tracing) into ``logdir`` on exit; it yields the profiler, whose
    ``key_averages()`` sums the kernels by name;
  * ``StageTimer``: wall-clock time per named stage, synchronising a
    tensor's CUDA stream (``block_on=``) so asynchronous launches do not hide
    their work in a later stage;
  * shape tracing lives in ``models.surgery`` (``trace_shapes``,
    ``inspect_model``).
"""

from __future__ import annotations

import contextlib
import time
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


class StageTimer:
    """Wall time per named stage: ``with timer.stage("decode"): ...``;
    ``block_on`` (a tensor) synchronises its device's current CUDA stream
    before the stage's clock stops."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on: torch.Tensor | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.is_cuda:
                torch.cuda.current_stream(block_on.device).synchronize()
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot, n = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {tot:8.3f}s total  {tot / n * 1000:8.1f} ms/call  ×{n}")
        return "\n".join(lines)
