"""Reading a ``torch.profiler`` session: device operations as intervals,
their union, the device time by kernel class, and the idle gaps named by
what the host was doing across them.

``KERNEL_CLASSES`` is a frozen copy of ``chip_smoke.py``'s
``PROFILE_LAYERS`` (first match wins) with the NCCL collectives in front.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

KERNEL_CLASSES = (("NCCL collectives", ("nccl",)),
                  ("K5 attention forward", ("attn_single_fwd",)),
                  ("K5 attention backward", ("attn_single_bwd",)),
                  ("K7 attention forward", ("attn_stream_fwd",)),
                  ("K7 attention backward", ("attn_stream_bwd",)),
                  ("K1 attention forward", ("attn_fwd_qkv",)),
                  ("K2/K6/K8 attention backward", ("attn_bwd_",)),
                  ("K8 dx/dW products", ("qkv_grad_d",)),
                  ("K3/K4 resample", ("resample_kernel",)),
                  ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "convolve", "cudnn",
                                           "conv2d", "conv3d")),
                  ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma", "imma")),
                  ("BatchNorm", ("batch_norm", "bn_fw", "bn_bw")),
                  ("pooling", ("pool",)),
                  ("Adam (fused)", ("multi_tensor_apply",)),
                  ("LayerNorm", ("layer_norm",)),
                  ("softmax", ("softmax",)),
                  ("dropout masks (random)", ("distribution", "philox")),
                  ("copies, casts, elementwise", ("copy", "elementwise", "Cat", "where",
                                                  "index", "reduce", "Memcpy", "Memset")))
NCCL = "NCCL collectives"


def kernel_class(name: str) -> str:
    return next((label for label, marks in KERNEL_CLASSES if any(m in name for m in marks)),
                "other")


def _runs(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals [start, end) as disjoint runs (starts, ends)."""
    order = np.argsort(starts)
    s, e = starts[order], np.maximum.accumulate(ends[order])
    # an interval opens a new run where it starts after everything before ended
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(e[idx[1:] - 1], e[-1])


def union_seconds(starts: np.ndarray, ends: np.ndarray) -> float:
    """Length of the union of intervals [start, end)."""
    if starts.size == 0:
        return 0.0
    rs, re = _runs(starts, ends)
    return float(np.sum(re - rs))


@dataclass
class Profile:
    """One profiled stretch of ``steps`` steps lasting ``wall_s`` on the host
    clock.  Times are seconds on the profiler's clock."""
    steps: int
    wall_s: float
    names: list = field(default_factory=list)       # device operations
    starts: np.ndarray = field(default_factory=lambda: np.zeros(0))
    ends: np.ndarray = field(default_factory=lambda: np.zeros(0))
    host_names: list = field(default_factory=list)  # host operations
    host_starts: np.ndarray = field(default_factory=lambda: np.zeros(0))
    host_ends: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @property
    def empty(self) -> bool:
        return not self.names

    def busy_s(self) -> float:
        return union_seconds(self.starts, self.ends)

    def seconds_by_class(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, s, e in zip(self.names, self.starts, self.ends):
            label = kernel_class(name)
            out[label] = out.get(label, 0.0) + float(e - s)
        return out

    def seconds_of(self, mark: str) -> tuple[float, int]:
        """(summed seconds, count) of the device operations whose name holds ``mark``."""
        hit = [float(e - s) for n, s, e in zip(self.names, self.starts, self.ends) if mark in n]
        return sum(hit), len(hit)

    def exposed_s(self, label: str) -> float:
        """Seconds in which an operation of class ``label`` runs and no
        operation of any other class does."""
        mine = np.array([kernel_class(n) == label for n in self.names], bool)
        if not mine.any():
            return 0.0
        both = union_seconds(self.starts, self.ends)
        others = union_seconds(self.starts[~mine], self.ends[~mine])
        return both - others

    def top_operations(self, n: int = 10) -> list[list]:
        total: dict[str, float] = {}
        for name, s, e in zip(self.names, self.starts, self.ends):
            total[name] = total.get(name, 0.0) + float(e - s)
        return [[k[:120], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, least_s: float = 5e-6) -> list[list]:
        """Idle device time between the first and the last operation, summed
        by the innermost host operation that spans each gap's middle."""
        if self.empty:
            return []
        rs, re = _runs(self.starts, self.ends)
        gap_start, gap_end = re[:-1], rs[1:]
        keep = gap_end - gap_start >= least_s
        hs, he = self.host_starts, self.host_ends
        dur = he - hs
        total: dict[str, float] = {}
        for a, b in zip(gap_start[keep], gap_end[keep]):
            mid = 0.5 * (a + b)
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            name = self.host_names[cover[np.argmin(dur[cover])]] if cover.size else "(no host op)"
            total[name] = total.get(name, 0.0) + float(b - a)
        return [[k[:120], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def read_profile(prof, steps: int, wall_s: float) -> Profile:
    """The device and host operations of a finished ``torch.profiler.profile``.
    Ranges annotated on the device timeline (``nccl:all_reduce``,
    ``DistributedDataParallel.forward``, ``Optimizer.step``: each also a
    host event of the same name) are not device operations and are left out."""
    from torch.autograd import DeviceType

    events = prof.events()
    host_names = {ev.name for ev in events if ev.device_type == DeviceType.CPU}
    dev, host = [], []
    for ev in events:
        tr = ev.time_range
        row = (ev.name, tr.start * 1e-6, tr.end * 1e-6)
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False) and ev.name not in host_names:
                dev.append(row)
        elif ev.device_type == DeviceType.CPU:
            host.append(row)
    out = Profile(steps, wall_s)
    if dev:
        out.names = [r[0] for r in dev]
        out.starts = np.array([r[1] for r in dev])
        out.ends = np.array([r[2] for r in dev])
    if host:
        out.host_names = [r[0] for r in host]
        out.host_starts = np.array([r[1] for r in host])
        out.host_ends = np.array([r[2] for r in host])
    return out
