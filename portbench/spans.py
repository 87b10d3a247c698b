"""The program's own spans in a profiled stretch, and the device's idle time
inside them.

``cross_attention_vit_tpu_torch.utils.profiling.span`` opens each span as a
``record_function`` host event while a profiler records, on the clock of
the device operations.  The train step's phases are ``step:augment``,
``step:forward``, ``step:backward`` (once per microbatch each, the last
also finishing the gradients) and ``step:optimizer``; ``sync:h2d`` is a
copy from host memory to the card, which blocks the host.  The backward's
host operations run on autograd's own thread, so the idle time is given to
a phase by time interval, not by thread.

The idle time is that of ``trace.Profile.idle_gaps``: the gaps between the
runs of the union of device intervals, from the first operation to the
last, here each clipped to the union of the named spans' intervals.
"""

from __future__ import annotations

import numpy as np

from .trace import Profile, _runs

PHASES = ("step:augment", "step:forward", "step:backward", "step:optimizer")
SYNC = "sync:h2d"


def intervals(profile: Profile, names) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the host events named one of ``names``."""
    hit = np.array([n in names for n in profile.host_names], bool)
    if not hit.any():
        return np.zeros(0), np.zeros(0)
    return profile.host_starts[hit], profile.host_ends[hit]


def recorded(profile: Profile) -> bool:
    """The stretch holds the train step's spans (a program without them
    records none)."""
    return intervals(profile, (PHASES[0],))[0].size > 0


def count(profile: Profile, name: str) -> int:
    return int(intervals(profile, (name,))[0].size)


def idle_gaps(profile: Profile) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the device's idle gaps between its operations."""
    if profile.empty:
        return np.zeros(0), np.zeros(0)
    rs, re = _runs(profile.starts, profile.ends)
    return re[:-1], rs[1:]


def between_kernel_idle_s(profile: Profile) -> float:
    gs, ge = idle_gaps(profile)
    return float(np.sum(ge - gs))


def idle_s(profile: Profile, names) -> float:
    """Device-idle seconds between operations inside the union of the spans
    named one of ``names``."""
    ss, se = intervals(profile, names)
    gs, ge = idle_gaps(profile)
    if not ss.size or not gs.size:
        return 0.0
    total = 0.0
    for a, b in zip(*_runs(ss, se)):
        total += float(np.sum(np.clip(np.minimum(ge, b) - np.maximum(gs, a), 0.0, None)))
    return total


def phase_idle_ms(profile: Profile, name: str) -> float | None:
    """Device-idle ms a step inside the phase ``name``; None where the
    stretch has no step spans."""
    if not recorded(profile):
        return None
    return 1e3 * idle_s(profile, (name,)) / profile.steps
