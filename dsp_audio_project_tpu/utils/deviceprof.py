"""Device time from a profiler trace.

``trace_device(thunk)`` runs ``thunk`` under ``jax.profiler.trace``, reads
the XSpace it wrote with ``jax.profiler.ProfileData`` and reduces the GPU
device planes (``/device:GPU:<n>``) to busy time, idle share and per-op
time.  A trace with no device events raises: a timing that found no
device must not pass for one.
"""
from __future__ import annotations

import collections
import dataclasses
import glob
import os
import tempfile
from typing import Callable, Dict, Iterable, List, Tuple

import jax

DEVICE_PLANE_PREFIX = "/device:GPU:"
# Lines that summarize the kernel events of the stream lines (added by some
# profiler versions); they would count every kernel twice.
_SUMMARY_LINES = frozenset({
    "XLA Modules", "XLA Ops", "XLA TraceMe", "Steps", "Source",
    "Framework Name Scope", "Framework Ops", "TensorFlow Name Scope",
    "TensorFlow Ops",
})


@dataclasses.dataclass
class DeviceProfile:
    """Reduction of the device events of one trace."""

    busy_ns: float                 # union of device-event intervals (all
                                   # devices; see device_busy_ns per card)
    window_ns: float               # first device-event start .. last end
    ops_ns: Dict[str, float]       # summed duration per HLO op / kernel
    modules_ns: Dict[str, float]   # summed duration per HLO module
    n_events: int
    device_busy_ns: Dict[str, float]  # busy time per device plane

    @property
    def busy_ms(self) -> float:
        return self.busy_ns / 1e6

    @property
    def idle_share(self) -> float:
        """1 - busy / window over the span of device activity."""
        return 1.0 - self.busy_ns / self.window_ns if self.window_ns else 0.0

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.ops_ns.items(), key=lambda kv: -kv[1])[:k]


def _stat(event, key: str):
    for k, v in event.stats:
        if k == key:
            return v
    return None


def reduce_device_events(planes: Iterable) -> DeviceProfile:
    """Reduce the device planes of a ProfileData-like object's ``planes``.

    Each plane has ``name`` and ``lines``; each line ``name`` and
    ``events``; each event ``name``, ``start_ns``, ``duration_ns`` and
    ``stats`` ((key, value) pairs).  Raises RuntimeError when no plane
    named /device:GPU:<n> holds an event.
    """
    per_plane: Dict[str, list] = collections.defaultdict(list)
    ops: Dict[str, float] = collections.Counter()
    modules: Dict[str, float] = collections.Counter()
    for plane in planes:
        if not plane.name.startswith(DEVICE_PLANE_PREFIX):
            continue
        for line in plane.lines:
            if line.name in _SUMMARY_LINES:
                continue
            for ev in line.events:
                dur = float(ev.duration_ns)
                if dur <= 0:
                    continue
                start = float(ev.start_ns)
                per_plane[plane.name].append((start, start + dur))
                op = _stat(ev, "hlo_op") or ev.name
                ops[str(op)] += dur
                mod = _stat(ev, "hlo_module")
                if mod is not None:
                    modules[str(mod)] += dur
    intervals = [iv for ivs in per_plane.values() for iv in ivs]
    if not intervals:
        raise RuntimeError(
            "trace holds no device events (no /device:GPU:<n> plane with "
            "kernels): the work did not run on a GPU"
        )
    window = (max(e for _, e in intervals)
              - min(s for s, _ in intervals))
    return DeviceProfile(
        busy_ns=_union_ns(intervals), window_ns=window, ops_ns=dict(ops),
        modules_ns=dict(modules), n_events=len(intervals),
        device_busy_ns={k: _union_ns(v) for k, v in per_plane.items()},
    )


def _union_ns(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    intervals = sorted(intervals)
    busy = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s)


def trace_device(thunk: Callable[[], object]):
    """Run ``thunk()`` under a profiler trace and wait for its result;
    return (result, DeviceProfile of every device event in the trace)."""
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            out = jax.block_until_ready(thunk())
        paths = sorted(glob.glob(os.path.join(td, "**", "*.xplane.pb"),
                                 recursive=True))
        if not paths:
            raise RuntimeError(f"profiler wrote no .xplane.pb under {td}")
        profile = jax.profiler.ProfileData.from_file(paths[-1])
        return out, reduce_device_events(profile.planes)


def device_profile(fn: Callable, *args, reps: int = 5) -> DeviceProfile:
    """DeviceProfile of ``reps`` back-to-back calls of ``fn(*args)``, after
    one untraced call (which compiles)."""
    jax.block_until_ready(fn(*args))
    _, prof = trace_device(lambda: [fn(*args) for _ in range(reps)])
    return prof


def device_ms(fn: Callable, *args, reps: int = 5) -> float:
    """Device busy ms per call of ``fn(*args)`` (see device_profile)."""
    return device_profile(fn, *args, reps=reps).busy_ms / reps
