"""Stage names, peak rates and roofline accounting.

``trace_stage`` names a pipeline stage in the compiled program (HLO op
metadata), so a profiler trace attributes device work to SRC / EQ /
spectra.  ``PEAKS`` holds the published rates of each supported card,
keyed by ``jax.Device.device_kind``: a device that is not in the table is
an error, never a silent default.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, Optional, Tuple

import jax


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one card (dense, no sparsity)."""

    hbm_bytes_per_s: float
    fp32_flops: float        # float32 outside the tensor cores
    tf32_flops: float
    bf16_flops: float
    source: str


PEAKS: Dict[str, DevicePeaks] = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        hbm_bytes_per_s=3.35e12, fp32_flops=67e12, tf32_flops=495e12,
        bf16_flops=989e12,
        source="NVIDIA H100 SXM5 data sheet, dense rates at the 700 W "
               "power limit",
    ),
}


def device_peaks(kind: Optional[str] = None) -> DevicePeaks:
    """Peaks of ``kind`` (default: the first JAX device's device_kind)."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no peak rates for device kind {kind!r}; add a row to "
            f"utils.profiling.PEAKS with its source"
        ) from None


def bound_seconds(flops: float, bytes_moved: float, flops_per_s: float,
                  bytes_per_s: float) -> Tuple[float, str]:
    """Least time the work could take at these rates, and which of the two
    bounds it ('compute' or 'memory')."""
    t_c = flops / flops_per_s
    t_m = bytes_moved / bytes_per_s
    return (t_c, "compute") if t_c >= t_m else (t_m, "memory")


def roofline_fraction(bytes_moved: float, seconds: float,
                      kind: Optional[str] = None) -> float:
    """Achieved bandwidth as a fraction of the card's published HBM peak."""
    if seconds <= 0:
        raise ValueError(f"seconds must be positive, got {seconds}")
    return (bytes_moved / seconds) / device_peaks(kind).hbm_bytes_per_s


@contextlib.contextmanager
def trace_stage(name: str) -> Iterator[None]:
    """Name a pipeline stage: ops traced inside carry ``name`` in their
    HLO metadata (jax.named_scope), which profiler traces show."""
    with jax.named_scope(name):
        yield


@dataclasses.dataclass
class StageTimer:
    """Wall-clock stage timing with device sync."""

    timings_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, result_to_block=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if result_to_block is not None:
            jax.block_until_ready(result_to_block)
        self.timings_s[name] = self.timings_s.get(name, 0.0) + (
            time.perf_counter() - t0
        )

    def report(self) -> str:
        total = sum(self.timings_s.values())
        lines = [
            f"  {k}: {v*1e3:.2f} ms ({100*v/total:.0f}%)"
            for k, v in sorted(self.timings_s.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
