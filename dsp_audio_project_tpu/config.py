"""Static configuration for the audio-DSP pipeline.

The reference (``/root/reference``) hardcodes every knob inside UI widgets
(``app.py:149-159``) and the DSP core (``modules/dsp_core.py:158,225-228``).
Here they are first-class dataclasses; the defaults reproduce the reference's
hardcoded values exactly, so a parity configuration is ``PipelineConfig()``.

All configs are *static* (hashable, usable as jit static args): filter design
runs on host in float64 at trace time, which is both the precision-correct and
the XLA-friendly choice (coefficients become compile-time constants).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

# Reference band table: modules/dsp_core.py:225-228.
DEFAULT_BAND_CENTERS: Tuple[Tuple[str, float], ...] = (
    ("Sub-Bass", 40.0),
    ("Bass", 150.0),
    ("Low Mids", 1000.0),
    ("High Mids", 3000.0),
    ("Presence", 5000.0),
    ("Brilliance", 10000.0),
)

DEFAULT_BAND_NAMES = tuple(name for name, _ in DEFAULT_BAND_CENTERS)

# Reference slider ranges: app.py:149-159.
SRC_FACTOR_MIN, SRC_FACTOR_MAX = 1, 8
GAIN_DB_MIN, GAIN_DB_MAX = -15, 15


@dataclasses.dataclass(frozen=True)
class SRCConfig:
    """L/M rational sample-rate conversion (reference: dsp_core.py:133-173).

    ``taps_rule_factor`` reproduces the reference's ``num_taps = 40*max(L,M)+1``
    tap-count rule (dsp_core.py:158).
    """

    L: int = 1
    M: int = 1
    taps_rule_factor: int = 40

    def __post_init__(self):
        if self.L < 1 or self.M < 1:
            raise ValueError(f"L and M must be >= 1, got L={self.L} M={self.M}")

    @property
    def bypass(self) -> bool:
        # dsp_core.py:144-145
        return self.L == 1 and self.M == 1

    @property
    def num_taps(self) -> int:
        # dsp_core.py:158, forced odd at dsp_core.py:114
        t = self.taps_rule_factor * max(self.L, self.M) + 1
        return t if t % 2 == 1 else t + 1

    @property
    def cutoff_norm(self) -> float:
        # dsp_core.py:155 — cutoff relative to Nyquist.
        return 1.0 / max(self.L, self.M)

    def output_rate(self, fs: int) -> int:
        # dsp_core.py:172 — int() truncation of the float product, replicated.
        return int(fs * self.L / self.M)

    def output_length(self, n: int) -> int:
        # ceil(max(n*L, T)/M): numpy 'same' convolution returns
        # max(len(signal), len(filter)) samples before decimation.
        if self.bypass:
            return n
        return -(-max(n * self.L, self.num_taps) // self.M)


@dataclasses.dataclass(frozen=True)
class EQConfig:
    """6-band peaking-EQ cascade (reference: dsp_core.py:216-254).

    ``gains_db`` maps band name -> gain in dB; application order is the tuple
    order (the reference applies bands in dict-insertion order,
    dsp_core.py:233).  ``q`` is fixed at 1.0 in the reference
    (alpha = sin(w0)/2, dsp_core.py:188).
    """

    gains_db: Tuple[Tuple[str, float], ...] = tuple(
        (name, 0.0) for name in DEFAULT_BAND_NAMES
    )
    band_centers: Tuple[Tuple[str, float], ...] = DEFAULT_BAND_CENTERS
    q: float = 1.0
    # Reference thresholds (dsp_core.py:222,234,240,249).
    bypass_threshold_db: float = 0.1
    nyquist_safety: float = 0.90
    min_center_hz: float = 10.0

    @staticmethod
    def from_gains(gains: Mapping[str, float] | None = None, **kw) -> "EQConfig":
        g = dict.fromkeys(DEFAULT_BAND_NAMES, 0.0)
        if gains:
            g.update(gains)
        return EQConfig(gains_db=tuple(g.items()), **kw)

    @property
    def bypass(self) -> bool:
        # dsp_core.py:222-223 — flat response if every |gain| < 0.1 dB.
        return all(abs(g) < self.bypass_threshold_db for _, g in self.gains_db)

    def active_bands(self, fs: float) -> Tuple[Tuple[float, float], ...]:
        """(effective_fc, gain_db) for each band that actually filters.

        Encodes the reference's per-band skip (|g| <= 0.1, dsp_core.py:234),
        Nyquist clamp to 0.9*fs/2 (dsp_core.py:240-246) and the 10 Hz floor
        (dsp_core.py:249), in application order.
        """
        centers = dict(self.band_centers)
        ceiling = (fs / 2.0) * self.nyquist_safety
        out = []
        for name, gain in self.gains_db:
            if abs(gain) <= self.bypass_threshold_db:
                continue
            fc = centers.get(name, 1000.0)
            fc = ceiling if fc >= ceiling else fc
            if fc > self.min_center_hz:
                out.append((fc, float(gain)))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    """Windowed magnitude spectrum (reference: dsp_core.py:68-98, app.py:202).

    ``analysis_limit`` caps the samples handed to the spectrum op
    (app.py:202 uses the first 100k samples).
    """

    nfft: int = 2048
    window: str = "hann"  # symmetric Hann, computed as in dsp_core.py:86-87
    analysis_limit: int = 100_000


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh for sharded processing.

    Axes: ``channel`` shards independent audio channels, ``block`` shards the
    time axis into contiguous blocks (this domain's sequence parallelism —
    overlap-save halos for the FIR, state carries for the IIR).
    """

    channel_axis: str = "channel"
    block_axis: str = "block"
    channel_devices: int = 1
    block_devices: int = 1


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Numerics and tiling knobs of the device ops.

    Which path runs is not configured here: routing.choose_route decides
    from the plan and the configuration alone.

    ``iir_block`` / ``iir_unroll`` set the flat route's EQ block geometry
    (the frame-major routes use one block of FRAME_GRANULE frames at
    unroll = P).  ``eq_fast`` / ``src_fast`` run the EQ's FIR/injection and
    state-solve matmuls / the frame-major routes' SRC matmul as bf16x3
    (utils.precision.FAST) instead of full float32; the block-carry and
    readout paths and the flat route's SRC stay full precision.
    """

    iir_block: int = 8192            # block length for the IIR block recurrence
    iir_unroll: int = 128            # samples per matmul group within a block
    eq_fast: bool = False
    src_fast: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full SRC -> EQ chain configuration (reference cascade: app.py:162-167)."""

    src: SRCConfig = SRCConfig()
    eq: EQConfig = EQConfig()
    spectrum: SpectrumConfig = SpectrumConfig()
    mesh: MeshConfig = MeshConfig()
    kernels: KernelConfig = KernelConfig()
