"""Golden numpy oracle: the reference's behavioral contract, executable.

This module is the framework's ground truth.  It executes the exact math of
the reference pipeline (/root/reference/modules/dsp_core.py) sequentially in
numpy/scipy — float64 filters, full-rate convolution, sequential ``lfilter``
recurrences — so every device op can be scored against it
(target: >= 60 dB SNR, BASELINE.json north_star).

Numerical notes:
  * The reference's hand-rolled recursive radix-2 DIT FFT (dsp_core.py:41-66)
    matches ``np.fft.fft`` to ~3.4e-6 at N=2048-scale (measured in SURVEY.md
    §6), far below the 60 dB budget, so ``np.fft`` serves as the FFT engine.
  * Coefficient/filter design is shared with the production ``design``
    package — the oracle pins the *execution* semantics (zero-stuffed
    full-rate convolution, sequential DF2T recurrences, ordering, bypasses,
    clipping), the design modules pin the coefficients.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import scipy.signal as _signal

from .config import EQConfig, SRCConfig, SpectrumConfig
from .design.sinc import lowpass_sinc


def resample_oracle(
    x: np.ndarray, fs: int, cfg: SRCConfig, engine: str = "direct"
) -> Tuple[np.ndarray, int]:
    """L/M rate conversion, executed the reference way (dsp_core.py:133-173).

    Zero-stuff by L, filter at the full upsampled rate with the sinc-Blackman
    LPF (cutoff 1/max(L,M) of Nyquist, 40*max(L,M)+1 taps, gain-compensated
    by L) using centered 'same' convolution, then decimate by M.

    ``engine='direct'`` is the reference's exact ``np.convolve`` (O(N*L*T) —
    minutes for seconds of audio at L=160).  ``engine='fast'`` evaluates the
    identical sum through the float64 polyphase-frame geometry (only the
    summation order differs — ~1e-13 relative, far below any SNR gate) so
    large-signal oracle comparisons stay tractable; timing baselines always
    use 'direct'.
    """
    if cfg.bypass:
        return x, fs
    L, M = cfg.L, cfg.M
    if engine == "fast":
        return _resample_oracle_fast(x, fs, cfg)
    up = np.zeros(len(x) * L, dtype=x.dtype)
    up[::L] = x
    h = lowpass_sinc(cfg.cutoff_norm, cfg.num_taps) * L
    filtered = np.convolve(up, h, mode="same")
    return filtered[::M], cfg.output_rate(fs)


def _resample_oracle_fast(
    x: np.ndarray, fs: int, cfg: SRCConfig
) -> Tuple[np.ndarray, int]:
    """Float64 polyphase evaluation of the reference sum (see ops/src.py)."""
    from .ops.src import make_plan

    n = len(x)
    n_up = n * cfg.L
    T = cfg.num_taps
    if n_up >= T:
        plan = make_plan(cfg.L, cfg.M, cfg.taps_rule_factor)
        n_out = cfg.output_length(n)
    else:
        plan = make_plan(cfg.L, cfg.M, cfg.taps_rule_factor, (n_up - 1) // 2)
        n_out = -(-T // cfg.M)
    num_frames = -(-n_out // plan.P)
    pad_left = max(0, -plan.lo)
    max_idx = (num_frames - 1) * plan.s + plan.W - 1 + plan.lo
    pad_right = max(0, max_idx - (n - 1))
    xp = np.pad(x.astype(np.float64), (pad_left, pad_right))
    k = np.arange(num_frames)[:, None] * plan.s
    w = np.arange(plan.W)[None, :]
    frames = xp[k + w + (plan.lo + pad_left)]
    y = (frames @ plan.G).reshape(-1)[:n_out]
    return y, cfg.output_rate(fs)


def equalize_oracle(x: np.ndarray, fs: int, cfg: EQConfig) -> np.ndarray:
    """6-band cascade, executed the reference way (dsp_core.py:216-254).

    Whole-EQ bypass when every |gain| < 0.1 dB (returned *unclipped*);
    otherwise each active band runs a zero-initial-state ``lfilter`` biquad
    on the previous band's output, in configured order, followed by a hard
    clip to [-1, 1].
    """
    from .design.biquad import peaking_coeffs

    if cfg.bypass:
        return x
    y = np.asarray(x).copy()
    for fc, gain in cfg.active_bands(fs):
        b, a = peaking_coeffs(fc, fs, gain, cfg.q)
        y = _signal.lfilter(b, a, y)
    return np.clip(y, -1.0, 1.0)


def spectrum_oracle(
    x: np.ndarray, fs: int, cfg: SpectrumConfig = SpectrumConfig()
) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed magnitude spectrum (dsp_core.py:68-98).

    Segment choice: the nfft samples starting at the signal midpoint when the
    signal is longer than nfft; otherwise zero-pad to the next power of two.
    Symmetric Hann window 0.5 - 0.5 cos(2 pi n / (N-1)); returns the first
    N//2 + 1 bins of |FFT| with an rfftfreq axis.
    """
    n = len(x)
    if n > cfg.nfft:
        mid = n // 2
        seg = x[mid : mid + cfg.nfft]
    else:
        padded = 1 << (n - 1).bit_length()
        seg = np.pad(x, (0, padded - n))
    m = len(seg)
    idx = np.arange(m)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * idx / (m - 1))
    mag = np.abs(np.fft.fft(seg * win))
    freqs = np.fft.rfftfreq(m, d=1.0 / fs)
    half = m // 2 + 1
    return freqs[:half], mag[:half]


def pipeline_oracle(
    x: np.ndarray,
    fs: int,
    src: SRCConfig,
    eq: EQConfig,
    engine: str = "direct",
) -> Tuple[np.ndarray, int]:
    """Full reference cascade x --SRC--> y --EQ--> z (app.py:162-167)."""
    y, fs_out = resample_oracle(x, fs, src, engine)
    z = equalize_oracle(y, fs_out, eq)
    return z, fs_out


def equalize_oracle_gains(
    x: np.ndarray, fs: int, gains: Mapping[str, float]
) -> np.ndarray:
    """Convenience wrapper taking a {band: dB} mapping."""
    return equalize_oracle(x, fs, EQConfig.from_gains(gains))


def snr_db(reference: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-error ratio in dB between two equal-length signals."""
    ref = np.asarray(reference, dtype=np.float64)
    err = ref - np.asarray(test, dtype=np.float64)
    p_sig = float(np.mean(ref**2))
    p_err = float(np.mean(err**2))
    if p_err == 0.0:
        return float("inf")
    if p_sig == 0.0:
        return float("-inf")
    return 10.0 * np.log10(p_sig / p_err)
