"""Windowed magnitude-spectrum analysis ops.

Reproduces the reference's two analysis views:
  * ``magnitude_spectrum`` — the primary view (dsp_core.py:68-98): center
    segment (or zero-pad to the next power of two), symmetric Hann window,
    |FFT| over the first N//2+1 bins with an rfftfreq axis.
  * ``angular_spectrum``  — the "textbook" two-sided view (app.py:308-327):
    1024-point fftshifted spectrum over [-pi, pi).

Both are analysis-only (never in the audio path, SURVEY.md §1) and batch over
leading dims — on a sharded pipeline each (channel, time-block) computes its
spectrum independently with zero cross-device traffic.
"""
from __future__ import annotations

import functools

import jax
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..config import SpectrumConfig
from .fft import fft_magnitude, rfft_magnitude


@functools.lru_cache(maxsize=None)
def _hann(n: int) -> np.ndarray:
    # Symmetric Hann, exactly the reference's inline form (dsp_core.py:86-87).
    idx = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * idx / (n - 1))).astype(np.float32)


def _segment_bounds(n: int, nfft: int) -> Tuple[int, int]:
    """Static segment selection (dsp_core.py:74-82).

    Note the nfft < n < mid + nfft corner: the reference slices
    x[mid : mid + nfft], gets a short non-power-of-two segment, and its
    recursive FFT crashes on it.  The build defines clean semantics instead
    (SURVEY.md §4 property tier): window whatever the tail holds and zero-pad
    to the next power of two.
    """
    if n > nfft:
        mid = n // 2
        avail = n - mid
        if avail >= nfft:
            return mid, nfft
        return mid, 1 << (avail - 1).bit_length()
    return 0, 1 << (n - 1).bit_length()


@functools.partial(jax.jit, static_argnames=('start', 'm'))
def _windowed_rfft_mag(x: jnp.ndarray, start: int, m: int) -> jnp.ndarray:
    n = x.shape[-1]
    avail = min(m, n - start)
    seg = x[..., start : start + avail]
    if avail < m:
        seg = jnp.pad(seg, [(0, 0)] * (x.ndim - 1) + [(0, m - avail)])
    seg = seg.astype(jnp.float32) * jnp.asarray(_hann(m))
    return rfft_magnitude(seg)  # (..., m//2 + 1)


def spectrum_segment(n: int, cfg: SpectrumConfig) -> Tuple[int, int, int]:
    """Static (start, m, n_capped) a spectrum of an n-sample signal uses.

    Applies the analysis cap (first ``analysis_limit`` samples, app.py:202)
    then the reference's center-segment rule (dsp_core.py:74-82).
    """
    if cfg.analysis_limit and n > cfg.analysis_limit:
        n = cfg.analysis_limit
    start, m = _segment_bounds(n, cfg.nfft)
    return start, m, n


def spectrum_freqs(
    n: int, fs: int, cfg: SpectrumConfig = SpectrumConfig()
) -> np.ndarray:
    """Host frequency axis matching ``spectrum_mag*`` on an n-sample signal."""
    _, m, _ = spectrum_segment(n, cfg)
    return np.fft.rfftfreq(m, d=1.0 / fs)


def spectrum_mag(
    x: jnp.ndarray, cfg: SpectrumConfig = SpectrumConfig()
) -> jnp.ndarray:
    """Traceable magnitude spectrum of (..., N) — the device half of
    ``magnitude_spectrum``, composable inside a larger jitted program
    (the full-chain forward computes spectra of x, y AND z per render,
    app.py:202-205)."""
    start, m, n = spectrum_segment(x.shape[-1], cfg)
    return _windowed_rfft_mag(x[..., :n], start, m)


def spectrum_window(
    x: jnp.ndarray, cfg: SpectrumConfig = SpectrumConfig()
) -> jnp.ndarray:
    """The windowed (..., m) analysis segment of (..., N) — spectrum_mag
    minus the FFT, so a caller can stack several signals' segments and run
    ONE batched rFFT over all of them (spectra_mag_stacked)."""
    start, m, n = spectrum_segment(x.shape[-1], cfg)
    xn = x[..., :n]
    avail = min(m, n - start)
    seg = xn[..., start : start + avail]
    if avail < m:
        seg = jnp.pad(seg, [(0, 0)] * (x.ndim - 1) + [(0, m - avail)])
    return seg.astype(jnp.float32) * jnp.asarray(_hann(m))


def spectrum_window_frames(
    frames: jnp.ndarray, n_flat: int, cfg: SpectrumConfig = SpectrumConfig()
) -> jnp.ndarray:
    """spectrum_mag_frames minus the FFT (see spectrum_window)."""
    P = frames.shape[-1]
    start, m, n = spectrum_segment(n_flat, cfg)
    avail = min(m, n - start)
    r0 = start // P
    r1 = -(-(start + avail) // P)
    rows = frames[..., r0:r1, :]
    flat = rows.reshape(rows.shape[:-2] + ((r1 - r0) * P,))
    off = start - r0 * P
    seg = flat[..., off : off + avail]
    if avail < m:
        seg = jnp.pad(seg, [(0, 0)] * (seg.ndim - 1) + [(0, m - avail)])
    return seg.astype(jnp.float32) * jnp.asarray(_hann(m))


def spectrum_rows_needed(
    n_flat: int, P: int, cfg: SpectrumConfig = SpectrumConfig()
) -> Tuple[int, int]:
    """Frame-row range [r0, r1) of P-wide frames that the analysis window
    of an n_flat-sample signal touches (static host arithmetic)."""
    start, m, n = spectrum_segment(n_flat, cfg)
    avail = min(m, n - start)
    return start // P, -(-(start + avail) // P)


def spectrum_window_rows(
    rows: jnp.ndarray, r0: int, n_flat: int,
    cfg: SpectrumConfig = SpectrumConfig(),
) -> jnp.ndarray:
    """spectrum_window_frames when the caller already holds JUST the touched
    rows [r0, r1) (see spectrum_rows_needed) — the fused cat chain emits
    the z/y analysis rows as small side tensors so the full-size output
    fusion is never sliced."""
    P = rows.shape[-1]
    start, m, n = spectrum_segment(n_flat, cfg)
    avail = min(m, n - start)
    flat = rows.reshape(rows.shape[:-2] + (rows.shape[-2] * P,))
    off = start - r0 * P
    seg = flat[..., off : off + avail]
    if avail < m:
        seg = jnp.pad(seg, [(0, 0)] * (seg.ndim - 1) + [(0, m - avail)])
    return seg.astype(jnp.float32) * jnp.asarray(_hann(m))


def spectra_mag_stacked(segs):
    """|rfft| of several same-width windowed segments in ONE FFT call.

    The full-chain forward computes three 2048-point spectra per render
    (x, y, z — app.py:202-205); as three separate calls each pays the
    small-kernel launch cost.  Stacking them on a new leading axis makes
    one (3*B, m) batch — one launch, same results.  Falls back to
    per-segment calls when widths differ (mixed-length corner configs).
    """
    m = segs[0].shape[-1]
    if any(s.shape != segs[0].shape for s in segs[1:]):
        return [rfft_magnitude(s) for s in segs]
    stacked = jnp.stack(segs, axis=0)
    mags = rfft_magnitude(stacked)
    return [mags[i] for i in range(len(segs))]


def spectrum_mag_frames(
    frames: jnp.ndarray, n_flat: int, cfg: SpectrumConfig = SpectrumConfig()
) -> jnp.ndarray:
    """Traceable magnitude spectrum of the flat view of (..., F, P) frames.

    The fused frame-major pipeline (models/chain.py) keeps signals as
    P-wide frames; the analysis window covers only ~m/P frame rows, so the
    spectrum slices those rows and flattens a tiny block instead of
    materializing the full (F, P) -> (F*P,) relayout.  ``n_flat`` is the
    true sample count the frames represent (trailing pad excluded).
    Matches ``spectrum_mag`` on the flattened signal exactly.
    """
    P = frames.shape[-1]
    start, m, n = spectrum_segment(n_flat, cfg)
    avail = min(m, n - start)
    r0 = start // P
    r1 = -(-(start + avail) // P)
    rows = frames[..., r0:r1, :]
    flat = rows.reshape(rows.shape[:-2] + ((r1 - r0) * P,))
    off = start - r0 * P
    seg = flat[..., off : off + avail]
    if avail < m:
        seg = jnp.pad(seg, [(0, 0)] * (seg.ndim - 1) + [(0, m - avail)])
    seg = seg.astype(jnp.float32) * jnp.asarray(_hann(m))
    return rfft_magnitude(seg)


def magnitude_spectrum(
    x: jnp.ndarray, fs: int, cfg: SpectrumConfig = SpectrumConfig()
) -> Tuple[np.ndarray, jnp.ndarray]:
    """(freqs, |X[k]|) for (..., N) signals; freqs is a host constant.

    The analysis cap (first ``analysis_limit`` samples, app.py:202) is applied
    before segmentation, like the app driver does.  The device part is
    jit-compiled per (shape, segment).
    """
    n = x.shape[-1]
    start, m, n_cap = spectrum_segment(n, cfg)
    mag = _windowed_rfft_mag(x[..., :n_cap], start, m)
    freqs = np.fft.rfftfreq(m, d=1.0 / fs)
    return freqs, mag


@jax.jit
def _angular_mag(segment: jnp.ndarray) -> jnp.ndarray:
    m = segment.shape[-1]
    return jnp.roll(fft_magnitude(segment), m // 2, axis=-1)


def angular_spectrum(segment: jnp.ndarray) -> Tuple[np.ndarray, jnp.ndarray]:
    """Two-sided fftshifted magnitude over [-pi, pi) (app.py:322-327).

    ``segment`` is (..., nfft) with nfft a power of two; returns the
    normalized-frequency axis (host constant) and |fftshift(FFT(segment))|.
    """
    m = segment.shape[-1]
    w_axis = np.linspace(-np.pi, np.pi, m)
    return w_axis, _angular_mag(segment)


def spectrum_db(mag: jnp.ndarray, floor: float = 1e-12) -> jnp.ndarray:
    """dB conversion used by the app's frequency view (app.py:208-210)."""
    return 20.0 * jnp.log10(mag + floor)


@functools.partial(jax.jit, static_argnames=("nfft", "hop", "pad_end"))
def stft(
    x: jnp.ndarray,
    nfft: int = 2048,
    hop: int = 512,
    pad_end: bool = True,
) -> jnp.ndarray:
    """Short-time Fourier transform: (..., N) -> (..., frames, nfft//2+1).

    Hann-windowed (the reference's analysis window), hop-strided frames
    through the batched rFFT — the framework's spectrogram workhorse (the
    reference computes one window per signal; production analysis wants all
    of them).

    Frames are built from nfft/hop shifted views of hop-sample groups (no
    gather); requires hop | nfft.  ``pad_end`` zero-pads so every sample is
    covered; otherwise trailing samples short of a full window are dropped.
    """
    if nfft % hop:
        raise ValueError(f"hop {hop} must divide nfft {nfft}")
    n = x.shape[-1]
    lead = x.shape[:-1]
    r = nfft // hop
    if pad_end:
        frames = -(-n // hop)
    else:
        frames = max(0, (n - nfft) // hop + 1)
    groups_total = frames + r - 1
    total = groups_total * hop
    xp = x.astype(jnp.float32)
    if total > n:
        xp = jnp.pad(xp, [(0, 0)] * (x.ndim - 1) + [(0, total - n)])
    else:
        xp = xp[..., :total]
    g = xp.reshape(lead + (groups_total, hop))
    parts = [
        jax.lax.slice_in_dim(g, j, j + frames, axis=x.ndim - 1)
        for j in range(r)
    ]
    win_frames = jnp.concatenate(parts, axis=-1)  # (..., frames, nfft)
    win_frames = win_frames * jnp.asarray(_hann(nfft))
    return jnp.fft.rfft(win_frames, axis=-1)


def spectrogram(
    x: jnp.ndarray, nfft: int = 2048, hop: int = 512
) -> jnp.ndarray:
    """Power spectrogram |STFT|^2: (..., frames, nfft//2+1)."""
    s = stft(x, nfft=nfft, hop=hop)
    return (s.real**2 + s.imag**2).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("nfft", "hop", "pad_end"))
def stft_planes(
    x: jnp.ndarray,
    nfft: int = 2048,
    hop: int = 512,
    pad_end: bool = True,
) -> jnp.ndarray:
    """STFT as stacked real planes: (..., 2, frames, nfft//2+1) f32 —
    planes [0] = real, [1] = imag, for consumers that take real arrays
    only.  Recombine with ``planes[..., 0, :, :] + 1j * planes[..., 1, :, :]``.
    """
    s = stft(x, nfft=nfft, hop=hop, pad_end=pad_end)
    return jnp.stack(
        [s.real.astype(jnp.float32), s.imag.astype(jnp.float32)], axis=-3
    )
