"""Spectrum FFTs: XLA's FFT (cuFFT on the GPU) behind the reference's rules.

The reference computes spectra with a *recursive Python* radix-2 DIT FFT
(dsp_core.py:41-66) — O(N log N) flops buried under ~2N interpreter frames
— and raises on non-power-of-two sizes.  Here every spectrum runs XLA's
own FFT, which beat a vectorized butterfly port of that algorithm on the
H100 at every size the spectra and spectrograms use (N = 2048 to 1048576);
the power-of-two rule stays where the reference enforces it.
"""
from __future__ import annotations

import jax.numpy as jnp


def check_pow2(n: int) -> int:
    """log2(n); raises ValueError unless n is a power of two (the
    reference's FFT constraint; its callers zero-pad, dsp_core.py:81-82)."""
    if n <= 0 or (n & (n - 1)) != 0:
        raise ValueError(f"FFT size must be a power of two, got {n}")
    return n.bit_length() - 1


def fft_magnitude(x: jnp.ndarray) -> jnp.ndarray:
    """|FFT(x)| over the last axis (power-of-two length), batched."""
    check_pow2(x.shape[-1])
    return jnp.abs(jnp.fft.fft(x.astype(jnp.complex64), axis=-1))


def rfft_magnitude(x: jnp.ndarray) -> jnp.ndarray:
    """|rfft(x)| over the last axis — the spectrum ops' workhorse: bins
    0..N//2 of the reference's spectrum math (dsp_core.py:41-66, 96-98)."""
    return jnp.abs(jnp.fft.rfft(x.astype(jnp.float32), axis=-1))
