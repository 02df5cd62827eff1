"""Unit tier: FFT ops vs numpy oracle (SURVEY.md §4)."""
import numpy as np
import pytest
import jax.numpy as jnp

from dsp_audio_project_tpu.ops.fft import (
    check_pow2, fft_magnitude, rfft_magnitude,
)
from dsp_audio_project_tpu.ops.spectrum import angular_spectrum


@pytest.mark.parametrize("n", [1, 2, 8, 256, 2048])
def test_fft_matches_numpy(n, rng):
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    got = np.asarray(fft_magnitude(jnp.asarray(x, dtype=jnp.complex64)))
    want = np.abs(np.fft.fft(x, axis=-1))
    scale = max(1.0, np.max(want))
    assert np.max(np.abs(got - want)) / scale < 1e-5


@pytest.mark.parametrize("n", [2, 1024, 2048])
def test_rfft_matches_numpy(n, rng):
    x = rng.standard_normal((5, n)).astype(np.float32)
    got = np.asarray(rfft_magnitude(jnp.asarray(x)))
    want = np.abs(np.fft.rfft(x, axis=-1))
    assert got.shape == want.shape
    scale = np.max(want)
    assert np.max(np.abs(got - want)) / scale < 1e-5


def test_rfft_magnitude_batched(rng):
    x = rng.standard_normal((5, 1024)).astype(np.float32)
    got = np.asarray(rfft_magnitude(jnp.asarray(x)))
    want = np.abs(np.fft.rfft(x, axis=-1))
    assert np.max(np.abs(got - want)) / np.max(want) < 1e-5


@pytest.mark.parametrize("n", [1, 2, 1024, 1 << 20])
def test_check_pow2_log2(n):
    assert check_pow2(n) == int(np.log2(n))


@pytest.mark.parametrize("lead", [(), (2,), (3, 2), (1, 1, 4)])
def test_fft_batched_leading_dims(lead, rng):
    shape = lead + (512,)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    got = np.asarray(fft_magnitude(jnp.asarray(x, jnp.complex64)))
    want = np.abs(np.fft.fft(x))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(want) < 1e-5


@pytest.mark.parametrize("n", [512, 1024, 2048])
def test_angular_spectrum_matches_numpy(n, rng):
    """The two-sided view is |fftshift(FFT)| over [-pi, pi), like the
    reference's np.fft.fft + fftshift (app.py:322-327)."""
    x = rng.standard_normal((4, n)).astype(np.float32)
    w, mag = angular_spectrum(jnp.asarray(x))
    want = np.abs(np.fft.fftshift(np.fft.fft(x, axis=-1), axes=-1))
    assert w.shape == (n,) and mag.shape == (4, n)
    assert np.max(np.abs(np.asarray(mag) - want)) / np.max(want) < 1e-5


def test_non_pow2_rejected():
    # The reference FFT crashes with a broadcast error on non-pow2 input
    # (SURVEY.md C2); the build rejects cleanly instead.
    with pytest.raises(ValueError, match="power of two"):
        fft_magnitude(jnp.zeros(12, dtype=jnp.complex64))
    with pytest.raises(ValueError, match="power of two"):
        angular_spectrum(jnp.zeros(12, dtype=jnp.float32))


def test_rfft_magnitude_one_million():
    """Long-window spectrum size: N = 1048576 parity."""
    rng = np.random.default_rng(5)
    n = 1 << 20
    x = rng.standard_normal((2, n)).astype(np.float32)
    got = np.asarray(rfft_magnitude(jnp.asarray(x)))
    want = np.abs(np.fft.rfft(x))
    assert got.shape == (2, n // 2 + 1)
    assert np.max(np.abs(got - want)) / np.max(want) < 1e-4
