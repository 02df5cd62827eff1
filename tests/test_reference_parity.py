"""Golden-oracle vs. actual-reference parity.

Runs only where the reference checkout is mounted (/root/reference): imports
the reference's own modules and asserts our numpy oracle reproduces them
bit-for-bit (or to float noise).  This pins the oracle to the ground truth;
every other test then measures the device path against the oracle.
"""
import os
import sys

import numpy as np
import pytest

from dsp_audio_project_tpu.config import SRCConfig, SpectrumConfig
from dsp_audio_project_tpu import oracle

REF = "/root/reference"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "modules")),
    reason="reference checkout not mounted",
)


@pytest.fixture(scope="module")
def ref_core():
    # The reference imports soundfile (absent in this image) at module scope;
    # only its WAV-load path uses it, which these tests don't touch.
    import types

    if "soundfile" not in sys.modules:
        stub = types.ModuleType("soundfile")
        stub.read = None  # never called here
        sys.modules["soundfile"] = stub
    sys.path.insert(0, REF)
    try:
        from modules import dsp_core  # type: ignore
    finally:
        sys.path.pop(0)
    return dsp_core


def _sig(n=20000, fs=44100, seed=5):
    r = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * r.standard_normal(n)
    return (x / np.max(np.abs(x))).astype(np.float32)


@pytest.mark.parametrize("L,M", [(2, 1), (1, 2), (3, 4), (8, 7), (2, 2)])
def test_src_oracle_matches_reference(ref_core, L, M):
    x = _sig()
    want, fs_want = ref_core.conversion_tasa_muestreo(x, 44100, M, L)
    got, fs_got = oracle.resample_oracle(x, 44100, SRCConfig(L=L, M=M))
    assert fs_got == fs_want
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_src_oracle_bypass(ref_core):
    x = _sig(1000)
    want, fsw = ref_core.conversion_tasa_muestreo(x, 44100, 1, 1)
    got, fsg = oracle.resample_oracle(x, 44100, SRCConfig(L=1, M=1))
    assert fsg == fsw and np.array_equal(got, want)


@pytest.mark.parametrize(
    "gains",
    [
        {"Sub-Bass": 6, "Bass": -3, "Low Mids": 0, "High Mids": 12,
         "Presence": -15, "Brilliance": 4},
        {"Sub-Bass": 0, "Bass": 0, "Low Mids": 0, "High Mids": 0,
         "Presence": 0, "Brilliance": 0},
        {"Sub-Bass": 15, "Bass": 15, "Low Mids": 15, "High Mids": 15,
         "Presence": 15, "Brilliance": 15},
    ],
)
def test_eq_oracle_matches_reference(ref_core, gains):
    x = _sig(30000)
    want = ref_core.sistema_ecualizador(x, 44100, gains)
    got = oracle.equalize_oracle_gains(x, 44100, gains)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_eq_oracle_nyquist_clamp(ref_core):
    # At fs=8000, Brilliance (10 kHz) and Presence (5 kHz) exceed 0.9*Nyquist.
    x = _sig(8000, fs=8000)
    gains = {"Sub-Bass": 0, "Bass": 0, "Low Mids": 3, "High Mids": 5,
             "Presence": 5, "Brilliance": -7}
    want = ref_core.sistema_ecualizador(x, 8000, gains)
    got = oracle.equalize_oracle_gains(x, 8000, gains)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [1000, 2048, 5000, 100000])
def test_spectrum_oracle_matches_reference(ref_core, n):
    x = _sig(n)
    fw, mw = ref_core.calcular_espectro_magnitud(x, 44100)
    fg, mg = oracle.spectrum_oracle(x, 44100, SpectrumConfig())
    np.testing.assert_allclose(fg, fw, rtol=0, atol=0)
    # Reference uses its hand-rolled recursive FFT; ours uses np.fft —
    # agreement to ~1e-5 relative (SURVEY.md §6 measured 3.4e-6).
    np.testing.assert_allclose(mg, mw, rtol=1e-4, atol=1e-3)


def test_load_matches_reference_semantics(tmp_path):
    from dsp_audio_project_tpu.io.signal_io import load_signal
    from dsp_audio_project_tpu.io.wavio import write_wav

    r = np.random.default_rng(0)
    stereo = (r.standard_normal((500, 2)) * 8000).astype(np.int16)
    p = tmp_path / "t.wav"
    write_wav(str(p), 22050, stereo)
    x, fs = load_signal(str(p))
    assert fs == 22050 and x.dtype == np.float32
    # mono mean then peak-normalized
    want = stereo.astype(np.float64).mean(axis=1) / 32768.0
    want = (want / np.max(np.abs(want))).astype(np.float32)
    np.testing.assert_allclose(x, want, atol=2e-7)


def test_load_failure_fallback():
    from dsp_audio_project_tpu.io.signal_io import load_signal

    x, fs = load_signal(b"not a wav at all")
    assert fs == 44100 and x.shape == (100,) and not x.any()
