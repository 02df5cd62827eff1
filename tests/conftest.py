"""Test harness configuration.

Tests run on the platform JAX_PLATFORMS names (``cpu`` by default), with 8
virtual CPU devices so the shard_map paths run without several cards.  Tests
that need a GPU carry the ``gpu`` marker and skip elsewhere (tests/test_gpu.py).
Must run before anything touches a JAX backend — pytest imports conftest
first.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else
# <repo>/.jax_cache): repeated suite runs reuse the CPU compiles.
from dsp_audio_project_tpu.utils.compcache import enable as _enable_cache

_enable_cache()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_test_signal(n: int, fs: int, seed: int = 0) -> np.ndarray:
    """Deterministic broadband fixture: tones + sweep + noise, float32 in [-1,1].

    Synthesized because the reference's WAV fixtures were stripped from the
    mount (SURVEY.md file inventory)."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = (
        0.35 * np.sin(2 * np.pi * 440.0 * t)
        + 0.25 * np.sin(2 * np.pi * 40.0 * t + 0.3)
        + 0.15 * np.sin(2 * np.pi * 9800.0 * t + 1.1)
        + 0.15 * np.sin(2 * np.pi * (200.0 + 4000.0 * t / t[-1]) * t)
        + 0.1 * r.standard_normal(n)
    )
    x = x / np.max(np.abs(x))
    return x.astype(np.float32)


@pytest.fixture(scope="session")
def audio_44k():
    return make_test_signal(44100, 44100, seed=7), 44100


@pytest.fixture(scope="session")
def audio_short():
    return make_test_signal(4096, 48000, seed=3), 48000
