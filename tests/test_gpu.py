"""Tests that need an NVIDIA GPU (``-m gpu``); they skip elsewhere.

Whether a card is present is decided inside the ``gpu`` fixture, never at
import, so every pytest worker collects the same tests.  chip_smoke.py runs
them on the card before its own phases.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dsp_audio_project_tpu.utils.precision import FAST

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


# (einsum, lhs shape, rhs shape) of the main path's matmuls at small batch:
# SRC shifted matmul, EQ weight concat, group-Toeplitz solve, readout.
MAIN_PATH_DOTS = [
    ("bks,sp->bkp", (2, 512, 147), (147, 160)),
    ("bkgu,uv->bkgv", (2, 4, 128, 160), (160, 170)),
    ("bkx,xy->bky", (2, 4, 1280), (1280, 1280)),
    ("bkgd,du->bkgu", (2, 4, 128, 10), (10, 160)),
]


@pytest.mark.parametrize("sub,sa,sb", MAIN_PATH_DOTS)
def test_fast_preset_is_bf16x3_not_tf32(gpu, sub, sa, sb):
    """The GPU compiles BF16_BF16_F32_X3 for each main-path dot shape and
    it keeps ~16 mantissa bits; TF32 (10 bits) would miss the bound."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(sa).astype(np.float32)
    b = (0.1 * rng.standard_normal(sb)).astype(np.float32)
    got = np.asarray(jax.jit(lambda u, v: jnp.einsum(
        sub, u, v, precision=FAST, preferred_element_type=jnp.float32))(a, b))
    want = np.einsum(sub, a.astype(np.float64), b.astype(np.float64))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-5, rel


def test_deviceprof_reads_gpu_trace(gpu):
    from dsp_audio_project_tpu.utils.deviceprof import trace_device

    a = jnp.ones((2048, 2048), jnp.float32)
    f = jax.jit(lambda v: v @ v)
    f(a).block_until_ready()
    _, prof = trace_device(lambda: f(a))
    assert prof.n_events > 0 and prof.busy_ns > 0
    assert 0.0 <= prof.idle_share < 1.0


def test_headline_routes_agree_on_gpu(gpu):
    """1 s of the headline chain: the cat and frames routes agree and
    match the oracle in fast mode on the card."""
    from dsp_audio_project_tpu import (
        AudioPipeline, EQConfig, PipelineConfig, SRCConfig,
    )
    from dsp_audio_project_tpu.config import KernelConfig
    from dsp_audio_project_tpu.oracle import pipeline_oracle, snr_db

    from conftest import make_test_signal

    fs = 44100
    x = make_test_signal(fs, fs, seed=5)
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147),
        eq=EQConfig.from_gains({"Sub-Bass": 6, "Bass": -3, "High Mids": 12,
                                "Presence": -15, "Brilliance": 4}),
        kernels=KernelConfig(eq_fast=True, src_fast=True),
    )
    pipe = AudioPipeline(cfg)
    n_out = cfg.src.output_length(fs)
    zc = np.asarray(pipe.jit_forward_cat()(jnp.asarray(x), fs)).reshape(-1)
    zf, _ = pipe.jit_forward_frames()(jnp.asarray(x), fs)
    zf = np.asarray(zf).reshape(-1)
    want, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq, engine="fast")
    assert snr_db(want, zc[:n_out]) > 80.0
    assert snr_db(want, zf[:n_out]) > 80.0
