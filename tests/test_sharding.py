"""Distributed tier: sharded pipeline vs single-device results.

Runs on the 8-virtual-device CPU mesh (conftest).  The gate (SURVEY.md §4):
sharded outputs must be bit-identical-or-better than 60 dB vs the unsharded
path at EVERY shard count — halo or carry off-by-ones degrade SNR silently,
so these tests are the tripwire.
"""
import numpy as np
import pytest

from dsp_audio_project_tpu import EQConfig, PipelineConfig, SRCConfig
from dsp_audio_project_tpu.config import KernelConfig, MeshConfig
from dsp_audio_project_tpu.oracle import pipeline_oracle, snr_db
from dsp_audio_project_tpu.parallel.mesh import build_mesh
from dsp_audio_project_tpu.parallel.pipeline import run_sharded

from conftest import make_test_signal

GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15}


def _config(L, M, gains=GAINS):
    return PipelineConfig(
        src=SRCConfig(L=L, M=M),
        eq=EQConfig.from_gains(gains),
        kernels=KernelConfig(iir_block=256),
    )


@pytest.mark.parametrize("nblocks", [1, 2, 4, 8])
def test_block_shard_invariance(nblocks):
    fs = 44100
    x = make_test_signal(40000, fs, seed=11)
    cfg = _config(3, 2)
    mesh = build_mesh(MeshConfig(channel_devices=1, block_devices=nblocks))
    z, y, fs_out, _ = run_sharded(x, fs, cfg, mesh)
    want, fs_want = pipeline_oracle(x, fs, cfg.src, cfg.eq)
    z = np.asarray(z)[0]
    assert fs_out == fs_want
    assert z.shape == want.shape
    assert snr_db(want, z) > 60.0


def test_headline_config_sharded():
    # 44.1k -> 48k, 6-band EQ, 8-way time sharding (BASELINE.json config 4/5).
    fs = 44100
    x = make_test_signal(44100, fs, seed=2)
    cfg = _config(160, 147)
    mesh = build_mesh(MeshConfig(channel_devices=1, block_devices=8))
    z, y, fs_out, _ = run_sharded(x, fs, cfg, mesh)
    want, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq)
    assert fs_out == 48000
    assert snr_db(want, np.asarray(z)[0]) > 60.0


def test_channel_and_block_mesh():
    fs = 44100
    c, n = 4, 20000
    x = np.stack([make_test_signal(n, fs, seed=s) for s in range(c)])
    cfg = _config(2, 3)
    mesh = build_mesh(MeshConfig(channel_devices=2, block_devices=4))
    z, y, fs_out, _ = run_sharded(x, fs, cfg, mesh)
    z = np.asarray(z)
    for ch in range(c):
        want, _ = pipeline_oracle(x[ch], fs, cfg.src, cfg.eq)
        assert z[ch].shape == want.shape
        assert snr_db(want, z[ch]) > 60.0


def test_sharded_equals_unsharded_bitwise_fir():
    """With EQ bypassed, the sharded FIR must match the single-shard run
    almost exactly (same matmul geometry, zero halo semantics)."""
    fs = 48000
    x = make_test_signal(30000, fs, seed=9)
    cfg = _config(2, 1, gains={})
    mesh1 = build_mesh(MeshConfig(channel_devices=1, block_devices=1))
    mesh8 = build_mesh(MeshConfig(channel_devices=1, block_devices=8))
    z1, *_ = run_sharded(x, fs, cfg, mesh1)
    z8, *_ = run_sharded(x, fs, cfg, mesh8)
    np.testing.assert_allclose(np.asarray(z1), np.asarray(z8), atol=1e-6)


@pytest.mark.parametrize("nblocks", [2, 4])
def test_fused_sharded_matches_oracle(nblocks):
    """Frame-major shards (the cat route by default, the frames route when
    y is needed) match the oracle and the unsharded flat route."""
    import jax.numpy as jnp

    from dsp_audio_project_tpu import AudioPipeline

    fs = 44100
    x = make_test_signal(44100, fs, seed=13)
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147),
        eq=EQConfig.from_gains(GAINS),
        kernels=KernelConfig(iir_block=256),
    )
    mesh = build_mesh(MeshConfig(channel_devices=1, block_devices=nblocks))
    z, y, fs_out, sp = run_sharded(x, fs, cfg, mesh)
    assert sp.route == "cat" and y is None
    want, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq)
    assert fs_out == 48000
    z = np.asarray(z)[0]
    assert z.shape == want.shape
    assert snr_db(want, z) > 60.0
    z_ref, y_ref = AudioPipeline(cfg).jit_forward()(jnp.asarray(x), fs)
    assert snr_db(np.asarray(z_ref), z) > 110.0
    z_f, y_f, _, sp_f = run_sharded(x, fs, cfg, mesh, need_y=True)
    assert sp_f.route == "frames"
    assert snr_db(np.asarray(z_ref), np.asarray(z_f)[0]) > 110.0
    assert snr_db(np.asarray(y_ref), np.asarray(y_f)[0]) > 110.0


def test_eq_bypass_sharded():
    fs = 44100
    x = make_test_signal(16000, fs, seed=4)
    cfg = _config(1, 2, gains={})
    mesh = build_mesh(MeshConfig(channel_devices=1, block_devices=4))
    z, y, fs_out, _ = run_sharded(x, fs, cfg, mesh)
    want, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq)
    assert snr_db(want, np.asarray(z)[0]) > 60.0
