"""Streaming tier: chunked processing == one-shot, and checkpoint/resume."""
import numpy as np
import pytest

from dsp_audio_project_tpu import EQConfig, PipelineConfig, SRCConfig, process
from dsp_audio_project_tpu.config import KernelConfig
from dsp_audio_project_tpu.oracle import pipeline_oracle, snr_db
from dsp_audio_project_tpu.streaming import StreamProcessor, StreamState

from conftest import make_test_signal


def _run_stream(x, fs, cfg, chunks):
    sp = StreamProcessor(cfg, fs)
    outs = []
    pos = 0
    for c in chunks:
        outs.append(sp.process(x[pos : pos + c]))
        pos += c
    assert pos == len(x)
    outs.append(sp.flush())
    return np.concatenate([o for o in outs if len(o)])


@pytest.mark.parametrize("chunking", [
    [16384], [5000, 5000, 6384], [100, 16000, 284], [1] * 0 + [8192, 8192],
])
@pytest.mark.parametrize("L,M", [(3, 2), (1, 2), (2, 1)])
def test_stream_equals_oneshot(chunking, L, M):
    fs = 44100
    x = make_test_signal(16384, fs, seed=21)
    cfg = PipelineConfig(
        src=SRCConfig(L=L, M=M),
        eq=EQConfig.from_gains({"Bass": 6, "Presence": -4}),
        kernels=KernelConfig(iir_block=256),
    )
    want, _ = process(x, fs, cfg)
    got = _run_stream(x, fs, cfg, chunking)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5)


def test_stream_headline_config_vs_oracle():
    fs = 44100
    x = make_test_signal(30000, fs, seed=5)
    cfg = PipelineConfig(src=SRCConfig(L=160, M=147),
                         eq=EQConfig.from_gains({"Bass": 5}))
    got = _run_stream(x, fs, cfg, [7000, 7000, 7000, 9000])
    want, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq, engine="fast")
    assert got.shape == want.shape
    assert snr_db(want, got) > 60.0


def test_stream_checkpoint_resume():
    fs = 44100
    x = make_test_signal(20000, fs, seed=9)
    cfg = PipelineConfig(src=SRCConfig(L=2, M=3),
                         eq=EQConfig.from_gains({"Sub-Bass": 8}))

    # continuous run
    want = _run_stream(x, fs, cfg, [20000])

    # run half, serialize, resume in a fresh processor
    sp1 = StreamProcessor(cfg, fs)
    part1 = sp1.process(x[:11000])
    blob = sp1.state_bytes()
    assert isinstance(blob, bytes) and len(blob) < 100_000

    sp2 = StreamProcessor.resume(cfg, blob)
    part2 = sp2.process(x[11000:])
    tail = sp2.flush()
    got = np.concatenate([part1, part2, tail])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_stream_state_roundtrip():
    st = StreamState(
        samples_in=123, frames_done=7,
        src_carry=np.arange(5, dtype=np.float32),
        eq_state=np.ones(4, dtype=np.float32), fs=48000,
    )
    back = StreamState.from_bytes(st.to_bytes())
    assert back.samples_in == 123 and back.frames_done == 7 and back.fs == 48000
    np.testing.assert_array_equal(back.src_carry, st.src_carry)
    np.testing.assert_array_equal(back.eq_state, st.eq_state)


def test_stream_short_total_signal():
    # Total stream shorter than the SRC filter: one-shot geometry at flush.
    fs = 44100
    x = make_test_signal(40, fs, seed=2)
    cfg = PipelineConfig(src=SRCConfig(L=3, M=4))
    want, _ = process(x, fs, cfg)
    got = _run_stream(x, fs, cfg, [25, 15])
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_stream_bypass():
    fs = 48000
    x = make_test_signal(5000, fs, seed=1)
    cfg = PipelineConfig()
    got = _run_stream(x, fs, cfg, [2500, 2500])
    np.testing.assert_array_equal(got, x)


# ---- sharded streaming: chunk x shard invariance (BASELINE config 5) ----

def _sharded_cfg(L, M, iir_block=1024):
    return PipelineConfig(
        src=SRCConfig(L=L, M=M),
        eq=EQConfig.from_gains({"Bass": 6, "High Mids": -4}),
        kernels=KernelConfig(iir_block=iir_block),
    )


def _mesh(mc, mb):
    from dsp_audio_project_tpu.config import MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh

    return build_mesh(MeshConfig(channel_devices=mc, block_devices=mb))


def _stream_through(sp, x, chunking):
    outs, pos = [], 0
    n = x.shape[-1]
    for size in chunking:
        take = min(size, n - pos)
        if take <= 0:
            break
        outs.append(sp.process(x[:, pos : pos + take]))
        pos += take
    assert pos == n, "chunking must cover the signal"
    outs.append(sp.flush())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("mc,mb", [(1, 4), (2, 2), (4, 1), (1, 8)])
@pytest.mark.parametrize("L,M", [(3, 2), (160, 147)])
def test_sharded_stream_chunk_shard_invariance(L, M, mc, mb):
    """Any chunking x any mesh == the one-shot unsharded chain (>=110 dB)."""
    import jax.numpy as jnp

    from dsp_audio_project_tpu import AudioPipeline
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs, C, n = 44100, 2, 50000
    x = np.stack([make_test_signal(n, fs, seed=i) for i in range(C)])
    cfg = _sharded_cfg(L, M)
    z_ref = np.asarray(AudioPipeline(cfg).jit_forward()(jnp.asarray(x), fs)[0])

    sp = ShardedStreamProcessor(cfg, fs, _mesh(mc, mb), C)
    z = _stream_through(sp, x, [977, 3000, 16000, 9999, n])
    assert z.shape == z_ref.shape
    q = min(snr_db(z_ref[c], z[c]) for c in range(C))
    assert q > 110.0, f"mesh {mc}x{mb}: {q:.1f} dB"


def test_sharded_stream_chunking_invariance():
    """Different chunkings through the same mesh agree bit-for-bit (one
    compiled super-step executable; chunk boundaries only move host
    buffering)."""
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs, C, n = 44100, 2, 40000
    x = np.stack([make_test_signal(n, fs, seed=7 + i) for i in range(C)])
    cfg = _sharded_cfg(160, 147)
    mesh = _mesh(1, 4)
    z1 = _stream_through(ShardedStreamProcessor(cfg, fs, mesh, C), x, [n])
    z2 = _stream_through(
        ShardedStreamProcessor(cfg, fs, mesh, C), x, [1, 499, 12000, n]
    )
    np.testing.assert_array_equal(z1, z2)


def test_sharded_stream_checkpoint_resume():
    """state_bytes/resume mid-stream: the resumed stream continues exactly."""
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs, C, n = 44100, 2, 45000
    x = np.stack([make_test_signal(n, fs, seed=11 + i) for i in range(C)])
    cfg = _sharded_cfg(160, 147)
    mesh = _mesh(2, 2)

    full = _stream_through(
        ShardedStreamProcessor(cfg, fs, mesh, C), x, [20000, n]
    )
    sp1 = ShardedStreamProcessor(cfg, fs, mesh, C)
    part1 = sp1.process(x[:, :20000])
    blob = sp1.state_bytes()
    sp2 = ShardedStreamProcessor.resume(cfg, mesh, C, blob)
    part2 = np.concatenate(
        [sp2.process(x[:, 20000:]), sp2.flush()], axis=1
    )
    got = np.concatenate([part1, part2], axis=1)
    np.testing.assert_array_equal(full, got)


def test_sharded_stream_short_signal():
    """Stream shorter than the filter: the short-signal 'same' geometry
    falls back to the one-shot unsharded path at flush."""
    import jax.numpy as jnp

    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs, C = 44100, 2
    n = 30  # 30 * 160 < 6401 taps
    x = np.stack([make_test_signal(n, fs, seed=3 + i) for i in range(C)])
    cfg = _sharded_cfg(160, 147)
    sp = ShardedStreamProcessor(cfg, fs, _mesh(1, 4), C)
    z = np.concatenate([sp.process(x), sp.flush()], axis=1)
    want = np.stack([
        pipeline_oracle(x[c], fs, cfg.src, cfg.eq, engine="fast")[0]
        for c in range(C)
    ])
    assert z.shape == want.shape
    assert min(snr_db(want[c], z[c]) for c in range(C)) > 60.0


def test_sharded_stream_bypass_paths():
    """SRC-bypass (EQ only) and EQ-bypass (SRC only, unclipped) streams."""
    import jax.numpy as jnp

    from dsp_audio_project_tpu import AudioPipeline
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs, C, n = 44100, 2, 30000
    x = np.stack([make_test_signal(n, fs, seed=21 + i) for i in range(C)])
    mesh = _mesh(1, 4)

    cfg_eq = PipelineConfig(
        src=SRCConfig(L=1, M=1),
        eq=EQConfig.from_gains({"Bass": 6, "Presence": -9}),
        kernels=KernelConfig(iir_block=1024),
    )
    z_ref = np.asarray(
        AudioPipeline(cfg_eq).jit_forward()(jnp.asarray(x), fs)[0]
    )
    z = _stream_through(
        ShardedStreamProcessor(cfg_eq, fs, mesh, C), x, [7000, n]
    )
    assert min(snr_db(z_ref[c], z[c]) for c in range(C)) > 110.0

    cfg_src = PipelineConfig(
        src=SRCConfig(L=160, M=147), eq=EQConfig(),
        kernels=KernelConfig(iir_block=1024),
    )
    z_ref = np.asarray(
        AudioPipeline(cfg_src).jit_forward()(jnp.asarray(x), fs)[0]
    )
    z = _stream_through(
        ShardedStreamProcessor(cfg_src, fs, mesh, C), x, [12345, n]
    )
    assert min(snr_db(z_ref[c], z[c]) for c in range(C)) > 110.0


# ---- fused (frame-major) super-steps + dynamic gains ----------------------


def test_sharded_stream_fused_frames():
    """Frame-major super-step (the cat route: EQ-fused SRC inside the
    shard) == the one-shot flat chain and the one-shot frames route."""
    import jax.numpy as jnp

    from dsp_audio_project_tpu import AudioPipeline
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs, C, n = 44100, 2, 24000
    x = np.stack([make_test_signal(n, fs, seed=31 + i) for i in range(C)])
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147),
        eq=EQConfig.from_gains({"Bass": 6, "High Mids": -4}),
        kernels=KernelConfig(iir_block=1024),
    )
    mesh = _mesh(1, 2)
    sp = ShardedStreamProcessor(cfg, fs, mesh, C)
    assert sp._fused and sp._cat
    z = _stream_through(sp, x, [5000, 9000, n])

    pipe = AudioPipeline(cfg)
    z_ref = np.asarray(pipe.jit_forward()(jnp.asarray(x), fs)[0])
    assert z.shape == z_ref.shape
    q = min(snr_db(z_ref[c], z[c]) for c in range(C))
    assert q > 100.0, f"fused stream vs one-shot: {q:.1f} dB"

    # And against the one-shot frame-major route.
    zf = np.asarray(pipe.jit_forward_frames()(jnp.asarray(x), fs)[0])
    z_frames = zf.reshape(C, -1)[:, : z.shape[1]]
    q = min(snr_db(z_frames[c], z[c]) for c in range(C))
    assert q > 100.0, f"fused stream vs one-shot frames: {q:.1f} dB"


def _all_gains(vals):
    cfg = EQConfig()
    names = [nm for nm, _ in cfg.band_centers]
    return dict(zip(names, vals))


def test_sharded_stream_dynamic_matches_static():
    """Dynamic-mode stream (traced operators) == static-ops stream at the
    same gains (all six bands active so the band-skip semantics agree)."""
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs, C, n = 44100, 2, 30000
    gains = [6.0, -3.0, 2.0, 5.0, -7.0, 4.0]
    x = np.stack([make_test_signal(n, fs, seed=41 + i) for i in range(C)])
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147),
        eq=EQConfig.from_gains(_all_gains(gains)),
        kernels=KernelConfig(iir_block=1024),
    )
    mesh = _mesh(1, 2)
    z_static = _stream_through(
        ShardedStreamProcessor(cfg, fs, mesh, C), x, [8000, n]
    )
    sp = ShardedStreamProcessor(cfg, fs, mesh, C, gains_db=gains)
    assert sp._dynamic
    z_dyn = _stream_through(sp, x, [8000, n])
    assert z_dyn.shape == z_static.shape
    q = min(snr_db(z_static[c], z_dyn[c]) for c in range(C))
    assert q > 80.0, f"dynamic vs static stream: {q:.1f} dB"


def test_sharded_stream_set_gains_requires_dynamic():
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    cfg = _sharded_cfg(160, 147)
    sp = ShardedStreamProcessor(cfg, 44100, _mesh(1, 2), 1)
    with pytest.raises(RuntimeError):
        sp.set_gains([0.0] * 6)


def _seq_eq_quantized(y, gains, fs, s0):
    """Independent sequential oracle: the f32-quantized Schur cascade run
    sample by sample in float64 (state convention of ops/eq:
    y[n] = C s[n-1] + D x[n]; s[n] = A s[n-1] + B x[n])."""
    from dsp_audio_project_tpu.design.biquad import (
        cascade_state_space, peaking_coeffs, schur_form,
    )

    cfg = EQConfig()
    ceiling = (fs / 2.0) * cfg.nyquist_safety
    sections = []
    for (nm, fc), g in zip(cfg.band_centers, gains):
        fc_eff = ceiling if fc >= ceiling else fc
        sections.append(peaking_coeffs(fc_eff, fs, float(g), cfg.q))
    ss = schur_form(cascade_state_space(sections))
    A = ss.A.astype(np.float32).astype(np.float64)
    B = ss.B.astype(np.float32).astype(np.float64)
    C = ss.C.astype(np.float32).astype(np.float64)
    D = float(np.float32(ss.D))
    s = np.array(s0, np.float64)
    out = np.empty_like(y, dtype=np.float64)
    for i in range(len(y)):
        out[i] = C @ s + D * y[i]
        s = A @ s + B * y[i]
    return np.clip(out, -1.0, 1.0), s


def test_sharded_stream_midstream_gain_change():
    """set_gains at a super-step boundary: no recompile, carry passes
    through the change, and the result equals the segment-concat oracle
    (old gains to the boundary, new gains from the carried state after)."""
    import jax.numpy as jnp

    from dsp_audio_project_tpu.ops.src import resample
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs, C, n = 44100, 1, 40000
    gains_a = [6.0, -3.0, 2.0, 5.0, -7.0, 4.0]
    gains_b = [-2.0, 8.0, -5.0, 1.0, 3.0, -6.0]
    x = np.stack([make_test_signal(n, fs, seed=51)])
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147),
        eq=EQConfig.from_gains(_all_gains(gains_a)),
        kernels=KernelConfig(iir_block=1024),
    )
    mesh = _mesh(1, 2)
    sp = ShardedStreamProcessor(cfg, fs, mesh, C, gains_db=gains_a)
    fn_before = sp._fn
    part1 = sp.process(x[:, :22000])
    fn_mid = sp._fn
    sp.set_gains(gains_b)
    part2 = np.concatenate(
        [sp.process(x[:, 22000:]), sp.flush()], axis=1
    )
    assert sp._fn is fn_mid, "gain change must not rebuild the step"
    z = np.concatenate([part1, part2], axis=1)
    m = part1.shape[1]
    assert m % (sp._F_sup * sp._P) == 0, "change landed off a step boundary"

    fs_out = cfg.src.output_rate(fs)
    y = np.asarray(resample(jnp.asarray(x[0]), fs, cfg.src)[0],
                   dtype=np.float64)
    z1, s1 = _seq_eq_quantized(y[:m], gains_a, fs_out, np.zeros(12))
    z2, _ = _seq_eq_quantized(y[m:], gains_b, fs_out, s1)
    want = np.concatenate([z1, z2])
    assert z.shape == (C, want.shape[0])
    q = snr_db(want, z[0].astype(np.float64))
    assert q > 80.0, f"mid-stream change vs segment oracle: {q:.1f} dB"


def test_sharded_stream_dynamic_fused():
    """The full serving shape: dynamic gains + frame-major super-step
    (dynamic cat) agrees with the one-shot dynamic frames route."""
    import jax.numpy as jnp

    from dsp_audio_project_tpu import AudioPipeline
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs, C, n = 44100, 2, 20000
    gains = [4.0, -6.0, 3.0, 2.0, -2.0, 5.0]
    x = np.stack([make_test_signal(n, fs, seed=61 + i) for i in range(C)])
    cfg_p = PipelineConfig(
        src=SRCConfig(L=160, M=147),
        eq=EQConfig.from_gains(_all_gains(gains)),
        kernels=KernelConfig(iir_block=1024),
    )
    mesh = _mesh(1, 2)
    sp = ShardedStreamProcessor(cfg_p, fs, mesh, C, gains_db=gains)
    assert sp._cat_dyn
    z_p = _stream_through(sp, x, [9000, n])
    pipe = AudioPipeline(cfg_p)
    dops = pipe.dynamic_eq_operators(gains, fs, n, builder="host")
    zf, _ = pipe.jit_forward_frames_dynamic_ops()(jnp.asarray(x), dops, fs)
    z_x = np.asarray(zf).reshape(C, -1)[:, : z_p.shape[1]]
    assert z_p.shape == z_x.shape
    q = min(snr_db(z_x[c], z_p[c]) for c in range(C))
    assert q > 100.0, f"dynamic fused stream vs one-shot dynamic: {q:.1f} dB"
