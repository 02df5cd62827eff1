"""EQ-fused cat route: the SRC operator carries the EQ's first matmul
(G @ [group_fir^T | group_in], folded in float64 on host or on device for
dynamic gains), so the SRC emits the EQ's [y0 | inj] directly and
ops/eq.equalize_frames_cat finishes with the group-Toeplitz solve +
readout.  Gates:

  * cat route == frames route on the same config (both vs each other and
    vs the golden oracle) in fast AND full precision;
  * the spectra side-rows (z from row slices, y recomputed via
    ops/src.resample_rows) match the frames-route spectra;
  * resample_rows rows == resample's frames rows exactly;
  * dynamic-gains cat == static cat at equal gains.

Workload parity target: /root/reference/modules/dsp_core.py:133-254 and
app.py:162-167 (SRC -> EQ cascade with per-render spectra).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from dsp_audio_project_tpu import (
    AudioPipeline, EQConfig, PipelineConfig, SRCConfig,
)
from dsp_audio_project_tpu.config import KernelConfig
from dsp_audio_project_tpu.oracle import pipeline_oracle, snr_db

FS = 44100
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}


def make_x(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * rng.standard_normal(n)).astype(np.float32)
    return x / np.abs(x).max()


def make_pipe(fast: bool) -> AudioPipeline:
    return AudioPipeline(PipelineConfig(
        src=SRCConfig(L=160, M=147), eq=EQConfig.from_gains(GAINS),
        kernels=KernelConfig(eq_fast=fast, src_fast=fast),
    ))


@pytest.mark.parametrize("fast", [True, False])
def test_cat_matches_frames_and_oracle(fast):
    n = FS  # 1 s
    x = make_x(n)
    pipe = make_pipe(fast)
    assert pipe.cat_supported(n, FS)
    n_out = pipe.config.src.output_length(n)
    zf, _ = pipe._forward_frames(jnp.asarray(x), FS)
    zc = pipe._forward_cat(jnp.asarray(x), FS)
    assert zc.shape == zf.shape
    a = np.asarray(zf).reshape(-1)[:n_out]
    b = np.asarray(zc).reshape(-1)[:n_out]
    assert snr_db(a, b) > (95 if fast else 110)
    want, _ = pipeline_oracle(x, FS, pipe.config.src, pipe.config.eq,
                              engine="fast")
    assert snr_db(want, b) > 90


def test_cat_spectra_match_frames_path():
    n = 2 * FS
    x = make_x(n, seed=3)
    pipe = make_pipe(True)
    z, (mx, my, mz) = pipe._forward_cat_spectra(jnp.asarray(x), FS)
    zf, yf, (mx0, my0, mz0) = pipe._forward_frames_spectra(
        jnp.asarray(x), FS)
    assert snr_db(np.asarray(mx0), np.asarray(mx)) > 140  # same math
    assert snr_db(np.asarray(my0), np.asarray(my)) > 90
    assert snr_db(np.asarray(mz0), np.asarray(mz)) > 90
    # z itself also matches
    n_out = pipe.config.src.output_length(n)
    assert snr_db(np.asarray(zf).reshape(-1)[:n_out],
                  np.asarray(z).reshape(-1)[:n_out]) > 95


def test_cat_batched():
    n = FS
    xs = np.stack([make_x(n, seed=s) for s in range(3)])
    pipe = make_pipe(True)
    zc = pipe._forward_cat(jnp.asarray(xs), FS)
    zf, _ = pipe._forward_frames(jnp.asarray(xs), FS)
    assert zc.shape == zf.shape == (3,) + zf.shape[1:]
    for i in range(3):
        assert snr_db(np.asarray(zf[i]).ravel(),
                      np.asarray(zc[i]).ravel()) > 95


def test_resample_rows_match_frames():
    from dsp_audio_project_tpu.ops.src import (
        make_plan, resample_frames, resample_rows,
    )

    n = FS
    x = make_x(n, seed=5)
    plan = make_plan(160, 147)
    n_out = -(-n * 160 // 147)
    yf = resample_frames(jnp.asarray(x)[None], plan, n_out, pad_frames=True)
    for r0, r1 in ((0, 4), (100, 113), (270, 276)):
        rows = resample_rows(jnp.asarray(x)[None], plan, r0, r1)
        ref = np.asarray(yf)[:, r0:r1]
        got = np.asarray(rows)
        # same windows, same operator; HIGHEST both sides
        assert snr_db(ref.ravel(), got.ravel()) > 120


def test_cat_emission_matches_frames_times_w_cat():
    """The cat SRC's (y0, inj) equal the frames route's frames @ w_cat."""
    from dsp_audio_project_tpu.ops.eq import eq_cat_weights, make_block_operators
    from dsp_audio_project_tpu.ops.src import make_plan, resample_frames

    pipe = make_pipe(False)
    plan = make_plan(160, 147)
    fs_out = 48000
    cfg = EQConfig.from_gains(GAINS)
    ops = make_block_operators(cfg.active_bands(fs_out), fs_out, cfg.q,
                               128 * plan.P, plan.P)
    w_cat = eq_cat_weights(ops)
    d = ops.A.shape[0]
    x = make_x(FS, seed=9)
    n_out = -(-FS * 160 // 147)
    (y0, inj), _, _, _ = pipe._cat_pieces(jnp.asarray(x)[None], FS)
    frames = np.asarray(resample_frames(jnp.asarray(x)[None], plan, n_out,
                                        pad_frames=True), np.float64)
    cat_ref = frames @ w_cat
    F = frames.shape[1]
    assert y0.shape == (1, F, plan.P)
    assert inj.shape == (1, F, d)
    assert snr_db(cat_ref[..., :plan.P].ravel(), np.asarray(y0).ravel()) > 110
    assert snr_db(cat_ref[..., plan.P:].ravel(), np.asarray(inj).ravel()) > 110


def test_cat_rejects_wrong_geometry():
    from dsp_audio_project_tpu.ops.eq import equalize_frames_cat

    cfg = EQConfig.from_gains(GAINS)
    y0 = jnp.zeros((256, 160), jnp.float32)
    inj = jnp.zeros((256, 10), jnp.float32)
    with pytest.raises(ValueError):  # y0 width != unroll
        equalize_frames_cat(y0, inj, 48000, cfg, unroll=165)
    with pytest.raises(ValueError):  # F not multiple of 128
        equalize_frames_cat(jnp.zeros((100, 160), jnp.float32), inj,
                            48000, cfg, unroll=160)
    with pytest.raises(ValueError):  # inj shape mismatch
        equalize_frames_cat(y0, jnp.zeros((256, 12), jnp.float32),
                            48000, cfg, unroll=160)
    with pytest.raises(ValueError):  # bypass EQ
        equalize_frames_cat(y0, inj, 48000, EQConfig(), unroll=160)


def _run_stream(sp, xs, in_step, n):
    outs = []
    i = 0
    while (i + 1) * in_step <= n:
        outs.append(sp.process(xs[:, i * in_step:(i + 1) * in_step]))
        i += 1
    outs.append(sp.process(xs[:, i * in_step:]))
    outs.append(sp.flush())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_cat_streaming_matches_plain(mesh_shape):
    """Cat super-steps (EQ-fused SRC inside the shard) == plain fused
    super-steps."""
    from dsp_audio_project_tpu.config import KernelConfig, MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs = FS
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147), eq=EQConfig.from_gains(GAINS),
        kernels=KernelConfig(eq_fast=True, src_fast=True),
    )
    mc, mb = mesh_shape
    mesh = build_mesh(MeshConfig(channel_devices=mc, block_devices=mb))
    C, FL = 2, 1024
    n = 4 * fs
    rng = np.random.default_rng(7)
    xs = np.stack([make_x(n, seed=11),
                   (0.3 * rng.standard_normal(n)).astype(np.float32)])

    sp = ShardedStreamProcessor(cfg, fs, mesh, C, frames_per_shard=FL)
    assert sp._cat, "cat super-steps should engage on this config"
    in_step = mb * FL * sp._s
    z = _run_stream(sp, xs, in_step, n)

    sp2 = ShardedStreamProcessor(cfg, fs, mesh, C, frames_per_shard=FL)
    sp2._cat = False
    z2 = _run_stream(sp2, xs, in_step, n)
    assert z.shape == z2.shape
    assert snr_db(z2.ravel(), z.ravel()) > 95

    want, _ = pipeline_oracle(xs[0], fs, cfg.src, cfg.eq, engine="fast")
    m = min(len(want), z.shape[1])
    assert snr_db(want[:m], z[0][:m]) > 90


def test_cat_streaming_resume_bitwise():
    from dsp_audio_project_tpu.config import KernelConfig, MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs = FS
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147), eq=EQConfig.from_gains(GAINS),
        kernels=KernelConfig(eq_fast=True, src_fast=True),
    )
    mesh = build_mesh(MeshConfig(channel_devices=1, block_devices=1))
    C, FL = 2, 1024
    n = 3 * fs
    xs = np.stack([make_x(n, seed=21), make_x(n, seed=22)])
    sp_full = ShardedStreamProcessor(cfg, fs, mesh, C, frames_per_shard=FL)
    assert sp_full._cat
    in_step = FL * sp_full._s
    z_full = _run_stream(sp_full, xs, in_step, n)

    cut = 2 * in_step
    sp1 = ShardedStreamProcessor(cfg, fs, mesh, C, frames_per_shard=FL)
    p1 = sp1.process(xs[:, :cut])
    blob = sp1.state_bytes()
    sp2 = ShardedStreamProcessor.resume(cfg, mesh, C, blob,
                                        frames_per_shard=FL)
    assert sp2._cat
    p2 = np.concatenate([sp2.process(xs[:, cut:]), sp2.flush()], axis=1)
    resumed = np.concatenate([p1, p2], axis=1)
    assert resumed.shape == z_full.shape
    assert np.array_equal(z_full, resumed)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (8, 1)])
def test_cat_sharded_matches_fused(mesh_shape):
    """EQ-fused cat shards (the default route) == frame-major shards
    (the route when y is needed) == oracle across mesh splits."""
    from dsp_audio_project_tpu.config import KernelConfig, MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh
    from dsp_audio_project_tpu.parallel.pipeline import run_sharded

    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147), eq=EQConfig.from_gains(GAINS),
        kernels=KernelConfig(eq_fast=True, src_fast=True),
    )
    mc, mb = mesh_shape
    mesh = build_mesh(MeshConfig(channel_devices=mc, block_devices=mb))
    C = 2
    n = 4 * FS
    rng = np.random.default_rng(17)
    xs = np.stack([make_x(n, seed=31),
                   (0.3 * rng.standard_normal(n)).astype(np.float32)])
    z_cat, y_none, fs_out, sp = run_sharded(xs, FS, cfg, mesh)
    assert sp.route == "cat" and y_none is None
    z_f, _, _, sp_f = run_sharded(xs, FS, cfg, mesh, need_y=True)
    assert sp_f.route == "frames"
    z_cat, z_f = np.asarray(z_cat), np.asarray(z_f)
    assert z_cat.shape == z_f.shape
    assert snr_db(z_f.ravel(), z_cat.ravel()) > 95
    want, _ = pipeline_oracle(xs[0], FS, cfg.src, cfg.eq, engine="fast")
    assert snr_db(want[: z_cat.shape[1]], z_cat[0]) > 90


def test_dynamic_cat_matches_dynamic_frames():
    """Dynamic-gains cat serving: device-folded operator + cat finish ==
    the dynamic frames path == oracle."""
    pipe = make_pipe(True)
    cfg = pipe.config
    n = FS
    x = make_x(n, seed=61)
    n_out = cfg.src.output_length(n)
    names = [nm for nm, _ in cfg.eq.band_centers]
    g = np.asarray([float(GAINS.get(nm, 0.0)) for nm in names])
    dops = pipe.dynamic_eq_operators(g, FS, n, builder="host")
    fold = pipe.dynamic_cat_tables(dops)
    zc = pipe.jit_forward_cat_dynamic_ops()(jnp.asarray(x), dops, fold, FS)
    zf, _ = pipe.jit_forward_frames_dynamic_ops()(jnp.asarray(x), dops, FS)
    a = np.asarray(zf).reshape(-1)[:n_out]
    b = np.asarray(zc).reshape(-1)[:n_out]
    assert snr_db(a, b) > 95
    want, _ = pipeline_oracle(x, FS, cfg.src, cfg.eq, engine="fast")
    assert snr_db(want, b) > 90
    # a DIFFERENT gain vector through the same compiled functions
    g2 = np.asarray([float(((i * 5) % 25) - 12) for i in range(len(names))])
    dops2 = pipe.dynamic_eq_operators(g2, FS, n, builder="host")
    fold2 = pipe.dynamic_cat_tables(dops2)
    zc2 = pipe.jit_forward_cat_dynamic_ops()(
        jnp.asarray(x), dops2, fold2, FS)
    zf2, _ = pipe.jit_forward_frames_dynamic_ops()(jnp.asarray(x), dops2, FS)
    assert snr_db(np.asarray(zf2).reshape(-1)[:n_out],
                  np.asarray(zc2).reshape(-1)[:n_out]) > 95


def test_dynamic_cat_equals_static_cat_at_equal_gains():
    """The device-folded dynamic cat route reproduces the host-folded
    static cat route when the gains match."""
    pipe = make_pipe(True)
    cfg = pipe.config
    x = make_x(FS, seed=63)
    g = np.asarray([float(GAINS.get(nm, 0.0)) for nm, _ in cfg.eq.band_centers])
    dops = pipe.dynamic_eq_operators(g, FS, FS, builder="host")
    z_dyn = pipe.jit_forward_cat_dynamic_ops()(
        jnp.asarray(x), dops, pipe.dynamic_cat_tables(dops), FS)
    z_static = pipe.jit_forward_cat()(jnp.asarray(x), FS)
    assert z_dyn.shape == z_static.shape
    assert snr_db(np.asarray(z_static).ravel(), np.asarray(z_dyn).ravel()) > 100


def test_dynamic_cat_rejects_wrong_geometry():
    from dsp_audio_project_tpu.ops.eq_dynamic import equalize_dynamic_cat_ops

    pipe = make_pipe(True)
    g = np.zeros(len(pipe.config.eq.band_centers))
    dops = pipe.dynamic_eq_operators(g, FS, FS, builder="host")
    d = dops.group_in.shape[-1]
    with pytest.raises(ValueError):  # F not a multiple of the block
        equalize_dynamic_cat_ops(jnp.zeros((100, 160)), jnp.zeros((100, d)),
                                 dops)
    with pytest.raises(ValueError):  # inj shape mismatch
        equalize_dynamic_cat_ops(jnp.zeros((256, 160)),
                                 jnp.zeros((256, d + 1)), dops)
    F = 128 * dops.carry_w.shape[0] // d      # the geometry dops serve
    z = equalize_dynamic_cat_ops(jnp.zeros((F, 160)), jnp.zeros((F, d)), dops)
    assert z.shape == (F, 160)


def test_streaming_dynamic_cat_with_midstream_gain_change():
    """Dynamic-cat super-steps (operator folded on device per gain change)
    == plain dynamic super-steps, including a set_gains swap mid-stream."""
    from dsp_audio_project_tpu.config import KernelConfig, MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    fs = FS
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147), eq=EQConfig(),
        kernels=KernelConfig(eq_fast=True, src_fast=True),
    )
    mesh = build_mesh(MeshConfig(channel_devices=1, block_devices=2))
    C, FL = 2, 1024
    n = 4 * fs
    g0 = [6.0, -3.0, 0.0, 12.0, -15.0, 4.0]
    g1 = [0.0, 5.0, -5.0, 0.0, 8.0, -8.0]
    rng = np.random.default_rng(77)
    xs = (0.3 * rng.standard_normal((C, n))).astype(np.float32)

    def run(force_plain):
        sp = ShardedStreamProcessor(cfg, fs, mesh, C, frames_per_shard=FL,
                                    gains_db=g0)
        if force_plain:
            sp._cat_dyn = False
            sp._fn = None
        else:
            assert sp._cat_dyn
        in_step = 2 * FL * sp._s
        outs, i = [], 0
        while (i + 1) * in_step <= n:
            outs.append(sp.process(xs[:, i * in_step:(i + 1) * in_step]))
            i += 1
        sp.set_gains(g1)
        outs.append(sp.process(xs[:, i * in_step:]))
        outs.append(sp.flush())
        return np.concatenate(outs, axis=1)

    z_cat = run(False)
    z_ref = run(True)
    assert z_cat.shape == z_ref.shape
    assert snr_db(z_ref.ravel(), z_cat.ravel()) > 95


def test_streaming_explicit_small_frames_per_shard_still_works():
    """A small frames_per_shard (not 128-aligned) keeps working: the cat
    fold has no alignment requirement, so cat super-steps engage."""
    from dsp_audio_project_tpu.config import KernelConfig, MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147), eq=EQConfig.from_gains(GAINS),
        kernels=KernelConfig(eq_fast=True, src_fast=True),
    )
    mesh = build_mesh(MeshConfig(channel_devices=1, block_devices=1))
    sp = ShardedStreamProcessor(cfg, FS, mesh, 1, frames_per_shard=64)
    assert sp._cat and not sp._cat_dyn
    n = FS
    x = make_x(n, seed=91)[None]
    outs = [sp.process(x), sp.flush()]
    z = np.concatenate(outs, axis=1)
    want, _ = pipeline_oracle(x[0], FS, cfg.src, cfg.eq, engine="fast")
    m = min(len(want), z.shape[1])
    assert snr_db(want[:m], z[0][:m]) > 90


@pytest.mark.parametrize("rows", [(0, 13), (120, 140), (250, 263)])
def test_cat_rows_edges_match_full_output(rows):
    """The spectra side-rows (recomputed without materializing s_true)
    equal the corresponding full-output rows, including block-boundary
    crossings (r % 128 == 0 inside the range) and r0 = 0."""
    from dsp_audio_project_tpu.ops.eq import equalize_frames_cat

    pipe = make_pipe(True)
    n = FS
    x = make_x(n, seed=71)
    (y0, inj), plan, n_out, fs_out = pipe._cat_pieces(jnp.asarray(x), FS)
    cfg = pipe.config.eq
    z, z_rows = equalize_frames_cat(
        y0, inj, fs_out, cfg, unroll=plan.P, fast=True, rows=rows)
    r0, r1 = rows
    ref = np.asarray(z)[..., r0:r1, :]
    got = np.asarray(z_rows)
    assert got.shape == ref.shape
    # identical math on the same inputs -> float-exact
    assert snr_db(ref.ravel(), got.ravel()) > 130
