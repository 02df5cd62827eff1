#!/usr/bin/env python3
"""Smoke run of the main path on one NVIDIA GPU (``--four``: four GPUs).

    python chip_smoke.py          # one card: the phases below
    python chip_smoke.py --four   # four cards: the sharded paths only

Run from the repository root.  One card, in order:

1. the ``gpu``-marked tests, in a child pytest that runs before this process
   opens the card (one process holds the card at a time);
2. the device check — JAX platform ``gpu``, its device kind and count, and
   the card's name and power limit from nvidia-smi — failing at once on
   any other platform;
3. the headline program (44.1 -> 48 kHz SRC, 5-band EQ, spectra of x, y
   and z; 60 s signals, batch 8) compiled, with its memory analysis;
4. every entry point of the main path at that size, each gated at >= 60 dB
   SNR against the golden oracle: static full precision, static fast, the
   spectra, dynamic gains with host-built and with traced (df32) operators
   across one gain change, streaming on a 1x1 mesh with a gain change, and
   the CLI;
5. device time per stage (SRC, EQ, spectra) from a profiler trace, beside
   the share of the stage's shape-computed bound at the copy bandwidth and
   bf16 GEMM rate measured in the same run.

The configuration, signals and oracle gates live in
dsp_audio_project_tpu/headline.py, shared with bench.py.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}},
printed only when every phase passed; any failure exits non-zero without it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from dsp_audio_project_tpu.headline import (  # noqa: E402
    BATCH, FS, GAINS, GAINS_2, SECONDS, Oracle, flat, gains_vector, gate,
    headline_config, log, make_signals, min_snr, nvidia_smi,
)
from dsp_audio_project_tpu.utils.deviceprof import (  # noqa: E402
    device_ms, device_profile,
)

INVARIANCE_DB = 110.0


def run_gpu_tests() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
         "-p", "no:cacheprovider"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = "\n".join(proc.stdout.strip().splitlines()[-15:])
    log(f"[gpu tests] exit {proc.returncode}\n{tail}")
    if proc.returncode != 0:
        raise RuntimeError(f"gpu-marked tests failed:\n{proc.stderr[-3000:]}")


# ---- phase 3-4: the main path at full size ----------------------------------

def compile_headline(x_dev) -> None:
    from dsp_audio_project_tpu import AudioPipeline

    pipe = AudioPipeline(headline_config(fast=True))
    t0 = time.perf_counter()
    compiled = pipe.jit_forward_cat_spectra().lower(x_dev, FS).compile()
    log(f"[compile] headline cat-route program ({pipe.route(x_dev.shape[-1], FS)}"
        f"): {time.perf_counter() - t0:.2f} s")
    log(f"[compile] memory_analysis: {compiled.memory_analysis()}")


def static_phases(x, x_dev, oracle) -> None:
    from dsp_audio_project_tpu import AudioPipeline
    from dsp_audio_project_tpu.oracle import snr_db, spectrum_oracle

    cfg = headline_config(fast=False)
    n = x.shape[-1]
    n_out = cfg.src.output_length(n)
    fs_out = cfg.src.output_rate(FS)
    cap = cfg.spectrum.analysis_limit
    z_want = oracle.z(GAINS)
    spec_want = [
        np.stack([spectrum_oracle(s[:cap], r)[1] for s in sig])
        for sig, r in ((x, FS), (oracle.y, fs_out), (z_want, fs_out))
    ]

    def gate_spectra(name, mags):
        q = min(min(snr_db(w, g) for w, g in zip(want, np.asarray(m)))
                for want, m in zip(spec_want, mags))
        gate(f"{name} spectra x/y/z", q)

    log("[static full precision]")
    pipe = AudioPipeline(cfg)
    out = pipe(x_dev, FS, with_spectra=True)
    gate(f"AudioPipeline.__call__ (route "
         f"{pipe.route(n, FS, need_y=True)}) z",
         min_snr(z_want, np.asarray(out.output)))
    gate("AudioPipeline.__call__ y", min_snr(oracle.y, np.asarray(out.resampled)))
    gate_spectra("AudioPipeline.__call__",
                 [out.spectra[k][1] for k in ("input", "resampled", "output")])
    z, y, mags = pipe.jit_forward_spectra()(x_dev, FS)
    gate("jit_forward_spectra (flat route) z", min_snr(z_want, np.asarray(z)))
    gate_spectra("jit_forward_spectra", mags)
    z = pipe.jit_forward_cat()(x_dev, FS)
    gate("jit_forward_cat z", min_snr(z_want, flat(z, n_out)))

    log("[static fast: bf16x3 dot algorithm]")
    pipe = AudioPipeline(headline_config(fast=True))
    zf, yf = pipe.jit_forward_frames()(x_dev, FS)
    gate("jit_forward_frames z", min_snr(z_want, flat(zf, n_out)))
    gate("jit_forward_frames y", min_snr(oracle.y, flat(yf, n_out)))
    zf, yf, mags = pipe.jit_forward_frames_spectra()(x_dev, FS)
    gate("jit_forward_frames_spectra z", min_snr(z_want, flat(zf, n_out)))
    gate_spectra("jit_forward_frames_spectra", mags)
    z = pipe.jit_forward_cat()(x_dev, FS)
    gate("jit_forward_cat z", min_snr(z_want, flat(z, n_out)))
    z, mags = pipe.jit_forward_cat_spectra()(x_dev, FS)
    gate("jit_forward_cat_spectra z", min_snr(z_want, flat(z, n_out)))
    gate_spectra("jit_forward_cat_spectra", mags)


def dynamic_phases(x, x_dev, oracle) -> None:
    import jax
    import jax.numpy as jnp

    from dsp_audio_project_tpu import AudioPipeline

    cfg = headline_config(fast=True)
    pipe = AudioPipeline(cfg)
    n = x.shape[-1]
    n_out = cfg.src.output_length(n)
    fwd_frames = pipe.jit_forward_frames_dynamic_ops()
    fwd_cat = pipe.jit_forward_cat_dynamic_ops()
    for builder in ("host", "traced"):
        log(f"[dynamic gains, {builder}-built operators]")
        for gains in (GAINS, GAINS_2):
            g = gains_vector(cfg, gains)
            if builder == "traced":
                g = jnp.asarray(g, jnp.float32)
            t0 = time.perf_counter()
            dops = pipe.dynamic_eq_operators(g, FS, n, builder=builder)
            fold = pipe.dynamic_cat_tables(dops)
            jax.block_until_ready((dops, fold))
            change_ms = (time.perf_counter() - t0) * 1e3
            want = oracle.z(gains)
            zf, _ = fwd_frames(x_dev, dops, FS)
            zc = fwd_cat(x_dev, dops, fold, FS)
            tag = "gains 1" if gains is GAINS else "gains 2 (change)"
            log(f"  {tag}: operator build + fold {change_ms:.1f} ms wall "
                f"(first call compiles)")
            gate(f"{builder} {tag} jit_forward_frames_dynamic_ops",
                 min_snr(want, flat(zf, n_out)))
            gate(f"{builder} {tag} jit_forward_cat_dynamic_ops",
                 min_snr(want, flat(zc, n_out)))
        if fwd_frames._cache_size() != 1 or fwd_cat._cache_size() != 1:
            raise RuntimeError("a gain change recompiled the per-batch program")
    log("[dynamic gains, in-graph operators]")
    fwd = pipe.jit_forward_frames_dynamic()
    zf, _ = fwd(x_dev, jnp.asarray(gains_vector(cfg, GAINS_2), jnp.float32), FS)
    gate("jit_forward_frames_dynamic z", min_snr(oracle.z(GAINS_2), flat(zf, n_out)))


def streaming_phase(x, oracle, frames_per_step: int = 2048) -> None:
    """ShardedStreamProcessor on a 1x1 mesh, all channels, dynamic gains
    with one set_gains: before the change the stream must match the oracle
    at the first gains; from one second after it, the oracle at the second
    (the EQ's state decays in a few ms)."""
    from dsp_audio_project_tpu.config import MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    log("[streaming: 1x1 mesh, dynamic gains, one set_gains]")
    cfg = headline_config(fast=True)
    mesh = build_mesh(MeshConfig(channel_devices=1, block_devices=1))
    sp = ShardedStreamProcessor(cfg, FS, mesh, x.shape[0],
                                frames_per_shard=frames_per_step,
                                gains_db=gains_vector(cfg, GAINS))
    step = frames_per_step * sp._s
    n = x.shape[-1]
    n_steps = n // step
    change_at = n_steps // 2
    outs, times = [], []
    for i in range(n_steps):
        if i == change_at:
            sp.set_gains(gains_vector(cfg, GAINS_2))
        t0 = time.perf_counter()
        outs.append(sp.process(x[:, i * step:(i + 1) * step]))
        times.append(time.perf_counter() - t0)
    outs.append(sp.process(x[:, n_steps * step:]))
    outs.append(sp.flush())
    z = np.concatenate(outs, axis=1)
    steady = times[2:]  # the first call emits nothing, the second compiles
    log(f"  {n_steps} super-steps of {frames_per_step} frames "
        f"(cat={sp._cat_dyn}); steady wall per step: median "
        f"{np.median(steady) * 1e3:.2f} ms over {len(steady)} steps")
    if len(steady) < 4:
        raise RuntimeError("fewer than 4 steady super-steps")
    n_out = cfg.src.output_length(n)
    if z.shape != (x.shape[0], n_out):
        raise RuntimeError(f"stream output {z.shape} != {(x.shape[0], n_out)}")
    cut = sum(o.shape[1] for o in outs[:change_at])
    settle = cfg.src.output_rate(FS)
    want1, want2 = oracle.z(GAINS), oracle.z(GAINS_2)
    gate("stream before set_gains", min_snr(want1[:, :cut], z[:, :cut]))
    gate("stream 1 s after set_gains",
         min_snr(want2[:, cut + settle:], z[:, cut + settle:]))


def cli_phase(oracle_cfg_src) -> None:
    from dsp_audio_project_tpu import EQConfig
    from dsp_audio_project_tpu.cli import main as cli_main
    from dsp_audio_project_tpu.io.wavio import read_wav, write_wav
    from dsp_audio_project_tpu.oracle import pipeline_oracle, snr_db

    log("[CLI: 3 s stereo WAV, --expand 160 --decimate 147 --gain Bass=6]")
    fs = 44100
    t = np.arange(3 * fs) / fs
    x = np.stack([0.8 * np.sin(2 * np.pi * 440 * t),
                  0.5 * np.sin(2 * np.pi * 40 * t)], 1)
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "in.wav"), os.path.join(td, "out.wav")
        spec = os.path.join(td, "spec.json")
        write_wav(src, fs, (x * 32000).astype(np.int16))
        rc = cli_main([src, dst, "--expand", "160", "--decimate", "147",
                       "--gain", "Bass=6", "--no-ui-bounds",
                       "--spectra", spec])
        if rc != 0:
            raise RuntimeError(f"CLI exit code {rc}")
        y, fs_y = read_wav(dst)
        with open(spec) as fh:
            keys = sorted(json.load(fh))
    if fs_y != 48000 or len(y) != 144000:
        raise RuntimeError(f"CLI wrote {len(y)} samples @ {fs_y} Hz")
    # The CLI peak-normalizes its input (mono mix) and its output WAV.
    mono = (x * 32000).astype(np.int16).astype(np.float64).mean(1)
    want, _ = pipeline_oracle(mono / np.max(np.abs(mono)), fs,
                              oracle_cfg_src, EQConfig.from_gains({"Bass": 6}),
                              engine="fast")
    got = np.asarray(y, np.float64).reshape(-1)
    log(f"  wrote {len(y)} samples @ {fs_y} Hz, spectra {keys}")
    gate("CLI output (16-bit WAV)", snr_db(want / np.max(np.abs(want)),
                                           got / np.max(np.abs(got))))


# ---- phase 5-6: device time ---------------------------------------------------

def measure_ceilings():
    """Copy bandwidth and bf16 GEMM rate reached on this card, this run."""
    import jax
    import jax.numpy as jnp

    a = jnp.ones((1 << 28,), jnp.float32)               # 1 GiB
    copy_ms = device_ms(jax.jit(lambda v: v * 2.0), a)
    copy_bps = 2 * a.nbytes / (copy_ms / 1e3)
    m = 8192
    b = jnp.ones((m, m), jnp.bfloat16)
    gemm_ms = device_ms(jax.jit(
        lambda u, v: jnp.matmul(u, v, preferred_element_type=jnp.float32)), b, b)
    gemm_fps = 2 * m ** 3 / (gemm_ms / 1e3)
    return copy_bps, gemm_fps


def stage_shapes(x_shape):
    """Shape-computed flops and bytes of each headline stage (fast mode:
    the bf16x3 dot algorithm issues three bf16 products per matmul)."""
    from dsp_audio_project_tpu.ops.src import frame_count, make_plan

    cfg = headline_config(fast=True)
    B, n = x_shape
    plan = make_plan(160, 147)
    n_out = cfg.src.output_length(n)
    F = frame_count(plan, n_out, pad_frames=True)
    P, W = plan.P, plan.W
    d = 2 * len(cfg.eq.active_bands(cfg.src.output_rate(FS)))
    G = 128
    K = F // G
    eq_state = 2 * B * K * (G * d) ** 2 + 2 * B * (K * d) ** 2
    readout = 2 * B * F * d * P + 2 * B * K * G * d * d
    m = cfg.spectrum.nfft
    return {
        "src (frames)": (3 * 2 * B * F * W * P, 4 * B * n + 4 * B * F * P),
        "src (cat fold)": (3 * 2 * B * F * W * (P + d),
                           4 * B * n + 4 * B * F * (P + d)),
        "eq (frames)": (3 * (2 * B * F * P * (P + d) + eq_state) + readout,
                        2 * 4 * B * F * P),
        "eq (cat finish)": (3 * eq_state + readout,
                            4 * B * F * (P + d) + 4 * B * F * P),
        "spectra": (3 * B * 2.5 * m * np.log2(m),
                    4 * 3 * B * m + 4 * 3 * B * (m // 2 + 1)),
    }


def stage_phase(x_dev, power_line: str) -> None:
    import jax

    from dsp_audio_project_tpu import AudioPipeline
    from dsp_audio_project_tpu.ops.eq import (
        eq_cat_weights, equalize_frames, equalize_frames_cat,
        make_block_operators,
    )
    from dsp_audio_project_tpu.ops.spectrum import (
        spectra_mag_stacked, spectrum_window,
    )
    from dsp_audio_project_tpu.ops.src import (
        fold_operator, make_plan, resample_frames, resample_frames_cat,
    )
    from dsp_audio_project_tpu.utils.profiling import bound_seconds, device_peaks

    log(f"[device time per stage: batch {x_dev.shape[0]} x "
        f"{x_dev.shape[1] / FS:.0f} s, fast mode; {power_line}]")
    cfg = headline_config(fast=True)
    pipe = AudioPipeline(cfg)
    fs_out = cfg.src.output_rate(FS)
    copy_bps, gemm_fps = measure_ceilings()
    peaks = device_peaks()
    log(f"  measured ceilings: copy {copy_bps / 1e12:.3f} TB/s "
        f"({copy_bps / peaks.hbm_bytes_per_s:.1%} of the published "
        f"{peaks.hbm_bytes_per_s / 1e12:.2f}), bf16 GEMM "
        f"{gemm_fps / 1e12:.1f} TFLOP/s ({gemm_fps / peaks.bf16_flops:.1%} "
        f"of the published {peaks.bf16_flops / 1e12:.0f})")

    plan = make_plan(160, 147)
    n_out = cfg.src.output_length(x_dev.shape[-1])
    ops = make_block_operators(cfg.eq.active_bands(fs_out), fs_out,
                               cfg.eq.q, 128 * plan.P, plan.P)
    fold = fold_operator(plan, eq_cat_weights(ops))
    frames = jax.jit(lambda v: resample_frames(
        v, plan, n_out, pad_frames=True, fast=True))
    cat_src = jax.jit(lambda v: resample_frames_cat(
        v, plan, n_out, fold, pad_frames=True, fast=True))
    yf = frames(x_dev)
    y0, inj = cat_src(x_dev)
    eq = jax.jit(lambda f: equalize_frames(f, fs_out, cfg.eq, fast=True))
    eq_cat = jax.jit(lambda a, b: equalize_frames_cat(
        a, b, fs_out, cfg.eq, unroll=160, fast=True))
    wins = [spectrum_window(x_dev, cfg.spectrum)] * 3
    spectra = jax.jit(lambda a, b, c: spectra_mag_stacked([a, b, c]))
    shapes = stage_shapes(x_dev.shape)
    runs = {
        "src (frames)": (frames, (x_dev,)),
        "src (cat fold)": (cat_src, (x_dev,)),
        "eq (frames)": (eq, (yf,)),
        "eq (cat finish)": (eq_cat, (y0, inj)),
        "spectra": (spectra, tuple(wins)),
    }
    for name, (fn, args) in runs.items():
        ms = device_ms(fn, *args)
        flops, nbytes = shapes[name]
        bound, kind = bound_seconds(flops, nbytes, gemm_fps, copy_bps)
        log(f"  {name:16s} {ms:9.4f} ms  bound {bound * 1e3:8.4f} ms "
            f"({kind}), share {bound * 1e3 / ms:6.1%}")
    for name, fn in (("full chain (cat route + spectra)",
                      pipe.jit_forward_cat_spectra()),
                     ("full chain (frames route + spectra)",
                      pipe.jit_forward_frames_spectra())):
        prof = device_profile(fn, x_dev, FS)
        ms = prof.busy_ms / 5
        log(f"  {name}: {ms:.4f} ms per batch -> "
            f"{x_dev.shape[0] * x_dev.shape[1] / (ms / 1e3) / 1e9:.3f} "
            f"G input samples/s; idle share {prof.idle_share:.1%} over 5 "
            f"back-to-back calls; top ops: "
            + ", ".join(f"{k} {v / 5e6:.3f}" for k, v in prof.top_ops(4)))


# ---- --four: the sharded paths -------------------------------------------------

def four_card_phase(seconds_a: float = SECONDS,
                    seconds_b: float = 600.0) -> None:
    """run_sharded on (4 x 1) and (1 x 4) meshes and ShardedStreamProcessor
    on (1 x 4), each against the 1x1 run of the same path on the same data
    (>= 110 dB) and the oracle (>= 60 dB), with device time per mesh."""
    import jax

    from dsp_audio_project_tpu.config import MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh, signal_sharding
    from dsp_audio_project_tpu.parallel.pipeline import (
        build_sharded_pipeline, run_sharded,
    )
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    if len(jax.devices()) != 4:
        raise RuntimeError(f"--four needs 4 devices, have {len(jax.devices())}")
    cfg = headline_config(fast=True)
    mesh11 = build_mesh(MeshConfig(channel_devices=1, block_devices=1))

    def sharded(x, mesh):
        return np.asarray(run_sharded(x, FS, cfg, mesh)[0])

    def stream(x, mesh, frames_per_shard):
        """The whole signal through ShardedStreamProcessor, super-steps of
        the same frame count on every mesh."""
        sp = ShardedStreamProcessor(cfg, FS, mesh, x.shape[0],
                                    frames_per_shard=frames_per_shard)
        step = mesh.shape["block"] * frames_per_shard * sp._s
        outs = [sp.process(x[:, i:i + step])
                for i in range(0, x.shape[1], step)]
        return np.concatenate(outs + [sp.flush()], axis=1)

    def timed(x, mesh, label):
        """Device busy ms per card of the sharded program on placed input."""
        fn, sp = build_sharded_pipeline(mesh, cfg, FS, x.shape[1], x.shape[0])
        xp = np.zeros((sp.c_pad, sp.n_in_local * mesh.shape["block"]),
                      np.float32)
        xp[: x.shape[0], : x.shape[1]] = x
        prof = device_profile(fn, jax.device_put(xp, signal_sharding(mesh)))
        per_dev = ", ".join(f"{k.split(':')[-1]}:{v / 5e6:.3f}"
                            for k, v in sorted(prof.device_busy_ns.items()))
        log(f"  {label}: device busy ms per call, per card [{per_dev}]")

    for label, (mc, mb), (ch, sec) in (
        ("channel mesh 4x1", (4, 1), (8, seconds_a)),
        ("block mesh 1x4", (1, 4), (2, seconds_b)),
    ):
        log(f"[--four {label}: {ch} ch x {sec:.0f} s]")
        x = make_signals(ch, sec)
        oracle = Oracle(x, cfg)
        mesh = build_mesh(MeshConfig(channel_devices=mc, block_devices=mb))
        z1, z4 = sharded(x, mesh11), sharded(x, mesh)
        gate(f"{label} vs 1x1", min_snr(z1, z4), INVARIANCE_DB)
        gate(f"{label} vs oracle", min_snr(oracle.z(GAINS), z4))
        timed(x, mesh11, "1x1")
        timed(x, mesh, label)
        if mb == 4:
            log("[--four ShardedStreamProcessor on the 1x4 mesh]")
            zs1 = stream(x, mesh11, 4 * 16384)
            zs4 = stream(x, mesh, 16384)
            gate("stream 1x4 vs stream 1x1", min_snr(zs1, zs4),
                 INVARIANCE_DB)
            gate("stream 1x4 vs oracle", min_snr(oracle.z(GAINS), zs4))


# ---- main ---------------------------------------------------------------------

def device_record(expected_count: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    if d.platform != "gpu":
        raise RuntimeError(f"JAX found no GPU (platform {d.platform!r})")
    if len(devs) < expected_count:
        raise RuntimeError(f"need {expected_count} GPUs, have {len(devs)}")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    power = nvidia_smi()
    if not args.four:
        run_gpu_tests()
    from dsp_audio_project_tpu.utils.compcache import enable

    log(f"[compile cache] {enable()}")
    device = device_record(4 if args.four else 1)
    if args.four:
        four_card_phase()
    else:
        import jax

        x = make_signals(BATCH, SECONDS)
        x_dev = jax.device_put(x)
        compile_headline(x_dev)
        t0 = time.perf_counter()
        oracle = Oracle(x, headline_config(fast=False))
        log(f"[oracle] {BATCH} x {SECONDS:.0f} s in "
            f"{time.perf_counter() - t0:.1f} s")
        static_phases(x, x_dev, oracle)
        dynamic_phases(x, x_dev, oracle)
        streaming_phase(x, oracle)
        cli_phase(headline_config(fast=False).src)
        stage_phase(x_dev, power.replace("\n", " | "))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(f"nvidia-smi: {power.replace(chr(10), ' | ')}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
