"""Benchmark: input samples/s per GPU of the SRC -> EQ -> spectra chain.

    python bench.py

The headline configuration (44.1 -> 48 kHz SRC with L=160/M=147, five
active EQ bands, magnitude spectra of x, y and z; 60 s signals, batch 8,
bf16x3 fast mode) runs through the route routing.choose_route picks, as
one jitted program.  Times come from the host clock around
``block_until_ready`` and, for device time, from a profiler trace
(utils.deviceprof); a run that finds no GPU fails, and so does an
output below the 60 dB SNR gate against the golden oracle.  Every line
names the card.  Detail goes to stderr; stdout gets one JSON line.
"""
from __future__ import annotations

import json
import sys
import time
from statistics import median

from dsp_audio_project_tpu.headline import (
    BATCH, FS, GAINS, GAINS_2, SECONDS, Oracle, flat, gains_vector, gate,
    headline_config, make_signals, min_snr, nvidia_smi,
)


def main() -> None:
    import jax

    from dsp_audio_project_tpu import AudioPipeline
    from dsp_audio_project_tpu.config import MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor
    from dsp_audio_project_tpu.utils.benchmarking import time_calls
    from dsp_audio_project_tpu.utils.compcache import enable
    from dsp_audio_project_tpu.utils.deviceprof import device_ms

    enable()
    dev = jax.devices()[0]
    card = f"{dev.device_kind} ({nvidia_smi().splitlines()[0]})"

    def log(msg: str) -> None:
        print(f"[{card}] {msg}", file=sys.stderr, flush=True)

    if dev.platform != "gpu":
        raise RuntimeError(f"bench needs a GPU; JAX platform is {dev.platform}")
    cfg = headline_config(fast=True)
    pipe = AudioPipeline(cfg)
    x = make_signals(BATCH, SECONDS)
    x_dev = jax.device_put(x)
    n = x.shape[-1]
    n_out = cfg.src.output_length(n)
    route = pipe.route(n, FS)
    full = {
        "cat": pipe.jit_forward_cat_spectra(),
        "frames": pipe.jit_forward_frames_spectra(),
        "flat": pipe.jit_forward_spectra(),
    }[route]
    first, wall = time_calls(full, x_dev, FS, reps=10)
    dev_ms = device_ms(full, x_dev, FS)
    sps = BATCH * n / (dev_ms / 1e3)
    log(f"route={route}: first call (compile) {first:.2f} s; wall median "
        f"{median(wall) * 1e3:.3f} ms, device {dev_ms:.4f} ms per batch of "
        f"{BATCH} x {SECONDS:.0f} s -> {sps / 1e9:.3f} G input samples/s")
    oracle = Oracle(x, headline_config(fast=False))
    z = full(x_dev, FS)[0]
    q = min_snr(oracle.z(GAINS), z if route == "flat" else flat(z, n_out))
    gate(f"{route} route z vs oracle", q, out=log)

    # Dynamic gains: cost of one gain change (host build + upload + device
    # expand + fold) and the per-batch program at the new gains.
    fwd = pipe.jit_forward_cat_dynamic_ops()
    change_ms = []
    for gains in (GAINS, GAINS_2, GAINS):
        t0 = time.perf_counter()
        dops = pipe.dynamic_eq_operators(gains_vector(cfg, gains), FS, n,
                                         builder="host")
        fold = jax.block_until_ready(pipe.dynamic_cat_tables(dops))
        change_ms.append((time.perf_counter() - t0) * 1e3)
    dyn_ms = device_ms(fwd, x_dev, dops, fold, FS)
    log(f"dynamic gains: change {median(change_ms[1:]):.3f} ms wall (host "
        f"build + upload + fold), batch {dyn_ms:.4f} ms device")
    gate("dynamic cat route z vs oracle", min_snr(
        oracle.z(GAINS), flat(fwd(x_dev, dops, fold, FS), n_out)), out=log)

    # Streaming steady state: 1x1 mesh, all channels, carry on device.
    fl = 12288
    sp = ShardedStreamProcessor(cfg, FS, build_mesh(MeshConfig()), BATCH,
                                frames_per_shard=fl)
    step = fl * sp._s
    xs = make_signals(BATCH, 240.0, seed=7)
    sp.process(xs[:, :2 * step])                       # compile + warm
    t0 = time.perf_counter()
    steps = 0
    for i in range(2, xs.shape[1] // step):
        sp.process(xs[:, i * step:(i + 1) * step])
        steps += 1
    st_wall = time.perf_counter() - t0
    stream_sps = steps * BATCH * step / st_wall
    log(f"streaming: {steps} super-steps of {fl} frames, wall "
        f"{st_wall / steps * 1e3:.3f} ms/step -> {stream_sps / 1e9:.3f} G "
        f"input samples/s (host clock, includes upload and fetch)")

    print(json.dumps({
        "metric": "src_eq_fft_chain_input_samples_per_sec",
        "value": sps,
        "unit": "samples/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": {"route": route, "device_ms_per_batch": dev_ms,
                  "snr_db": q, "dynamic_batch_device_ms": dyn_ms,
                  "streaming_wall_samples_per_sec": stream_sps},
    }))


if __name__ == "__main__":
    main()
