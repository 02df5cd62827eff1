"""dsp_audio_project_tpu — an accelerator audio DSP framework in JAX.

A from-scratch JAX/XLA re-architecture of the capabilities of the reference
project ``Renatovela-ctrl/dsp-audio-project`` (an audio pipeline of L/M
sample-rate conversion, a 6-band peaking-EQ biquad cascade, and windowed FFT
spectrum analysis), built for an accelerator (an NVIDIA H100):

* the full-rate zero-stuffed FIR becomes a polyphase frame matmul,
* the sequential IIR cascade becomes a block-parallel state-space recurrence,
* the recursive Python FFT becomes a batched rFFT,
* multichannel + long-form audio shard over a (channel, block) device mesh
  with overlap-save halos and biquad state carries as collectives.

Public entry points:
    load_signal / export_wav          host-side audio I/O
    process(x, fs, config)            the full SRC->EQ chain
    resample / equalize               individual stages
    magnitude_spectrum                analysis
    AudioPipeline                     configured, jitted pipeline object
"""

from .config import (
    EQConfig,
    KernelConfig,
    MeshConfig,
    PipelineConfig,
    SpectrumConfig,
    SRCConfig,
)
from .io.signal_io import example_signal, export_wav, load_signal
from .io.wavio import read_wav, write_wav
from .models.chain import AudioPipeline, PipelineOutputs
from .models.graph import Chain, Clip, Equalize, Gain, Normalize, Resample, Stage
from .ops.eq import equalize, equalize_stream
from .ops.eq_dynamic import (
    build_dynamic_operators,
    equalize_dynamic,
    equalize_dynamic_frames,
    equalize_dynamic_frames_ops,
)
from .ops.spectrum import (
    angular_spectrum,
    magnitude_spectrum,
    spectrogram,
    spectrum_db,
    stft,
    stft_planes,
)
from .ops.src import resample
from .streaming import ShardedStreamProcessor, StreamProcessor, StreamState

__version__ = "0.1.0"


def process(x, fs, config: PipelineConfig = PipelineConfig()):
    """One-shot convenience: run the full chain, return (z, fs_out)."""
    out = AudioPipeline(config)(x, fs)
    return out.output, out.fs_out


__all__ = [
    "AudioPipeline",
    "Chain",
    "Clip",
    "Equalize",
    "Gain",
    "Normalize",
    "Resample",
    "Stage",
    "EQConfig",
    "KernelConfig",
    "MeshConfig",
    "PipelineConfig",
    "PipelineOutputs",
    "SpectrumConfig",
    "SRCConfig",
    "angular_spectrum",
    "equalize",
    "build_dynamic_operators",
    "equalize_dynamic",
    "equalize_dynamic_frames",
    "equalize_dynamic_frames_ops",
    "example_signal",
    "equalize_stream",
    "export_wav",
    "load_signal",
    "magnitude_spectrum",
    "process",
    "read_wav",
    "resample",
    "spectrogram",
    "stft_planes",
    "spectrum_db",
    "stft",
    "ShardedStreamProcessor",
    "StreamProcessor",
    "StreamState",
    "write_wav",
]
