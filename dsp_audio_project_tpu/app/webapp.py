"""Streamlit web app — interactive parity with the reference UI.

The reference's only user surface is ``streamlit run app.py`` (A1-A9,
/root/reference/app.py).  This module provides the same interactive surface
on top of the accelerator pipeline: source selection, the optional 15 s center
analysis window, L/M inputs bounded [1, 8], six EQ sliders in [-15, 15] dB,
both analysis modes (spectral/temporal and discrete-stem), playback with
position persistence, and WAV download.

Streamlit is not a dependency of the framework; the module import-guards it and the
CLI's ``--report`` path (app/report.py) provides the same views offline.

Run with:  streamlit run -m dsp_audio_project_tpu.app.webapp  (or
``python -m streamlit run dsp_audio_project_tpu/app/webapp.py``).
"""
from __future__ import annotations

import io
import uuid

import numpy as np

try:
    import streamlit as st

    HAVE_STREAMLIT = True
except ImportError:  # pragma: no cover - exercised only where UI deps exist
    st = None
    HAVE_STREAMLIT = False

from ..config import (
    DEFAULT_BAND_NAMES,
    EQConfig,
    PipelineConfig,
    SRCConfig,
)
from ..io.signal_io import export_wav, load_signal
from ..models.chain import AudioPipeline
from .report import render_report

_BAND_RANGES = ("16-60 Hz", "60-250 Hz", "250-2k Hz", "2k-4k Hz",
                "4k-6k Hz", "6k-16k Hz")  # app.py:155


def _synth(kind: str, seconds: float = 10.0, fs: int = 44100):
    from ..io.signal_io import example_signal

    return example_signal(kind, seconds, fs)


_EXAMPLES = {
    "Three tones (40/440/9800 Hz)": lambda: _synth("tones"),
    "Log sweep 20 Hz - 16 kHz": lambda: _synth("sweep"),
    "White noise": lambda: _synth("noise"),
}


def _plotly_views(st, x, y, z, fs, fs_out, cfg, omega,
                  session_id) -> bool:  # pragma: no cover - needs plotly
    """Native plotly time + frequency views (A7, app.py:173-251).

    Returns False when plotly isn't installed — callers fall back to the
    report's interactive SVG.  ``uirevision=session_id`` preserves the
    user's zoom across Streamlit reruns exactly like the reference
    (app.py:186-199).
    """
    try:
        import plotly.graph_objects as go
    except ImportError:
        return False

    from ..ops.spectrum import magnitude_spectrum
    from .report import _BAND_EDGES_HZ, _masked_db
    from .svgplot import decimate_for_display as dec

    t_in = np.linspace(0, len(x) / fs, len(x))
    t_out = np.linspace(0, len(z) / fs_out, len(z))
    fig_t = go.Figure()
    fig_t.add_scatter(x=dec(t_in), y=dec(x), name="x[n] input",
                      line=dict(color="#888888"), opacity=0.4)
    fig_t.add_scatter(x=dec(t_out), y=dec(y), name="y[n] resampled",
                      line=dict(color="#ffd700"), opacity=0.8)
    fig_t.add_scatter(x=dec(t_out), y=dec(z), name="z[n] output",
                      line=dict(color="#00ff00"))
    fig_t.update_layout(title="Time-domain evolution", template="plotly_dark",
                        uirevision=session_id, xaxis_title="time (s)")
    st.plotly_chart(fig_t, use_container_width=True)

    scfg = cfg.spectrum
    fig_f = go.Figure()
    for sig, rate, name, color, op in (
        (x, fs, "|X| input", "#888888", 0.5),
        (y, fs_out, "|Y| resampled", "#ffd700", 0.8),
        (z, fs_out, "|Z| output", "#00e5ff", 1.0),
    ):
        f, m = magnitude_spectrum(sig, rate, scfg)
        fr, db = _masked_db(f, m)
        if omega:
            fr = fr * (2 * np.pi / rate)
        fig_f.add_scatter(x=dec(fr), y=dec(db), name=name,
                          line=dict(color=color), opacity=op)
    for edge in _BAND_EDGES_HZ:
        pos = edge * (2 * np.pi / fs_out) if omega else edge
        if pos < (np.pi if omega else fs_out / 2):
            fig_f.add_vline(x=pos, line_dash="dash", line_color="#ff5500",
                            opacity=0.7)
    fig_f.update_layout(
        title="Spectral cascade", template="plotly_dark",
        uirevision=session_id, yaxis_title="magnitude (dB)",
        xaxis_title=("normalized frequency (rad/sample)" if omega
                     else "frequency (Hz)"),
        xaxis_type="log",
    )
    st.plotly_chart(fig_f, use_container_width=True)
    return True


def main() -> None:  # pragma: no cover - UI glue, needs streamlit
    if not HAVE_STREAMLIT:
        raise SystemExit(
            "streamlit is not installed; use the CLI --report flag for the "
            "offline HTML analysis views"
        )

    st.set_page_config(page_title="DSP Lab", layout="wide", page_icon="🎛️")
    st.markdown(
        "<style>.stAlert{display:none;}.block-container{padding-top:1.5rem;}"
        ".dsp-monitor{background-color:#1e1e1e;color:#00ff00;padding:10px 15px;"
        "border-radius:5px;font-family:'Courier New',monospace;font-size:0.9em;"
        "border:1px solid #333;margin-bottom:15px;}</style>",
        unsafe_allow_html=True,
    )
    st.title("🎛️ Discrete-time audio processing")

    if "signal" not in st.session_state:
        st.session_state.signal = None
        st.session_state.fs = 0
        st.session_state.name = ""
        st.session_state.session_id = str(uuid.uuid4())

    st.sidebar.header("Input")
    # Source radio (A2/A5, app.py:51-60,116-135).  The reference ships
    # example WAVs (stripped from its repo); synthesized test signals play
    # the same role here.
    source = st.sidebar.radio("Source", ["Example signal", "Upload WAV"])
    if source == "Upload WAV":
        upload = st.sidebar.file_uploader("Upload WAV", type=["wav"])
        if upload is not None and upload.name != st.session_state.name:
            x, fs = load_signal(upload.read())
            st.session_state.signal = x
            st.session_state.fs = fs
            st.session_state.name = upload.name
            st.session_state.session_id = str(uuid.uuid4())
    else:
        # On-disk example browsing (reference app.py:123-126): any WAV/AIFF
        # in ./examples (or $DSP_EXAMPLES_DIR) is listed alongside the
        # built-in synthesized kinds.
        import os

        from ..io.signal_io import list_example_files

        sources = dict(_EXAMPLES)
        for path in list_example_files():
            sources[os.path.basename(path)] = (
                lambda p=path: load_signal(p)
            )
        example = st.sidebar.selectbox("Example", list(sources))
        key = f"example:{example}"
        if key != st.session_state.name:
            x, fs = sources[example]()
            st.session_state.signal = x
            st.session_state.fs = fs
            st.session_state.name = key
            st.session_state.session_id = str(uuid.uuid4())

    if st.session_state.signal is None:
        st.info("Load a WAV to start processing.")
        st.stop()

    x = st.session_state.signal
    fs = int(st.session_state.fs)

    use_window = st.sidebar.checkbox("Analysis window (15s)", value=False)
    if use_window:
        center = len(x) // 2
        n_win = 15 * fs
        start = max(0, center - n_win // 2)
        x = x[start : min(len(x), start + n_win)]

    st.sidebar.subheader("1. Sample-rate converter (SRC)")
    c1, c2 = st.sidebar.columns(2)
    L = c1.number_input("Expansion (L)", 1, 8, 1)
    M = c2.number_input("Decimation (M)", 1, 8, 1)

    st.sidebar.subheader("2. Equalizer (EQ)")
    gains = {}
    for i, (name, rng) in enumerate(zip(DEFAULT_BAND_NAMES, _BAND_RANGES)):
        gains[name] = st.sidebar.slider(f"{name} ({rng})", -15, 15, 0, key=f"g_{i}")

    cfg = PipelineConfig(
        src=SRCConfig(L=int(L), M=int(M)), eq=EQConfig.from_gains(gains)
    )
    with st.spinner("Processing signal..."):
        pipe = AudioPipeline(cfg)
        out = pipe(x, fs)
        z = np.asarray(out.output)

    mode = st.radio(
        "Analysis mode:",
        ["Spectral & temporal", "Discrete sequence (stem)"],
        horizontal=True,
    )
    omega = False
    t_sel = None
    if mode == "Spectral & temporal":
        omega = "rad" in st.radio(
            "Units:", ["Hz (real frequency)", "rad/s (normalized omega)"],
            horizontal=True,
        )
    else:
        duration = len(x) / fs
        t_sel = st.slider("Analysis instant (seconds)", 0.0, duration,
                          duration / 2.0, step=0.01)

    # Native plotly charts for the A7 views when plotly is installed —
    # full zoom/pan/hover with uirevision persistence (app.py:186-251);
    # otherwise the embedded report's self-contained interactive SVG covers
    # the same gestures.
    used_plotly = mode == "Spectral & temporal" and _plotly_views(
        st, x, np.asarray(out.resampled), z, fs, out.fs_out, cfg, omega,
        st.session_state.session_id,
    )

    html = render_report(
        x, fs, cfg,
        title=st.session_state.name or "analysis",
        normalized_omega=omega,
        stem_time_s=t_sel,
        include_audio=True,
        main_charts=not used_plotly,
    )
    st.components.v1.html(html, height=1400 if used_plotly else 2400,
                          scrolling=True)

    buf = io.BytesIO()
    buf.write(export_wav(z, out.fs_out))
    buf.seek(0)
    st.download_button("💾 Download WAV", buf, "output_dsp.wav", "audio/wav")


if __name__ == "__main__" and HAVE_STREAMLIT:  # pragma: no cover
    main()
