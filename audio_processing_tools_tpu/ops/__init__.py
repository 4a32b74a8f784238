"""Batched JAX DSP primitives (the kernel layer).

Everything in this package is a pure function over arrays, jit-safe, and
vmappable over a leading batch axis.  Numerical semantics intentionally match
the CPU reference (librosa / scipy) so golden-parity tests can bound the
deviation (<1e-5 on spectrograms per the project north star).
"""

from audio_processing_tools_tpu.ops.windows import hann_window
from audio_processing_tools_tpu.ops.framing import frame_signal, num_frames
from audio_processing_tools_tpu.ops.stft import (
    stft,
    istft,
    stft_power,
    fft_frequencies,
    frames_to_time,
)

__all__ = [
    "hann_window",
    "frame_signal",
    "num_frames",
    "stft",
    "istft",
    "stft_power",
    "fft_frequencies",
    "frames_to_time",
]
