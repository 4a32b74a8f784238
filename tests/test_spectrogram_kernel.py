"""Spectrogram front-end: ``spectrogram_power`` against a float64 NumPy
STFT oracle."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from audio_processing_tools_tpu.ops.spectrogram import spectrogram_power

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from chip_checks import numpy_stft_power_f64  # noqa: E402

FS = 11162


@pytest.mark.parametrize("shape,n_fft,hop,center", [
    ((FS,), 256, 128, True),             # 1-D
    ((3, FS), 256, 128, True),           # batched
    ((2, FS + 37), 256, 128, True),      # odd length
    ((2, FS), 256, 128, False),          # causal framing
    ((2, FS), 512, 128, True),           # n_fft 512, hop 128
], ids=["1d", "batched", "odd_length", "center_false", "nfft512_hop128"])
def test_spectrogram_power_matches_float64_numpy(rng, shape, n_fft, hop,
                                                 center):
    x = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    P = np.asarray(spectrogram_power(jnp.asarray(x), n_fft=n_fft, hop=hop,
                                     center=center))
    ref = numpy_stft_power_f64(x, n_fft=n_fft, hop=hop, center=center)
    assert P.shape == ref.shape
    assert P.dtype == np.float32
    assert np.abs(P - ref).max() / ref.max() < 1e-5
