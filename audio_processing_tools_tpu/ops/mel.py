"""Mel filterbank + band-energy features (north-star kernel list).

librosa-parity semantics (``librosa.filters.mel`` defaults): Slaney-style
mel scale (linear below 1 kHz, log above), triangular filters normalized by
Slaney area normalization.  The filterbank is a trace-time constant, so
applying it is one matmul over the spectrogram — the canonical
"band-energy reducer" of the feature layer, generalizing the detector's
``mode_bands`` machinery to a learnable/mel frequency axis.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.ops.stft import fft_frequencies
from audio_processing_tools_tpu.ops.spectrogram import spectrogram_power


def hz_to_mel(f, htk: bool = False):
    """Hz -> mel (Slaney default, HTK optional); librosa parity."""
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if np.ndim(f):
        log_t = f >= min_log_hz
        mels = np.where(
            log_t,
            min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
            mels,
        )
    elif f >= min_log_hz:
        mels = min_log_mel + np.log(f / min_log_hz) / logstep
    return mels


def mel_to_hz(m, htk: bool = False):
    """mel -> Hz; librosa parity."""
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if np.ndim(m):
        log_t = m >= min_log_mel
        freqs = np.where(
            log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
        )
    elif m >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (m - min_log_mel))
    return freqs


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 40,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False, norm: Optional[str] = "slaney"
                   ) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular filterbank; librosa.filters.mel
    parity (float64 NumPy trace-time constant)."""
    if fmax is None:
        fmax = float(sr) / 2
    fft_freqs = fft_frequencies(sr, n_fft)
    mel_pts = mel_to_hz(
        np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2),
        htk,
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]

    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported norm {norm!r}")
    return weights


@partial(jax.jit, static_argnames=("sr", "n_fft", "hop", "n_mels", "fmin",
                                   "fmax", "htk", "log"))
def mel_spectrogram(x: jnp.ndarray, *, sr: int = 11162, n_fft: int = 256,
                    hop: int = 128, n_mels: int = 40, fmin: float = 0.0,
                    fmax: Optional[float] = None, htk: bool = False,
                    log: bool = False) -> jnp.ndarray:
    """Mel power spectrogram ``(..., n_mels, T)``; one matmul after the
    power spectrogram.  ``log=True`` returns dB (10 log10)."""
    P = spectrogram_power(x, n_fft=n_fft, hop=hop)  # (..., F, T)
    fb = jnp.asarray(
        mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk).astype(np.float32)
    )
    # HIGHEST: no reduced-precision (TF32) matmul; the filterbank reduce
    # must hold the <1e-5 parity bound
    M = jnp.einsum("mf,...ft->...mt", fb, P,
                   precision=jax.lax.Precision.HIGHEST)
    if log:
        M = 10.0 * jnp.log10(jnp.maximum(M, 1e-10))
    return M


def band_energies(P: jnp.ndarray, freqs: np.ndarray,
                  bands, db: bool = False, eps: float = 1e-10) -> jnp.ndarray:
    """Sum spectrogram power over arbitrary (lo, hi) bands -> (..., n_bands, T).

    The general band-energy reducer (mode bands, occupancy bands, mel bands
    are all instances); the selection matrix is static so this is one matmul.
    """
    sel = np.stack([
        ((freqs >= lo) & (freqs <= hi)).astype(np.float32) for lo, hi in bands
    ])
    E = jnp.einsum("bf,...ft->...bt", jnp.asarray(sel), P,
                   precision=jax.lax.Precision.HIGHEST)
    if db:
        E = 10.0 * jnp.log10(jnp.maximum(E, eps))
    return E
