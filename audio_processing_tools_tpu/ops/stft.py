"""STFT / ISTFT with librosa-parity semantics, batched over a leading axis.

The reference computes its spectrograms with
``librosa.stft(x, n_fft=256, hop_length=128, win_length=256, window="hann",
center=True)`` (``edge/rain_signal_processor.py:818-825``,
``edge/dsp_rain_detection.py:2283``) and reconstructs with ``librosa.istft``
(``edge/rain_signal_processor.py:1115-1122``).  The firmware-shaped paths use
non-centered framing (``center=False``) because they must be causal
(``edge/README.md`` "no look-ahead").

Semantics reproduced here:
  * hann window is the *periodic* variant (scipy ``fftbins=True``),
  * ``center=True`` pads ``n_fft // 2`` zeros on both sides
    (librosa >= 0.10 default ``pad_mode="constant"``),
  * frame count ``T = 1 + n // hop`` (centered) or
    ``1 + (n - n_fft) // hop`` (causal),
  * ISTFT does windowed overlap-add normalized by the summed squared window,
    trimmed by ``n_fft // 2`` and cut/padded to ``length``.

All functions accept ``(..., n)`` inputs and return ``(..., F, T)`` so they
can be vmapped/pjitted over a ``files`` batch axis.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.ops.windows import hann_window
from audio_processing_tools_tpu.ops.framing import frame_signal


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    """Bin center frequencies; matches ``librosa.fft_frequencies``."""
    return np.linspace(0.0, float(sr) / 2.0, 1 + n_fft // 2, dtype=np.float64)


def frames_to_time(frames: np.ndarray, sr: float, hop: int) -> np.ndarray:
    """Frame index -> seconds; matches ``librosa.frames_to_time``."""
    return np.asarray(frames, dtype=np.float64) * (float(hop) / float(sr))


def _pad_center(x: jnp.ndarray, n_fft: int, pad_mode: str) -> jnp.ndarray:
    pad = n_fft // 2
    widths = [(0, 0)] * (x.ndim - 1) + [(pad, pad)]
    if pad_mode == "constant":
        return jnp.pad(x, widths)
    if pad_mode == "reflect":
        return jnp.pad(x, widths, mode="reflect")
    raise ValueError(f"unsupported pad_mode {pad_mode!r}")


@partial(jax.jit, static_argnames=("n_fft", "hop", "center", "pad_mode"))
def stft(
    x: jnp.ndarray,
    n_fft: int = 256,
    hop: int = 128,
    center: bool = True,
    pad_mode: str = "constant",
) -> jnp.ndarray:
    """Complex STFT of the last axis. Returns ``(..., 1 + n_fft//2, T)``."""
    x = x.astype(jnp.float32)
    if center:
        x = _pad_center(x, n_fft, pad_mode)
    frames = frame_signal(x, n_fft, hop)  # (..., T, n_fft)
    w = jnp.asarray(hann_window(n_fft), dtype=frames.dtype)
    spec = jnp.fft.rfft(frames * w, axis=-1)  # (..., T, F)
    return jnp.swapaxes(spec, -1, -2)  # (..., F, T)


@partial(jax.jit, static_argnames=("n_fft", "hop", "center", "pad_mode"))
def stft_power(
    x: jnp.ndarray,
    n_fft: int = 256,
    hop: int = 128,
    center: bool = True,
    pad_mode: str = "constant",
) -> jnp.ndarray:
    """|STFT|^2 as float32 — the detector front-end quantity ``P``.

    Matches ``P = np.abs(S).astype(float32) ** 2`` in the reference engine
    (``edge/rain_signal_processor.py:826``).
    """
    s = stft(x, n_fft=n_fft, hop=hop, center=center, pad_mode=pad_mode)
    return (s.real * s.real + s.imag * s.imag).astype(jnp.float32)


@partial(jax.jit, static_argnames=("n_fft", "hop", "length", "center"))
def istft(
    S: jnp.ndarray,
    n_fft: int = 256,
    hop: int = 128,
    length: int | None = None,
    center: bool = True,
) -> jnp.ndarray:
    """Inverse STFT via windowed overlap-add (librosa semantics).

    ``S`` is ``(..., F, T)`` complex.  Returns ``(..., length)`` float32.
    """
    F, T = S.shape[-2], S.shape[-1]
    if F != 1 + n_fft // 2:
        raise ValueError(f"S has {F} bins; expected {1 + n_fft // 2}")
    w = hann_window(n_fft).astype(np.float32)

    frames = jnp.fft.irfft(jnp.swapaxes(S, -1, -2), n=n_fft, axis=-1)
    frames = frames * jnp.asarray(w)  # (..., T, n_fft)

    total = (T - 1) * hop + n_fft
    batch_shape = frames.shape[:-2]
    if n_fft % hop == 0:
        # Overlap-add as m = n_fft/hop shifted pad+add views: frame t's
        # k-th hop-chunk lands on output block t+k, so the sum over k of
        # block-shifted chunk planes IS the OLA — no scatter-add.
        m = n_fft // hop
        n_blocks = T - 1 + m
        chunks = frames.reshape(batch_shape + (T, m, hop))
        y = jnp.zeros(batch_shape + (n_blocks, hop), dtype=frames.dtype)
        for k in range(m):
            y = y.at[..., k : k + T, :].add(chunks[..., :, k, :])
        y = y.reshape(batch_shape + (total,))
    else:
        # Overlap-add via scatter-add with static indices (rare geometry).
        idx = (np.arange(T)[:, None] * hop
               + np.arange(n_fft)[None, :]).reshape(-1)
        flat = frames.reshape(batch_shape + (T * n_fft,))
        y = jnp.zeros(batch_shape + (total,), dtype=frames.dtype)
        y = y.at[..., idx].add(flat)

    # Squared-window normalization (host-side static weights).
    idx_w = (np.arange(T)[:, None] * hop + np.arange(n_fft)[None, :]).reshape(-1)
    wsq = np.zeros(total, dtype=np.float64)
    np.add.at(wsq, idx_w, np.tile(w.astype(np.float64) ** 2, T))
    wsq = np.where(wsq > 1e-10, wsq, 1.0)  # librosa uses util.tiny ~ threshold
    y = y / jnp.asarray(wsq, dtype=y.dtype)

    if center:
        y = y[..., n_fft // 2 :]
    if length is not None:
        if length <= y.shape[-1]:
            y = y[..., :length]
        else:
            widths = [(0, 0)] * (y.ndim - 1) + [(0, length - y.shape[-1])]
            y = jnp.pad(y, widths)
    return y.astype(jnp.float32)


def amplitude_to_db(
    mag: jnp.ndarray, ref: jnp.ndarray | float = 1.0, amin: float = 1e-5, top_db: float = 80.0
) -> jnp.ndarray:
    """``librosa.amplitude_to_db`` parity (used by the legacy RoE debug path,
    reference ``edge/dsp_rain_detection.py:2337-2338``)."""
    mag = jnp.abs(mag)
    power = jnp.square(mag)
    ref_p = jnp.square(jnp.asarray(ref, dtype=power.dtype))
    log_spec = 10.0 * jnp.log10(jnp.maximum(power, amin**2))
    log_spec = log_spec - 10.0 * jnp.log10(jnp.maximum(ref_p, amin**2))
    if top_db is not None:
        log_spec = jnp.maximum(log_spec, jnp.max(log_spec) - top_db)
    return log_spec
