"""Raw spectral-shape frame features + clip-level occupancy stats.

Parity targets:
  * ``extract_raw_spectral_shape_features_inline``
    (reference ``edge/feature_extraction.py:542-747``) — centroid, bandwidth,
    band ratios, entropy/flatness/rolloff, dominant freq, frame energy, real
    cepstrum 0..4 over the operating band.
  * ``compute_clip_spectral_occupancy_stats``
    (reference ``edge/feature_extraction.py:87-171``) — per-band log-power and
    power-ratio statistics split by rain / no-rain frames.

The engine always passes the raw linear power from the centered STFT
(``raw_power``); a standalone path computes it with scipy-``stft`` scaling
(``rfft(frames * hann) / hann.sum()``, ``boundary=None, padded=False``).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.ops.framing import frame_signal
from audio_processing_tools_tpu.ops.windows import hann_window
from audio_processing_tools_tpu.ops.stft import fft_frequencies

def resolve_np_dtype(process_dtype):
    """Name/dtype -> NumPy scalar type (reference ``feature_extraction.py:55``)."""
    import numpy as _np

    if process_dtype in ("float32", _np.float32):
        return _np.float32
    if process_dtype in ("float64", _np.float64):
        return _np.float64
    return _np.dtype(process_dtype).type


RAW_SPECTRAL_FEATURE_NAMES = (
    "raw_spectral_centroid_hz",
    "raw_spectral_bandwidth_hz",
    "raw_low_freq_ratio",
    "raw_rain_band_ratio",
    "raw_mode_band_ratio_0",
    "raw_mode_band_ratio_1",
    "raw_mode_band_ratio_2",
    "raw_mode_band_ratio_3",
    "raw_mode_band_ratio_4",
    "raw_mode_band_entropy",
    "raw_mode_band_std",
    "raw_mode_band_max_ratio",
    "raw_spectral_flatness",
    "raw_spectral_rolloff_hz",
    "raw_dominant_freq_hz",
    "raw_frame_energy",
    "raw_cepstrum_coeff_0",
    "raw_cepstrum_coeff_1",
    "raw_cepstrum_coeff_2",
    "raw_cepstrum_coeff_3",
    "raw_cepstrum_coeff_4",
)

DEFAULT_MODE_BANDS = (
    (450.0, 650.0),
    (800.0, 1050.0),
    (1500.0, 1800.0),
    (2350.0, 2550.0),
    (3150.0, 3350.0),
)


def scipy_stft_power(x: jnp.ndarray, fs: int, n_fft: int, hop: int) -> jnp.ndarray:
    """``|scipy.signal.stft(x, boundary=None, padded=False)|^2`` parity."""
    n_fft = max(8, int(n_fft))
    hop = max(1, int(hop))
    w = hann_window(n_fft)
    frames = frame_signal(x.astype(jnp.float32), n_fft, hop)
    spec = jnp.fft.rfft(frames * jnp.asarray(w), axis=-1) / float(w.sum())
    power = spec.real**2 + spec.imag**2
    return jnp.swapaxes(power, -1, -2)  # (F, T)


@partial(jax.jit, static_argnames=(
    "fs", "n_fft", "operating_band", "rain_band", "low_band", "mode_bands",
    "rolloff_fraction", "eps",
))
def extract_raw_spectral_features(
    power: jnp.ndarray,           # (F, T) linear power
    *,
    fs: int,
    n_fft: int,
    operating_band: Tuple[float, float],
    rain_band: Tuple[float, float] = (400.0, 800.0),
    low_band: Tuple[float, float] = (0.0, 200.0),
    mode_bands: Optional[Tuple[Tuple[float, float], ...]] = None,
    rolloff_fraction: float = 0.85,
    eps: float = 1e-12,
) -> Dict[str, jnp.ndarray]:
    """Spectral-shape features from a linear power spectrogram, vectorized.

    All band masks are static (derived from fs/n_fft at trace time).
    """
    freqs = fft_frequencies(fs, n_fft)
    power = power.astype(jnp.float32)
    T = power.shape[-1]

    total = jnp.sum(power, axis=0) + eps
    non_dc = freqs > 0.0
    total_no_dc = jnp.sum(power[non_dc, :], axis=0) + eps if non_dc.any() else total

    low_lo, low_hi = float(low_band[0]), float(low_band[1])
    rain_lo, rain_hi = float(rain_band[0]), float(rain_band[1])
    op_lo, op_hi = float(operating_band[0]), float(operating_band[1])

    low_mask = (freqs >= max(low_lo, eps)) & (freqs < low_hi)
    rain_mask = (freqs >= rain_lo) & (freqs <= rain_hi)
    op_mask = (freqs >= op_lo) & (freqs <= op_hi)

    op_power = jnp.sum(power[op_mask, :], axis=0) + eps if op_mask.any() else total

    shape_power = power[op_mask, :] if op_mask.any() else power[non_dc, :]
    shape_freqs = freqs[op_mask] if op_mask.any() else freqs[non_dc]
    if shape_power.shape[0] == 0:
        shape_power, shape_freqs = power, freqs

    shape_total = jnp.sum(shape_power, axis=0) + eps
    fcol = jnp.asarray(shape_freqs.reshape(-1, 1), jnp.float32)

    centroid = jnp.sum(fcol * shape_power, axis=0) / shape_total
    bandwidth = jnp.sqrt(
        jnp.sum(((fcol - centroid[None, :]) ** 2) * shape_power, axis=0) / shape_total
    )

    low_ratio = (
        jnp.sum(power[low_mask, :], axis=0) / total_no_dc
        if low_mask.any() else jnp.zeros((T,), jnp.float32)
    )
    rain_ratio = (
        jnp.sum(power[rain_mask, :], axis=0) / total_no_dc
        if rain_mask.any() else jnp.zeros((T,), jnp.float32)
    )

    mb = mode_bands if mode_bands is not None else DEFAULT_MODE_BANDS
    mode_powers = []
    for lo, hi in mb:
        m = (freqs >= float(lo)) & (freqs <= float(hi))
        mode_powers.append(
            jnp.sum(power[m, :], axis=0) if m.any() else jnp.zeros((T,), jnp.float32)
        )
    mode_power = jnp.stack(mode_powers)  # (n_modes, T)
    mode_total = jnp.sum(mode_power, axis=0) + eps
    mode_ratio = mode_power / mode_total[None, :]
    mode_entropy = -jnp.sum(mode_ratio * jnp.log(mode_ratio + eps), axis=0)
    mode_std = jnp.std(mode_ratio, axis=0)
    mode_max = jnp.max(mode_ratio, axis=0)

    flat_power = shape_power if op_mask.any() else power
    flatness = jnp.exp(jnp.mean(jnp.log(flat_power + eps), axis=0)) / (
        jnp.mean(flat_power + eps, axis=0) + eps
    )

    cum = jnp.cumsum(shape_power, axis=0)
    thresh = float(np.clip(rolloff_fraction, 0.0, 1.0)) * shape_total
    roll_idx = jnp.argmax(cum >= thresh[None, :], axis=0)
    sf = jnp.asarray(shape_freqs, jnp.float32)
    # one-hot picks from the constant frequency table (no traced gather)
    rows = jnp.arange(sf.shape[0])

    def _pick_freq(idx):
        oh = (rows[:, None] == jnp.clip(idx, 0, sf.shape[0] - 1)[None, :])
        return jnp.sum(jnp.where(oh, sf[:, None], 0.0), axis=0)

    rolloff = _pick_freq(roll_idx)

    dom_idx = jnp.argmax(shape_power, axis=0)
    dominant = _pick_freq(dom_idx)

    cep_in = jnp.log(jnp.maximum(shape_power, eps))
    cepstrum = jnp.fft.irfft(jnp.swapaxes(cep_in, 0, 1), axis=-1)  # (T, ncep_full)
    n_cep = min(5, cepstrum.shape[-1])
    cep = jnp.zeros((5, T), jnp.float32)
    cep = cep.at[:n_cep].set(jnp.swapaxes(cepstrum[:, :n_cep], 0, 1))

    def mode_or_zero(i):
        if mode_ratio.shape[0] > i:
            return mode_ratio[i].astype(jnp.float32)
        return jnp.zeros((T,), jnp.float32)

    return {
        "raw_spectral_centroid_hz": centroid.astype(jnp.float32),
        "raw_spectral_bandwidth_hz": bandwidth.astype(jnp.float32),
        "raw_low_freq_ratio": low_ratio.astype(jnp.float32),
        "raw_rain_band_ratio": rain_ratio.astype(jnp.float32),
        "raw_mode_band_ratio_0": mode_or_zero(0),
        "raw_mode_band_ratio_1": mode_or_zero(1),
        "raw_mode_band_ratio_2": mode_or_zero(2),
        "raw_mode_band_ratio_3": mode_or_zero(3),
        "raw_mode_band_ratio_4": mode_or_zero(4),
        "raw_mode_band_entropy": mode_entropy.astype(jnp.float32),
        "raw_mode_band_std": mode_std.astype(jnp.float32),
        "raw_mode_band_max_ratio": mode_max.astype(jnp.float32),
        "raw_spectral_flatness": flatness.astype(jnp.float32),
        "raw_spectral_rolloff_hz": rolloff.astype(jnp.float32),
        "raw_dominant_freq_hz": dominant.astype(jnp.float32),
        "raw_frame_energy": op_power.astype(jnp.float32),
        "raw_cepstrum_coeff_0": cep[0],
        "raw_cepstrum_coeff_1": cep[1],
        "raw_cepstrum_coeff_2": cep[2],
        "raw_cepstrum_coeff_3": cep[3],
        "raw_cepstrum_coeff_4": cep[4],
    }


def default_spectral_occupancy_bands() -> Tuple[Tuple[str, float, float], ...]:
    """Semantic bands for clip occupancy (``feature_extraction.py:65-84``)."""
    return (
        ("dc", 0.0, 43.6015625),
        ("wind_1", 43.6015625, 261.609375),
        ("wind_2", 261.609375, 436.015625),
        ("mode_1", 436.015625, 654.0234375),
        ("inter_1", 654.0234375, 784.828125),
        ("mode_2", 784.828125, 1046.4375),
        ("inter_2a", 1046.4375, 1264.4453125),
        ("inter_2b", 1264.4453125, 1482.453125),
        ("mode_3", 1482.453125, 1787.6640625),
        ("inter_3a", 1787.6640625, 2092.875),
        ("inter_3b", 2092.875, 2354.484375),
        ("mode_4", 2354.484375, 2616.09375),
        ("inter_4a", 2616.09375, 2790.5),
        ("inter_4b", 2790.5, 2964.90625),
        ("inter_4c", 2964.90625, 3139.3125),
        ("mode_5", 3139.3125, 3575.328125),
    )


@partial(jax.jit, static_argnames=("fs", "n_fft", "bands", "eps"))
def clip_spectral_occupancy(
    raw_power: jnp.ndarray,   # (F, T)
    frame_is_rain: jnp.ndarray,  # (T,) bool
    *,
    fs: int,
    n_fft: int,
    bands: Optional[Tuple[Tuple[str, float, float], ...]] = None,
    eps: float = 1e-12,
) -> Dict[str, jnp.ndarray]:
    """Clip-level per-band occupancy stats split by rain / no-rain frames.

    Returns mean/std/p50/p90/max of band log1p-power and band power-ratio for
    each split, shaped ``(n_bands,)`` — zeros when a split is empty (parity
    with ``compute_clip_spectral_occupancy_stats``).
    """
    if bands is None:
        bands = default_spectral_occupancy_bands()
    freqs = fft_frequencies(fs, n_fft)
    n_bands = len(bands)
    T = raw_power.shape[-1]

    masks = []
    for i, (_, lo, hi) in enumerate(bands):
        if i == n_bands - 1:
            masks.append((freqs >= lo) & (freqs <= hi))
        else:
            masks.append((freqs >= lo) & (freqs < hi))
    sel = jnp.asarray(np.stack(masks).astype(np.float32))  # (n_bands, F)
    # HIGHEST: no reduced-precision (TF32) matmul
    band_power = jax.lax.dot(sel, raw_power.astype(jnp.float32),
                             precision=jax.lax.Precision.HIGHEST)  # (n_bands, T)

    total = jnp.sum(band_power, axis=0) + eps
    log_power = jnp.log1p(jnp.maximum(band_power, 0.0))
    ratio = band_power / total[None, :]

    rain = frame_is_rain.astype(bool)

    def stats(arr, mask, prefix):
        cnt = jnp.sum(mask)
        m = mask[None, :]
        any_ = cnt > 0
        cntf = jnp.maximum(cnt, 1).astype(jnp.float32)
        mean = jnp.sum(jnp.where(m, arr, 0.0), axis=1) / cntf
        var = jnp.sum(jnp.where(m, (arr - mean[:, None]) ** 2, 0.0), axis=1) / cntf
        std = jnp.sqrt(var)
        # masked percentiles via sort-to-end
        big = jnp.asarray(jnp.finfo(arr.dtype).max, arr.dtype)
        xs = jnp.sort(jnp.where(m, arr, big), axis=1)
        def q_at(q):
            h = q * jnp.maximum(cnt - 1, 0).astype(jnp.float32)
            lo_i = jnp.floor(h).astype(jnp.int32)
            hi_i = jnp.ceil(h).astype(jnp.int32)
            fr = h - lo_i.astype(jnp.float32)
            v_lo = xs[:, lo_i]
            v_hi = xs[:, hi_i]
            return v_lo + fr * (v_hi - v_lo)
        mx = jnp.max(jnp.where(m, arr, -big), axis=1)
        z = jnp.zeros((n_bands,), jnp.float32)
        return {
            f"{prefix}_mean": jnp.where(any_, mean, z),
            f"{prefix}_std": jnp.where(any_, std, z),
            f"{prefix}_p50": jnp.where(any_, q_at(0.5), z),
            f"{prefix}_p90": jnp.where(any_, q_at(0.9), z),
            f"{prefix}_max": jnp.where(any_, mx, z),
        }

    out: Dict[str, jnp.ndarray] = {
        "band_lo_hz": jnp.asarray([lo for _, lo, _ in bands], jnp.float32),
        "band_hi_hz": jnp.asarray([hi for _, _, hi in bands], jnp.float32),
        "rain_frame_count": jnp.sum(rain).astype(jnp.int32),
        "no_rain_frame_count": (T - jnp.sum(rain)).astype(jnp.int32),
    }
    out.update(stats(log_power, rain, "rain_log_power"))
    out.update(stats(ratio, rain, "rain_power_ratio"))
    out.update(stats(log_power, ~rain, "no_rain_log_power"))
    out.update(stats(ratio, ~rain, "no_rain_power_ratio"))
    return out
