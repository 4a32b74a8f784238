"""Rain / noise frame classifier — batched re-design of
``RainFrameClassifierMixin._detect_rain_over_time``
(reference ``edge/rain_frame_classifier.py:290-1168``).

The reference iterates frames in Python (flux, peak gate) and then applies
vectorized thresholds.  Here the whole classifier is one traced function:

  * t-vs-(t-2) positive spectral flux  -> shifted tensor subtraction,
  * causal low-quantile flux normalization -> ``lax.scan`` (ops.trackers),
  * the optional peak-structure gate   -> vectorized peak ops (ops.peaks),
  * TD gating + fixed-band log1p decision -> elementwise tensor math.

All detector parameters are trace-time constants resolved through
``NoiseConfig.dget`` with the reference's precedence.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Any, Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.config import NoiseConfig
from audio_processing_tools_tpu.ops.stft import fft_frequencies
from audio_processing_tools_tpu.ops.stats import nan_to_num
from audio_processing_tools_tpu.ops.trackers import causal_low_quantile_baseline
from audio_processing_tools_tpu.ops.stats import quantile_linear
from audio_processing_tools_tpu.ops.peaks import (
    local_maxima,
    peak_prominences,
    peak_widths_rel,
)
from audio_processing_tools_tpu.ops.features_td import extract_td_features
from audio_processing_tools_tpu.ops.features_spec import (
    extract_raw_spectral_features,
    clip_spectral_occupancy,
    RAW_SPECTRAL_FEATURE_NAMES,
)
from audio_processing_tools_tpu.ops.filters import (
    design_highpass,
    design_bandpass,
    sosfiltfilt,
)


class FrameClass(IntEnum):
    """Frame classes (``edge/rain_frame_classifier.py:18-23``)."""

    NOISE = 0
    UNCERTAIN = 1
    RAIN = 2


def build_prefilter_sos(cfg: NoiseConfig, sr: int, mode: str) -> Optional[np.ndarray]:
    """Engine pre-filter design (``edge/rain_signal_processor.py:347-364``)."""
    if mode == "bandpass":
        op_lo, op_hi = cfg.operating_band
        return design_bandpass(sr, float(op_lo), float(op_hi),
                               int(getattr(cfg, "bp_order", cfg.hp_order)))
    if mode == "highpass" and cfg.hp_cutoff_hz > 0:
        return design_highpass(sr, cfg.hp_cutoff_hz, cfg.hp_order)
    return None


def _align_to_frames(arr: jnp.ndarray, T: int) -> jnp.ndarray:
    """Truncate / zero-fill a per-frame feature to T frames
    (``rain_frame_classifier.py:178-194``)."""
    n = arr.shape[-1]
    if n >= T:
        return arr[..., :T]
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, T - n)]
    return jnp.pad(arr, pad)


def _mode_flux(P_band: jnp.ndarray, mode_masks: np.ndarray,
               primary_mask: np.ndarray, mode_weights) -> Tuple[jnp.ndarray, ...]:
    """t vs t-2 positive rise flux, per mode band.

    ``P_band`` is (K, T).  Frames 0 and 1 carry zero flux (warm-up), matching
    ``rain_frame_classifier.py:713-759``.
    """
    K, T = P_band.shape
    flux = jnp.zeros_like(P_band)
    if T > 2:
        d2 = jnp.maximum(P_band[:, 2:] - P_band[:, :-2], 0.0)
        flux = flux.at[:, 2:].set(d2)
    sel = jnp.asarray(mode_masks.astype(np.float32))       # (n_modes, K)
    # HIGHEST: a default-precision float32 matmul may run in TF32 on the
    # GPU; flux feeds threshold
    # decisions, so the band reduce must be exact f32
    mode_flux_by_mode = jax.lax.dot(
        sel, flux, precision=jax.lax.Precision.HIGHEST)     # (n_modes, T)
    flux_primary = jax.lax.dot(
        jnp.asarray(primary_mask.astype(np.float32))[None, :], flux,
        precision=jax.lax.Precision.HIGHEST)[0]
    if mode_weights is not None:
        w = jnp.asarray(np.asarray(mode_weights, np.float32))
        flux_modes = jnp.sum(w[:, None] * mode_flux_by_mode, axis=0)
    else:
        flux_modes = jnp.sum(mode_flux_by_mode, axis=0)
    return flux, flux_primary, flux_modes, mode_flux_by_mode


def _peak_gate(spec: jnp.ndarray, mode_masks: np.ndarray, primary_mask: np.ndarray,
               freqs_band: np.ndarray, *, top_p: int, top_m: int,
               prominence_db: float, min_db_above_floor: float, ratio_min: float,
               valid_prom_min: float, valid_prom_max: float) -> Dict[str, jnp.ndarray]:
    """Peak-structure gate, vectorized over frames.

    ``spec`` is (K, T) detector-input dB.  Parity target:
    ``rain_frame_classifier.py:761-843``.
    """
    K, T = spec.shape
    sT = jnp.swapaxes(spec, 0, 1)  # (T, K)
    floor_db = quantile_linear(sT, 0.5, axis=-1)  # per-frame median
    height = floor_db + min_db_above_floor

    is_max = local_maxima(sT)
    prom = peak_prominences(sT, is_max)
    found = is_max & (prom >= prominence_db) & (sT >= height[:, None])

    widths = peak_widths_rel(sT, found, prom, 0.5)
    df_hz = float(freqs_band[1] - freqs_band[0]) if freqs_band.size > 1 else 0.0
    bw_hz = widths * df_hz

    valid = found & (prom >= valid_prom_min) & (prom <= valid_prom_max)
    valid_count = jnp.sum(valid, axis=-1).astype(jnp.int32)  # (T,)

    mode_sel = jnp.asarray(mode_masks)  # (n_modes, K) bool
    count_by_mode = jnp.sum(valid[None, :, :] & mode_sel[:, None, :], axis=-1
                            ).astype(jnp.int32)  # (n_modes, T)

    # top-P valid peaks by height
    neg = jnp.asarray(-jnp.inf, sT.dtype)
    hts = jnp.where(valid, sT, neg)
    order = jnp.argsort(-hts, axis=-1)  # (T, K): valid tallest first
    rank = jnp.arange(K)[None, :]
    sel_n = jnp.minimum(valid_count, top_p)  # per-frame top-P count
    sel_mask = rank < sel_n[:, None]         # ranks selected

    prim = jnp.asarray(primary_mask)
    any_mode = jnp.asarray(mode_masks.any(axis=0))
    in_primary_sorted = jnp.take_along_axis(
        jnp.broadcast_to(prim[None, :], (T, K)), order, axis=-1
    )
    in_any_sorted = jnp.take_along_axis(
        jnp.broadcast_to(any_mode[None, :], (T, K)), order, axis=-1
    )
    ratio = jnp.sum(in_any_sorted & sel_mask, axis=-1) / jnp.maximum(sel_n, 1)
    top_m_eff = jnp.minimum(sel_n, top_m)
    primary_ok = jnp.any(in_primary_sorted & (rank < top_m_eff[:, None]), axis=-1)
    mode_ok = ratio >= ratio_min
    has_valid = valid_count > 0
    gate_score = jnp.where(
        has_valid,
        jnp.minimum(primary_ok.astype(jnp.float32), mode_ok.astype(jnp.float32)),
        0.0,
    )
    peak_ratio = jnp.where(has_valid, ratio.astype(jnp.float32), 0.0)

    # frames 0 handled by caller (reference zeroes frame 0)
    return {
        "peak_ratio": peak_ratio,
        "peak_gate_score": gate_score,
        "peak_valid_count": valid_count,
        "peak_count_by_mode": count_by_mode,
        "peak_bw_hz": bw_hz,
    }


def rain_frame_decision(
    primary: jnp.ndarray, s1: jnp.ndarray, s2: jnp.ndarray, s3: jnp.ndarray,
    *, primary_flux_min: float, mode1_flux_min: float, mode2_flux_min: float,
    mode3_flux_min: float, min_support_count: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fixed-band log1p decision (``rain_frame_classifier.py:230-284``)."""
    f0 = jnp.log1p(jnp.maximum(primary, 0.0))
    f1 = jnp.log1p(jnp.maximum(s1, 0.0))
    f2 = jnp.log1p(jnp.maximum(s2, 0.0))
    f3 = jnp.log1p(jnp.maximum(s3, 0.0))
    msc = max(1, int(min_support_count))
    primary_ok = f0 >= float(primary_flux_min)
    hits = (
        (f1 >= float(mode1_flux_min)).astype(jnp.int32)
        + (f2 >= float(mode2_flux_min)).astype(jnp.int32)
        + (f3 >= float(mode3_flux_min)).astype(jnp.int32)
    )
    is_rain = primary_ok & (hits >= msc)
    return is_rain, is_rain.astype(jnp.float32)


def assign_td_soft_label(*, td_crest_factor, td_kurtosis, crest_thr: float,
                         kurt_thr: float, min_positive_votes: int = 2
                         ) -> Dict[str, jnp.ndarray]:
    """TD soft label from impulse features: crest/kurtosis voting
    (reference ``rain_frame_classifier.py:85-110``)."""
    crest = jnp.asarray(td_crest_factor)
    kurt = jnp.asarray(td_kurtosis)
    votes = (crest >= float(crest_thr)).astype(jnp.int32) + (
        kurt >= float(kurt_thr)
    ).astype(jnp.int32)
    return {
        "td_vote_count": votes,
        "td_soft_score": votes.astype(jnp.float32) / 2.0,
        "td_soft_label": votes >= int(min_positive_votes),
    }


def detect_rain_over_time(
    cfg: NoiseConfig,
    P_det: jnp.ndarray,            # (F, T) detector input (normalized dB)
    x: jnp.ndarray,                # raw waveform (detector TD front-end input)
    raw_power: Optional[jnp.ndarray] = None,  # (F, T) linear power
) -> Tuple[jnp.ndarray, jnp.ndarray, Dict[str, Any], Dict[str, Any]]:
    """Traced classifier body. Returns (frame_class, rain_conf, det_debug,
    feature_dump) with det_debug/feature_dump as dicts of arrays."""
    eps = float(cfg.dget("eps", 1e-9))
    fs = int(cfg.dget("sample_rate", cfg.dget("fs", 11162)))
    n_fft = int(cfg.dget("n_fft", 256))
    hop = int(cfg.dget("hop", 128))

    op_band = cfg.dget("operating_band", (400.0, 3500.0))
    op_lo, op_hi = float(op_band[0]), float(op_band[1])

    mode_bands = cfg.dget("mode_bands", None)
    if mode_bands is None:
        raise AttributeError("Missing required detector param: mode_bands")
    mode_bands = tuple((float(a), float(b)) for (a, b) in mode_bands)
    if len(mode_bands) < 4:
        raise ValueError(
            "Fixed-band rain decision requires at least 4 mode bands"
        )

    mode_weights = cfg.dget("mode_weights", None)
    if mode_weights is not None:
        mode_weights = tuple(float(w) for w in mode_weights)
        if len(mode_weights) != len(mode_bands):
            raise ValueError("mode_weights length must match mode_bands length")

    freqs = fft_frequencies(fs, n_fft)
    band_mask = (freqs >= op_lo) & (freqs <= op_hi)
    if not band_mask.any():
        raise ValueError("operating_band does not overlap the frequency grid")
    freqs_band = freqs[band_mask]

    primary_lo, primary_hi = mode_bands[0]
    primary_mask = (freqs_band >= primary_lo) & (freqs_band <= primary_hi)
    if not primary_mask.any():
        raise ValueError("primary mode band has no bins inside operating_band")
    mode_masks = np.stack(
        [(freqs_band >= lo) & (freqs_band <= hi) for lo, hi in mode_bands]
    )
    if not mode_masks.any():
        raise ValueError("No mode band overlaps the operating band")

    F, T = P_det.shape
    P_band = P_det[np.flatnonzero(band_mask), :]  # (K, T) static gather

    # ---------------- TD + raw-spectral features ----------------
    td_apply_prefilter = cfg.dflag("td_apply_input_prefilter", True)
    td_prefilter_mode = str(
        cfg.dget("td_prefilter_mode", cfg.dget("pre_filter_mode", "none"))
    ).lower()
    x_td_in = x
    if td_apply_prefilter and td_prefilter_mode not in ("", "none"):
        sos = build_prefilter_sos(cfg, fs, td_prefilter_mode)
        if sos is not None:
            x_td_in = sosfiltfilt(sos, x)

    td_input_band = cfg.dget("td_input_band", None)
    if td_input_band is not None:
        td_input_band = (float(td_input_band[0]), float(td_input_band[1]))
    td_envelope_enable = cfg.dflag("td_envelope_features_enable", False)

    td = extract_td_features(
        x_td_in,
        fs=fs, frame_len=n_fft, hop=hop,
        operating_band=(op_lo, op_hi), mode_bands=mode_bands,
        td_input_mode=str(cfg.dget("td_input_mode", "default")).lower(),
        td_input_band=td_input_band,
        bp_order=int(cfg.dget("td_soft_bp_order", 4)),
        subframe_len=int(cfg.dget("td_soft_subframe_len", 128)),
        subframe_hop=int(cfg.dget("td_soft_subframe_hop", 128)),
        block_energy_len=int(cfg.dget("td_block_energy_len", 8)),
        block_energy_hop=(
            None if cfg.dget("td_block_energy_hop", None) is None
            else int(cfg.dget("td_block_energy_hop"))
        ),
        block_energy_post_pre_blocks=int(cfg.dget("td_block_energy_post_pre_blocks", 4)),
        block_energy_smooth_enable=cfg.dflag("td_block_energy_smooth_enable", True),
        envelope_features_enable=td_envelope_enable,
        eps=eps,
    )
    aligned_td = {k: _align_to_frames(v, T) for k, v in td.items()}
    td_crest = nan_to_num(aligned_td["td_crest_factor"])
    td_kurt = nan_to_num(aligned_td["td_kurtosis"])
    td_bec = nan_to_num(aligned_td["td_block_energy_crest"])
    td_bpw = nan_to_num(aligned_td["td_block_peak_width_50"])
    td_bpp = nan_to_num(aligned_td["td_block_post_pre_energy_ratio"])

    raw_spectral_enable = cfg.dflag("raw_spectral_shape_enable", True)
    aligned_raw = {
        name: jnp.zeros((T,), jnp.float32) for name in RAW_SPECTRAL_FEATURE_NAMES
    }
    if raw_spectral_enable and raw_power is not None:
        rb = cfg.dget("raw_spectral_rain_band", (400.0, 800.0))
        lb = cfg.dget("raw_spectral_low_band", (50.0, 200.0))
        raw = extract_raw_spectral_features(
            raw_power, fs=fs, n_fft=n_fft, operating_band=(op_lo, op_hi),
            rain_band=(float(rb[0]), float(rb[1])),
            low_band=(float(lb[0]), float(lb[1])),
            mode_bands=mode_bands,
            rolloff_fraction=float(cfg.dget("raw_spectral_rolloff_fraction", 0.85)),
            eps=eps,
        )
        aligned_raw = {k: _align_to_frames(v, T) for k, v in raw.items()}

    # TD soft labels (optional)
    td_soft_enable = cfg.dflag("td_soft_enable", False)
    if td_soft_enable:
        soft = assign_td_soft_label(
            td_crest_factor=td_crest, td_kurtosis=td_kurt,
            crest_thr=float(cfg.dget("td_soft_crest_factor_min", 4.0)),
            kurt_thr=float(cfg.dget("td_soft_kurtosis_min", 6.0)),
            min_positive_votes=int(cfg.dget("td_soft_min_positive_votes", 2)),
        )
        td_vote_count = soft["td_vote_count"]
        td_soft_score = soft["td_soft_score"]
        td_soft_label = soft["td_soft_label"]
    else:
        td_vote_count = jnp.zeros((T,), jnp.int32)
        td_soft_score = jnp.zeros((T,), jnp.float32)
        td_soft_label = jnp.zeros((T,), bool)

    # ---------------- spectral flux ----------------
    flux, flux_primary, flux_modes, mode_flux_by_mode = _mode_flux(
        P_band, mode_masks, primary_mask, mode_weights
    )

    # optional winsorization of the combined-mode flux
    flux_modes_proc = flux_modes
    if cfg.dflag("flux_modes_winsor_enable", False):
        wq = float(np.clip(float(cfg.dget("flux_modes_winsor_q", 99.0)), 50.0, 100.0))
        winsor_hi = quantile_linear(flux_modes_proc, wq / 100.0)
        flux_modes_proc = jnp.minimum(flux_modes_proc, winsor_hi)

    # normalization params
    norm_enable = cfg.dflag("mode_flux_norm_enable", True)
    norm_win_sec = float(cfg.dget("mode_flux_norm_win_sec", 0.5))
    norm_q = float(np.clip(float(cfg.dget("mode_flux_norm_q", 20.0)), 0.0, 100.0))
    norm_min = max(float(cfg.dget("mode_flux_norm_min", 1.0)), eps)
    frames_per_sec = float(fs) / max(float(hop), 1.0)

    def baseline_of(v):
        b, _ = causal_low_quantile_baseline(
            v, q_percent=norm_q, samples_per_sec=frames_per_sec,
            win_sec=norm_win_sec, min_hist_sec=0.0, floor=norm_min,
        )
        return b

    # one stacked scan for all six baselines (same tracker params; scans
    # serialize per frame, so fusing the (T,) and (n_modes, T) trackers
    # halves the per-frame sequential overhead)
    stacked = jnp.concatenate(
        [flux_modes_proc[None, :], mode_flux_by_mode], axis=0
    )
    base_stacked = baseline_of(stacked)
    base_all = base_stacked[0]
    base_modes = base_stacked[1:]

    excess_all = jnp.maximum(flux_modes_proc - base_all, 0.0)
    mode_flux_score = (
        excess_all / (base_all + norm_min) if norm_enable else excess_all
    )

    excess_modes = jnp.maximum(mode_flux_by_mode - base_modes, 0.0)
    normalized_mode_flux = nan_to_num(
        excess_modes / (base_modes + norm_min) if norm_enable else excess_modes
    )

    # ---------------- peak gate (optional) ----------------
    peak_features_enable = cfg.dflag("peak_features_enable", False)
    if peak_features_enable:
        pg = _peak_gate(
            P_band, mode_masks, primary_mask, freqs_band,
            top_p=max(1, int(cfg.dget("peak_top_p", 6))),
            top_m=max(1, int(cfg.dget("primary_top_m", 3))),
            prominence_db=float(cfg.dget("peak_prominence_db", 3.0)),
            min_db_above_floor=float(cfg.dget("peak_min_db_above_floor", 6.0)),
            ratio_min=float(np.clip(float(cfg.dget("peak_ratio_min", 0.50)), 0, 1)),
            valid_prom_min=float(cfg.dget("peak_valid_prom_min_db", 3.0)),
            valid_prom_max=max(
                float(cfg.dget("peak_valid_prom_min_db", 3.0)),
                float(cfg.dget("peak_valid_prom_max_db", 6.0)),
            ),
        )
        # reference zeroes frame 0 (warm-up)
        zero0 = jnp.ones((T,), bool).at[0].set(False)
        peak_ratio = jnp.where(zero0, pg["peak_ratio"], 0.0)
        peak_gate_score = jnp.where(zero0, pg["peak_gate_score"], 0.0)
        peak_valid_count = jnp.where(zero0, pg["peak_valid_count"], 0)
        peak_count_by_mode = jnp.where(zero0[None, :], pg["peak_count_by_mode"], 0)
    else:
        peak_ratio = jnp.full((T,), jnp.nan, jnp.float32)
        peak_gate_score = jnp.full((T,), jnp.nan, jnp.float32)
        peak_valid_count = jnp.zeros((T,), jnp.int32)
        peak_count_by_mode = jnp.zeros((len(mode_bands), T), jnp.int32)

    # ---------------- decision ----------------
    mode_flux_score = nan_to_num(mode_flux_score)

    primary_flux_min = float(cfg.dget("new_rain_primary_flux_min", 1.8))
    legacy12 = float(cfg.dget("new_rain_mode12_flux_min", 2.6))
    mode1_min = float(cfg.dget("new_rain_mode1_flux_min", legacy12))
    mode2_min = float(cfg.dget("new_rain_mode2_flux_min", legacy12))
    mode3_min = float(cfg.dget("new_rain_mode3_flux_min", 3.0))
    min_support = int(cfg.dget("new_rain_min_support_count", 2))

    primary_flux = nan_to_num(normalized_mode_flux[0])
    s1 = nan_to_num(normalized_mode_flux[1])
    s2 = nan_to_num(normalized_mode_flux[2])
    s3 = nan_to_num(normalized_mode_flux[3])
    if normalized_mode_flux.shape[0] > 4:
        s4 = nan_to_num(normalized_mode_flux[4])
    else:
        s4 = jnp.zeros_like(primary_flux)

    td_gate_threshold = float(cfg.dget("td_gate_threshold", 2.5))
    td_kurt_upper = cfg.dget("td_kurtosis_upper_threshold", None)
    td_gate_mask = td_crest > td_gate_threshold
    if td_kurt_upper is not None:
        td_gate_mask = td_gate_mask & (td_kurt <= float(td_kurt_upper))
    gate = td_gate_mask.astype(jnp.float32)

    primary_g = primary_flux * gate
    s1_g = s1 * gate
    s2_g = s2 * gate
    s3_g = s3 * gate

    is_rain, rain_conf = rain_frame_decision(
        primary_g, s1_g, s2_g, s3_g,
        primary_flux_min=primary_flux_min, mode1_flux_min=mode1_min,
        mode2_flux_min=mode2_min, mode3_flux_min=mode3_min,
        min_support_count=min_support,
    )

    noise_conf = jnp.clip(1.0 - rain_conf, 0.0, 1.0)
    mode_flux_noise_max = max(float(cfg.dget("mode_flux_noise_max", 1.5)), 0.0)
    noise_hi = float(cfg.dget("noise_hi", 0.80))
    score_gated = mode_flux_score * gate
    weak = score_gated <= mode_flux_noise_max

    frame_class = jnp.full((T,), int(FrameClass.UNCERTAIN), jnp.int8)
    frame_class = jnp.where(
        (noise_conf >= noise_hi) & weak & (~is_rain),
        jnp.int8(FrameClass.NOISE), frame_class,
    )
    frame_class = jnp.where(is_rain, jnp.int8(FrameClass.RAIN), frame_class)

    det_debug: Dict[str, Any] = {
        "mode_flux_score": mode_flux_score,
        "mode_flux_score_gated": score_gated,
        "primary_mode_flux": primary_flux,
        "support_mode_flux_1": s1,
        "support_mode_flux_2": s2,
        "support_mode_flux_3": s3,
        "support_mode_flux_4": s4,
        "primary_mode_flux_gated": primary_g,
        "support_mode_flux_1_gated": s1_g,
        "support_mode_flux_2_gated": s2_g,
        "support_mode_flux_3_gated": s3_g,
        "rain_conf": rain_conf,
        "noise_conf": noise_conf,
        "frame_class": frame_class,
        "td_soft_label": td_soft_label,
        "td_crest_factor": td_crest,
        "td_kurtosis": td_kurt,
        "td_block_energy_crest": td_bec,
        "td_block_peak_width_50": td_bpw,
        "td_block_post_pre_energy_ratio": td_bpp,
        "td_gate_mask": td_gate_mask,
        "td_vote_count": td_vote_count,
        "td_soft_score": td_soft_score,
        "mode_flux_by_mode": mode_flux_by_mode,
        "normalized_mode_flux_by_mode": normalized_mode_flux,
        "flux_primary_raw": flux_primary,
        "flux_modes_raw": flux_modes,
    }
    det_debug.update(aligned_raw)
    if td_envelope_enable:
        for k in ("td_rise_time_sec", "td_fall_time_sec", "td_rise_slope",
                  "td_fall_slope", "td_energy_envelope", "td_peak_energy"):
            det_debug[k] = aligned_td[k]
    if peak_features_enable:
        det_debug.update({
            "peak_ratio": peak_ratio,
            "peak_gate_score": peak_gate_score,
            "peak_valid_count": peak_valid_count,
            "peak_count_by_mode": peak_count_by_mode,
        })

    # clip occupancy (optional)
    if cfg.dflag("clip_spectral_occupancy_enable", False) and raw_power is not None:
        det_debug["clip_spectral_occupancy"] = clip_spectral_occupancy(
            raw_power, frame_class == FrameClass.RAIN, fs=fs, n_fft=n_fft,
            bands=cfg.dget("clip_spectral_occupancy_bands", None), eps=eps,
        )

    # feature dump (3-tier, flattened like the reference)
    feature_dump: Dict[str, Any] = {}
    if int(cfg.dget("feature_dump_level", 0)) > 0:
        if cfg.dflag("feature_dump_dense_enable", True):
            feature_dump.update({
                "primary_mode_flux": primary_flux,
                "support_mode_flux_1": s1,
                "support_mode_flux_2": s2,
                "support_mode_flux_3": s3,
                "support_mode_flux_4": s4,
                "td_block_energy_crest": td_bec,
                "td_block_peak_width_50": td_bpw,
                "td_block_post_pre_energy_ratio": td_bpp,
                "td_gate_mask": td_gate_mask,
            })
            if cfg.dflag("feature_dump_include_frame_class", True):
                feature_dump["frame_class"] = frame_class
            if cfg.dflag("feature_dump_include_td_soft", False):
                feature_dump.update({
                    "td_crest_factor": td_crest,
                    "td_kurtosis": td_kurt,
                    "td_vote_count": td_vote_count,
                    "td_soft_score": td_soft_score,
                })
        # sparse tier: static-shape gather of rain-frame spectral features
        # (reference gathers at flatnonzero(mask) — dynamic; here a fixed
        # K-slot layout with -1-padded indices keeps the program jittable)
        if cfg.dflag("feature_dump_sparse_enable", False):
            gate_feature = str(
                cfg.dget("feature_dump_sparse_gate_feature", "td_block_energy_crest")
            ).strip().lower()
            thr = float(cfg.dget("feature_dump_sparse_gate_threshold", 3.5))
            src = td_crest if gate_feature == "td_crest_factor" else td_bec
            mask = nan_to_num(src) > thr
            feature_dump["sparse_frame_mask"] = mask

            K = min(int(cfg.dget("feature_dump_sparse_max_frames", 64)), T)
            select = str(
                cfg.dget("feature_dump_sparse_select", "first")
            ).strip().lower()
            idxs = jnp.arange(T, dtype=jnp.int32)
            if select == "top":
                # the K most salient gated frames (by gate value), then
                # re-sorted into time order for a stable slot layout
                score = jnp.where(mask, src, -jnp.inf)
                cand = jnp.argsort(-score)[:K].astype(jnp.int32)
                cand = jnp.where(mask[cand], cand, jnp.int32(T))
            else:
                # "first": the first K gated frames in time order — an exact
                # prefix of the reference's flatnonzero(mask) indices
                cand = jnp.sort(jnp.where(mask, idxs, jnp.int32(T)))[:K]
            sel = jnp.sort(cand)
            valid = sel < T
            gather_idx = jnp.where(valid, sel, 0)

            feature_dump["sparse_frame_idx"] = jnp.where(valid, sel, -1)
            feature_dump["sparse_valid_count"] = jnp.sum(
                mask.astype(jnp.int32)
            )
            feature_dump["sparse_captured_count"] = jnp.sum(
                valid.astype(jnp.int32)
            )

            # reference name selection (rain_frame_classifier.py:1131-1152):
            # the full raw-spectral list skips the "basic" trio unless the
            # basic flag is also on; basic-only mode gathers just the trio
            basic = (
                "raw_spectral_centroid_hz", "raw_rain_band_ratio",
                "raw_spectral_rolloff_hz",
            )
            include_full = cfg.dflag(
                "feature_dump_include_raw_spectral_frame_features", True)
            include_basic = cfg.dflag(
                "feature_dump_include_raw_spectral_basic", False)
            if include_full:
                names = tuple(
                    n for n in RAW_SPECTRAL_FEATURE_NAMES
                    if include_basic or n not in basic
                )
            elif include_basic:
                names = basic
            else:
                names = ()
            for name in names:
                vals = aligned_raw[name][gather_idx]
                feature_dump[f"sparse_{name}"] = jnp.where(valid, vals, 0.0)

        # clip-summary tier: clip spectral occupancy in the dump
        if (cfg.dflag("feature_dump_clip_summary_enable", False)
                and "clip_spectral_occupancy" in det_debug):
            feature_dump["clip_spectral_occupancy"] = det_debug[
                "clip_spectral_occupancy"
            ]

    det_debug["peak_features_enable"] = peak_features_enable
    return frame_class, rain_conf, det_debug, feature_dump

class RainFrameClassifierMixin:
    """Compat surface of the reference mixin
    (``rain_frame_classifier.py:114-148, 290``): host classes expose
    ``self.cfg`` (a :class:`NoiseConfig`) and call
    ``self._detect_rain_over_time(P, freqs, ...)``; the body delegates to the
    traced :func:`detect_rain_over_time`."""

    cfg: NoiseConfig

    def _detect_rain_over_time(self, P, freqs=None,
                               detector_frame_times=None, input_audio=None,
                               raw_power=None, work_dtype=None):
        del freqs, detector_frame_times, work_dtype  # derived from cfg
        x = input_audio if input_audio is not None else jnp.zeros(
            (int(self.cfg.dget("n_fft", 256)),), jnp.float32)
        return detect_rain_over_time(self.cfg, jnp.asarray(P), jnp.asarray(x),
                                     raw_power=raw_power)
