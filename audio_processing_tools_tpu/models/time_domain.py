"""Stage-2 time-domain droplet confirmation, vectorized over frames.

Re-design of ``TimeDomainRainDetector``
(reference ``edge/time_domain_detector.py``): instead of per-candidate-frame
Python loops, all analysis windows are grouped by their (static) length and
processed as batched tensors — Hilbert envelopes via batched FFT, peak
picking via the vectorized peak ops, crest/kurtosis via batched reductions.
Masking by the stage-1 rain mask happens at the end (compute-everywhere,
select-by-mask — the static-shape trade).

Window = ``prev_context_hops`` hops + current frame + ``future_context_hops``
hops, clipped to the signal ([t-128, t+256] -> 384 samples by default).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.ops.filters import design_bandpass, sosfiltfilt, sosfilt
from audio_processing_tools_tpu.ops.peaks import (
    local_maxima,
    peak_prominences,
    select_peaks_by_distance,
)


@dataclass(frozen=True)
class TimeDomainDetectorConfig:
    """(``edge/time_domain_detector.py:10-38``)."""

    fs: int = 11162
    n_fft: int = 256
    hop: int = 128
    prev_context_hops: int = 1
    future_context_hops: int = 0
    mode_bands: Optional[Tuple[Tuple[float, float], ...]] = None
    operating_band: Tuple[float, float] = (400.0, 3500.0)
    bp_order: int = 4
    envelope_smooth_ms: float = 2.0
    peak_prominence_ratio: float = 0.25
    peak_distance_ms: float = 4.0
    min_crest_factor: float = 3.0
    min_kurtosis: float = 3.5
    eps: float = 1e-9


def build_time_domain_config(params: Dict[str, Any]) -> TimeDomainDetectorConfig:
    """Framework-params builder (``time_domain_detector.py:41-73``)."""
    td = dict(params.get("time_domain", {}) or {})
    det = dict(params.get("detector", {}) or {})

    mode_bands_raw = det.get("mode_bands", None)
    mode_bands = None
    if isinstance(mode_bands_raw, (list, tuple)):
        bands = []
        for bb in mode_bands_raw:
            try:
                lo, hi = float(bb[0]), float(bb[1])
            except Exception:
                continue
            if np.isfinite(lo) and np.isfinite(hi) and hi > lo:
                bands.append((lo, hi))
        mode_bands = tuple(bands) if bands else None

    return TimeDomainDetectorConfig(
        fs=int(params.get("sample_rate", params.get("fs", 11162))),
        n_fft=int(params.get("n_fft", 256)),
        hop=int(params.get("hop", 128)),
        prev_context_hops=int(td.get("prev_context_hops", 1)),
        future_context_hops=int(td.get("future_context_hops", 0)),
        mode_bands=mode_bands,
        operating_band=tuple(params.get("operating_band", (400.0, 3500.0))),
        bp_order=int(td.get("bp_order", 4)),
        envelope_smooth_ms=float(td.get("envelope_smooth_ms", 2.0)),
        peak_prominence_ratio=float(td.get("peak_prominence_ratio", 0.25)),
        peak_distance_ms=float(td.get("peak_distance_ms", 4.0)),
        min_crest_factor=float(td.get("min_crest_factor", 3.0)),
        min_kurtosis=float(td.get("min_kurtosis", 3.5)),
        eps=float(td.get("eps", 1e-9)),
    )


def hilbert_envelope(seg: jnp.ndarray) -> jnp.ndarray:
    """|analytic signal| over the last axis (scipy ``hilbert`` parity)."""
    n = seg.shape[-1]
    X = jnp.fft.fft(seg.astype(jnp.float32), axis=-1)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1 : (n + 1) // 2] = 2.0
    analytic = jnp.fft.ifft(X * jnp.asarray(h), axis=-1)
    return jnp.abs(analytic)


def _mode_signal(x: jnp.ndarray, cfg: TimeDomainDetectorConfig, sr: int
                 ) -> jnp.ndarray:
    """Summed mode-band bandpass signal (``time_domain_detector.py:99-143``)."""
    bands: List[Tuple[float, float]] = []
    if cfg.mode_bands:
        bands = [(float(a), float(b)) for a, b in cfg.mode_bands]
    if not bands:
        bands = [tuple(map(float, cfg.operating_band))]
    y = jnp.zeros_like(x)
    for lo, hi in bands:
        sos = design_bandpass(sr, lo, hi, cfg.bp_order)
        n_sections = sos.shape[0]
        ntaps = 2 * n_sections + 1 - int(
            min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
        )
        if x.shape[-1] > 3 * ntaps:
            y = y + sosfiltfilt(sos, x)
        else:
            y = y + sosfilt(sos, x)
    return y


def _analyze_windows(env: jnp.ndarray, seg: jnp.ndarray, lengths: np.ndarray,
                     cfg: TimeDomainDetectorConfig, sr: int):
    """Batched window analysis: (n_win, L) envelope + raw segment.

    ``lengths`` gives the true window length per row (rows are zero-padded to
    L); all stats respect the valid region.
    """
    nw, L = env.shape
    valid = np.arange(L)[None, :] < lengths[:, None]
    vmask = jnp.asarray(valid)

    env_m = jnp.where(vmask, env, -jnp.inf)
    env_max = jnp.max(env_m, axis=-1)
    prominence_thr = jnp.maximum(cfg.eps, cfg.peak_prominence_ratio * env_max)
    distance = max(1, int(round(cfg.peak_distance_ms * 1e-3 * sr)))

    # scipy find_peaks order: local maxima -> distance -> prominence
    env_z = jnp.where(vmask, env, 0.0)
    is_max = local_maxima(env_z) & vmask
    kept = jax.vmap(lambda e, m: select_peaks_by_distance(e, m, distance))(
        env_z, is_max
    )
    prom = peak_prominences(env_z, kept)
    peaks = kept & (prom >= prominence_thr[:, None])
    n_peaks = jnp.sum(peaks, axis=-1).astype(jnp.int32)

    # whole-window crest + kurtosis on the raw segment
    cnt = jnp.asarray(lengths, jnp.float32)
    seg_z = jnp.where(vmask, seg, 0.0)
    msq = jnp.sum(seg_z * seg_z, axis=-1) / jnp.maximum(cnt, 1.0)
    rms = jnp.sqrt(msq + cfg.eps)
    peak_abs = jnp.max(jnp.where(vmask, jnp.abs(seg), 0.0), axis=-1)
    crest = peak_abs / jnp.maximum(rms, cfg.eps)

    mean = jnp.sum(seg_z, axis=-1) / jnp.maximum(cnt, 1.0)
    d = jnp.where(vmask, seg - mean[:, None], 0.0)
    m2 = jnp.sum(d * d, axis=-1) / jnp.maximum(cnt, 1.0)
    m4 = jnp.sum((d * d) ** 2, axis=-1) / jnp.maximum(cnt, 1.0)
    g2 = m4 / jnp.where(m2 > 0, m2 * m2, 1.0) - 3.0
    nf = cnt
    G2 = ((nf + 1.0) * g2 + 6.0) * (nf - 1.0) / jnp.maximum(
        (nf - 2.0) * (nf - 3.0), 1.0
    )
    kurt = jnp.where((m2 > 0) & (nf >= 4), G2 + 3.0, 0.0)
    kurt = jnp.where(jnp.isfinite(kurt), kurt, 0.0)

    confirmed = (n_peaks > 0) & (crest >= cfg.min_crest_factor) & (
        kurt >= cfg.min_kurtosis
    )
    return confirmed, n_peaks, crest, kurt, peaks


class TimeDomainRainDetector:
    """Stage-2 confirmation over stage-1 rain frames (batched compute)."""

    def __init__(self, config: Optional[TimeDomainDetectorConfig] = None):
        self.cfg = config
        self._is_setup = config is not None
        self._compiled: Dict[Any, Any] = {}

    def setup(self, params: Dict[str, Any]) -> None:
        if self._is_setup:
            return
        self.cfg = build_time_domain_config(params)
        self._is_setup = True

    def _window_bounds(self, t: int, n: int) -> Tuple[int, int]:
        cfg = self.cfg
        frame_start = t * cfg.hop
        start = max(0, frame_start - max(0, cfg.prev_context_hops) * cfg.hop)
        end = min(n, frame_start + max(1, cfg.n_fft)
                  + max(0, cfg.future_context_hops) * cfg.hop)
        return start, end

    def _traced(self, x: jnp.ndarray, sr: int, T: int):
        cfg = self.cfg
        n = x.shape[-1]
        x_mode = _mode_signal(x.astype(jnp.float32), cfg, sr)

        bounds = [self._window_bounds(t, n) for t in range(T)]
        lengths = np.array([e - s for s, e in bounds])
        L = int(lengths.max()) if T else 0
        idx = np.zeros((T, L), np.int64)
        for t, (s, e) in enumerate(bounds):
            ln = e - s
            idx[t, :ln] = np.arange(s, e)
        seg = jnp.where(
            jnp.asarray(np.arange(L)[None, :] < lengths[:, None]),
            x_mode[idx], 0.0,
        )

        # envelope per window: Hilbert over the *clipped* window, grouped by
        # unique length so FFT sizes stay static (reference computes Hilbert
        # on each clipped segment)
        env = jnp.zeros_like(seg)
        smooth_len = max(1, int(round(cfg.envelope_smooth_ms * 1e-3 * sr)))
        kernel = np.ones(smooth_len) / smooth_len
        for ln in np.unique(lengths):
            rows = np.flatnonzero(lengths == ln)
            sub = seg[rows, :ln]
            e = hilbert_envelope(sub)
            if smooth_len > 1:
                # np.convolve(mode="same") REVERSES the kernel, so for an
                # even-length boxcar the window is [t-ceil, t+floor], not
                # [t-floor, t+ceil]; the mirrored split shifted every
                # envelope peak by one sample vs the reference
                pad_l = smooth_len // 2
                pad_r = smooth_len - 1 - pad_l
                ep = jnp.pad(e, ((0, 0), (pad_l, pad_r)))
                e = jnp.stack(
                    [ep[:, i : i + ln] for i in range(smooth_len)], axis=0
                )
                e = jnp.tensordot(jnp.asarray(kernel, jnp.float32), e, axes=1,
                                  precision=jax.lax.Precision.HIGHEST)
            env = env.at[np.ix_(rows, np.arange(ln))].set(e)

        confirmed, n_peaks, crest, kurt, peak_mask = _analyze_windows(
            env, seg, lengths, cfg, sr
        )
        return {
            "confirmed_mask": confirmed,
            "confirmed_counts": jnp.where(confirmed, n_peaks, 0),
            "crest_factor": crest,
            "kurtosis": kurt,
            "candidate_peaks": n_peaks,
            "x_mode": x_mode,
            "peak_mask": peak_mask,
        }

    def process(self, x, stage1_is_rain: Optional[np.ndarray] = None,
                sr: Optional[int] = None) -> Dict[str, Any]:
        """Reference-shaped output dict; rows outside the stage-1 mask are
        zeroed (compute-everywhere, mask-at-end)."""
        if self.cfg is None:
            self.setup({"sample_rate": sr or 11162})
        cfg = self.cfg
        if sr is None:
            sr = cfg.fs
        x = np.asarray(x, np.float32).reshape(-1)

        if stage1_is_rain is not None:
            stage1_is_rain = np.asarray(stage1_is_rain, bool).reshape(-1)
            T = int(stage1_is_rain.shape[0])
            run_mask = stage1_is_rain
        else:
            T = 0 if x.size < cfg.n_fft else 1 + (x.size - cfg.n_fft) // cfg.hop
            run_mask = np.ones(T, bool)
            stage1_is_rain = run_mask.copy()

        key = (x.size, int(sr), T)
        fn = self._compiled.get(key)
        if fn is None:
            fn = jax.jit(lambda xx: self._traced(xx, int(sr), T))
            self._compiled[key] = fn
        out = jax.tree_util.tree_map(np.asarray, fn(jnp.asarray(x)))

        rm = run_mask
        details = []
        for t in np.flatnonzero(rm):
            s, e = self._window_bounds(int(t), x.size)
            details.append({
                "frame_idx": int(t),
                "window": (s, e),
                "confirmed": bool(out["confirmed_mask"][t]),
                "confirmed_raindrops": int(out["confirmed_counts"][t]),
                "n_candidate_peaks": int(out["candidate_peaks"][t]),
                "crest_factor": float(out["crest_factor"][t]),
                "kurtosis": float(out["kurtosis"][t]),
                "peak_indices_local": np.flatnonzero(out["peak_mask"][t]).astype(
                    np.int32
                ),
            })

        return {
            "confirmed_mask": out["confirmed_mask"] & rm,
            "confirmed_counts": np.where(rm, out["confirmed_counts"], 0),
            "crest_factor": np.where(rm, out["crest_factor"], 0.0),
            "kurtosis": np.where(rm, out["kurtosis"], 0.0),
            "candidate_peaks": np.where(rm, out["candidate_peaks"], 0),
            "details": details,
            "x_mode": out["x_mode"],
            "stage1_is_rain": stage1_is_rain,
            "run_mask": rm,
        }
