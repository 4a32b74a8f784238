"""Spectral noise suppressor + rain detector — the flagship engine.

Accelerator-native re-design of ``SpectralNoiseProcessor``
(reference ``edge/rain_signal_processor.py:257-1198``): one traced function
``waveform -> {frame_class, confidences, noise PSD, gain, S_hat, metrics}``,
jit-compiled per config, vmappable over a batch of clips and shardable over a
``files`` mesh axis.  The per-frame Python loops of the reference (PSD
tracking, gain temporal smoothing) are ``lax.scan`` carries; everything else
is tensor math.

Clip aggregation (``RainDetectorProcessor``,
``edge/rain_signal_processor.py:1205-1344``) is computed in-graph so a batch
of clips returns fixed-shape per-clip metrics without host round-trips.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.config import NoiseConfig, build_noise_config
from audio_processing_tools_tpu.models.frame_classifier import (
    FrameClass,
    build_prefilter_sos,
    detect_rain_over_time,
)
from audio_processing_tools_tpu.ops.stft import (
    stft,
    istft,
    fft_frequencies,
    frames_to_time,
)
from audio_processing_tools_tpu.ops.filters import sosfiltfilt
from audio_processing_tools_tpu.ops.spectrogram import spectrogram_power
from audio_processing_tools_tpu.ops.trackers import (
    noise_psd_track,
    make_psd_params,
    causal_time_median,
    causal_time_mean,
)
from audio_processing_tools_tpu.ops.stats import quantile_linear


def _mode_union_mask(freqs_band: np.ndarray, mode_bands) -> np.ndarray:
    """Union of mode bands over band bins
    (``edge/rain_signal_processor.py:534-551``)."""
    mask = np.zeros(freqs_band.shape[0], dtype=bool)
    if not isinstance(mode_bands, (list, tuple)):
        return mask
    for bb in mode_bands:
        try:
            lo, hi = float(bb[0]), float(bb[1])
        except Exception:
            continue
        if not (np.isfinite(lo) and np.isfinite(hi)) or hi <= lo:
            continue
        mask |= (freqs_band >= lo) & (freqs_band <= hi)
    return mask


_GAIN_NOISE_TH = 0.7  # noise-conf knee for adaptive oversubtraction


def gain_freq_stage(
    cfg: NoiseConfig,
    P_band: jnp.ndarray,       # (K, T)
    N_band: jnp.ndarray,       # (K, T)
    noise_conf: jnp.ndarray,   # (T,)
    snr_gate: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Per-frame part of the suppression gain: oversubtraction + raw gain +
    frequency smoothing.  Purely frame-local, so the streaming suppressor
    (``models/streaming.py``) reuses it verbatim ahead of its carried
    temporal-smoothing scan."""
    eps = cfg.eps
    K, T = P_band.shape
    noise_conf = jnp.clip(noise_conf, 0.0, 1.0)
    adaptive = bool(cfg.adaptive_gain_enable)
    th = _GAIN_NOISE_TH
    denom = max(1e-9, 1.0 - th)

    if adaptive:
        eff_noise = jnp.clip((noise_conf - th) / denom, 0.0, 1.0)
        oversub = cfg.oversub_base + eff_noise * (cfg.oversub_max - cfg.oversub_base)
        if snr_gate is not None:
            sg = jnp.clip(snr_gate.reshape(-1), 0.0, 1.0)
            oversub = oversub * (1.0 - sg)
    else:
        oversub = jnp.full((T,), float(cfg.oversub_base), P_band.dtype)

    oversub_2d = oversub[None, :]

    if cfg.gain_mode.lower() == "wiener":
        P_clean = jnp.maximum(P_band - oversub_2d * N_band, 0.0)
        G_raw = P_clean / (P_band + eps)
    else:
        ratio = jnp.clip(N_band / (P_band + eps), 0.0, 1.0)
        G_raw = 1.0 - oversub_2d * jnp.sqrt(ratio)

    G_raw = jnp.clip(G_raw, cfg.gain_floor, cfg.gain_ceil)

    # ---- frequency smoothing (noise-like frames only when adaptive) ----
    kernel = np.asarray(cfg.gain_freq_kernel, np.float32).reshape(-1)
    if kernel.size < 1:
        kernel = np.array([1.0], np.float32)
    kernel = kernel / (kernel.sum() + 1e-12)
    if bool(cfg.gain_freq_smooth_enable) and kernel.size > 1:
        pad = kernel.size // 2
        Gp = jnp.pad(G_raw, ((pad, pad), (0, 0)))
        G_conv = jnp.zeros_like(G_raw)
        for i, kv in enumerate(kernel):
            G_conv = G_conv + float(kv) * Gp[i : i + K, :]
        if adaptive:
            apply = (noise_conf >= th)[None, :]
            G_freq = jnp.where(apply, G_conv, G_raw)
        else:
            G_freq = G_conv
    else:
        G_freq = G_raw
    return G_freq


def gain_time_step(cfg: NoiseConfig):
    """The causal temporal-smoothing EMA step (rain-frame protected when
    adaptive).  Shared by the offline whole-clip scan below and the
    streaming suppressor's carried chunk scan."""
    adaptive = bool(cfg.adaptive_gain_enable)
    th = _GAIN_NOISE_TH
    denom = max(1e-9, 1.0 - th)
    alpha_base = float(np.clip(cfg.gain_smooth_alpha, 0.0, 1.0))

    def step(G_prev, inp):
        G_f_t, nc_t = inp
        if adaptive:
            eff_nc = (nc_t - th) / denom
            alpha_t = jnp.where(nc_t < th, 0.0, alpha_base * eff_nc)
            G_t = alpha_t * G_prev + (1.0 - alpha_t) * G_f_t
            G_t = jnp.where(nc_t < th, jnp.maximum(G_t, G_f_t), G_t)
        else:
            G_t = alpha_base * G_prev + (1.0 - alpha_base) * G_f_t
        return G_t, G_t

    return step


def compute_gain(
    cfg: NoiseConfig,
    P_band: jnp.ndarray,       # (K, T)
    N_band: jnp.ndarray,       # (K, T)
    noise_conf: jnp.ndarray,   # (T,)
    snr_gate: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Adaptive suppression gain (``edge/rain_signal_processor.py:400-533``).

    Oversubtraction scales with "noise-ness" above th=0.7; frequency
    smoothing applies only on noise-like frames; temporal smoothing is a
    causal EMA scan with rain-frame protection.
    """
    _K, T = P_band.shape
    noise_conf = jnp.clip(noise_conf, 0.0, 1.0)
    G_freq = gain_freq_stage(cfg, P_band, N_band, noise_conf, snr_gate)
    step = gain_time_step(cfg)

    if T > 1:
        _, G_rest = jax.lax.scan(
            step, G_freq[:, 0],
            (jnp.moveaxis(G_freq[:, 1:], -1, 0), noise_conf[1:]), unroll=8,
        )
        G_time = jnp.concatenate(
            [G_freq[:, :1], jnp.moveaxis(G_rest, 0, -1)], axis=-1
        )
    else:
        G_time = G_freq
    return jnp.clip(G_time, cfg.gain_floor, cfg.gain_ceil)


class SpectralNoiseEngine:
    """Config-bound, jit-compiled engine.

    ``process(x, sr)`` mirrors the reference's output dict for one clip;
    ``process_batch(xb)`` runs a ``(B, N)`` batch through one vmapped program
    and additionally returns in-graph clip aggregates.
    """

    def __init__(self, config: Optional[NoiseConfig] = None):
        self.cfg = config
        self._is_setup = config is not None
        if self._is_setup:
            self.cfg.validate()
        self._compiled: Dict[Any, Any] = {}

    def setup(self, params: Dict[str, Any]) -> None:
        if self._is_setup:
            return
        sr = int(params.get("sample_rate", params.get("fs", 11162)))
        self.cfg = build_noise_config(sr, params)
        self.cfg.validate()
        self._is_setup = True

    # ------------------------------------------------------------------
    def _trace_single(self, x: jnp.ndarray, sr: int) -> Dict[str, Any]:
        """Traced body for one clip. All config access is trace-time."""
        cfg = self.cfg
        x = x.astype(jnp.float32).reshape(-1)

        mode = str(cfg.pre_filter_mode).lower()
        if mode not in ("highpass", "bandpass", "none"):
            mode = "highpass"
        x_proc = x
        if mode != "none":
            sos = build_prefilter_sos(cfg, sr, mode)
            if sos is not None:
                x_proc = sosfiltfilt(sos, x)

        # The complex STFT is only needed when spectra / reconstructed audio
        # leave the engine; the pure detector/metrics path needs only the
        # power spectrogram.
        needs_complex = bool(
            cfg.return_spectra or cfg.compute_output_audio
            or cfg.return_filtered_audio
        )
        if needs_complex:
            S = stft(x, n_fft=cfg.n_fft, hop=cfg.hop, center=True)
            P = (S.real**2 + S.imag**2).astype(jnp.float32)
        else:
            S = None
            P = spectrogram_power(x, n_fft=cfg.n_fft, hop=cfg.hop, center=True)
        freqs = fft_frequencies(sr, cfg.n_fft)
        F, T = P.shape

        op_lo, op_hi = cfg.operating_band
        band_mask = (freqs >= op_lo) & (freqs <= op_hi)
        band_rows = np.flatnonzero(band_mask)  # static integer gather/scatter
        K = int(band_mask.sum())
        frames_per_sec = float(sr) / float(cfg.hop)

        psd_params = make_psd_params(
            cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=frames_per_sec,
            ema_up=cfg.ema_up, ema_down=cfg.ema_down, eps=cfg.eps,
            noise_psd_max_ratio=cfg.noise_psd_max_ratio,
            adaptive_q_enable=cfg.adaptive_q_enable,
            adaptive_q_min=cfg.adaptive_q_min,
            adaptive_q_alpha=cfg.adaptive_q_alpha,
        )

        def estimate_noise_psd(P_full, is_rain_for_psd):
            """``_estimate_noise_psd_fft`` parity: band-only tracking with
            optional pre-smoothing and causal median post-filter."""
            P_band_all = P_full[band_rows, :]
            L = int(cfg.pre_smooth_frames)
            if L and L > 1:
                P_band_all = causal_time_mean(P_band_all, L)
            N_band = noise_psd_track(P_band_all, is_rain_for_psd, psd_params)
            noise_psd = jnp.zeros_like(P_full)
            noise_psd = noise_psd.at[band_rows, :].set(N_band)
            m = int(cfg.median_frames)
            if m and m > 1:
                noise_psd = causal_time_median(noise_psd, m)
            return noise_psd

        bypass_classifier = cfg.dflag("bypass_classifier", False)
        use_norm = cfg.dflag("detector_use_noise_norm", True)
        norm_mode = str(cfg.detector_noise_norm_mode).lower()
        maxr = float(cfg.noise_psd_max_ratio)
        maxr = 1.0 if not np.isfinite(maxr) else float(np.clip(maxr, 0.0, 1.0))

        detector_noise_psd = None
        detector_noise_psd_lag = None
        det_debug: Dict[str, Any] = {}
        feature_dump: Dict[str, Any] = {}

        if bypass_classifier:
            frame_class = jnp.zeros((T,), jnp.int8)
            rain_conf = jnp.zeros((T,), jnp.float32)
            det_debug = {
                "frame_class": frame_class,
                "rain_conf": rain_conf,
                "noise_conf": jnp.ones((T,), jnp.float32),
            }
        else:
            P_masked = jnp.where(jnp.asarray(band_mask)[:, None], P, 0.0)
            if use_norm:
                detector_noise_psd = estimate_noise_psd(
                    P, jnp.zeros((T,), bool)
                )
                lag = jnp.roll(detector_noise_psd, 1, axis=1)
                lag = lag.at[:, 0].set(detector_noise_psd[:, 0]) if T > 1 else detector_noise_psd
                detector_noise_psd_lag = jnp.minimum(lag, maxr * P)
                if norm_mode == "ratio_db":
                    P_det = 10.0 * jnp.log10(
                        P_masked / (detector_noise_psd_lag + cfg.eps) + cfg.eps
                    )
                else:
                    P_det = 10.0 * jnp.log10(P_masked + cfg.eps) - 10.0 * jnp.log10(
                        detector_noise_psd_lag + cfg.eps
                    )
            else:
                P_det = 10.0 * jnp.log10(P_masked + cfg.eps)

            frame_class, rain_conf, det_debug, feature_dump = detect_rain_over_time(
                cfg, P_det, x, raw_power=P
            )

        is_rain = frame_class == jnp.int8(FrameClass.RAIN)
        is_noise = frame_class == jnp.int8(FrameClass.NOISE)
        noise_conf = det_debug.get(
            "noise_conf", jnp.clip(1.0 - rain_conf, 0.0, 1.0)
        )

        times = jnp.asarray(
            frames_to_time(np.arange(T), sr, cfg.hop), jnp.float32
        )

        out: Dict[str, Any] = {
            "frame_class": frame_class,
            "rain_conf": rain_conf,
            "noise_conf": noise_conf,
            "times": times,
        }
        if cfg.dump_features:
            out["features"] = {
                "frame_times": times,
                "frame_class": frame_class,
                "is_rain": is_rain,
                "rain_conf": rain_conf,
                "noise_conf": noise_conf,
                **feature_dump,
            }
        keep_det_debug = cfg.return_detector_debug or cfg.debug_enable
        if keep_det_debug:
            out["det_debug"] = det_debug

        if cfg.classifier_only_mode:
            if cfg.return_filtered_audio or cfg.compute_output_audio:
                out["x_filt"] = x_proc
                out["y"] = x_proc
            if cfg.return_spectra:
                out["S"] = S
                out["S_hat"] = S
            return out

        # ---------------- suppressor path ----------------
        use_for_noise_psd = is_noise
        is_rain_for_psd = ~use_for_noise_psd
        P_band_all = P[band_rows, :]
        snr_gate = None
        snr_mode_arr = None

        if cfg.suppressor_bypass:
            noise_psd = jnp.zeros_like(P)
            N_band_all = noise_psd[band_rows, :]
            G = jnp.ones_like(P)
            S_hat = S  # None when the complex STFT was skipped
            y = x_proc if cfg.compute_output_audio else None
        else:
            noise_psd = estimate_noise_psd(P, is_rain_for_psd)
            N_band_all = noise_psd[band_rows, :]
            if bool(cfg.use_lagged_noise_psd) and T > 1:
                N_lag = jnp.roll(N_band_all, 1, axis=1)
                N_lag = N_lag.at[:, 0].set(N_band_all[:, 0])
            else:
                N_lag = N_band_all
            N_eff = jnp.minimum(N_lag, maxr * P_band_all)

            if bool(cfg.snr_gating_enable):
                mode_bands = (cfg.detector or {}).get("mode_bands", None) if bool(
                    cfg.snr_gating_use_mode_bands
                ) else None
                freqs_band = freqs[band_mask]
                mm = _mode_union_mask(freqs_band, mode_bands) if mode_bands is not None \
                    else np.ones(K, bool)
                if not mm.any():
                    mm = np.ones(K, bool)
                Pm = jnp.sum(P_band_all[np.flatnonzero(mm), :], axis=0)
                Nm = jnp.sum(N_eff[np.flatnonzero(mm), :], axis=0)
                snr_mode_arr = Pm / (Nm + cfg.eps)
                snr1 = max(1e-9, float(cfg.snr_gating_snr1))
                gate = snr_mode_arr / (snr_mode_arr + snr1)
                pwr = float(cfg.snr_gating_power)
                if pwr != 1.0 and np.isfinite(pwr) and pwr > 0.0:
                    gate = jnp.power(jnp.clip(gate, 0.0, 1.0), pwr)
                snr_gate = jnp.clip(gate, 0.0, 1.0)

            G_band = compute_gain(cfg, P_band_all, N_eff, noise_conf, snr_gate)
            G = jnp.ones_like(P)
            G = G.at[band_rows, :].set(G_band)
            S_hat = G * S if S is not None else None
            if cfg.compute_output_audio:
                y = istft(S_hat, n_fft=cfg.n_fft, hop=cfg.hop,
                          length=x.shape[-1], center=True)
            else:
                y = None

        # metrics computed in-graph (adapter parity)
        noise_band = noise_psd[band_rows, :]
        noise_db = 10.0 * jnp.log10(noise_band + cfg.eps)
        out["mean_noise_floor_db"] = jnp.mean(noise_db)
        out["median_noise_floor_db"] = quantile_linear(noise_db.reshape(-1), 0.5)

        if cfg.return_noise_psd or cfg.debug_enable:
            out["noise_psd"] = noise_psd
        if cfg.return_debug or cfg.debug_enable:
            out["debug"] = {
                "use_for_noise_psd": use_for_noise_psd,
                "is_rain_for_psd": is_rain_for_psd,
                "G": G,
                "noise_psd": noise_psd,
                "snr_mode": snr_mode_arr,
                "snr_gate": snr_gate,
                "detector_noise_psd": detector_noise_psd,
                "detector_noise_psd_lag": detector_noise_psd_lag,
                # band-limited power/noise panels (reference debug keys,
                # visualize_noise_output.py:54-58, 641-727)
                "P_band_all": P_band_all,
                "N_band_all": N_band_all,
                "freqs_band": jnp.asarray(freqs[band_mask]),
            }
        if cfg.return_spectra:
            out["S"] = S
            out["S_hat"] = S_hat
        if cfg.return_filtered_audio or cfg.compute_output_audio:
            out["x_filt"] = x_proc
            out["y"] = y
            out["y_suppressed"] = y
        return out

    # ------------------------------------------------------------------
    def _get_fn(self, n: int, sr: int, batched: bool):
        key = (n, sr, batched)
        fn = self._compiled.get(key)
        if fn is None:
            single = lambda x: self._trace_single(x, sr)
            if batched:
                fn = jax.jit(jax.vmap(single))
            else:
                fn = jax.jit(single)
            self._compiled[key] = fn
        return fn

    def process(self, x, sr: Optional[int] = None) -> Dict[str, Any]:
        """Single clip; returns a dict of NumPy arrays (reference API shape)."""
        if self.cfg is None:
            self.setup({"sample_rate": sr or 11162})
        if sr is None:
            sr = self.cfg.fs
        x = jnp.asarray(np.asarray(x, np.float32).reshape(-1))
        out = self._get_fn(x.shape[-1], int(sr), batched=False)(x)
        return jax.tree_util.tree_map(np.asarray, out)

    def process_batch(self, xb, sr: Optional[int] = None) -> Dict[str, Any]:
        """Batch of clips (B, N) through one vmapped program (device output)."""
        if self.cfg is None:
            self.setup({"sample_rate": sr or 11162})
        if sr is None:
            sr = self.cfg.fs
        xb = jnp.asarray(xb, jnp.float32)
        return self._get_fn(xb.shape[-1], int(sr), batched=True)(xb)


# ---------------------------------------------------------------------------
# Framework adapter
# ---------------------------------------------------------------------------


def clip_aggregate(frame_class: np.ndarray, rain_conf: np.ndarray,
                   clip_rain_min_frames: int = 1) -> Dict[str, Any]:
    """Clip-level aggregation (``RainDetectorProcessor.run``,
    ``edge/rain_signal_processor.py:1254-1271``)."""
    frame_is_rain = np.asarray(frame_class, np.int8) == int(FrameClass.RAIN)
    cmin = max(1, int(clip_rain_min_frames))
    count = int(frame_is_rain.sum())
    frac = float(frame_is_rain.mean()) if frame_is_rain.size else 0.0
    clip_is_rain = bool(count >= cmin)
    rc = np.asarray(rain_conf, np.float32).reshape(-1)
    if count > 0 and rc.size == frame_is_rain.size:
        median_conf = float(np.median(rc[frame_is_rain]))
    else:
        median_conf = 0.0
    abundance_ref = max(2 * cmin, 1)
    abundance_conf = float(np.clip(count / float(abundance_ref), 0.0, 1.0))
    return {
        "rain_frame_fraction": frac,
        "clip_rain_fraction": frac,
        "rain_frame_count": count,
        "clip_is_rain": clip_is_rain,
        "clip_rain_conf": float(max(median_conf, abundance_conf)),
        "median_rain_conf": median_conf,
        "clip_rain_min_frames": cmin,
    }


class RainDetectorProcessor:
    """Framework-facing processor (parity with the reference class of the
    same name).  Caches one configured engine per parameter set."""

    def __init__(self, name: str = "rain_detector"):
        self.name = name
        self._cache: Dict[str, SpectralNoiseEngine] = {}

    @staticmethod
    def _key(params: Dict[str, Any]) -> str:
        try:
            return json.dumps(params, sort_keys=True, default=str)
        except Exception:
            return repr(sorted(params.items(), key=lambda kv: kv[0]))

    def _engine(self, params: Dict[str, Any]) -> SpectralNoiseEngine:
        key = self._key(params)
        eng = self._cache.get(key)
        if eng is None:
            eng = SpectralNoiseEngine()
            eng.setup(params)
            self._cache[key] = eng
        return eng

    def run(self, audio_data: np.ndarray, params: Dict[str, Any]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        import time as _time

        audio_data = np.asarray(audio_data)
        if audio_data.ndim != 1:
            raise ValueError(f"audio_data must be 1-D, got {audio_data.shape}")
        sr_chk = params.get("sample_rate")
        dur_chk = params.get("check_duration")
        if sr_chk is not None and dur_chk is not None:
            if audio_data.size < int(sr_chk * dur_chk):
                raise ValueError(
                    f"audio_data too short: {audio_data.size} < "
                    f"{int(sr_chk * dur_chk)}"
                )

        p = dict(params)
        keep_audio = bool(p.get("keep_state_audio", False))
        keep_spectra = bool(p.get("keep_state_spectra", False))
        keep_debug = bool(p.get("keep_state_debug", False))
        keep_features = bool(p.get("keep_state_features", True))
        p.setdefault("compute_output_audio", keep_audio)
        p.setdefault("return_filtered_audio", keep_audio)
        p.setdefault("return_spectra", keep_spectra)
        p.setdefault("return_debug", keep_debug)
        p.setdefault("return_detector_debug", keep_debug)
        p.setdefault("return_noise_psd", keep_debug)

        sample_rate = int(p.get("sample_rate", 11162))
        eng = self._engine(p)

        t0 = _time.perf_counter()
        out = eng.process(audio_data, sr=sample_rate)
        latency = _time.perf_counter() - t0

        agg = clip_aggregate(
            out.get("frame_class", np.zeros(0, np.int8)),
            out.get("rain_conf", np.zeros(0, np.float32)),
            int(p.get("clip_rain_min_frames", 1)),
        )
        metrics: Dict[str, Any] = {**agg, "latency_s": latency}
        if "mean_noise_floor_db" in out:
            metrics["mean_noise_floor_db"] = float(out["mean_noise_floor_db"])
            metrics["median_noise_floor_db"] = float(out["median_noise_floor_db"])

        state: Dict[str, Any] = {
            "frame_class": out.get("frame_class"),
            "times": out.get("times"),
            "rain_conf": out.get("rain_conf"),
            "noise_conf": out.get("noise_conf"),
            **agg,
            "latency_s": latency,
            "processor": self.name,
        }
        if keep_features:
            state["features"] = out.get("features")
        if keep_debug:
            for k in ("debug", "det_debug", "noise_psd"):
                if k in out:
                    state[k] = out[k]
        if keep_spectra:
            state["S"] = out.get("S")
            state["S_hat"] = out.get("S_hat")
        if keep_audio:
            state["input_audio"] = audio_data
            if "x_filt" in out:
                state["filtered_audio"] = out["x_filt"]
            if "y" in out:
                state["output_audio"] = out["y"]
        if bool(p.get("keep_state_config", False)):
            state["config"] = eng.cfg
        return metrics, state

    def run_batch(self, audio_matrix: np.ndarray, params: Dict[str, Any]
                  ) -> list:
        """Device-batched path: one vmapped program for a (B, N) batch.

        Returns ``[(metrics, state), ...]`` per clip — the orchestrator's
        ``run_batch`` contract.  This is the batched device replacement for the
        reference's per-file ProcessPoolExecutor fan-out.
        """
        import time as _time

        audio_matrix = np.asarray(audio_matrix, np.float32)
        if audio_matrix.ndim != 2:
            raise ValueError(f"audio_matrix must be 2-D, got {audio_matrix.shape}")
        B = audio_matrix.shape[0]

        p = dict(params)
        keep_features = bool(p.get("keep_state_features", True))
        for flag, default in (
            ("compute_output_audio", False), ("return_filtered_audio", False),
            ("return_spectra", False), ("return_debug", False),
            ("return_detector_debug", False), ("return_noise_psd", False),
        ):
            p.setdefault(flag, bool(p.get("keep_state_debug", False)) or default)

        sample_rate = int(p.get("sample_rate", 11162))
        eng = self._engine(p)
        t0 = _time.perf_counter()
        out = eng.process_batch(audio_matrix, sr=sample_rate)
        out = jax.tree_util.tree_map(np.asarray, out)
        latency = (_time.perf_counter() - t0) / max(B, 1)

        cmin = int(p.get("clip_rain_min_frames", 1))
        pairs = []
        for i in range(B):
            fc = out["frame_class"][i]
            rc = out["rain_conf"][i]
            agg = clip_aggregate(fc, rc, cmin)
            metrics: Dict[str, Any] = {**agg, "latency_s": latency}
            if "mean_noise_floor_db" in out:
                metrics["mean_noise_floor_db"] = float(out["mean_noise_floor_db"][i])
                metrics["median_noise_floor_db"] = float(
                    out["median_noise_floor_db"][i]
                )
            state: Dict[str, Any] = {
                "frame_class": fc,
                "times": out["times"][i],
                "rain_conf": rc,
                "noise_conf": out["noise_conf"][i],
                **agg,
                "latency_s": latency,
                "processor": self.name,
            }
            if keep_features and "features" in out:
                state["features"] = {
                    k: v[i] for k, v in out["features"].items()
                }
            pairs.append((metrics, state))
        return pairs
