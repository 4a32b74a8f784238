"""Streaming chunked rain detection with explicit carried state.

BASELINE config #4 ("streaming edge-style chunked inference: overlapped
frames with stateful noise-floor tracking"): the flagship detector in a
strictly causal, chunk-by-chunk form — the deployment shape of the firmware
(``edge/README.md``: no look-ahead, ``center=False``).

Differences from the offline engine (all inherent to causality):
  * causal framing (``center=False``) instead of librosa center padding,
  * the TD front-end uses a *causal* streaming prefilter (``sosfilt`` with
    carried ``zi``) instead of zero-phase ``filtfilt``,
  * block-energy/peak diagnostics are omitted (they are tuning payloads; the
    TD gate uses the per-frame crest factor, as in the offline default).

The invariant tested is **chunk invariance**: processing a stream in any
chunking (multiples of ``hop``) produces bit-identical outputs to processing
it in one call, because every tracker threads an explicit carry
(:mod:`ops.trackers` carry variants).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.config import NoiseConfig, build_noise_config
from audio_processing_tools_tpu.models.frame_classifier import (
    FrameClass,
    build_prefilter_sos,
    rain_frame_decision,
)
from audio_processing_tools_tpu.models.spectral_noise import (
    gain_freq_stage,
    gain_time_step,
)
from audio_processing_tools_tpu.ops.framing import frame_signal
from audio_processing_tools_tpu.ops.stft import fft_frequencies
from audio_processing_tools_tpu.ops.windows import hann_window
from audio_processing_tools_tpu.ops.filters import sosfilt
from audio_processing_tools_tpu.ops.stats import kurtosis, crest_factor, nan_to_num
from audio_processing_tools_tpu.ops.trackers import (
    make_psd_params,
    make_psd_track_step,
    noise_psd_track_chunk,
    causal_low_quantile_baseline_chunk,
)


class StreamingRainDetector:
    """Causal chunked rain-frame detector with explicit state threading.

    Usage::

        det = StreamingRainDetector(); det.setup(params)
        state = det.init_state()
        for chunk in hop_multiple_chunks(stream):
            state, out = det.process_chunk(state, chunk)
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
    def _static(self):
        cfg = self.cfg
        sr = cfg.fs
        n_fft, hop = cfg.n_fft, cfg.hop
        freqs = fft_frequencies(sr, n_fft)
        op_lo, op_hi = cfg.operating_band
        band_mask = (freqs >= op_lo) & (freqs <= op_hi)
        band_rows = np.flatnonzero(band_mask)
        freqs_band = freqs[band_mask]
        mode_bands = tuple(
            (float(a), float(b)) for a, b in cfg.dget("mode_bands")
        )
        mode_masks = np.stack(
            [(freqs_band >= lo) & (freqs_band <= hi) for lo, hi in mode_bands]
        )
        fps = float(sr) / float(hop)
        psd_params = make_psd_params(
            cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=fps,
            ema_up=cfg.ema_up, ema_down=cfg.ema_down, eps=cfg.eps,
            noise_psd_max_ratio=cfg.noise_psd_max_ratio,
            adaptive_q_enable=cfg.adaptive_q_enable,
            adaptive_q_min=cfg.adaptive_q_min,
            adaptive_q_alpha=cfg.adaptive_q_alpha,
        )
        td_mode = str(
            cfg.dget("td_prefilter_mode", cfg.dget("pre_filter_mode", "none"))
        ).lower()
        td_sos = None
        if cfg.dflag("td_apply_input_prefilter", True) and td_mode not in ("", "none"):
            td_sos = build_prefilter_sos(cfg, sr, td_mode)
        return (sr, n_fft, hop, band_rows, mode_masks, fps, psd_params, td_sos)

    # ------------------------------------------------------------------
    @property
    def emit_audio(self) -> bool:
        """True when chunks also return denoised audio (``y``)."""
        return bool(self.cfg.compute_output_audio)

    @property
    def audio_delay_samples(self) -> int:
        """Constant latency of the emitted denoised audio vs the input
        stream: the OLA-ISTFT can only finalize a sample once every frame
        overlapping it has been processed, i.e. ``n_fft - hop`` samples
        (~11.5 ms at the default 256/128 @ 11162 Hz)."""
        return int(self.cfg.n_fft - self.cfg.hop)

    def _audio_static(self):
        """Trace-time constants for the causal suppressor output path."""
        cfg = self.cfg
        if cfg.n_fft != 2 * cfg.hop:
            raise ValueError(
                "streaming audio output requires 50% overlap (n_fft == "
                f"2*hop); got n_fft={cfg.n_fft} hop={cfg.hop}"
            )
        for knob in ("pre_smooth_frames", "median_frames"):
            if int(getattr(cfg, knob, 0) or 0) > 1:
                raise ValueError(
                    f"streaming audio output does not support {knob} "
                    "(acausal-window smoothing); clear it or use the "
                    "offline engine"
                )
        w = np.asarray(hann_window(cfg.n_fft), np.float64)
        hop = cfg.hop
        # steady-state weighted-OLA normalizer: periodic with period hop.
        # Shipped as a RECIPROCAL constant and applied by multiply — XLA's
        # CPU division lowers differently per shape (measured 2e-7 drift
        # between tile sizes), which would break bitwise chunk invariance.
        ws = np.zeros(hop)
        for j in range(cfg.n_fft // hop):
            ws += w[j * hop : (j + 1) * hop] ** 2
        inv_ws = np.asarray(1.0 / ws, np.float32)
        # the carried tail (stream end) is covered only by the last frame's
        # second half
        inv_ws_tail = np.asarray(1.0 / np.maximum(w[hop:] ** 2, 1e-12),
                                 np.float32)
        return (np.asarray(w, np.float32), inv_ws, inv_ws_tail)

    def init_state(self) -> Dict[str, Any]:
        """Fresh stream state (all carries at their pre-first-sample values)."""
        cfg = self.cfg
        (sr, n_fft, hop, band_rows, mode_masks, fps, psd_params, td_sos) = (
            self._static()
        )
        K = band_rows.size
        n_modes = mode_masks.shape[0]
        floor = max(float(cfg.dget("mode_flux_norm_min", 1.0)), cfg.eps)
        state: Dict[str, Any] = {
            "raw_tail": jnp.zeros((n_fft - hop,), jnp.float32),
            "td_tail": jnp.zeros((n_fft - hop,), jnp.float32),
            "frame_idx": jnp.int32(0),
            # PSD tracker carry (initialized lazily on the first frame)
            "psd": (
                jnp.zeros((K,), jnp.float32), jnp.zeros((K,), jnp.float32),
                jnp.zeros((K,), jnp.float32), jnp.int32(0), jnp.float32(0),
                jnp.asarray(True),
            ),
            "last_N": jnp.zeros((K,), jnp.float32),
            # flux needs P_det frames at t-1 and t-2
            "pdet_tail": jnp.zeros((2, K), jnp.float32),
            # per-mode + combined baseline carries (flux[0] == 0 -> floor init)
            "mode_base": (
                jnp.full((n_modes,), floor, jnp.float32),
                jnp.full((n_modes,), floor, jnp.float32),
            ),
            "all_base": (jnp.float32(floor), jnp.float32(floor)),
        }
        if td_sos is not None:
            state["td_zi"] = jnp.zeros((td_sos.shape[0], 2), jnp.float32)
        if self.emit_audio:
            self._audio_static()  # validate the config eagerly
            state["sup_psd"] = (
                jnp.zeros((K,), jnp.float32), jnp.zeros((K,), jnp.float32),
                jnp.zeros((K,), jnp.float32), jnp.int32(0), jnp.float32(0),
                jnp.asarray(True),
            )
            state["gain_prev"] = jnp.zeros((K,), jnp.float32)
            state["ola_tail"] = jnp.zeros((cfg.n_fft - hop,), jnp.float32)
        return state

    # ------------------------------------------------------------------
    def _trace_chunk(self, state: Dict[str, Any], chunk: jnp.ndarray
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        cfg = self.cfg
        (sr, n_fft, hop, band_rows, mode_masks, fps, psd_params, td_sos) = (
            self._static()
        )
        eps = float(cfg.eps)
        chunk = chunk.astype(jnp.float32).reshape(-1)
        n = chunk.shape[-1]
        if n % hop != 0:
            raise ValueError(f"chunk length {n} must be a multiple of hop {hop}")
        T_c = n // hop
        state = dict(state)

        # ---- causal STFT power over this chunk ----
        xa = jnp.concatenate([state["raw_tail"], chunk])
        # len(xa) = (T_c + 1) * hop with n_fft = 2 * hop, so frame_signal
        # yields exactly T_c frames via its reshape/concat fast path (no
        # (T_c, n_fft) index gather)
        frames = frame_signal(xa, n_fft, hop)
        w = jnp.asarray(hann_window(n_fft))
        spec = jnp.fft.rfft(frames * w, axis=-1)
        P = (spec.real**2 + spec.imag**2).astype(jnp.float32)  # (T_c, F)
        state["raw_tail"] = xa[-(n_fft - hop):]
        P_band = P[:, band_rows]  # (T_c, K)

        # ---- detector PSD normalization (streaming tracker) ----
        psd_carry = state["psd"]
        tracker, scale, prev_N, wcount, rain_ema, is_first = psd_carry
        first_frame = P_band[0]
        step_floor = float(max(cfg.eps, 1e-9))
        tracker = jnp.where(is_first, jnp.maximum(first_frame, 0.0), tracker)
        scale = jnp.where(
            is_first, jnp.maximum(jnp.abs(first_frame), step_floor), scale
        )
        psd_carry = (tracker, scale, prev_N, wcount, rain_ema, is_first)
        N_band, psd_carry = noise_psd_track_chunk(
            P_band.T, jnp.zeros((T_c,), bool), psd_carry, psd_params
        )
        N_band = N_band.T  # (T_c, K)
        state["psd"] = psd_carry

        # lag by one frame across the stream
        N_lag = jnp.concatenate([state["last_N"][None, :], N_band[:-1]], axis=0)
        N_lag = jnp.where(
            jnp.arange(T_c)[:, None] + state["frame_idx"] == 0,
            N_band[:1], N_lag,
        )  # very first frame uses its own estimate (reference roll semantics)
        maxr = float(np.clip(cfg.noise_psd_max_ratio, 0.0, 1.0))
        N_lag = jnp.minimum(N_lag, maxr * P_band)
        state["last_N"] = N_band[-1]

        P_det = 10.0 * jnp.log10(P_band + eps) - 10.0 * jnp.log10(N_lag + eps)

        # ---- t-vs-(t-2) positive flux with carried frames ----
        hist = jnp.concatenate([state["pdet_tail"], P_det], axis=0)  # (T_c+2, K)
        d2 = jnp.maximum(P_det - hist[:-2], 0.0)  # (T_c, K)
        # global frames 0 and 1 carry zero flux
        gidx = state["frame_idx"] + jnp.arange(T_c)
        d2 = jnp.where((gidx >= 2)[:, None], d2, 0.0)
        state["pdet_tail"] = hist[-2:]

        sel = jnp.asarray(mode_masks.astype(np.float32))     # (n_modes, K)
        mode_flux = jax.lax.dot(d2, sel.T,
                                precision=jax.lax.Precision.HIGHEST)  # (T_c, n_modes)
        flux_all = jnp.sum(mode_flux, axis=-1)               # (T_c,)

        # ---- causal baselines (carried) ----
        norm_min = max(float(cfg.dget("mode_flux_norm_min", 1.0)), eps)
        norm_q = float(np.clip(float(cfg.dget("mode_flux_norm_q", 20.0)), 0, 100))
        win_sec = float(cfg.dget("mode_flux_norm_win_sec", 0.5))
        base_m, carry_m = causal_low_quantile_baseline_chunk(
            mode_flux.T, state["mode_base"], q_percent=norm_q,
            samples_per_sec=fps, win_sec=win_sec, floor=norm_min,
        )
        state["mode_base"] = carry_m
        norm_flux = nan_to_num(
            jnp.maximum(mode_flux.T - base_m, 0.0) / (base_m + norm_min)
        )  # (n_modes, T_c)

        base_a, carry_a = causal_low_quantile_baseline_chunk(
            flux_all, state["all_base"], q_percent=norm_q,
            samples_per_sec=fps, win_sec=win_sec, floor=norm_min,
        )
        state["all_base"] = carry_a
        score_all = nan_to_num(
            jnp.maximum(flux_all - base_a, 0.0) / (base_a + norm_min)
        )

        # ---- TD gate (causal streaming prefilter) ----
        if td_sos is not None:
            x_td_chunk, zi = sosfilt(td_sos, chunk, zi=state["td_zi"])
            state["td_zi"] = zi
        else:
            x_td_chunk = chunk
        ta = jnp.concatenate([state["td_tail"], x_td_chunk])
        td_frames = frame_signal(ta, n_fft, hop)
        state["td_tail"] = ta[-(n_fft - hop):]
        td_crest = nan_to_num(crest_factor(td_frames, axis=-1, eps=eps))
        td_kurt = kurtosis(td_frames, axis=-1, fisher=False, bias=False)
        td_kurt = nan_to_num(jnp.where(jnp.isfinite(td_kurt), td_kurt, 0.0))

        td_gate_threshold = float(cfg.dget("td_gate_threshold", 2.5))
        gate_mask = td_crest > td_gate_threshold
        tk_up = cfg.dget("td_kurtosis_upper_threshold", None)
        if tk_up is not None:
            gate_mask = gate_mask & (td_kurt <= float(tk_up))
        gate = gate_mask.astype(jnp.float32)

        # ---- decision ----
        legacy12 = float(cfg.dget("new_rain_mode12_flux_min", 2.6))
        is_rain, rain_conf = rain_frame_decision(
            norm_flux[0] * gate, norm_flux[1] * gate, norm_flux[2] * gate,
            norm_flux[3] * gate,
            primary_flux_min=float(cfg.dget("new_rain_primary_flux_min", 1.8)),
            mode1_flux_min=float(cfg.dget("new_rain_mode1_flux_min", legacy12)),
            mode2_flux_min=float(cfg.dget("new_rain_mode2_flux_min", legacy12)),
            mode3_flux_min=float(cfg.dget("new_rain_mode3_flux_min", 3.0)),
            min_support_count=int(cfg.dget("new_rain_min_support_count", 2)),
        )
        noise_conf = jnp.clip(1.0 - rain_conf, 0.0, 1.0)
        weak = (score_all * gate) <= max(
            float(cfg.dget("mode_flux_noise_max", 1.5)), 0.0
        )
        noise_hi = float(cfg.dget("noise_hi", 0.80))
        frame_class = jnp.full((T_c,), int(FrameClass.UNCERTAIN), jnp.int8)
        frame_class = jnp.where(
            (noise_conf >= noise_hi) & weak & (~is_rain),
            jnp.int8(FrameClass.NOISE), frame_class,
        )
        frame_class = jnp.where(is_rain, jnp.int8(FrameClass.RAIN), frame_class)

        # ---- causal suppressor output (y = OLA-ISTFT(G * S)) ----
        # Offline product: edge/rain_signal_processor.py:1085-1125.  Every
        # stage is chunk-causal: a second noise tracker fed the frame
        # decisions (is_rain_for_psd = ~is_noise, the offline semantics),
        # the shared per-frame gain stage, the temporal-smoothing EMA, and a
        # weighted-OLA inverse STFT whose half-window tail is carried — so
        # the emitted audio lags the input by exactly
        # ``audio_delay_samples`` and is BIT-identical under any chunking.
        #
        # Bitwise invariance demands one unusual structural choice: the
        # whole per-frame tail (tracker -> gain -> S_hat -> iFFT -> OLA)
        # runs as a SINGLE ``lax.scan`` whose body is fenced with
        # ``optimization_barrier``.  Batched formulations are faster on
        # paper, but XLA fuses/contracts them differently per chunk shape
        # (measured 1-ulp drift between chunkings, e.g. division lowering
        # and excess-precision FMA); a fenced scan body compiles to the
        # same float sequence for every T_c.
        y_chunk = None
        if self.emit_audio:
            _w_np, inv_ws, _inv_ws_tail = self._audio_static()
            is_noise_f = frame_class == jnp.int8(FrameClass.NOISE)
            s_trk, s_scl, s_pN, s_wc, s_rema, s_first = state["sup_psd"]
            s_trk = jnp.where(s_first, jnp.maximum(P_band[0], 0.0), s_trk)
            s_scl = jnp.where(
                s_first, jnp.maximum(jnp.abs(P_band[0]), step_floor), s_scl
            )
            sup0 = (s_trk, s_scl, s_pN, s_wc, s_rema, s_first)
            psd_step = make_psd_track_step(psd_params)
            gstep = gain_time_step(cfg)
            inv_ws_c = jnp.asarray(inv_ws)
            use_lagged = bool(cfg.use_lagged_noise_psd)
            snr_cols = None
            if bool(cfg.snr_gating_enable):
                mm = (mode_masks.any(axis=0)
                      if bool(cfg.snr_gating_use_mode_bands)
                      else np.ones(P_band.shape[-1], bool))
                if not mm.any():
                    mm = np.ones(P_band.shape[-1], bool)
                snr_cols = np.flatnonzero(mm)
                snr1 = max(1e-9, float(cfg.snr_gating_snr1))
                snr_pwr = float(cfg.snr_gating_power)

            def sup_step(carry, inp):
                carry = jax.lax.optimization_barrier(carry)
                inp = jax.lax.optimization_barrier(inp)
                psd_c, G_prev, ola_prev = carry
                P_t, rain_t, nc_t, seed_t, spec_t = inp
                prev_N = psd_c[2]  # N at t-1 (for the lagged variant)
                psd_c, N_t = psd_step(psd_c, (P_t, rain_t))
                N_used = jnp.where(seed_t, N_t, prev_N) if use_lagged else N_t
                N_eff = jnp.minimum(N_used, maxr * P_t)
                gate_t = None
                if snr_cols is not None:
                    snr_m = jnp.sum(P_t[snr_cols]) / (
                        jnp.sum(N_eff[snr_cols]) + eps
                    )
                    gate_t = snr_m / (snr_m + snr1)
                    if snr_pwr != 1.0 and np.isfinite(snr_pwr) and snr_pwr > 0:
                        gate_t = jnp.power(jnp.clip(gate_t, 0.0, 1.0), snr_pwr)
                    gate_t = jnp.clip(gate_t, 0.0, 1.0)[None]
                G_f = gain_freq_stage(
                    cfg, P_t[:, None], N_eff[:, None], nc_t[None], gate_t
                )[:, 0]
                G_t, _ = gstep(G_prev, (G_f, nc_t))
                # the stream's very first frame takes the unsmoothed gain
                # (offline scan-init semantics)
                G_t = jnp.where(seed_t, G_f, G_t)
                G_out = jnp.clip(G_t, cfg.gain_floor, cfg.gain_ceil)
                S_t = spec_t.at[band_rows].set(spec_t[band_rows] * G_out)
                recon_t = (jnp.fft.irfft(S_t, n=n_fft)
                           .astype(jnp.float32) * w)
                y_t = (recon_t[:hop] + ola_prev) * inv_ws_c
                new_carry = (psd_c, G_t, recon_t[hop:])
                new_carry, y_t = jax.lax.optimization_barrier(
                    (new_carry, y_t)
                )
                return new_carry, y_t

            carry0 = (sup0, state["gain_prev"], state["ola_tail"])
            (sup_c, gain_c, ola_c), y_frames = jax.lax.scan(
                sup_step, carry0,
                (P_band, ~is_noise_f, noise_conf, gidx == 0, spec),
                unroll=1,
            )
            state["sup_psd"] = sup_c
            state["gain_prev"] = gain_c
            state["ola_tail"] = ola_c
            y_chunk = y_frames.reshape(-1)

        times = (state["frame_idx"] + jnp.arange(T_c)).astype(jnp.float32) * (
            hop / float(sr)
        )
        state["frame_idx"] = state["frame_idx"] + T_c

        out = {
            "frame_class": frame_class,
            "rain_conf": rain_conf,
            "noise_conf": noise_conf,
            "times": times,
            "td_crest_factor": td_crest,
            "td_kurtosis": td_kurt,
            "normalized_mode_flux_by_mode": norm_flux,
            "mode_flux_score": score_all,
            "noise_psd_band": N_band,
        }
        if y_chunk is not None:
            out["y"] = y_chunk
        return state, out

    # ------------------------------------------------------------------
    def drain_audio(self, state: Dict[str, Any]) -> np.ndarray:
        """Flush the final ``n_fft - hop`` carried OLA samples at stream
        end (best effort: the tail is covered only by the last frame's
        window half, so it is normalized by that partial window sum)."""
        if not self.emit_audio:
            raise ValueError("detector was not configured with "
                             "compute_output_audio")
        _w, _inv_ws, inv_ws_tail = self._audio_static()
        return np.asarray(state["ola_tail"]) * inv_ws_tail

    # ------------------------------------------------------------------
    def process_chunk(self, state: Dict[str, Any], chunk) -> Tuple[Dict[str, Any],
                                                                   Dict[str, Any]]:
        """Process one chunk (length a multiple of ``hop``); returns
        ``(new_state, outputs)`` with NumPy-convertible device arrays."""
        chunk = jnp.asarray(np.asarray(chunk, np.float32).reshape(-1))
        key = int(chunk.shape[-1])
        fn = self._compiled.get(key)
        if fn is None:
            fn = jax.jit(self._trace_chunk)
            self._compiled[key] = fn
        return fn(state, chunk)

    # ------------------------------------------------------------------
    def init_state_batch(self, n_streams: int) -> Dict[str, Any]:
        """Stacked fresh state for ``n_streams`` independent live streams."""
        one = self.init_state()
        return jax.tree_util.tree_map(
            lambda a: jnp.repeat(jnp.asarray(a)[None], int(n_streams), axis=0),
            one,
        )

    def process_chunk_batch(self, state: Dict[str, Any], chunks
                            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Process one hop-multiple chunk from EACH of B live streams as a
        single vmapped device program — the multi-stream serving fast path
        (per-stream results are bit-identical to ``process_chunk``).

        ``chunks``: (B, L) with one chunk per stream (same L — lockstep
        batching; servers coalesce connections that have a full chunk
        pending).  ``state`` comes from :meth:`init_state_batch` (or
        stacked per-stream states).
        """
        if not isinstance(chunks, jax.Array):
            chunks = jnp.asarray(np.asarray(chunks, np.float32))
        elif chunks.dtype != jnp.float32:
            chunks = chunks.astype(jnp.float32)
        if chunks.ndim != 2:
            raise ValueError("chunks must be (n_streams, chunk_len)")
        key = ("batch", int(chunks.shape[0]), int(chunks.shape[-1]))
        fn = self._compiled.get(key)
        if fn is None:
            fn = jax.jit(jax.vmap(self._trace_chunk))
            self._compiled[key] = fn
        return fn(state, chunks)

    def process_stream(self, x, chunk_sec: float = 2.0) -> Dict[str, np.ndarray]:
        """Convenience: run a whole recording through fixed-size chunks."""
        cfg = self.cfg
        hop = cfg.hop
        chunk_len = max(hop, int(cfg.fs * chunk_sec) // hop * hop)
        x = np.asarray(x, np.float32).reshape(-1)
        usable = x.size // hop * hop
        state = self.init_state()
        outs = []
        for start in range(0, usable, chunk_len):
            piece = x[start : min(start + chunk_len, usable)]
            if piece.size % hop:
                piece = piece[: piece.size // hop * hop]
            if piece.size == 0:
                break
            state, out = self.process_chunk(state, piece)
            outs.append(jax.tree_util.tree_map(np.asarray, out))
        cat = {
            k: np.concatenate([o[k] for o in outs],
                              axis=-1 if outs[0][k].ndim == 1 else
                              (1 if k == "normalized_mode_flux_by_mode" else 0))
            for k in outs[0]
        }
        return cat
