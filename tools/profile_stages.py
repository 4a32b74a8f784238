"""Per-stage device-time profile of the flagship engine on the accelerator.

Times each compute stage with the same chained-``lax.scan`` trick as
``bench.py::device_loop`` (K steps per dispatch, each step's input perturbed
by the previous step's output so XLA cannot hoist the body), amortizing the
dispatch round trip.

K must be LARGE: at small K a trivial body measures the dispatch round trip
divided by K, not compute.  Subtract the printed ``floor_ms_per_step``
(measured with an empty body) from every stage.

Usage:  python tools/profile_stages.py [--batch 128] [--iters 64]
Prints one JSON object: per-stage ms per batch-step, medians of 5 trials.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# runnable as `python tools/profile_stages.py` from anywhere
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--clip-sec", type=float, default=10.0)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--model", default="spectral",
                    choices=["spectral", "roe", "band_noise"],
                    help="roe: per-stage profile of the RoE engine at the "
                         "bench geometry (batch 32 x 3 s); band_noise: the "
                         "streaming estimator (batch 32 x 10 s)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from audio_processing_tools_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    if args.model == "roe":
        _profile_roe(args, jax, jnp)
        return
    if args.model == "band_noise":
        _profile_band_noise(args, jax, jnp)
        return

    from audio_processing_tools_tpu.config import (
        DEFAULT_MODE_BANDS,
        build_noise_config,
    )
    from audio_processing_tools_tpu.models.frame_classifier import (
        build_prefilter_sos,
        detect_rain_over_time,
    )
    from audio_processing_tools_tpu.models.spectral_noise import SpectralNoiseEngine
    from audio_processing_tools_tpu.ops.features_td import extract_td_features
    from audio_processing_tools_tpu.ops.filters import sosfiltfilt
    from audio_processing_tools_tpu.ops.spectrogram import spectrogram_power
    from audio_processing_tools_tpu.ops.stft import fft_frequencies
    from audio_processing_tools_tpu.ops.trackers import (
        causal_low_quantile_baseline,
        make_psd_params,
        noise_psd_track,
    )

    FS = 11162
    cfg = build_noise_config(FS, {
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
        "classifier_only_mode": True,
    })
    eng = SpectralNoiseEngine(cfg)
    B = args.batch
    K = args.iters
    N = int(FS * args.clip_sec)
    rng = np.random.default_rng(0)
    pcm = (rng.standard_normal((B, N)) * 2000).astype(np.int16)

    d = jax.device_put(pcm)
    np.asarray(d[0, 0])

    # shared shape facts
    n_fft, hop = cfg.n_fft, cfg.hop
    T = 1 + N // hop  # center=True frame count
    freqs = fft_frequencies(FS, n_fft)
    band_rows = np.flatnonzero((freqs >= cfg.operating_band[0])
                               & (freqs <= cfg.operating_band[1]))
    Kb = len(band_rows)
    psd_params = make_psd_params(
        cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=FS / hop,
        ema_up=cfg.ema_up, ema_down=cfg.ema_down, eps=cfg.eps,
        noise_psd_max_ratio=cfg.noise_psd_max_ratio,
        adaptive_q_enable=cfg.adaptive_q_enable,
        adaptive_q_min=cfg.adaptive_q_min,
        adaptive_q_alpha=cfg.adaptive_q_alpha,
    )
    sos = build_prefilter_sos(cfg, FS, "highpass")

    def to_f32(p):
        return p.astype(jnp.float32) / 32767.0

    # ---- stage bodies: pcm (B, N) int16 -> scalar --------------------------
    def full(p):
        xb = to_f32(p)
        out = jax.vmap(lambda x: eng._trace_single(x, FS))(xb)
        return jnp.sum(out["rain_conf"]) + jnp.sum(
            out["frame_class"].astype(jnp.float32))

    def spect(p):
        xb = to_f32(p)
        P = jax.vmap(lambda x: spectrogram_power(
            x, n_fft=n_fft, hop=hop, center=True))(xb)
        return jnp.sum(P)

    def prefilt(p):
        xb = to_f32(p)
        y = jax.vmap(lambda x: sosfiltfilt(sos, x))(xb)
        return jnp.sum(y)

    def psd(p):
        # spectrogram + band gather + noise PSD scan (detector norm path)
        xb = to_f32(p)
        P = jax.vmap(lambda x: spectrogram_power(
            x, n_fft=n_fft, hop=hop, center=True))(xb)
        Pb = P[:, band_rows, :]
        Nb = jax.vmap(lambda pb: noise_psd_track(
            pb, jnp.zeros((pb.shape[-1],), bool), psd_params))(Pb)
        return jnp.sum(Nb)

    def td(p):
        xb = to_f32(p)
        feats = jax.vmap(lambda x: extract_td_features(
            x, fs=FS, frame_len=n_fft, hop=hop,
            operating_band=cfg.operating_band,
            mode_bands=tuple(
                (float(a), float(b))
                for (a, b) in cfg.dget("mode_bands", DEFAULT_MODE_BANDS)
            ),
            td_input_mode="default",
        ))(xb)
        return sum(jnp.sum(v) for v in feats.values())

    def baselines(p):
        # the two causal low-quantile baseline scans on mode flux shapes
        xb = to_f32(p)
        v1 = xb[:, :T]              # (B, T) combined flux stand-in
        v5 = xb[:, :5 * T].reshape(B, 5, T)
        b1, _ = causal_low_quantile_baseline(
            v1, q_percent=20.0, samples_per_sec=FS / hop, win_sec=0.5,
            floor=1.0)
        b5, _ = causal_low_quantile_baseline(
            v5, q_percent=20.0, samples_per_sec=FS / hop, win_sec=0.5,
            floor=1.0)
        return jnp.sum(b1) + jnp.sum(b5)

    def classify(p):
        # detect_rain_over_time on a synthetic P_det (isolates the classifier
        # from the spectrogram + PSD-norm stages)
        xb = to_f32(p)
        P = jax.vmap(lambda x: spectrogram_power(
            x, n_fft=n_fft, hop=hop, center=True))(xb)
        Pdb = 10.0 * jnp.log10(P + cfg.eps)

        def one(pd, x):
            fc, rc, _, _ = detect_rain_over_time(cfg, pd, x, raw_power=None)
            return jnp.sum(rc) + jnp.sum(fc.astype(jnp.float32))
        return jnp.sum(jax.vmap(one)(Pdb, xb))

    stages = {
        "full": full,
        "spect": spect,
        "prefilt": prefilt,
        "spect+psd": psd,
        "td_features": td,
        "baselines_x6": baselines,
        "spect+classify": classify,
    }

    results = {}
    for name, fn in stages.items():
        def loop_fn(p, fn=fn):
            def body(seed, _):
                s = fn(p + (seed % 3).astype(jnp.int16))
                return (s.astype(jnp.float32) % 7.0).astype(jnp.int16), ()
            final, _ = jax.lax.scan(body, jnp.int16(0), None, length=K)
            return final

        t0 = time.perf_counter()
        compiled = jax.jit(loop_fn).lower(d).compile()
        compile_s = time.perf_counter() - t0
        np.asarray(compiled(d))  # warm
        times = []
        for _ in range(args.trials):
            t0 = time.perf_counter()
            np.asarray(compiled(d))
            times.append((time.perf_counter() - t0) / K * 1000.0)
        times.sort()
        results[name] = {
            "ms_per_step": round(times[len(times) // 2], 2),
            "spread": round((times[-1] - times[0]) / times[len(times) // 2], 3),
            "compile_s": round(compile_s, 1),
        }
        print(f"{name}: {results[name]}", flush=True)

    print(json.dumps({
        "batch": B, "iters": K, "T_frames": T, "band_bins": Kb,
        "backend": jax.default_backend(), "stages": results,
    }))


def _chained_loop_timer(args, jax, jnp, d, stages):
    """Shared K-chained-scan stage timer (same contract as the spectral
    profile: each step's input perturbed by the previous step's output)."""
    import numpy as np

    K = args.iters
    results = {}
    for name, fn in stages.items():
        def loop_fn(p, fn=fn):
            def body(seed, _):
                s = fn(p + (seed % 3.0) * 1e-6)
                return s.astype(jnp.float32) % 7.0, ()
            final, _ = jax.lax.scan(body, jnp.float32(0), None, length=K)
            return final

        t0 = time.perf_counter()
        compiled = jax.jit(loop_fn).lower(d).compile()
        compile_s = time.perf_counter() - t0
        np.asarray(compiled(d))  # warm
        times = []
        for _ in range(args.trials):
            t0 = time.perf_counter()
            np.asarray(compiled(d))
            times.append((time.perf_counter() - t0) / K * 1000.0)
        times.sort()
        results[name] = {
            "ms_per_step": round(times[len(times) // 2], 2),
            "spread": round((times[-1] - times[0]) / times[len(times) // 2], 3),
            "compile_s": round(compile_s, 1),
        }
        print(f"{name}: {results[name]}", flush=True)
    return results


def _profile_roe(args, jax, jnp) -> None:
    """RoE per-stage device profile at the bench geometry (attribute the
    step before optimizing it).

    Stage bodies recompute their prefix (like the spectral stages), so each
    row reads as cumulative pipeline cost up to that point; the last-stage
    deltas attribute the step."""
    import numpy as np

    from audio_processing_tools_tpu.models.roe import (
        _find_first_peak_in_range,
        _local_average_sorted3,
        _novelty_spectrum,
        _pulse_characteristics,
        _roe_traced,
        build_roe_config,
    )
    from audio_processing_tools_tpu.ops.filters import butter_sos, sosfilt
    from audio_processing_tools_tpu.ops.spectrogram import spectrogram_power

    FS = 11162
    cfg = build_roe_config(sample_rate=FS, check_duration=3)
    B = args.batch if args.batch != 128 else 32   # bench geometry default
    Nr = FS * 3
    rng = np.random.default_rng(0)
    d = jax.device_put((rng.standard_normal((B, Nr)) * 0.05
                        ).astype(np.float32))
    np.asarray(d[0, 0])

    N, H = cfg.frame_length, cfg.hop_length
    Fs = float(FS)
    op_lo, op_hi = cfg.op_freq_range
    nyq = 0.5 * Fs
    sos = butter_sos(8, [op_lo / nyq, op_hi / nyq], "bandpass")
    M = cfg.min_average_len
    n_harm_total = cfg.num_harmonics  # harmonic 0 + dynamic 1..n-1

    def bp(p):
        return jnp.sum(jax.vmap(lambda x: sosfilt(sos, x))(p))

    def mag_of(x):
        y = sosfilt(sos, x)
        return jnp.sqrt(spectrogram_power(y, n_fft=N, hop=H, center=True))

    def bp_spect(p):
        return jnp.sum(jax.vmap(mag_of)(p))

    def pulse(p):
        def one(x):
            T = 1 + x.shape[-1] // H
            r = _pulse_characteristics(x, T, cfg)
            return sum(jnp.sum(v) for v in r.values())
        return jnp.sum(jax.vmap(one)(p))

    def nov6(p):
        # 6 per-harmonic novelty chains (band mask -> freq-diff -> SNR via
        # the +-M top_k local average -> local-maxima mask -> threshold)
        def one(x):
            mag = mag_of(x)
            F = mag.shape[0]
            Y = mag if cfg.log_factor == 0 else jnp.log(1 + cfg.log_factor * mag)
            s = 0.0
            for hn in range(n_harm_total):
                lo = 500.0 * (hn + 1)
                mask = (jnp.arange(F) >= int(lo / (Fs / N))) & \
                       (jnp.arange(F) <= int((lo + 300.0) / (Fs / N)))
                Yh = jnp.where(mask[:, None], Y, 0.0)
                novk, novt = _novelty_spectrum(
                    Yh, M, float(cfg.harmonic_threshold[min(
                        hn, len(cfg.harmonic_threshold) - 1)]))
                s = s + jnp.sum(novk) + jnp.sum(novt)
            return s
        return jnp.sum(jax.vmap(one)(p))

    def peaks6(p):
        def one(x):
            mag = mag_of(x)
            s = 0.0
            for hn in range(n_harm_total):
                lo = jnp.float32(500.0 * (hn + 1))
                cnt, fpeak = _find_first_peak_in_range(
                    mag, lo - 100.0, lo + 400.0, lo, lo + 300.0, Fs,
                    cfg.max_peaks)
                s = s + jnp.sum(cnt.astype(jnp.float32)) + jnp.sum(fpeak)
            return s
        return jnp.sum(jax.vmap(one)(p))

    def localavg6(p):
        # just the 6 +-M top_k local averages on T-length novelty vectors
        def one(x):
            T = 1 + (x.shape[-1] // N) * (N // H)
            nov = x[: T + 1]
            s = 0.0
            for _ in range(n_harm_total):
                s = s + jnp.sum(_local_average_sorted3(nov, M))
            return s
        return jnp.sum(jax.vmap(one)(p))

    def full(p):
        def one(x):
            out = _roe_traced(x, cfg, Nr)
            return (out["rain_drop_count"].astype(jnp.float32)
                    + out["frain_mean"])
        return jnp.sum(jax.vmap(one)(p))

    stages = {
        "full": full,
        "bp_filter": bp,
        "bp+spect": bp_spect,
        "pulse_td": pulse,
        "bp+spect+nov6": nov6,
        "bp+spect+peaks6": peaks6,
        "localavg6_only": localavg6,
    }
    results = _chained_loop_timer(args, jax, jnp, d, stages)
    print(json.dumps({
        "model": "roe", "batch": B, "iters": args.iters,
        "backend": jax.default_backend(), "stages": results,
    }))


def _profile_band_noise(args, jax, jnp) -> None:
    """Band-noise estimator per-stage device profile (ROADMAP candidate 5:
    attribute the ~25k audio-s/s before optimizing the scan blind).

    Cumulative stages over the real pipeline (filters -> per-frame inputs ->
    estimator scan), plus two isolation rows: ``scan_only`` fabricates the
    per-frame inputs from cheap reshapes so the row reads as the scan body's
    own cost, and ``filters_lean`` times the y-only cascade-matmul path the
    whole-clip entry COULD use if it did not return ``zf``."""
    import numpy as np

    from audio_processing_tools_tpu.models.band_noise import (
        BandNoiseEstimatorConfig,
        _design_filters,
        _per_frame_inputs,
        _run_band_scan,
        _scan_carry_init,
        band_noise_process,
    )
    from audio_processing_tools_tpu.ops.filters import sosfilt, sosfilt_zi

    FS = 11162
    cfg = BandNoiseEstimatorConfig()
    B = args.batch if args.batch != 128 else 32
    N = int(FS * args.clip_sec)
    T = N // cfg.frame_len
    S = 1 + (cfg.frame_len - cfg.subframe_len) // cfg.subhop
    rng = np.random.default_rng(0)
    d = jax.device_put(
        (rng.standard_normal((B, N)) * 0.05).astype(np.float32))
    np.asarray(d[0, 0])

    hpf, bpf = _design_filters(cfg)
    zi_h_base = np.asarray(sosfilt_zi(hpf), np.float32)
    zi_b_base = np.asarray(sosfilt_zi(bpf), np.float32)

    def filt_one(x):
        x0 = x[0]
        x_h, _ = sosfilt(hpf, x, zi=jnp.asarray(zi_h_base) * x0)
        x_bp, _ = sosfilt(bpf, x_h, zi=jnp.asarray(zi_b_base) * x0)
        return x_h, x_bp

    def filters(p):
        x_h, x_bp = jax.vmap(filt_one)(p)
        return jnp.sum(x_h) + jnp.sum(x_bp)

    def filters_lean(p):
        def one(x):
            x0 = x[0]
            x_h = sosfilt(hpf, x, zi=jnp.asarray(zi_h_base) * x0,
                          return_zf=False)
            x_bp = sosfilt(bpf, x_h, zi=jnp.asarray(zi_b_base) * x0,
                           return_zf=False)
            return x_h, x_bp
        x_h, x_bp = jax.vmap(one)(p)
        return jnp.sum(x_h) + jnp.sum(x_bp)

    def inputs(p):
        def one(x):
            x_h, x_bp = filt_one(x)
            ins = _per_frame_inputs(x_h[: T * cfg.frame_len],
                                    x_bp[: T * cfg.frame_len], cfg, T)
            return sum(jnp.sum(v) for v in ins)
        return jnp.sum(jax.vmap(one)(p))

    def scan_only(p):
        def one(x):
            # fabricated per-frame inputs: cheap reshapes of the waveform so
            # this row's cost is the scan body itself
            f = jnp.abs(x[: T * cfg.frame_len].reshape(T, cfg.frame_len))
            subE_t = f[:, :S] + 1e-6
            scal = f[:, 0]
            ins = (subE_t, subE_t + 1e-7, scal, scal + 1e-7, scal,
                   jnp.sqrt(scal), scal, scal, scal)
            outs, _ = _run_band_scan(cfg, _scan_carry_init(cfg), ins)
            return jnp.sum(outs["M_clean"]) + jnp.sum(outs["N_E"])
        return jnp.sum(jax.vmap(one)(p))

    def full(p):
        def one(x):
            outs = band_noise_process(x, cfg)
            return jnp.sum(outs["M_clean"]) + jnp.sum(outs["N_E"])
        return jnp.sum(jax.vmap(one)(p))

    stages = {
        "full": full,
        "filters": filters,
        "filters_lean": filters_lean,
        "filters+inputs": inputs,
        "scan_only": scan_only,
    }
    results = _chained_loop_timer(args, jax, jnp, d, stages)
    audio_s = B * args.clip_sec
    full_ms = results["full"]["ms_per_step"]
    print(json.dumps({
        "model": "band_noise", "batch": B, "iters": args.iters,
        "T_frames": T, "backend": jax.default_backend(),
        "audio_sec_per_sec": round(audio_s / (full_ms / 1000.0), 1),
        "stages": results,
    }))


if __name__ == "__main__":
    main()
