"""On-accelerator numerics checks: the accelerator against the CPU backend
(or scipy / NumPy float64) for every compute path of the stack.

The pytest suite runs on a forced-CPU mesh (``tests/conftest.py``), so
numerics that only the accelerator's compiler produces (a float32 matmul
lowered to TF32, another reduction order in a fused kernel) can only be
caught on the card.  Every matmul on these paths carries
``Precision.HIGHEST`` (pinned by ``tests/test_precision_audit.py``), so TF32
never enters; each line below says so.  The checks:

  * sosfilt / sosfiltfilt (cascade-matmul path) vs scipy float64
  * TD features, accelerator vs CPU (same jitted program, both backends)
  * RoE drop counts, accelerator vs CPU
  * streaming detector chunked on the accelerator vs on the CPU
  * flagship classifier config variants (peak gate, td_soft, winsor)
  * mel classifier frames and clip decisions
  * flagship engine step (int16 wire, 10 s clips): every frame count equal
  * full suppressor: y relative deviation and frame agreement
  * firmware band-noise estimator frame agreement
  * spectrogram front-end vs a float64 NumPy STFT power at (128, 10 s)

Usage: ``python tools/chip_checks.py`` on a machine with an accelerator
(a few minutes, compiles included).  Prints one JSON line; exit 1 on any
failed bound.  ``--smoke-cpu`` runs the same logic with both sides on the
CPU at small sizes (the bounds are then trivially met).

``bench.py`` and ``chip_smoke.py`` import :func:`run_checks`; the bench's
artifact validator refuses a non-CPU run whose checks failed or are missing.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

# runnable as `python tools/chip_checks.py` from anywhere: the package lives
# at the repo root, one level up from this file
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

FS = 11162
PRECISION = "float32, every matmul at Precision.HIGHEST (no TF32)"


def numpy_stft_power_f64(x: np.ndarray, n_fft: int = 256, hop: int = 128,
                         center: bool = True) -> np.ndarray:
    """Plain float64 NumPy |STFT|^2 (periodic hann, zero center pad):
    the oracle the spectrogram front-end is held to.  (..., F, T)."""
    x = np.asarray(x, np.float64)
    if center:
        pad = [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        x = np.pad(x, pad)
    T = 1 + (x.shape[-1] - n_fft) // hop
    idx = np.arange(T)[:, None] * hop + np.arange(n_fft)[None, :]
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    spec = np.fft.rfft(x[..., idx] * w, axis=-1)        # (..., T, F)
    return np.swapaxes(np.abs(spec) ** 2, -1, -2)


def rain_clip(seconds: float, seed: int, *, decay: float = 55.0,
              amp: float = 0.5, gap: int = FS // 5,
              f0: float = 523.0) -> np.ndarray:
    """Noise floor plus a train of damped pings (the engines' witness)."""
    r = np.random.default_rng(seed)
    n = int(FS * seconds)
    y = (0.01 * r.standard_normal(n)).astype(np.float32)
    k = np.arange(1400)
    ping = np.exp(-k / decay) * np.sin(2 * np.pi * f0 * k / FS)
    for s in range(300, n - 1500, gap):
        y[s:s + 1400] += amp * ping.astype(np.float32)
    return y


def run_checks(smoke: bool = False) -> dict:
    """Run every check; returns the results dict (``ok``/``failures`` keys).

    ``smoke=True`` forces the CPU platform and small shapes so the logic can
    run in the CPU test suite (both sides on the CPU).
    """
    import jax

    if smoke:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from scipy import signal

    backend = jax.default_backend()
    if not smoke and backend == "cpu":
        raise RuntimeError(
            "chip_checks compares an accelerator with the CPU backend, but "
            "JAX found no accelerator (use --smoke-cpu to test the logic)")
    cpu = jax.devices("cpu")[0]

    from audio_processing_tools_tpu.config import (
        DEFAULT_MODE_BANDS,
        build_noise_config,
    )

    rng = np.random.default_rng(42)
    results: dict = {"backend": backend, "precision": PRECISION}
    failures: list[str] = []

    def check(name: str, value: float, bound: float, larger_ok: bool = False):
        results[name] = float(value)
        ok = value >= bound if larger_ok else value <= bound
        if not ok:
            failures.append(f"{name}={value:.3e} vs bound {bound:.3e}")
        print(f"# {name}: {value:.3e} (bound {'>=' if larger_ok else '<='} "
              f"{bound:.1e}) {'OK' if ok else 'FAIL'} [{PRECISION}]",
              file=sys.stderr)

    def on_cpu(fn, *args):
        with jax.default_device(cpu):
            return jax.jit(fn)(*(jax.device_put(a, cpu) for a in args))

    # ---- 1. IIR cascade (the HIGHEST-precision matmul path) vs scipy -----
    from audio_processing_tools_tpu.ops.filters import sosfilt, sosfiltfilt

    sos = signal.butter(4, [2 * 400.0 / FS, 2 * 3500.0 / FS],
                        btype="band", output="sos")
    x = rng.standard_normal((4, FS * 2)).astype(np.float32)
    ref = signal.sosfilt(sos, x.astype(np.float64), axis=-1)
    got = np.asarray(jax.jit(lambda v: sosfilt(sos, v))(jnp.asarray(x)))
    check("sosfilt_accel_vs_scipy_rel",
          np.abs(got - ref).max() / np.abs(ref).max(), 1e-5)
    reff = signal.sosfiltfilt(sos, x.astype(np.float64), axis=-1)
    gotf = np.asarray(jax.jit(lambda v: sosfiltfilt(sos, v))(jnp.asarray(x)))
    check("sosfiltfilt_accel_vs_scipy_rel",
          np.abs(gotf - reff).max() / np.abs(reff).max(), 1e-5)

    # ---- 2. TD features: same program, accelerator vs CPU -----------------
    from audio_processing_tools_tpu.ops.features_td import extract_td_features

    def td_fn(v):
        return extract_td_features(
            v, fs=FS, frame_len=256, hop=128,
            operating_band=(400.0, 3500.0),
            mode_bands=tuple(DEFAULT_MODE_BANDS),
            td_input_mode="comb_filter",
        )

    xt = (0.1 * rng.standard_normal(FS * 2)).astype(np.float32)
    td_a = jax.jit(td_fn)(jnp.asarray(xt))
    td_c = on_cpu(td_fn, xt)
    dev = 0.0
    for k in td_a:
        a, b = np.asarray(td_a[k]), np.asarray(td_c[k])
        denom = max(np.abs(b).max(), 1e-6)
        dev = max(dev, np.abs(a - b).max() / denom)
    check("td_features_accel_vs_cpu_rel", dev, 1e-4)

    # ---- 3. RoE drop counts accelerator vs CPU ----------------------------
    from audio_processing_tools_tpu.models.roe import rain_detection_algo

    # 700 Hz / decay-40 pings land in RoE's harmonic bands (523 Hz does not
    # fire it); 6 drops on CPU — the check is only meaningful when nonzero
    xr = rain_clip(3.0, 7, decay=40.0, amp=0.9, gap=FS // 3, f0=700.0)
    drops_a, frain_a, _ = rain_detection_algo(
        xr, sample_rate=FS, check_duration=3)
    with jax.default_device(cpu):
        drops_c, frain_c, _ = rain_detection_algo(
            xr, sample_rate=FS, check_duration=3)
    results["roe_drops_accel"] = int(drops_a)
    results["roe_drops_cpu"] = int(drops_c)
    check("roe_drops_cpu_nonzero", float(int(drops_c) > 0), 1.0,
          larger_ok=True)
    check("roe_drop_count_abs_diff", abs(int(drops_a) - int(drops_c)), 0)
    check("roe_frain_mean_abs_diff", abs(float(frain_a) - float(frain_c)),
          1e-3)

    # ---- 4. streaming chunked, accelerator vs CPU -------------------------
    from audio_processing_tools_tpu.models.streaming import StreamingRainDetector

    s_cfg = build_noise_config(FS, {
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
        "classifier_only_mode": True,
    })
    xs = rain_clip(2.0, 11)
    n_hop = 128
    usable = (len(xs) // n_hop) * n_hop
    xs = xs[:usable]
    chunk = n_hop * 32

    def stream_classes():
        det = StreamingRainDetector(s_cfg)
        state = det.init_state()
        classes = []
        for s in range(0, usable, chunk):
            state, out = det.process_chunk(state, jnp.asarray(xs[s:s + chunk]))
            classes.append(np.asarray(out["frame_class"]))
        return np.concatenate(classes)

    fc_stream = stream_classes()
    with jax.default_device(cpu):
        fc_cpu = stream_classes()
    check("streaming_accel_vs_cpu_frame_agreement",
          float((fc_stream == fc_cpu).mean()), 0.99, larger_ok=True)

    # ---- 5. classifier config variants accelerator vs CPU -----------------
    from audio_processing_tools_tpu.models.spectral_noise import SpectralNoiseEngine

    variants = {
        "peak_gate": {"peak_features_enable": True},
        "td_soft": {"td_soft_enable": True},
        "winsor": {"flux_modes_winsor_enable": True},
    }
    xv = rain_clip(2.0, 23)
    for name, extra in variants.items():
        v_cfg = build_noise_config(FS, {
            "detector": {"mode_bands": list(DEFAULT_MODE_BANDS), **extra},
            "classifier_only_mode": True,
        })
        fc_a = np.asarray(SpectralNoiseEngine(v_cfg).process(
            jnp.asarray(xv), FS)["frame_class"])
        with jax.default_device(cpu):
            fc_c = np.asarray(SpectralNoiseEngine(v_cfg).process(
                jnp.asarray(xv), FS)["frame_class"])
        check(f"engine_{name}_accel_vs_cpu_frame_agreement",
              float((fc_a == fc_c).mean()), 0.99, larger_ok=True)

    # ---- 6. mel classifier accelerator vs CPU -----------------------------
    from audio_processing_tools_tpu.models.mel_classifier import (
        MelRainClassifier,
    )

    def mel_outputs(xm):
        eng = MelRainClassifier()
        eng.setup({"sample_rate": FS})
        return eng.process_batch(xm)

    xm = np.stack([rain_clip(2.0, 31 + i) for i in range(4)])
    out_ma = mel_outputs(xm)
    with jax.default_device(cpu):
        out_mc = mel_outputs(xm)
    fr_a = np.asarray(out_ma["frame_is_rain"])
    fr_c = np.asarray(out_mc["frame_is_rain"])
    check("mel_accel_vs_cpu_frame_agreement", float((fr_a == fr_c).mean()),
          0.99, larger_ok=True)
    check("mel_accel_vs_cpu_clip_decisions_equal",
          float(np.array_equal(np.asarray(out_ma["clip_is_rain"]),
                               np.asarray(out_mc["clip_is_rain"]))),
          1.0, larger_ok=True)

    # ---- 7. flagship engine step: every per-clip frame count equal --------
    from audio_processing_tools_tpu.models.frame_classifier import FrameClass

    clip_sec = 1.0 if smoke else 10.0
    clip_len = int(FS * clip_sec)
    flag_eng = SpectralNoiseEngine(build_noise_config(FS, {
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
        "classifier_only_mode": True,
    }))

    def flagship_counts(pcm):
        xb = pcm.astype(jnp.float32) / 32767.0
        fc = jax.vmap(lambda v: flag_eng._trace_single(v, FS))(xb)
        fc = fc["frame_class"]
        return jnp.sum(fc == jnp.int8(FrameClass.RAIN), axis=-1)

    small = (rng.standard_normal((4, clip_len)) * 2000).astype(np.int16)
    fc_a = np.asarray(jax.jit(flagship_counts)(jnp.asarray(small)))
    fc_c = np.asarray(on_cpu(flagship_counts, small))
    check("engine_cpu_accel_frame_agreement", float((fc_a == fc_c).mean()),
          1.0, larger_ok=True)

    # ---- 8. full suppressor (gain EMA scan + complex STFT + ISTFT) --------
    sup_eng = SpectralNoiseEngine(build_noise_config(FS, {
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
        "compute_output_audio": True,
    }))

    def sup_fn(xb):
        out = jax.vmap(lambda v: sup_eng._trace_single(v, FS))(xb)
        return out["y"], out["frame_class"]

    xsup = (rng.standard_normal((2, FS)) * 0.05).astype(np.float32)
    y_a, fcs_a = (np.asarray(a) for a in jax.jit(sup_fn)(jnp.asarray(xsup)))
    y_c, fcs_c = (np.asarray(a) for a in on_cpu(sup_fn, xsup))
    check("suppress_cpu_accel_y_rel_dev",
          np.max(np.abs(y_a - y_c)) / max(float(np.abs(y_c).max()), 1e-30),
          1e-3)
    check("suppress_cpu_accel_frame_agreement",
          float((fcs_a == fcs_c).mean()), 0.99, larger_ok=True)

    # ---- 9. firmware band-noise estimator (IIR prefilters + TTL ring) -----
    from audio_processing_tools_tpu.models.band_noise import (
        BandNoiseEstimatorConfig,
        band_noise_process,
    )

    bn_cfg = BandNoiseEstimatorConfig()
    bn_x = (rng.standard_normal(FS * 2) * 0.05).astype(np.float32)

    def bn_fn(v):
        return band_noise_process(v, bn_cfg)["fft_rain_frame"]

    bn_a = np.asarray(jax.jit(bn_fn)(jnp.asarray(bn_x))).astype(bool)
    bn_c = np.asarray(on_cpu(bn_fn, bn_x)).astype(bool)
    check("band_noise_cpu_accel_frame_agreement", float((bn_a == bn_c).mean()),
          0.99, larger_ok=True)

    # ---- 10. spectrogram front-end vs float64 NumPy at the flagship shape -
    from audio_processing_tools_tpu.ops.spectrogram import spectrogram_power

    B_sp = 4 if smoke else 128
    xsp = (rng.standard_normal((B_sp, clip_len)) * 0.1).astype(np.float32)
    P_a = np.asarray(jax.jit(spectrogram_power)(jnp.asarray(xsp)))
    P_ref = numpy_stft_power_f64(xsp)
    check("spectrogram_vs_numpy_f64_rel",
          np.abs(P_a - P_ref).max() / np.abs(P_ref).max(), 1e-5)

    results["failures"] = failures
    results["ok"] = not failures
    return results


def main() -> int:
    from audio_processing_tools_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    results = run_checks(smoke="--smoke-cpu" in sys.argv)
    print(json.dumps(results))
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
