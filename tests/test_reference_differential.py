"""Differential tests that execute the ACTUAL reference implementation.

Four reference edge modules are pure numpy/scipy and run in this container
(`band_noise_estimator.py`, `time_domain_detector.py`, `feature_extraction.py`,
`rain_frame_classifier.py` — verified: no librosa/boto3 imports).  Every test
here instantiates the reference code from /root/reference side by side with
the JAX engines on shared fixtures, converting this suite's "oracle parity"
claims (builder-authored float64 oracles in tests/oracles.py) into
*reference parity*.

Skipped automatically when /root/reference is not mounted.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

REF_ROOT = Path("/root/reference")
if REF_ROOT.is_dir() and str(REF_ROOT) not in sys.path:
    sys.path.insert(0, str(REF_ROOT))

ref_bne = pytest.importorskip(
    "audio_processing_tools.edge.band_noise_estimator",
    reason="reference repo not mounted at /root/reference",
)
ref_fe = pytest.importorskip("audio_processing_tools.edge.feature_extraction")
ref_rfc = pytest.importorskip("audio_processing_tools.edge.rain_frame_classifier")
ref_tdd = pytest.importorskip("audio_processing_tools.edge.time_domain_detector")

import jax.numpy as jnp  # noqa: E402

from audio_processing_tools_tpu.config import (  # noqa: E402
    DEFAULT_MODE_BANDS,
    build_noise_config,
)
from audio_processing_tools_tpu.models.band_noise import (  # noqa: E402
    BandNoiseEstimatorConfig,
    NoiseFrameDetectorConfig,
)
from audio_processing_tools_tpu.models.band_noise_streaming import (  # noqa: E402
    BandNoiseEstimator as AptBandNoiseEstimator,
    NoiseFrameDetector as AptNoiseFrameDetector,
)
from audio_processing_tools_tpu.models.frame_classifier import (  # noqa: E402
    detect_rain_over_time,
)
from audio_processing_tools_tpu.models.time_domain import (  # noqa: E402
    TimeDomainDetectorConfig as AptTimeDomainDetectorConfig,
    TimeDomainRainDetector as AptTimeDomainRainDetector,
)
from audio_processing_tools_tpu.ops.features_spec import (  # noqa: E402
    clip_spectral_occupancy,
    extract_raw_spectral_features,
    scipy_stft_power,
)
from audio_processing_tools_tpu.ops.features_td import extract_td_features  # noqa: E402
from audio_processing_tools_tpu.ops.stft import fft_frequencies  # noqa: E402
from audio_processing_tools_tpu.ops.trackers import (  # noqa: E402
    causal_low_quantile_baseline,
)
from audio_processing_tools_tpu.utils.corpus import synth_clip  # noqa: E402

FS = 11162
N_FFT = 256
HOP = 128
OP_BAND = (400.0, 3500.0)
MODE_BANDS = tuple(tuple(b) for b in DEFAULT_MODE_BANDS)


@pytest.fixture(scope="module", params=["rain_heavy", "noise", "wind"])
def clip(request):
    rng = np.random.default_rng({"rain_heavy": 11, "noise": 22, "wind": 33}[
        request.param
    ])
    return synth_clip(request.param, rng, fs=FS, seconds=2.0)


# ---------------------------------------------------------------------------
# causal stochastic low-quantile baseline (rain_frame_classifier.py:31-82)
# ---------------------------------------------------------------------------

def test_quantile_baseline_matches_reference(rng):
    x = np.abs(rng.standard_normal(600)).astype(np.float32) + 0.05
    kw = dict(q_percent=20.0, samples_per_sec=87.2, win_sec=1.0,
              min_hist_sec=0.25)
    ref_base, ref_warm = ref_rfc.causal_stochastic_low_quantile_baseline(
        x, **kw, dtype=np.float32
    )
    got_base, got_warm = causal_low_quantile_baseline(jnp.asarray(x), **kw)
    np.testing.assert_array_equal(np.asarray(got_warm), ref_warm)
    np.testing.assert_allclose(
        np.asarray(got_base), ref_base, rtol=1e-4,
        atol=1e-5 * float(ref_base.max()),
    )


# ---------------------------------------------------------------------------
# TD features (feature_extraction.py:174-538)
# ---------------------------------------------------------------------------

TD_KW = dict(
    fs=FS, frame_len=N_FFT, hop=HOP, operating_band=OP_BAND,
    mode_bands=MODE_BANDS, td_input_band=None, bp_order=4,
    subframe_len=128, subframe_hop=128, block_energy_len=8,
    block_energy_hop=None, block_energy_post_pre_blocks=4,
    block_energy_smooth_enable=True, envelope_features_enable=True,
)


@pytest.mark.parametrize("td_input_mode", ["default", "bandpass", "comb_filter"])
def test_td_features_match_reference(clip, td_input_mode):
    ref_out = ref_fe.extract_td_features_inline(
        x=clip, td_input_mode=td_input_mode, **TD_KW
    )
    got_out = extract_td_features(
        jnp.asarray(clip), td_input_mode=td_input_mode, **TD_KW
    )
    assert set(ref_out) <= set(got_out), (
        f"missing keys: {set(ref_out) - set(got_out)}"
    )
    for key, ref_v in ref_out.items():
        got_v = np.asarray(got_out[key])
        assert got_v.shape == np.asarray(ref_v).shape, key
        scale = float(np.abs(ref_v).max()) + 1e-9
        np.testing.assert_allclose(
            got_v, ref_v, rtol=5e-4, atol=5e-5 * scale,
            err_msg=f"TD feature {key!r} diverges from reference "
                    f"(mode={td_input_mode})",
        )


# ---------------------------------------------------------------------------
# raw spectral-shape features (feature_extraction.py:542-747)
# ---------------------------------------------------------------------------

SPEC_KW = dict(
    fs=FS, n_fft=N_FFT, operating_band=OP_BAND,
    rain_band=(400.0, 800.0), low_band=(50.0, 200.0),
    mode_bands=MODE_BANDS, rolloff_fraction=0.85,
)


def test_spectral_features_match_reference_shared_power(clip):
    """Both sides consume the same caller-provided raw power."""
    P = np.asarray(scipy_stft_power(jnp.asarray(clip), fs=FS, n_fft=N_FFT,
                                    hop=HOP))
    freqs = np.asarray(fft_frequencies(FS, N_FFT))
    ref_out = ref_fe.extract_raw_spectral_shape_features_inline(
        raw_power=P.astype(np.float32), freqs=freqs, hop=HOP, **SPEC_KW
    )
    got_out = extract_raw_spectral_features(jnp.asarray(P), **SPEC_KW)
    for key in ref_fe.RAW_SPECTRAL_FEATURE_NAMES:
        ref_v = np.asarray(ref_out[key])
        got_v = np.asarray(got_out[key])
        assert got_v.shape == ref_v.shape, key
        scale = float(np.abs(ref_v).max()) + 1e-9
        np.testing.assert_allclose(
            got_v, ref_v, rtol=5e-4, atol=5e-5 * scale,
            err_msg=f"spectral feature {key!r} diverges from reference",
        )


def test_spectral_features_match_reference_from_waveform(clip):
    """Reference computes its own scipy STFT from x; mine uses
    scipy_stft_power — verifies the STFT front-ends agree too."""
    ref_out = ref_fe.extract_raw_spectral_shape_features_inline(
        x=clip, hop=HOP, **SPEC_KW
    )
    P = scipy_stft_power(jnp.asarray(clip), fs=FS, n_fft=N_FFT, hop=HOP)
    got_out = extract_raw_spectral_features(P, **SPEC_KW)
    for key in ref_fe.RAW_SPECTRAL_FEATURE_NAMES:
        ref_v = np.asarray(ref_out[key])
        got_v = np.asarray(got_out[key])
        scale = float(np.abs(ref_v).max()) + 1e-9
        np.testing.assert_allclose(
            got_v, ref_v, rtol=1e-3, atol=1e-4 * scale,
            err_msg=f"spectral feature {key!r} diverges from reference "
                    f"(waveform path)",
        )


def test_clip_occupancy_matches_reference(clip, rng):
    P = np.asarray(scipy_stft_power(jnp.asarray(clip), fs=FS, n_fft=N_FFT,
                                    hop=HOP))
    freqs = np.asarray(fft_frequencies(FS, N_FFT))
    T = P.shape[1]
    frame_class = rng.choice([0, 1, 2], size=T).astype(np.int32)
    ref_out = ref_fe.compute_clip_spectral_occupancy_stats(
        raw_power=P, freqs=freqs, frame_class=frame_class
    )
    got_out = clip_spectral_occupancy(
        jnp.asarray(P), jnp.asarray(frame_class == 2), fs=FS, n_fft=N_FFT
    )
    assert ref_out["rain_frame_count"] == int((frame_class == 2).sum())
    for key, ref_v in ref_out.items():
        if key in ("band_names", "band_lo_hz", "band_hi_hz",
                   "rain_frame_count", "no_rain_frame_count"):
            continue
        got_v = np.asarray(got_out[key])
        scale = float(np.abs(np.asarray(ref_v)).max()) + 1e-9
        np.testing.assert_allclose(
            got_v, np.asarray(ref_v), rtol=5e-4, atol=5e-5 * scale,
            err_msg=f"occupancy stat {key!r} diverges from reference",
        )


# ---------------------------------------------------------------------------
# NoiseFrameDetector (band_noise_estimator.py:106-298)
# ---------------------------------------------------------------------------

def test_noise_frame_detector_matches_reference(clip):
    frame_len, sub_len = 512, 128
    S = frame_len // sub_len
    ref_det = ref_bne.NoiseFrameDetector(
        ref_bne.NoiseFrameDetectorConfig(), subframes_per_frame=S
    )
    got_det = AptNoiseFrameDetector(
        NoiseFrameDetectorConfig(), subframes_per_frame=S
    )
    n_frames = clip.size // frame_len
    for t in range(n_frames):
        frame = clip[t * frame_len : (t + 1) * frame_len].astype(np.float64)
        subE = np.array([
            float(np.sum(frame[i * sub_len : (i + 1) * sub_len] ** 2))
            for i in range(S)
        ])
        P = np.abs(np.fft.rfft(frame, n=512)) ** 2
        ref_rain, ref_mask = ref_det.process_frame(
            frame, subE, fft_power=P
        )
        got_rain, got_mask = got_det.process_frame(
            frame, subE, fft_power=P
        )
        assert bool(got_rain) == bool(ref_rain), f"frame {t}: fft_rain differs"
        np.testing.assert_array_equal(
            np.asarray(got_mask, bool), np.asarray(ref_mask, bool),
            err_msg=f"frame {t}: rain submask differs",
        )


# ---------------------------------------------------------------------------
# BandNoiseEstimator streaming engine (band_noise_estimator.py:513-986)
# ---------------------------------------------------------------------------

def _stream_reference(cfg, x, frame_len):
    est = ref_bne.BandNoiseEstimator(cfg)
    outs = []
    for t in range(x.size // frame_len):
        outs.append(est.process_frame(x[t * frame_len : (t + 1) * frame_len]))
    return outs


@pytest.mark.parametrize("variant", ["default", "replenish", "learn_during_rain"])
def test_band_noise_estimator_matches_reference(clip, variant):
    overrides = {
        "default": {},
        "replenish": {
            "noise_replenish_from_all_subframes": True,
            "noise_buffer_ttl_frames": 8,
            "W": 8, "W_min": 4,
        },
        "learn_during_rain": {"learn_during_rain": True, "smooth_N_E": True},
    }[variant]
    frame_len = 512
    ref_cfg = ref_bne.BandNoiseEstimatorConfig(dtype=np.float64, **overrides)
    got_cfg = BandNoiseEstimatorConfig(**overrides)
    ref_outs = _stream_reference(ref_cfg, clip.astype(np.float64), frame_len)
    est = AptBandNoiseEstimator(got_cfg)
    for t, ref_out in enumerate(ref_outs):
        got_out = est.process_frame(
            clip[t * frame_len : (t + 1) * frame_len]
        )
        assert bool(got_out.fft_rain_frame) == bool(ref_out.fft_rain_frame), (
            f"frame {t}: fft_rain_frame differs ({variant})"
        )
        np.testing.assert_array_equal(
            np.asarray(got_out.rain_submask, bool),
            np.asarray(ref_out.rain_submask, bool),
            err_msg=f"frame {t}: rain_submask differs ({variant})",
        )
        for field in ("E_band", "M_band", "N_E", "G_mag", "M_clean"):
            ref_v = float(getattr(ref_out, field))
            got_v = float(getattr(got_out, field))
            np.testing.assert_allclose(
                got_v, ref_v, rtol=2e-4, atol=1e-6 * max(abs(ref_v), 1e-12),
                err_msg=f"frame {t}: {field} differs ({variant})",
            )


def _random_band_noise_overrides(rng: np.random.Generator):
    """One seeded random draw over the estimator+detector config space.

    Covers the knobs that change *control flow* (replenish, TTL expiry,
    adaptive-q, learn gating, hold length) plus the continuous smoothing
    coefficients — the hand-picked variants above only walk three corners.
    """
    W = int(rng.integers(4, 32))
    est = {
        "W": W,
        "W_min": int(rng.integers(1, W + 1)),
        "noise_buffer_ttl_frames": int(rng.choice([0, 5, 40, 200])),
        "q": float(rng.uniform(0.1, 0.7)),
        "ema_alpha": float(rng.uniform(0.3, 1.0)),
        "gain_floor": float(rng.uniform(0.02, 0.3)),
        "ne_attack_alpha_dry": float(rng.uniform(0.05, 0.3)),
        "ne_attack_alpha_wet": float(rng.uniform(0.005, 0.05)),
        "ne_release_alpha": float(rng.uniform(0.1, 0.6)),
        "smooth_N_E": bool(rng.integers(0, 2)),
        "learn_during_rain": bool(rng.integers(0, 2)),
        "force_learn_all": bool(rng.integers(0, 4) == 0),
        "noise_replenish_from_all_subframes": bool(rng.integers(0, 2)),
        "noise_replenish_q": float(rng.uniform(0.1, 0.4)),
        "noise_replenish_only_when_buffer_not_full": bool(rng.integers(0, 2)),
        "noise_q_adapt_enable": bool(rng.integers(0, 2)),
        "noise_q_replenish_alpha": float(rng.uniform(0.05, 0.5)),
        "noise_q_normal_alpha": float(rng.uniform(0.05, 0.5)),
    }
    det = {
        "M_db": float(rng.uniform(3.0, 9.0)),
        "N_db": float(rng.uniform(1.0, 6.0)),
        "k_subframes": int(rng.integers(1, 5)),
        "band_rise_db": float(rng.uniform(4.0, 10.0)),
        "excess_rise_db": float(rng.uniform(1.0, 6.0)),
    }
    return est, det


@pytest.mark.parametrize("draw", range(6))
def test_band_noise_estimator_matches_reference_fuzzed_config(draw):
    """Seeded config-space fuzz: exact decisions + tight floats per draw.

    Complements the three fixed variants above; each draw randomizes every
    learning/replenish/adaptive-q/hold knob on BOTH the estimator and its
    frame detector (``band_noise_estimator.py:413-511,56-96``) and streams
    a mixed rain+noise clip through the reference and the rebuild
    side by side.
    """
    rng = np.random.default_rng(1000 + draw)
    est_over, det_over = _random_band_noise_overrides(rng)
    # mixed-content clip so rain gating / replenish paths actually engage
    half = synth_clip("rain_heavy", rng, fs=FS, seconds=1.0)
    rest = synth_clip("noise", rng, fs=FS, seconds=1.0)
    clip = np.concatenate([rest[: FS // 2], half, rest[FS // 2 :]])

    frame_len = 512
    ref_cfg = ref_bne.BandNoiseEstimatorConfig(
        dtype=np.float64,
        det=ref_bne.NoiseFrameDetectorConfig(**det_over),
        **est_over,
    )
    got_cfg = BandNoiseEstimatorConfig(
        det=NoiseFrameDetectorConfig(**det_over), **est_over
    )
    ref_outs = _stream_reference(ref_cfg, clip.astype(np.float64), frame_len)
    est = AptBandNoiseEstimator(got_cfg)
    for t, ref_out in enumerate(ref_outs):
        got_out = est.process_frame(clip[t * frame_len : (t + 1) * frame_len])
        assert bool(got_out.fft_rain_frame) == bool(ref_out.fft_rain_frame), (
            f"frame {t}: fft_rain_frame differs (draw {draw})"
        )
        np.testing.assert_array_equal(
            np.asarray(got_out.rain_submask, bool),
            np.asarray(ref_out.rain_submask, bool),
            err_msg=f"frame {t}: rain_submask differs (draw {draw})",
        )
        for field in ("E_band", "M_band", "N_E", "G_mag", "M_clean"):
            ref_v = float(getattr(ref_out, field))
            got_v = float(getattr(got_out, field))
            np.testing.assert_allclose(
                got_v, ref_v, rtol=2e-4, atol=1e-6 * max(abs(ref_v), 1e-12),
                err_msg=f"frame {t}: {field} differs (draw {draw})",
            )


# ---------------------------------------------------------------------------
# TimeDomainRainDetector (time_domain_detector.py:242-314)
# ---------------------------------------------------------------------------

def test_time_domain_detector_matches_reference(clip):
    params = {"sample_rate": FS}
    ref_det = ref_tdd.TimeDomainRainDetector()
    ref_out = ref_det.process(clip, sr=FS)
    got_det = AptTimeDomainRainDetector()
    got_out = got_det.process(clip, sr=FS)

    np.testing.assert_array_equal(
        np.asarray(got_out["confirmed_mask"], bool),
        np.asarray(ref_out["confirmed_mask"], bool),
    )
    np.testing.assert_array_equal(
        np.asarray(got_out["candidate_peaks"]),
        np.asarray(ref_out["candidate_peaks"]),
    )
    np.testing.assert_array_equal(
        np.asarray(got_out["confirmed_counts"]),
        np.asarray(ref_out["confirmed_counts"]),
    )
    for key in ("crest_factor", "kurtosis"):
        ref_v = np.asarray(ref_out[key])
        scale = float(np.abs(ref_v).max()) + 1e-9
        np.testing.assert_allclose(
            np.asarray(got_out[key]), ref_v, rtol=5e-4, atol=5e-5 * scale,
            err_msg=f"TD detector {key!r} diverges from reference",
        )


def test_time_domain_detector_stage1_mask_matches_reference(clip, rng):
    T = 1 + (clip.size - 256) // 128
    mask = rng.random(T) < 0.3
    ref_out = ref_tdd.TimeDomainRainDetector().process(
        clip, stage1_is_rain=mask, sr=FS
    )
    got_out = AptTimeDomainRainDetector().process(
        clip, stage1_is_rain=mask, sr=FS
    )
    np.testing.assert_array_equal(
        np.asarray(got_out["confirmed_mask"], bool), ref_out["confirmed_mask"]
    )
    np.testing.assert_array_equal(
        np.asarray(got_out["candidate_peaks"]), ref_out["candidate_peaks"]
    )


@pytest.mark.parametrize("draw", range(6))
def test_time_domain_detector_matches_reference_fuzzed_config(draw):
    """Seeded config fuzz over the stage-2 confirmer's knobs.

    Randomizes context window, band selection, filter order, envelope
    smoothing, peak geometry, and the crest/kurtosis gates
    (``time_domain_detector.py:10-38``); asserts the same exact
    mask/count/peak parity as the default-config test on a mixed clip.
    """
    rng = np.random.default_rng(2000 + draw)
    over = {
        "prev_context_hops": int(rng.integers(0, 3)),
        "future_context_hops": int(rng.integers(0, 2)),
        "mode_bands": (
            None if rng.integers(0, 2) == 0
            else tuple(tuple(b) for b in MODE_BANDS[: int(rng.integers(1, 6))])
        ),
        "operating_band": (
            float(rng.uniform(300.0, 500.0)), float(rng.uniform(2500.0, 4000.0))
        ),
        "bp_order": int(rng.choice([2, 4])),
        "envelope_smooth_ms": float(rng.uniform(1.0, 4.0)),
        "peak_prominence_ratio": float(rng.uniform(0.15, 0.4)),
        "peak_distance_ms": float(rng.uniform(2.0, 8.0)),
        "min_crest_factor": float(rng.uniform(2.0, 4.0)),
        "min_kurtosis": float(rng.uniform(2.5, 5.0)),
    }
    half = synth_clip("rain_heavy", rng, fs=FS, seconds=1.0)
    rest = synth_clip("noise", rng, fs=FS, seconds=1.0)
    clip = np.concatenate([rest[: FS // 2], half, rest[FS // 2 :]])

    ref_mb = None if over["mode_bands"] is None else [
        tuple(b) for b in over["mode_bands"]
    ]
    ref_det = ref_tdd.TimeDomainRainDetector(
        ref_tdd.TimeDomainDetectorConfig(**{**over, "mode_bands": ref_mb})
    )
    got_det = AptTimeDomainRainDetector(AptTimeDomainDetectorConfig(**over))
    ref_out = ref_det.process(clip, sr=FS)
    got_out = got_det.process(clip, sr=FS)
    np.testing.assert_array_equal(
        np.asarray(got_out["confirmed_mask"], bool),
        np.asarray(ref_out["confirmed_mask"], bool),
        err_msg=f"confirmed_mask differs (draw {draw})",
    )
    np.testing.assert_array_equal(
        np.asarray(got_out["candidate_peaks"]),
        np.asarray(ref_out["candidate_peaks"]),
        err_msg=f"candidate_peaks differ (draw {draw})",
    )
    np.testing.assert_array_equal(
        np.asarray(got_out["confirmed_counts"]),
        np.asarray(ref_out["confirmed_counts"]),
        err_msg=f"confirmed_counts differ (draw {draw})",
    )


# ---------------------------------------------------------------------------
# Rain frame classifier: _detect_rain_over_time (rain_frame_classifier.py:290)
# ---------------------------------------------------------------------------

class _RefHost(ref_rfc.RainFrameClassifierMixin):
    """Minimal host for the reference mixin: it only requires ``self.cfg``
    (rain_frame_classifier.py:124 'SpectralNoiseProcessor must provide
    self.cfg')."""

    def __init__(self, detector):
        class _Cfg:
            pass

        self.cfg = _Cfg()
        self.cfg.detector = dict(detector)


DET_PARAMS = {
    "mode_bands": MODE_BANDS,
    "operating_band": OP_BAND,
    "sample_rate": FS,
    "n_fft": N_FFT,
    "hop": HOP,
    "td_apply_input_prefilter": False,
    "td_envelope_features_enable": True,
    "td_soft_enable": True,
    "peak_features_enable": False,
    "clip_spectral_occupancy_enable": False,
}


def test_detect_rain_over_time_matches_reference(clip):
    P = np.asarray(
        scipy_stft_power(jnp.asarray(clip), fs=FS, n_fft=N_FFT, hop=HOP)
    ).astype(np.float32)
    freqs = np.asarray(fft_frequencies(FS, N_FFT))
    # detector input: plain dB power (noise normalization is tested at the
    # engine level; here both classifiers see the same P_det)
    P_det = (10.0 * np.log10(P + 1e-12)).astype(np.float32)

    host = _RefHost(DET_PARAMS)
    ref_fc, ref_conf, ref_dbg, ref_dump = host._detect_rain_over_time(
        P_det, freqs, input_audio=clip, raw_power=P
    )

    cfg = build_noise_config(FS, {"detector": dict(DET_PARAMS)})
    got_fc, got_conf, got_dbg, got_dump = detect_rain_over_time(
        cfg, jnp.asarray(P_det), jnp.asarray(clip), raw_power=jnp.asarray(P)
    )
    got_fc = np.asarray(got_fc)
    got_conf = np.asarray(got_conf)

    T = ref_fc.shape[0]
    assert got_fc.shape == ref_fc.shape

    # continuous quantities: tight agreement
    for key in ("primary_mode_flux", "support_mode_flux_1",
                "support_mode_flux_2", "support_mode_flux_3",
                "mode_flux_score", "noise_conf", "rain_conf",
                "td_gate_mask"):
        ref_v = np.asarray(ref_dbg[key], np.float64)
        got_v = np.asarray(got_dbg[key], np.float64)
        assert got_v.shape == ref_v.shape, key
        scale = float(np.abs(ref_v).max()) + 1e-9
        np.testing.assert_allclose(
            got_v, ref_v, rtol=1e-3, atol=1e-4 * scale,
            err_msg=f"det_debug[{key!r}] diverges from reference",
        )

    # frame-class decisions: thresholds on float32 flux can flip truly
    # borderline frames; demand (a) overwhelming agreement and (b) exact
    # agreement away from the decision boundary
    agree = float((got_fc == np.asarray(ref_fc)).mean())
    assert agree >= 0.99, f"frame_class agreement only {agree:.3f}"
    np.testing.assert_allclose(got_conf, np.asarray(ref_conf),
                               rtol=1e-3, atol=1e-3)
