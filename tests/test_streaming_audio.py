"""Streaming denoised-audio output.

The causal suppressor path of :class:`StreamingRainDetector`
(``compute_output_audio=True``): gain -> S_hat -> carried OLA-ISTFT, the
streaming form of the offline product ``y = istft(G * S)``
(reference ``edge/rain_signal_processor.py:1085-1125``).

Pinned properties:
  * BIT-exact chunk invariance of the emitted audio (any hop-multiple
    re-chunking, random splits),
  * exact (1e-7) delayed identity reconstruction at unity gain — the
    OLA-ISTFT itself is lossless,
  * batched multi-stream output bit-identical to per-stream,
  * a constant, documented latency of ``n_fft - hop`` samples,
  * real suppression on stationary noise while a rain burst survives.
"""

import numpy as np
import pytest

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.models.streaming import StreamingRainDetector

FS = 11162
PARAMS = {
    "sample_rate": FS,
    "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
    "compute_output_audio": True,
}


def _detector(extra=None):
    det = StreamingRainDetector()
    det.setup({**PARAMS, **(extra or {})})
    return det


def _run_chunks(det, x, sizes):
    """Run x through the given chunk sizes (samples); returns concat y."""
    st = det.init_state()
    ys = []
    i = 0
    k = 0
    while i < x.size:
        n = min(sizes[k % len(sizes)], x.size - i)
        n = n // det.cfg.hop * det.cfg.hop
        st, out = det.process_chunk(st, x[i : i + n])
        ys.append(np.asarray(out["y"]))
        i += n
        k += 1
    return np.concatenate(ys), st


def test_chunk_invariance_bitexact_random_splits(rng):
    det = _detector()
    hop = det.cfg.hop
    x = (0.1 * rng.standard_normal(FS * 3)).astype(np.float32)
    x = x[: x.size // hop * hop]
    y_one, _ = _run_chunks(det, x, [x.size])
    for seed in range(3):
        r = np.random.default_rng(seed)
        sizes = [int(r.integers(1, 12)) * hop for _ in range(64)]
        y_split, _ = _run_chunks(det, x, sizes)
        np.testing.assert_array_equal(y_one, y_split,
                                      err_msg=f"split seed {seed}")


def test_unity_gain_identity_reconstruction(rng):
    """With the gain pinned to 1 the OLA-ISTFT must reproduce the input
    exactly (delayed by audio_delay_samples) — the reconstruction machinery
    adds no distortion of its own."""
    det = _detector({"suppressor": {"gain_floor": 1.0, "gain_ceil": 1.0}})
    hop = det.cfg.hop
    x = (0.3 * rng.standard_normal(FS * 2)).astype(np.float32)
    x = x[: x.size // hop * hop]
    y, st = _run_chunks(det, x, [17 * hop])
    d = det.audio_delay_samples
    assert d == det.cfg.n_fft - det.cfg.hop
    np.testing.assert_allclose(y[d:], x[: x.size - d], atol=2e-7)
    # the drained tail carries the remaining d samples (best effort: the
    # division by the tiny window edge amplifies float32 noise, so the
    # tolerance is looser than the steady-state bound above)
    tail = det.drain_audio(st)
    assert tail.shape == (d,)
    np.testing.assert_allclose(tail, x[x.size - d :], atol=1e-3, rtol=1e-3)


def test_suppression_reduces_noise_keeps_rain(rng):
    """Stationary broadband noise is attenuated; a real rain clip (which
    the detector classifies as rain, protecting its frames from
    oversubtraction) keeps most of its energy."""
    from audio_processing_tools_tpu.utils.corpus import synth_clip

    det = _detector()
    hop = det.cfg.hop
    rain = synth_clip("rain_heavy", rng, fs=FS, seconds=4.0
                      ).astype(np.float32)
    noise = (float(np.sqrt(np.mean(rain**2)))
             * np.random.default_rng(1).standard_normal(rain.size)
             ).astype(np.float32)

    def retention(sig):
        sig = sig[: sig.size // hop * hop]
        y, _ = _run_chunks(det, sig, [87 * hop])
        s = FS  # skip tracker warmup
        return float(np.sqrt(np.mean(y[s:] ** 2))
                     / np.sqrt(np.mean(sig[s:] ** 2)))

    r_noise = retention(noise)
    r_rain = retention(rain)
    assert r_noise < 0.8, r_noise          # real suppression on noise
    assert r_rain > 0.85, r_rain           # rain passes nearly intact
    assert r_rain > r_noise + 0.15, (r_rain, r_noise)


def test_batched_matches_single_bitexact(rng):
    det = _detector()
    hop = det.cfg.hop
    B = 4
    chunk = FS * 2 // hop * hop
    xb = (0.1 * rng.standard_normal((B, chunk * 2))).astype(np.float32)
    stb = det.init_state_batch(B)
    stb, o1 = det.process_chunk_batch(stb, xb[:, :chunk])
    stb, o2 = det.process_chunk_batch(stb, xb[:, chunk:])
    yb = np.concatenate([np.asarray(o1["y"]), np.asarray(o2["y"])], axis=1)
    for i in range(B):
        st = det.init_state()
        st, a = det.process_chunk(st, xb[i, :chunk])
        st, b = det.process_chunk(st, xb[i, chunk:])
        np.testing.assert_array_equal(
            yb[i], np.concatenate([np.asarray(a["y"]), np.asarray(b["y"])]),
            err_msg=f"stream {i}",
        )


def test_detection_outputs_unchanged_by_audio_mode(rng):
    """Turning the audio path on must not perturb the detector outputs."""
    x = (0.1 * rng.standard_normal(FS * 2)).astype(np.float32)
    det_a = _detector()
    det_b = StreamingRainDetector()
    det_b.setup({k: v for k, v in PARAMS.items()
                 if k != "compute_output_audio"})
    x = x[: x.size // det_a.cfg.hop * det_a.cfg.hop]
    sta = det_a.init_state()
    stb = det_b.init_state()
    _, oa = det_a.process_chunk(sta, x)
    _, ob = det_b.process_chunk(stb, x)
    np.testing.assert_array_equal(np.asarray(oa["frame_class"]),
                                  np.asarray(ob["frame_class"]))
    np.testing.assert_array_equal(np.asarray(oa["rain_conf"]),
                                  np.asarray(ob["rain_conf"]))
    assert "y" in oa and "y" not in ob


def test_audio_config_guards():
    with pytest.raises(ValueError, match="50% overlap"):
        det = _detector({"n_fft": 512, "hop": 128})
        det.init_state()
    with pytest.raises(ValueError, match="pre_smooth_frames"):
        det = _detector({"pre_smooth_frames": 4})
        det.init_state()
    det = StreamingRainDetector()
    det.setup({"sample_rate": FS,
               "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)}})
    with pytest.raises(ValueError, match="compute_output_audio"):
        det.drain_audio(det.init_state())
