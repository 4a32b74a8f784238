"""Deterministic synthetic labeled-corpus generator.

The reference's real test strategy is corpus accuracy over labeled "test
vectors" — local dirs with ``True``/``False`` in filenames (reference
``audio_io.py:218-225``) or DB labels — run through a classifier and split
into FP/FN (``edge/dsp_rain_detection.py:3248-3282``). This module
synthesizes such corpora with known ground truth so the accuracy harness can
be pinned in CI: every clip class models a real acoustic condition the
Mark-3 sensor sees.

Clip classes (label = raining?):

  * ``rain_heavy``   (True)  — dense damped multi-mode pings over noise
  * ``rain_light``   (True)  — sparse, weaker pings
  * ``noise``        (False) — steady broadband sensor noise
  * ``wind``         (False) — low-frequency gust bands + broadband bursts
  * ``tonal``        (False) — steady machine hum (strong tones, no pings)

Near-threshold classes (the HARD tier — deliberately close to the default
detector's decision boundary so the accuracy canary is NOT saturated and
threshold drift in either direction moves the pinned confusion matrix):

  * ``rain_faint``   (True)  — pings at ~miss-level SNR over sensor noise
  * ``drizzle``      (True)  — 1-3 weak intermittent pings per clip
  * ``rain_in_wind`` (True)  — light rain mixed into an active gust bed
  * ``wind_gusty``   (False) — hard gust fronts with impulsive broadband
                               onsets (the FP-bait class)

All randomness flows from the caller's seed; the generator is pure.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_FS = 11162

# the Mark-3 resonance modes the detector listens to
_PING_MODES: Tuple[Tuple[float, float], ...] = (
    (520.0, 1.0), (900.0, 0.5), (1600.0, 0.35), (2450.0, 0.25),
)

CLIP_CLASSES = ("rain_heavy", "rain_light", "noise", "wind", "tonal")
HARD_CLIP_CLASSES = ("rain_faint", "drizzle", "rain_in_wind", "wind_gusty")
CLASS_IS_RAIN = {
    "rain_heavy": True, "rain_light": True,
    "noise": False, "wind": False, "tonal": False,
    "rain_faint": True, "drizzle": True, "rain_in_wind": True,
    "wind_gusty": False,
}


def _ping(k: np.ndarray, fs: int, decay: float = 60.0) -> np.ndarray:
    tone = sum(a * np.sin(2 * np.pi * f * k / fs) for f, a in _PING_MODES)
    return np.exp(-k / decay) * tone


def synth_clip(kind: str, rng: np.random.Generator, *, fs: int = DEFAULT_FS,
               seconds: float = 2.0) -> np.ndarray:
    """One float32 clip of the given class in [-1, 1]."""
    n = int(fs * seconds)
    x = 0.006 * rng.standard_normal(n)
    k = np.arange(800)
    if kind == "rain_heavy":
        for t0 in rng.integers(fs // 4, n - 1000, int(10 * seconds)):
            x[t0 : t0 + 800] += 0.5 * _ping(k, fs)
    elif kind == "rain_light":
        for t0 in rng.integers(fs // 4, n - 1000, max(2, int(3 * seconds))):
            x[t0 : t0 + 800] += 0.3 * _ping(k, fs)
    elif kind == "noise":
        x = 0.02 * rng.standard_normal(n)
    elif kind == "wind":
        # gusts: slowly-modulated low-frequency rumble + broadband swell
        t = np.arange(n) / fs
        envelope = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(0.2, 0.5) * t))
        rumble = np.cumsum(rng.standard_normal(n))
        rumble = rumble - np.linspace(rumble[0], rumble[-1], n)
        rumble /= max(np.abs(rumble).max(), 1e-9)
        x = 0.15 * envelope * rumble + 0.03 * envelope * rng.standard_normal(n)
    elif kind == "tonal":
        t = np.arange(n) / fs
        for f in (487.0, 974.0, 1461.0):
            x += 0.08 * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    elif kind == "rain_faint":
        # pings barely above the sensor-noise floor: per-clip random
        # amplitude spanning the default detector's miss level
        amp = rng.uniform(0.03, 0.10)
        for t0 in rng.integers(fs // 4, n - 1000, max(3, int(4 * seconds))):
            x[t0 : t0 + 800] += amp * _ping(k, fs)
    elif kind == "drizzle":
        # 1-3 weak, widely-spaced drops in the whole clip
        for t0 in rng.integers(fs // 4, n - 1000, int(rng.integers(1, 4))):
            x[t0 : t0 + 800] += rng.uniform(0.08, 0.16) * _ping(k, fs)
    elif kind == "rain_in_wind":
        # light rain on top of an active gust bed (masked mode bands)
        t = np.arange(n) / fs
        envelope = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(0.2, 0.5) * t))
        rumble = np.cumsum(rng.standard_normal(n))
        rumble = rumble - np.linspace(rumble[0], rumble[-1], n)
        rumble /= max(np.abs(rumble).max(), 1e-9)
        x = 0.12 * envelope * rumble + 0.03 * envelope * rng.standard_normal(n)
        for t0 in rng.integers(fs // 4, n - 1000, max(2, int(3 * seconds))):
            x[t0 : t0 + 800] += rng.uniform(0.10, 0.25) * _ping(k, fs)
    elif kind == "wind_gusty":
        # hard gust fronts: broadband bursts with fast onsets (FP bait for
        # flux-based detectors); no resonant ping structure
        t = np.arange(n) / fs
        envelope = 0.4 * (1 + np.sin(2 * np.pi * rng.uniform(0.3, 0.7) * t))
        x = 0.02 * rng.standard_normal(n) * (1 + envelope)
        for t0 in rng.integers(fs // 4, n - 1200, max(3, int(3 * seconds))):
            burst = rng.standard_normal(1000) * np.exp(-np.arange(1000) / 300.0)
            x[t0 : t0 + 1000] += rng.uniform(0.10, 0.22) * burst
    else:
        raise ValueError(f"unknown clip class: {kind!r}")
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def make_labeled_corpus(
    seed: int = 7, *, fs: int = DEFAULT_FS, seconds: float = 2.0,
    counts: Optional[Dict[str, int]] = None,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Deterministic corpus: (clips (B, N) float32, labels (B,) bool, kinds)."""
    counts = counts or {
        "rain_heavy": 6, "rain_light": 4, "noise": 6, "wind": 4, "tonal": 4,
    }
    rng = np.random.default_rng(seed)
    clips, labels, kinds = [], [], []
    for kind in CLIP_CLASSES + HARD_CLIP_CLASSES:
        for _ in range(counts.get(kind, 0)):
            clips.append(synth_clip(kind, rng, fs=fs, seconds=seconds))
            labels.append(CLASS_IS_RAIN[kind])
            kinds.append(kind)
    return np.stack(clips), np.asarray(labels, bool), kinds


def make_hard_corpus(
    seed: int = 17, *, fs: int = DEFAULT_FS, seconds: float = 2.0,
    per_class: int = 8,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Near-threshold corpus (HARD tier only): faint rain at miss-level SNR,
    intermittent drizzle, rain masked by wind, and gust-front FP bait.

    Sized so the default detector lands strictly BELOW 100% accuracy — the
    canary detects threshold drift in either direction.
    """
    counts = {kind: per_class for kind in HARD_CLIP_CLASSES}
    return make_labeled_corpus(seed, fs=fs, seconds=seconds, counts=counts)


def write_corpus_dir(
    out_dir: str, clips: np.ndarray, labels: Sequence[bool],
    kinds: Optional[Sequence[str]] = None, *, fs: int = DEFAULT_FS,
) -> List[str]:
    """Write a corpus as MARK ``.bin`` test vectors with the reference's
    True/False filename labeling convention; returns the file paths."""
    from audio_processing_tools_tpu.io.mark import write_mark_audio_file

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (clip, raining) in enumerate(zip(clips, labels)):
        kind = kinds[i] if kinds is not None else "clip"
        name = f"{kind}_{i:03d}_{'True' if raining else 'False'}.bin"
        pcm = (np.clip(clip, -1, 1) * 32767).astype(np.int16)
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(write_mark_audio_file(pcm, sample_rate=fs, timestamp=i))
        paths.append(path)
    return paths


def repeat_alac_mark(data: bytes, reps: int) -> bytes:
    """A MARK ALAC file whose audio is ``reps`` back-to-back copies of the
    audio in ``data`` (an ALAC MARK file).

    ALAC packets decode independently, so repeating the BER-framed packet
    run tiles the PCM; a duplicated leading MARK header and any bytes after
    the last packet are kept once.  Lets a short recorded fixture stand in
    for a long ALAC clip where no encoder is installed.
    """
    from audio_processing_tools_tpu.io.alac_native import split_ber_packets
    from audio_processing_tools_tpu.io.mark import HEADER_SIZE, MARK_MAGIC

    payload = data[HEADER_SIZE:]
    start = HEADER_SIZE if payload[:4] == MARK_MAGIC else 0
    end = start + sum(3 + len(p) for p in split_ber_packets(payload))
    return (data[:HEADER_SIZE] + payload[:start]
            + payload[start:end] * int(reps) + payload[end:])
