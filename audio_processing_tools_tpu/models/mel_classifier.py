"""Mel-feature rain classifier — BASELINE config #3 end to end.

Config #3 is "mel-filterbank + dB band-energy features -> rain/no-rain
labeler".  This module is the pipeline consumer of :mod:`ops.mel`: the
power spectrogram feeds the Slaney mel filterbank (one matmul),
band dB energies are reduced over the rain/mode region, and the decision
statistic is the 2-frame positive flux of that band energy — the mel-domain
analogue of the detector's mode-band spectral flux
(reference ``edge/rain_frame_classifier.py:710-759``; the band-energy
front-end generalizes ``edge/feature_extraction.py:671-677`` mode bands to
the mel axis).

Everything from waveform to clip verdict is one jitted program over a
``(B, N)`` batch; clip scoring is a high quantile of the flux (impulsive
rain pings produce large sparse rises; wind/tonal maskers produce smooth
energy, near-zero flux).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.ops.mel import (
    hz_to_mel,
    mel_spectrogram,
    mel_to_hz,
)
from audio_processing_tools_tpu.ops.stats import quantile_linear


@dataclass(frozen=True)
class MelClassifierConfig:
    """Trace-time constants (one compiled program per config+shape)."""

    sample_rate: int = 11162
    n_fft: int = 256
    hop: int = 128
    n_mels: int = 40
    band_lo_hz: float = 450.0
    band_hi_hz: float = 2600.0
    frame_flux_db: float = 6.0      # per-frame rain decision threshold
    clip_quantile: float = 0.98     # clip score = this quantile of the flux
    clip_threshold_db: float = 12.0  # clip is rain above this score
    eps: float = 1e-9

    def validate(self) -> None:
        if not 0.0 < self.clip_quantile <= 1.0:
            raise ValueError(f"clip_quantile must be in (0, 1], got "
                             f"{self.clip_quantile}")
        if self.band_hi_hz <= self.band_lo_hz:
            raise ValueError("band_hi_hz must exceed band_lo_hz")
        if self.n_mels < 4:
            raise ValueError("n_mels must be >= 4")


def build_mel_config(params: Dict[str, Any]) -> MelClassifierConfig:
    """Flat params > nested ``params['mel']`` > defaults (the project's
    config precedence)."""
    nested = dict(params.get("mel", {}) or {})
    kw = {}
    for f in MelClassifierConfig.__dataclass_fields__:
        if f in params:
            kw[f] = params[f]
        elif f in nested:
            kw[f] = nested[f]
    cfg = MelClassifierConfig(**kw)
    cfg.validate()
    return cfg


class MelRainClassifier:
    """Waveform batch -> mel dB band flux -> frame mask + clip verdict."""

    def __init__(self, config: Optional[MelClassifierConfig] = None):
        self.cfg = config
        self._compiled: Dict[Tuple[int, ...], Any] = {}

    def setup(self, params: Dict[str, Any]) -> None:
        if self.cfg is None:
            self.cfg = build_mel_config(params)

    def _band_mask(self) -> np.ndarray:
        cfg = self.cfg
        centers = mel_to_hz(np.linspace(
            hz_to_mel(0.0), hz_to_mel(cfg.sample_rate / 2), cfg.n_mels + 2
        ))[1:-1]
        mask = (centers >= cfg.band_lo_hz) & (centers <= cfg.band_hi_hz)
        if not mask.any():
            raise ValueError("mel band selection is empty")
        return mask

    def _traced(self, xb: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        cfg = self.cfg
        band = np.flatnonzero(self._band_mask())  # static integer gather
        M = mel_spectrogram(
            xb.astype(jnp.float32), sr=cfg.sample_rate, n_fft=cfg.n_fft,
            hop=cfg.hop, n_mels=cfg.n_mels,
        )                                          # (B, n_mels, T)
        M_db = 10.0 * jnp.log10(M + cfg.eps)
        E = jnp.mean(M_db[:, band, :], axis=1)     # (B, T)
        T = E.shape[-1]
        flux = jnp.zeros_like(E)
        if T > 2:
            flux = flux.at[:, 2:].set(jnp.maximum(E[:, 2:] - E[:, :-2], 0.0))
        frame_is_rain = flux > cfg.frame_flux_db
        score = quantile_linear(flux, cfg.clip_quantile, axis=-1)
        return {
            "band_energy_db": E,
            "mel_flux_db": flux,
            "frame_is_rain": frame_is_rain,
            "rain_frame_fraction": jnp.mean(
                frame_is_rain.astype(jnp.float32), axis=-1
            ),
            "clip_score_db": score,
            "clip_is_rain": score > cfg.clip_threshold_db,
        }

    def _fn(self, shape: Tuple[int, ...]):
        fn = self._compiled.get(shape)
        if fn is None:
            fn = jax.jit(self._traced)
            self._compiled[shape] = fn
        return fn

    def process_batch(self, xb, sr: Optional[int] = None) -> Dict[str, Any]:
        if self.cfg is None:
            self.setup({"sample_rate": sr or 11162})
        xb = jnp.asarray(xb, jnp.float32)
        if xb.ndim != 2:
            raise ValueError(f"expected (B, N) batch, got {xb.shape}")
        return self._fn(tuple(xb.shape))(xb)

    def process(self, x, sr: Optional[int] = None) -> Dict[str, Any]:
        out = self.process_batch(jnp.asarray(x, jnp.float32)[None, :], sr=sr)
        return {k: v[0] for k, v in out.items()}


class MelRainProcessor:
    """Framework adapter (``AudioProcessor`` protocol + ``run_batch`` device
    fast path) for the mel classifier."""

    def __init__(self, name: str = "mel_rain"):
        self.name = name
        self._cache: Dict[str, MelRainClassifier] = {}

    def _engine(self, params: Dict[str, Any]) -> MelRainClassifier:
        try:
            key = json.dumps(params, sort_keys=True, default=str)
        except Exception:
            key = repr(sorted(params.items(), key=lambda kv: kv[0]))
        eng = self._cache.get(key)
        if eng is None:
            eng = MelRainClassifier()
            eng.setup(params)
            self._cache[key] = eng
        return eng

    @staticmethod
    def _pair(out_i: Dict[str, np.ndarray], latency: float, name: str
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        metrics = {
            "clip_is_rain": bool(out_i["clip_is_rain"]),
            "clip_score_db": float(out_i["clip_score_db"]),
            "rain_frame_fraction": float(out_i["rain_frame_fraction"]),
            "latency_s": latency,
        }
        state = {
            "frame_is_rain": np.asarray(out_i["frame_is_rain"]),
            "mel_flux_db": np.asarray(out_i["mel_flux_db"]),
            "band_energy_db": np.asarray(out_i["band_energy_db"]),
            **metrics,
            "processor": name,
        }
        return metrics, state

    def run(self, audio_data: np.ndarray, params: Dict[str, Any]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        audio_data = np.asarray(audio_data)
        if audio_data.ndim != 1:
            raise ValueError(f"audio_data must be 1-D, got {audio_data.shape}")
        eng = self._engine(params)
        t0 = time.perf_counter()
        out = eng.process(audio_data, sr=params.get("sample_rate"))
        out = jax.tree_util.tree_map(np.asarray, out)
        return self._pair(out, time.perf_counter() - t0, self.name)

    def run_batch(self, audio_matrix: np.ndarray, params: Dict[str, Any]
                  ) -> list:
        audio_matrix = np.asarray(audio_matrix, np.float32)
        if audio_matrix.ndim != 2:
            raise ValueError(f"audio_matrix must be 2-D, got {audio_matrix.shape}")
        B = audio_matrix.shape[0]
        eng = self._engine(params)
        t0 = time.perf_counter()
        out = eng.process_batch(audio_matrix, sr=params.get("sample_rate"))
        out = jax.tree_util.tree_map(np.asarray, out)
        latency = (time.perf_counter() - t0) / max(B, 1)
        return [
            self._pair({k: v[i] for k, v in out.items()}, latency, self.name)
            for i in range(B)
        ]
