"""Per-frame streaming API for the band-noise estimator (sensor-shaped).

The reference exposes the estimator as stateful per-frame classes meant for
MCU deployment loops (``edge/band_noise_estimator.py:106-298, 312-410,
513-986``). The JAX rebuild runs the same algorithm as one ``lax.scan``
(``models/band_noise.py``); this module restores the per-frame class surface
on top of the chunked-scan core, so sensor-style integrations can keep
calling ``est.process_frame(frame)`` — each call advances the same carried
state the scan uses, so the stream is bit-identical to the whole-clip path
(verified in ``tests/test_band_noise.py``).

``NoiseFrameDetector`` is a standalone NumPy twin of the scan's in-graph
detector (FFT band-jump decision + subframe dB-rise mask + hold), useful for
firmware-porting work; it is differential-tested against the scan outputs.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Tuple

import numpy as np

from audio_processing_tools_tpu.models.band_noise import (
    BandNoiseEstimatorConfig,
    NoiseFrameDetectorConfig,
    band_noise_init_state,
    band_noise_process_chunk,
    band_noise_reset_noise_estimator,
    db_to_ratio,
    hz_to_bin,
)

_EPS = 1e-12

# scan outputs that are per-frame gauges vs since-start accumulators
_ACCUM_FIELDS = (
    "noise_energy_sum", "rain_energy_sum", "total_energy_sum",
    "noise_frame_count", "rain_frame_count", "total_frame_count",
    "noise_learned_subframe_count", "noise_replenish_count",
)
_GAUGE_FIELDS = (
    "noise_buffer_valid_count", "noise_buffer_min_valid_count",
    "noise_buffer_underflow_frame_count", "frames_since_noise_update",
    "noise_effective_q",
)


@dataclass
class BandNoiseFrameOut:
    """Per-frame estimator output (reference ``band_noise_estimator.py:312``)."""

    M_band: float
    E_band: float
    N_E: float
    N_E_raw: float
    N_sub: np.ndarray
    subE: np.ndarray
    rain_submask: np.ndarray
    G_mag: float
    M_clean: float
    fft_rain_frame: bool
    M_band_fft: float = 0.0
    E_band_fft: float = 0.0
    E_hpf: float = 0.0
    noise_energy_sum: float = 0.0
    rain_energy_sum: float = 0.0
    total_energy_sum: float = 0.0
    noise_frame_count: int = 0
    rain_frame_count: int = 0
    total_frame_count: int = 0
    noise_buffer_valid_count: int = 0
    noise_buffer_min_valid_count: int = 0
    noise_buffer_underflow_frame_count: int = 0
    frames_since_noise_update: int = 0
    noise_learned_subframe_count: int = 0
    noise_replenish_count: int = 0
    noise_effective_q: float = 0.0


@dataclass
class BandNoiseEnergyStats:
    """Accumulated telemetry since the last read/reset
    (reference ``band_noise_estimator.py:352-410``)."""

    noise_energy_sum: float = 0.0
    rain_energy_sum: float = 0.0
    total_energy_sum: float = 0.0
    noise_frame_count: int = 0
    rain_frame_count: int = 0
    total_frame_count: int = 0
    noise_buffer_valid_count: int = 0
    noise_buffer_min_valid_count: int = 0
    noise_buffer_underflow_frame_count: int = 0
    frames_since_noise_update: int = 0
    noise_learned_subframe_count: int = 0
    noise_replenish_count: int = 0
    noise_effective_q: float = 0.0

    @property
    def noise_energy_mean(self) -> float:
        return self.noise_energy_sum / max(1, self.noise_frame_count)

    @property
    def rain_energy_mean(self) -> float:
        return self.rain_energy_sum / max(1, self.rain_frame_count)

    @property
    def total_energy_mean(self) -> float:
        return self.total_energy_sum / max(1, self.total_frame_count)

    def as_dict(self) -> Dict[str, Any]:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d.update(
            noise_energy_mean=self.noise_energy_mean,
            rain_energy_mean=self.rain_energy_mean,
            total_energy_mean=self.total_energy_mean,
        )
        return d


class BandNoiseEstimator:
    """Stateful per-frame streaming wrapper over the scan core.

    ``process_frame(frame)`` consumes exactly ``cfg.frame_len`` samples and
    returns a :class:`BandNoiseFrameOut`. The carried state is the scan
    carry, so N frames streamed here equal one ``band_noise_process`` call
    on their concatenation, bit for bit.
    """

    def __init__(self, cfg: BandNoiseEstimatorConfig):
        cfg.validate()
        self.cfg = cfg
        self.state = band_noise_init_state(cfg)
        self._stats_baseline: Dict[str, float] = {k: 0 for k in _ACCUM_FIELDS}
        self._last_out: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------------
    def process_frame(self, frame: np.ndarray) -> BandNoiseFrameOut:
        frame = np.asarray(frame, np.float32).reshape(-1)
        if frame.shape[0] != self.cfg.frame_len:
            raise ValueError(
                f"process_frame expects exactly frame_len="
                f"{self.cfg.frame_len} samples, got {frame.shape[0]}"
            )
        outs, self.state = band_noise_process_chunk(frame, self.cfg, self.state)
        row = {k: np.asarray(v)[0] for k, v in outs.items()}
        self._last_out = row
        kw = {}
        for f in fields(BandNoiseFrameOut):
            v = row[f.name]
            if f.name in ("N_sub", "subE", "rain_submask"):
                kw[f.name] = np.asarray(v)
            elif f.type in ("int",):
                kw[f.name] = int(v)
            elif f.name == "fft_rain_frame":
                kw[f.name] = bool(v)
            else:
                kw[f.name] = float(v)
        return BandNoiseFrameOut(**kw)

    def process_stream(self, x: np.ndarray):
        """Frame-split a stream and yield per-frame outputs."""
        x = np.asarray(x, np.float32).reshape(-1)
        N = self.cfg.frame_len
        for t in range(x.shape[0] // N):
            yield self.process_frame(x[t * N : (t + 1) * N])

    # ------------------------------------------------------------------
    def reset_noise_estimator(self) -> None:
        """External-reset contract (reference ``:604-624``): clear the noise
        ring buffer/trackers while keeping filter state and telemetry."""
        self.state = band_noise_reset_noise_estimator(self.cfg, self.state)

    def read_and_reset_energy_stats(self) -> BandNoiseEnergyStats:
        """Telemetry snapshot since the last read, then reset the window."""
        if self._last_out is None:
            return BandNoiseEnergyStats()
        row = self._last_out
        kw: Dict[str, Any] = {}
        for k in _ACCUM_FIELDS:
            delta = row[k] - self._stats_baseline[k]
            kw[k] = int(delta) if "count" in k else float(delta)
            self._stats_baseline[k] = row[k]
        for k in _GAUGE_FIELDS:
            kw[k] = float(row[k]) if k == "noise_effective_q" else int(row[k])
        return BandNoiseEnergyStats(**kw)


class NoiseFrameDetector:
    """Standalone NumPy twin of the scan's in-graph frame detector.

    Decision rules (reference ``band_noise_estimator.py:106-298``):
      * FFT: rain-band power jump >= M_db AND primary-band jump >= N_db
        marks the whole frame rain;
      * time domain: per-subframe band dB-rise >= band_rise_db with an
        excess of >= excess_rise_db over the wideband rise, held for
        ``hold_k_subframes`` subframes.
    """

    def __init__(self, cfg: NoiseFrameDetectorConfig, *, subframes_per_frame: int):
        self.cfg = cfg
        self.S = int(subframes_per_frame)
        self._rain_bins = [
            (hz_to_bin(lo, cfg.fs, cfg.n_fft), hz_to_bin(hi, cfg.fs, cfg.n_fft))
            for lo, hi in cfg.rain_bands_hz
        ]
        self._primary = (
            hz_to_bin(cfg.primary_hz[0], cfg.fs, cfg.n_fft),
            hz_to_bin(cfg.primary_hz[1], cfg.fs, cfg.n_fft),
        )
        self.reset()

    def reset(self) -> None:
        self._prev_rain_sum: Optional[float] = None
        self._prev_primary: Optional[float] = None
        self._prev_Lb: float = 0.0
        self._prev_Lh: float = 0.0
        self._have_prev_L = False
        self._prev_Eb: float = 0.0
        self._have_prev_Eb = False
        self._hold = 0

    @staticmethod
    def _band_sum(P: np.ndarray, b0: int, b1: int) -> float:
        b0 = int(np.clip(b0, 0, len(P) - 1))
        b1 = int(np.clip(b1, 0, len(P) - 1))
        return float(P[b0 : b1 + 1].sum()) if b1 >= b0 else 0.0

    def fft_rain_from_power(self, P: np.ndarray) -> bool:
        P = np.asarray(P).reshape(-1)
        rain_sum = sum(self._band_sum(P, b0, b1) for b0, b1 in self._rain_bins)
        primary = self._band_sum(P, *self._primary)
        if self._prev_rain_sum is None:
            self._prev_rain_sum, self._prev_primary = rain_sum, primary
            return False
        jump = rain_sum > (self._prev_rain_sum + _EPS) * db_to_ratio(self.cfg.M_db)
        pjump = primary > (self._prev_primary + _EPS) * db_to_ratio(self.cfg.N_db)
        self._prev_rain_sum, self._prev_primary = rain_sum, primary
        return bool(jump and pjump)

    def fft_rain(self, x: np.ndarray) -> bool:
        X = np.fft.rfft(np.asarray(x, np.float64), n=self.cfg.n_fft)
        return self.fft_rain_from_power(X.real**2 + X.imag**2)

    def time_rain_mask_from_subE(
        self, subE: np.ndarray, subEhpf: Optional[np.ndarray] = None
    ) -> np.ndarray:
        det = self.cfg
        subE = np.asarray(subE, np.float64).reshape(-1)
        subEhpf = subE if subEhpf is None else (
            np.asarray(subEhpf, np.float64).reshape(-1)
        )
        mask = np.zeros(self.S, bool)
        for s in range(self.S):
            Eb_s = max(float(subE[s]), _EPS)
            m = self._hold > 0
            if m:
                self._hold -= 1

            Eh_s = float(subEhpf[s])
            energies_ok = (Eh_s >= det.min_Ehpf) and (Eb_s >= det.min_Eband)
            Lb = 10.0 * np.log10(Eb_s + _EPS)
            Lh = 10.0 * np.log10(Eh_s + _EPS)
            dLb = Lb - self._prev_Lb
            dLh = Lh - self._prev_Lh
            triggered = (
                energies_ok and self._have_prev_L
                and dLb >= det.band_rise_db
                and (dLb - dLh) >= det.excess_rise_db
            )
            if energies_ok:
                self._prev_Lb, self._prev_Lh = Lb, Lh
            self._have_prev_L = energies_ok

            if det.use_dE_over_Ehpf and not triggered:
                metric = max(Eb_s - self._prev_Eb, 0.0) / (max(Eh_s, _EPS) + _EPS)
                triggered = self._have_prev_Eb and metric >= det.dE_over_Ehpf_thr
            if det.use_D_trigger and not triggered:
                triggered = self._have_prev_Eb and (
                    Eb_s > (self._prev_Eb + _EPS) * db_to_ratio(det.D_db)
                )

            if triggered:
                self._hold = max(self._hold, max(0, int(det.k_subframes) - 1))
            self._prev_Eb = Eb_s
            self._have_prev_Eb = True
            mask[s] = m or triggered
        return mask

    def process_frame(
        self, x: np.ndarray, subE: np.ndarray, *,
        subEhpf: Optional[np.ndarray] = None,
        fft_power: Optional[np.ndarray] = None,
    ) -> Tuple[bool, np.ndarray]:
        """Returns ``(fft_rain_frame, rain_submask)``."""
        fft_rain_frame = (
            self.fft_rain_from_power(fft_power) if fft_power is not None
            else self.fft_rain(x)
        )
        time_mask = self.time_rain_mask_from_subE(subE, subEhpf=subEhpf)
        if fft_rain_frame:
            return True, np.ones(self.S, bool)
        return False, time_mask
