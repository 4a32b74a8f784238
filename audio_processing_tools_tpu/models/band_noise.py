"""Streaming band-noise estimator — firmware-shaped, as a ``lax.scan``.

Re-design of ``BandNoiseEstimator`` / ``NoiseFrameDetector``
(reference ``edge/band_noise_estimator.py``).  The reference is strictly
sequential per frame (persistent IIR ``zi``, ring buffer, hold counters,
EMAs); on the accelerator it becomes:

  * the IIR filters run ONCE over the whole clip as parallel-scan ``sosfilt``
    with carried state — valid because the streaming adapter requires
    ``hop == frame_len`` (contiguous frames), so streaming per-frame
    filtering == filtering the whole signal,
  * everything else (detector holds, ring-buffer noise learning with TTL,
    quantile+EMA estimate, replenish, adaptive-q, telemetry accumulators) is
    a single ``lax.scan`` over frames whose carry is the estimator state;
    the ``S`` subframes per frame unroll inside the scan body.

Throughput comes from ``vmap`` over files (SURVEY §7 "sequential-by-
construction engines"); a batched clip is one compiled program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.ops.filters import (
    butter_sos,
    sosfilt,
    sosfilt_matmul_zf,
    sosfilt_zi,
)
from audio_processing_tools_tpu.ops.stats import (
    masked_quantile_rankselect,
    quantile_linear,
)

EPS = 1e-12


def hz_to_bin(f_hz: float, fs: float, n_fft: int) -> int:
    """(``band_noise_estimator.py:33-34``)."""
    return int(np.clip(np.round(f_hz * n_fft / fs), 0, n_fft // 2))


def db_to_ratio(db: float) -> float:
    return 10.0 ** (db / 10.0)


@dataclass(frozen=True)
class NoiseFrameDetectorConfig:
    """(``band_noise_estimator.py:55-105``)."""

    fs: int = 11162
    n_fft: int = 512
    M_db: float = 6.0
    N_db: float = 3.0
    primary_hz: Tuple[float, float] = (450.0, 650.0)
    rain_bands_hz: Tuple[Tuple[float, float], ...] = (
        (450.0, 650.0), (800.0, 1050.0), (1500.0, 1800.0),
        (2350.0, 2550.0), (3150.0, 3350.0),
    )
    k_subframes: int = 2
    band_rise_db: float = 6.0
    excess_rise_db: float = 3.0
    min_Ehpf: float = 1e-10
    min_Eband: float = 1e-12
    use_dE_over_Ehpf: bool = False
    dE_over_Ehpf_thr: float = 0.08
    use_D_trigger: bool = False
    D_db: float = 6.0


@dataclass(frozen=True)
class BandNoiseEstimatorConfig:
    """(``band_noise_estimator.py:413-511``); float32 on device."""

    fs: int = 11162
    frame_len: int = 512
    hp_cutoff_hz: float = 350.0
    hp_order: int = 4
    band_hz: Tuple[float, float] = (400.0, 700.0)
    bpf_order: int = 4
    subframe_len: int = 128
    subhop: int = 128
    W: int = 30
    W_min: int = 10
    noise_buffer_ttl_frames: int = 200
    q: float = 0.3
    ema_alpha: float = 1.0
    beta: float = 1.0
    gain_floor: float = 0.10
    eps: float = 1e-12
    ne_attack_alpha_dry: float = 0.15
    ne_attack_alpha_wet: float = 0.02
    ne_release_alpha: float = 0.25
    smooth_N_E: bool = False
    learn_during_rain: bool = False
    force_learn_all: bool = False
    noise_replenish_from_all_subframes: bool = False
    noise_replenish_q: float = 0.20
    noise_replenish_only_when_buffer_not_full: bool = True
    noise_q_adapt_enable: bool = True
    noise_q_replenish_alpha: float = 0.2
    noise_q_normal_alpha: float = 0.1
    det: NoiseFrameDetectorConfig = field(default_factory=NoiseFrameDetectorConfig)

    def validate(self) -> None:
        if int(self.det.n_fft) != int(self.frame_len):
            raise ValueError(
                "det.n_fft must match frame_len so FFT diagnostics and FFT "
                "rain detection use the same spectrum"
            )
        if self.frame_len % self.subframe_len != 0:
            raise ValueError("subframe_len must divide frame_len")
        if not (0.0 < self.q < 1.0):
            raise ValueError("q must be in (0,1)")
        if not (0.0 < self.noise_replenish_q < 1.0):
            raise ValueError("noise_replenish_q must be in (0,1)")
        if not (0.0 < self.noise_q_replenish_alpha <= 1.0):
            raise ValueError("noise_q_replenish_alpha must be in (0,1]")
        if not (0.0 < self.noise_q_normal_alpha <= 1.0):
            raise ValueError("noise_q_normal_alpha must be in (0,1]")
        if self.W <= 0 or self.W_min < 0 or self.W_min > self.W:
            raise ValueError("Need W>0 and 0<=W_min<=W")
        if self.noise_buffer_ttl_frames < 0:
            raise ValueError("noise_buffer_ttl_frames must be >= 0")
        lo, hi = self.band_hz
        if not (0 < lo < hi < 0.5 * self.fs):
            raise ValueError("band_hz out of range")
        if not (0.0 < self.ema_alpha <= 1.0):
            raise ValueError("ema_alpha must be in (0, 1]")
        if not (isinstance(self.subhop, int) and self.subhop > 0):
            raise ValueError("subhop must be a positive integer")
        if self.frame_len < self.subframe_len:
            raise ValueError("frame_len must be >= subframe_len")
        if (self.frame_len - self.subframe_len) % self.subhop != 0:
            raise ValueError(
                "(frame_len - subframe_len) must be divisible by subhop"
            )


# output field order for the stacked per-frame telemetry
FRAME_OUT_FIELDS = (
    "M_band", "E_band", "N_E", "N_E_raw", "G_mag", "M_clean",
    "fft_rain_frame", "M_band_fft", "E_band_fft", "E_hpf",
    "rain_submask", "subE", "N_sub",
    "noise_energy_sum", "rain_energy_sum", "total_energy_sum",
    "noise_frame_count", "rain_frame_count", "total_frame_count",
    "noise_buffer_valid_count", "noise_buffer_min_valid_count",
    "noise_buffer_underflow_frame_count", "frames_since_noise_update",
    "noise_learned_subframe_count", "noise_replenish_count",
    "noise_effective_q",
)


def _design_filters(cfg: BandNoiseEstimatorConfig):
    nyq = 0.5 * cfg.fs
    hpf = None
    if cfg.hp_cutoff_hz > 0:
        w = float(np.clip(cfg.hp_cutoff_hz / nyq, 1e-6, 0.999))
        hpf = butter_sos(cfg.hp_order, w, "highpass")
    lo, hi = cfg.band_hz
    w1 = float(np.clip(lo / nyq, 1e-6, 0.999))
    w2 = float(np.clip(hi / nyq, 1e-6, 0.999))
    if w2 <= w1:
        w2 = min(0.999, w1 + 1e-3)
    bpf = butter_sos(cfg.bpf_order, [w1, w2], "bandpass")
    return hpf, bpf


@partial(jax.jit, static_argnames=("cfg",))
def band_noise_process(x: jnp.ndarray, cfg: BandNoiseEstimatorConfig
                       ) -> Dict[str, jnp.ndarray]:
    """Process a whole clip through the streaming estimator.

    ``x`` is 1-D (vmap for batches).  Frames are contiguous
    (``hop == frame_len``), matching the framework adapter's requirement.
    Returns per-frame telemetry arrays (``FRAME_OUT_FIELDS``).
    """
    x = x.astype(jnp.float32).reshape(-1)
    N = cfg.frame_len
    T = x.shape[-1] // N
    x = x[: T * N]
    S = 1 + (N - cfg.subframe_len) // cfg.subhop

    hpf, bpf = _design_filters(cfg)

    # zi seeding: both filters seeded from the raw first sample
    # (``band_noise_estimator.py:782-787``)
    # lean cascade-matmul filter path (zf discarded here); the chunked entry
    # uses ``sosfilt_matmul_zf`` — the SAME y math — so whole-clip vs chunked
    # stays bit-identical while skipping the per-sample prefix arrays
    x0 = x[0]
    if hpf is not None:
        zi_h = jnp.asarray(sosfilt_zi(hpf), jnp.float32) * x0
        x_h = sosfilt(hpf, x, zi=zi_h, return_zf=False)
    else:
        x_h = x
    zi_b = jnp.asarray(sosfilt_zi(bpf), jnp.float32) * x0
    x_bp = sosfilt(bpf, x_h, zi=zi_b, return_zf=False)

    inputs = _per_frame_inputs(x_h, x_bp, cfg, T)
    outs, _ = _run_band_scan(cfg, _scan_carry_init(cfg), inputs)
    return outs


def _per_frame_inputs(x_h, x_bp, cfg: BandNoiseEstimatorConfig, T: int):
    """Per-frame quantities feeding the estimator scan (batched tensor math)."""
    N = cfg.frame_len
    S = 1 + (N - cfg.subframe_len) // cfg.subhop
    frames_h = x_h.reshape(T, N)
    frames_bp = x_bp.reshape(T, N)

    E_hpf = jnp.sum(frames_h * frames_h, axis=-1)
    sub_idx = np.arange(S)[:, None] * cfg.subhop + np.arange(cfg.subframe_len)[None, :]
    subs_h = frames_h[:, sub_idx]          # (T, S, sub_len)
    subEhpf = jnp.sum(subs_h * subs_h, axis=-1)  # (T, S)
    subs_b = frames_bp[:, sub_idx]
    subE = jnp.sum(subs_b * subs_b, axis=-1)

    X = jnp.fft.rfft(frames_h, n=cfg.det.n_fft, axis=-1)
    P_fft = X.real**2 + X.imag**2          # (T, F)
    mag = jnp.abs(X)

    freqs = np.fft.rfftfreq(N, d=1.0 / cfg.fs)
    lo, hi = cfg.band_hz
    band_mask = np.flatnonzero((freqs >= lo) & (freqs <= hi))
    Mb_fft = jnp.sum(mag[:, band_mask], axis=-1)
    Eb_fft = jnp.sum(P_fft[:, band_mask], axis=-1)

    Eb = jnp.sum(frames_bp * frames_bp, axis=-1)
    Mb = jnp.sqrt(jnp.maximum(Eb, 0.0))

    # FFT rain-band sums (inclusive bin ranges with clipping)
    det = cfg.det
    n_bins = P_fft.shape[-1]

    def band_cols(b0, b1):
        b0 = max(0, min(b0, n_bins - 1))
        b1 = max(0, min(b1, n_bins - 1))
        if b1 < b0:
            return np.zeros(0, np.int64)
        return np.arange(b0, b1 + 1)

    rain_cols = np.concatenate([
        band_cols(hz_to_bin(f0, det.fs, det.n_fft), hz_to_bin(f1, det.fs, det.n_fft))
        for f0, f1 in det.rain_bands_hz
    ])
    prim_cols = band_cols(
        hz_to_bin(det.primary_hz[0], det.fs, det.n_fft),
        hz_to_bin(det.primary_hz[1], det.fs, det.n_fft),
    )
    rain_sum_t = jnp.sum(P_fft[:, rain_cols], axis=-1)
    primary_t = jnp.sum(P_fft[:, prim_cols], axis=-1)
    return (subE, subEhpf, rain_sum_t, primary_t, Eb, Mb, Mb_fft, Eb_fft, E_hpf)


def band_noise_init_state(cfg: BandNoiseEstimatorConfig) -> Dict[str, Any]:
    """Fresh stream state for chunked processing (zi unseeded + scan carry)."""
    hpf, bpf = _design_filters(cfg)
    n_h = hpf.shape[0] if hpf is not None else 0
    return {
        "seeded": jnp.asarray(False),
        "zi_h": jnp.zeros((n_h, 2), jnp.float32),
        "zi_b": jnp.zeros((bpf.shape[0], 2), jnp.float32),
        "scan": _scan_carry_init(cfg),
    }


def band_noise_reset_noise_estimator(cfg: BandNoiseEstimatorConfig,
                                     state: Dict[str, Any]) -> Dict[str, Any]:
    """Mid-stream noise-estimator reset (``reset_noise_estimator``,
    ``band_noise_estimator.py:604-624``): clears the ring buffer, EMA,
    effective q and N_E smoothing but keeps filter/detector state and the
    stream frame index (TTL timebase)."""
    state = dict(state)
    c = dict(state["scan"])
    fresh = _scan_carry_init(cfg)
    for k in ("buf", "valid", "buf_frame_idx", "wr", "count_valid",
              "frames_since_noise_update", "noise_ema", "noise_effective_q",
              "N_E_smooth"):
        c[k] = fresh[k]
    state["scan"] = c
    return state


@partial(jax.jit, static_argnames=("cfg",))
def band_noise_process_chunk(x: jnp.ndarray, cfg: BandNoiseEstimatorConfig,
                             state: Dict[str, Any]):
    """Chunked streaming: process ``len(x) // frame_len`` frames with carried
    state.  Threading states across chunks is bit-identical to
    :func:`band_noise_process` on the concatenated stream (chunk length must
    be a multiple of ``frame_len``).  Returns ``(outs, new_state)``."""
    x = x.astype(jnp.float32).reshape(-1)
    N = cfg.frame_len
    T = x.shape[-1] // N
    x = x[: T * N]

    hpf, bpf = _design_filters(cfg)
    state = dict(state)
    x0 = x[0]
    seeded = state["seeded"]
    if hpf is not None:
        zi_h_seed = jnp.asarray(sosfilt_zi(hpf), jnp.float32) * x0
        zi_h = jnp.where(seeded, state["zi_h"], zi_h_seed)
        x_h, zf_h = sosfilt_matmul_zf(hpf, x, zi_h)
        state["zi_h"] = zf_h
    else:
        x_h = x
    zi_b_seed = jnp.asarray(sosfilt_zi(bpf), jnp.float32) * x0
    zi_b = jnp.where(seeded, state["zi_b"], zi_b_seed)
    x_bp, zf_b = sosfilt_matmul_zf(bpf, x_h, zi_b)
    state["zi_b"] = zf_b
    state["seeded"] = jnp.asarray(True)

    inputs = _per_frame_inputs(x_h, x_bp, cfg, T)
    outs, carry = _run_band_scan(cfg, state["scan"], inputs)
    state["scan"] = carry
    return outs, state


def _scan_carry_init(cfg: BandNoiseEstimatorConfig) -> Dict[str, Any]:
    """Initial estimator scan carry (detector + ring buffer + telemetry)."""
    W = int(cfg.W)
    return dict(
        # fft detector
        prev_rain_sum=jnp.float32(0), prev_primary=jnp.float32(0),
        have_prev_fft=jnp.asarray(False),
        # time detector
        prev_Eb=jnp.float32(0), have_prev_Eb=jnp.asarray(False),
        hold=jnp.int32(0),
        prev_Lb=jnp.float32(0), prev_Lh=jnp.float32(0),
        have_prev_L=jnp.asarray(False),
        # ring buffer
        buf=jnp.zeros((W,), jnp.float32),
        valid=jnp.zeros((W,), bool),
        buf_frame_idx=jnp.full((W,), -1, jnp.int32),
        wr=jnp.int32(0), count_valid=jnp.int32(0),
        frames_since_noise_update=jnp.int32(0),
        frame_idx=jnp.int32(0),
        noise_ema=jnp.float32(0), noise_effective_q=jnp.float32(cfg.q),
        N_E_smooth=jnp.float32(0),
        # telemetry accumulators
        noise_energy_sum=jnp.float32(0), rain_energy_sum=jnp.float32(0),
        total_energy_sum=jnp.float32(0),
        noise_frame_count=jnp.int32(0), rain_frame_count=jnp.int32(0),
        total_frame_count=jnp.int32(0),
        min_valid_count=jnp.int32(0), underflow_count=jnp.int32(0),
        learned_total=jnp.int32(0), replenish_total=jnp.int32(0),
    )


def _run_band_scan(cfg: BandNoiseEstimatorConfig, carry0, inputs):
    """The estimator scan over per-frame arrays; returns (outs, carry)."""
    (subE, subEhpf, rain_sum_t, primary_t, Eb, Mb, Mb_fft, Eb_fft, E_hpf) = inputs
    det = cfg.det
    S = subE.shape[-1]
    W = int(cfg.W)
    M_ratio = db_to_ratio(det.M_db)
    N_ratio = db_to_ratio(det.N_db)
    D_ratio = db_to_ratio(det.D_db)
    ttl = int(cfg.noise_buffer_ttl_frames)

    def expire(c):
        if ttl <= 0:
            return c
        ages = c["frame_idx"] - c["buf_frame_idx"]
        stale = c["valid"] & (ages > ttl)
        do = c["count_valid"] > 0
        n_stale = jnp.sum(stale).astype(jnp.int32)
        c = dict(c)
        c["valid"] = jnp.where(do, c["valid"] & ~stale, c["valid"])
        c["buf"] = jnp.where(do & stale, 0.0, c["buf"])
        c["buf_frame_idx"] = jnp.where(do & stale, -1, c["buf_frame_idx"])
        c["count_valid"] = jnp.where(
            do, jnp.maximum(c["count_valid"] - n_stale, 0), c["count_valid"]
        )
        return c

    def push(c, v, do):
        c = dict(c)
        j = c["wr"]
        was_valid = c["valid"][j]
        c["buf"] = jnp.where(do, c["buf"].at[j].set(v), c["buf"])
        c["valid"] = jnp.where(do, c["valid"].at[j].set(True), c["valid"])
        c["buf_frame_idx"] = jnp.where(
            do, c["buf_frame_idx"].at[j].set(c["frame_idx"]), c["buf_frame_idx"]
        )
        c["count_valid"] = jnp.where(
            do & ~was_valid, c["count_valid"] + 1, c["count_valid"]
        )
        c["wr"] = jnp.where(do, (j + 1) % W, c["wr"])
        return c

    idxW = jnp.arange(W, dtype=jnp.int32)

    def push_many(c, vals, dos):
        """One frame's P pushes as a single one-hot update.

        Sequential :func:`push` calls write the consecutive ring slots
        ``wr + cumsum(dos) - dos`` (mod W); with P <= W those hit positions
        are distinct, so a one-hot masked sum reproduces the sequential
        write order bit-exactly while replacing P chained
        dynamic-update-slice ops (a serial dependency per subframe) with
        one fused elementwise block per frame.
        """
        c = dict(c)
        d32 = dos.astype(jnp.int32)
        offs = jnp.cumsum(d32) - d32
        pos = (c["wr"] + offs) % W                               # (P,)
        onehot = dos[:, None] & (idxW[None, :] == pos[:, None])  # (P, W)
        hit = jnp.any(onehot, axis=0)                            # (W,)
        overwrote = jnp.any(onehot & c["valid"][None, :], axis=1)
        c["buf"] = jnp.where(
            hit, jnp.sum(jnp.where(onehot, vals[:, None], 0.0), axis=0),
            c["buf"],
        )
        c["valid"] = c["valid"] | hit
        c["buf_frame_idx"] = jnp.where(hit, c["frame_idx"], c["buf_frame_idx"])
        c["count_valid"] = c["count_valid"] + jnp.sum(
            dos & ~overwrote
        ).astype(jnp.int32)
        c["wr"] = (c["wr"] + jnp.sum(d32)) % W
        return c

    def step(c, inp):
        (subE_t, subEhpf_t, rain_sum, primary, Eb_t, Mb_t,
         Mb_fft_t, Eb_fft_t, E_hpf_t) = inp
        c = dict(c)
        c["frame_idx"] = c["frame_idx"] + 1

        # ---- FFT rain decision ----
        cond1 = rain_sum > (c["prev_rain_sum"] + EPS) * M_ratio
        cond2 = primary > (c["prev_primary"] + EPS) * N_ratio
        fft_rain = c["have_prev_fft"] & cond1 & cond2
        c["prev_rain_sum"] = rain_sum
        c["prev_primary"] = primary
        c["have_prev_fft"] = jnp.asarray(True)

        # ---- time-domain mask over subframes (unrolled, S static) ----
        mask_list = []
        for s in range(S):
            Eb_s = jnp.maximum(subE_t[s], EPS)
            m = c["hold"] > 0
            c["hold"] = jnp.where(m, c["hold"] - 1, c["hold"])

            Eh_s = subEhpf_t[s]
            energies_ok = (Eh_s >= det.min_Ehpf) & (Eb_s >= det.min_Eband)
            Lb = 10.0 * jnp.log10(Eb_s + EPS)
            Lh = 10.0 * jnp.log10(Eh_s + EPS)
            dLb = Lb - c["prev_Lb"]
            dLh = Lh - c["prev_Lh"]
            trig_db = (
                energies_ok & c["have_prev_L"]
                & (dLb >= det.band_rise_db)
                & ((dLb - dLh) >= det.excess_rise_db)
            )
            c["prev_Lb"] = jnp.where(energies_ok, Lb, c["prev_Lb"])
            c["prev_Lh"] = jnp.where(energies_ok, Lh, c["prev_Lh"])
            c["have_prev_L"] = jnp.where(
                energies_ok, jnp.asarray(True), jnp.asarray(False)
            )

            triggered = trig_db
            if det.use_dE_over_Ehpf:
                Eh_c = jnp.maximum(Eh_s, EPS)
                dE = jnp.maximum(Eb_s - c["prev_Eb"], 0.0)
                metric = dE / (Eh_c + EPS)
                trig_m = c["have_prev_Eb"] & (metric >= det.dE_over_Ehpf_thr)
                triggered = triggered | (~triggered & trig_m)
            if det.use_D_trigger:
                trig_d = c["have_prev_Eb"] & (
                    Eb_s > (c["prev_Eb"] + EPS) * D_ratio
                )
                triggered = triggered | (~triggered & trig_d)

            m = m | triggered
            c["hold"] = jnp.where(
                triggered,
                jnp.maximum(c["hold"], max(0, int(det.k_subframes) - 1)),
                c["hold"],
            )
            c["prev_Eb"] = Eb_s
            c["have_prev_Eb"] = jnp.asarray(True)
            mask_list.append(m)
        time_mask = jnp.stack(mask_list)
        rain_submask = jnp.where(fft_rain, jnp.ones((S,), bool), time_mask)

        # ---- pre-learn expiry ----
        c = expire(c)

        # ---- learning ----
        if cfg.force_learn_all or cfg.learn_during_rain:
            learn_mask = jnp.ones((S,), bool)
        else:
            learn_mask = ~rain_submask
        c = push_many(c, jnp.maximum(subE_t, cfg.eps), learn_mask)
        learned_count = jnp.sum(learn_mask).astype(jnp.int32)

        buffer_not_full = c["count_valid"] < W
        if cfg.noise_replenish_from_all_subframes:
            should = (learned_count == 0) & (
                buffer_not_full
                if cfg.noise_replenish_only_when_buffer_not_full
                else jnp.asarray(True)
            )
            q_noise = quantile_linear(subE_t, cfg.noise_replenish_q)
            c = push(c, jnp.maximum(q_noise, cfg.eps), should)
            replenish_count = should.astype(jnp.int32)
        else:
            replenish_count = jnp.int32(0)

        c["learned_total"] = c["learned_total"] + learned_count
        c["replenish_total"] = c["replenish_total"] + replenish_count
        c["frames_since_noise_update"] = jnp.where(
            (learned_count + replenish_count) > 0,
            0, c["frames_since_noise_update"] + 1,
        )

        # ---- adaptive q ----
        if cfg.noise_q_adapt_enable:
            q_eff = c["noise_effective_q"]
            q_eff = jnp.where(
                replenish_count > 0,
                (1.0 - cfg.noise_q_replenish_alpha) * q_eff
                + cfg.noise_q_replenish_alpha * cfg.noise_replenish_q,
                q_eff,
            )
            q_eff = jnp.where(
                learned_count > 0,
                (1.0 - cfg.noise_q_normal_alpha) * q_eff
                + cfg.noise_q_normal_alpha * cfg.q,
                q_eff,
            )
            c["noise_effective_q"] = jnp.clip(q_eff, 1e-6, 1.0 - 1e-6)

        # ---- noise scalar (warmup semantics) ----
        # The reference expires the buffer again here, but between the
        # pre-learn expire() above and this point frame_idx has not changed
        # and every pushed entry has age 0, so no entry can have BECOME
        # stale: a second expire() is provably a no-op and is elided (the
        # exact-decision differential suites pin the equivalence).
        warm = c["count_valid"] >= cfg.W_min
        qv = masked_quantile_rankselect(
            c["buf"], c["valid"], c["noise_effective_q"]
        )
        a = float(cfg.ema_alpha)
        ema_new = (1.0 - a) * c["noise_ema"] + a * qv
        c["noise_ema"] = jnp.where(warm, ema_new, 0.0)
        c["N_E_smooth"] = jnp.where(warm, c["N_E_smooth"], 0.0)
        N_sub_scalar = jnp.where(warm, c["noise_ema"], 0.0)
        N_E_raw = S * N_sub_scalar

        if cfg.smooth_N_E:
            is_raining = fft_rain | jnp.any(rain_submask)
            up = jnp.where(is_raining, cfg.ne_attack_alpha_wet, cfg.ne_attack_alpha_dry)
            alpha = jnp.where(N_E_raw > c["N_E_smooth"], up, cfg.ne_release_alpha)
            c["N_E_smooth"] = (1.0 - alpha) * c["N_E_smooth"] + alpha * N_E_raw
            N_E = c["N_E_smooth"]
        else:
            N_E = N_E_raw

        # ---- telemetry (``_update_energy_stats``) ----
        any_rain = jnp.any(rain_submask)
        rain_energy = jnp.sum(jnp.where(rain_submask, subE_t, 0.0))
        non_rain_energy = jnp.sum(jnp.where(~rain_submask, subE_t, 0.0))
        noise_energy = jnp.minimum(
            jnp.maximum(N_E, 0.0), jnp.maximum(non_rain_energy, 0.0)
        )
        prev_total = c["total_frame_count"]
        c["total_energy_sum"] = c["total_energy_sum"] + jnp.maximum(Eb_t, 0.0)
        c["rain_energy_sum"] = c["rain_energy_sum"] + rain_energy
        c["noise_energy_sum"] = c["noise_energy_sum"] + noise_energy
        c["total_frame_count"] = prev_total + 1
        c["min_valid_count"] = jnp.where(
            prev_total == 0, c["count_valid"],
            jnp.minimum(c["min_valid_count"], c["count_valid"]),
        )
        c["underflow_count"] = c["underflow_count"] + (
            c["count_valid"] < cfg.W_min
        ).astype(jnp.int32)
        c["rain_frame_count"] = c["rain_frame_count"] + any_rain.astype(jnp.int32)
        c["noise_frame_count"] = c["noise_frame_count"] + (~any_rain).astype(jnp.int32)

        # ---- Wiener gain ----
        num = jnp.maximum(Eb_t - cfg.beta * N_E, 0.0)
        G_pow = num / (Eb_t + cfg.eps)
        G_mag = jnp.sqrt(jnp.clip(G_pow, 0.0, 1.0))
        G_mag = jnp.clip(G_mag, cfg.gain_floor, 1.0)
        M_clean = Mb_t * G_mag

        out = {
            "M_band": Mb_t, "E_band": Eb_t, "N_E": N_E, "N_E_raw": N_E_raw,
            "G_mag": G_mag, "M_clean": M_clean,
            "fft_rain_frame": fft_rain,
            "M_band_fft": Mb_fft_t, "E_band_fft": Eb_fft_t, "E_hpf": E_hpf_t,
            "rain_submask": rain_submask, "subE": subE_t,
            "N_sub": jnp.full((S,), N_sub_scalar),
            "noise_energy_sum": c["noise_energy_sum"],
            "rain_energy_sum": c["rain_energy_sum"],
            "total_energy_sum": c["total_energy_sum"],
            "noise_frame_count": c["noise_frame_count"],
            "rain_frame_count": c["rain_frame_count"],
            "total_frame_count": c["total_frame_count"],
            "noise_buffer_valid_count": c["count_valid"],
            "noise_buffer_min_valid_count": c["min_valid_count"],
            "noise_buffer_underflow_frame_count": c["underflow_count"],
            "frames_since_noise_update": c["frames_since_noise_update"],
            "noise_learned_subframe_count": c["learned_total"],
            "noise_replenish_count": c["replenish_total"],
            "noise_effective_q": c["noise_effective_q"],
        }
        return c, out

    carry_out, outs = jax.lax.scan(
        step, carry0,
        (subE, subEhpf, rain_sum_t, primary_t, Eb, Mb, Mb_fft, Eb_fft, E_hpf),
    )
    return outs, carry_out


# ---------------------------------------------------------------------------
# Framework adapter (parity with ``edge/band_noise_processor.py``)
# ---------------------------------------------------------------------------


def build_band_noise_config(params: Dict[str, Any]) -> BandNoiseEstimatorConfig:
    """Build the estimator config from framework params with ``det.*`` dotted
    overrides (``edge/band_noise_processor.py:32-77``)."""
    p = dict(params)
    det_kwargs: Dict[str, Any] = dict(p.pop("det", {}) or {})
    for k in list(p.keys()):
        if k.startswith("det."):
            det_kwargs[k[4:]] = p.pop(k)

    fs = int(p.get("sample_rate", p.get("fs", 11162)))
    frame_len = int(p.get("frame_len", 512))
    det_kwargs.setdefault("fs", fs)
    det_kwargs.setdefault("n_fft", frame_len)
    det_fields = {f for f in NoiseFrameDetectorConfig.__dataclass_fields__}
    det_kwargs = {k: v for k, v in det_kwargs.items() if k in det_fields}
    for tup in ("primary_hz",):
        if tup in det_kwargs:
            det_kwargs[tup] = tuple(det_kwargs[tup])
    if "rain_bands_hz" in det_kwargs:
        det_kwargs["rain_bands_hz"] = tuple(
            tuple(b) for b in det_kwargs["rain_bands_hz"]
        )
    det = NoiseFrameDetectorConfig(**det_kwargs)

    est_fields = {f for f in BandNoiseEstimatorConfig.__dataclass_fields__}
    est_kwargs = {k: v for k, v in p.items() if k in est_fields and k != "det"}
    est_kwargs["fs"] = fs
    est_kwargs["frame_len"] = frame_len
    if "band_hz" in est_kwargs:
        est_kwargs["band_hz"] = tuple(est_kwargs["band_hz"])
    cfg = BandNoiseEstimatorConfig(det=det, **est_kwargs)
    cfg.validate()
    return cfg



_TELEMETRY_KEYS = (
    "noise_energy_sum", "rain_energy_sum", "total_energy_sum",
    "noise_frame_count", "rain_frame_count", "total_frame_count",
    "noise_buffer_valid_count", "noise_buffer_min_valid_count",
    "noise_buffer_underflow_frame_count", "frames_since_noise_update",
    "noise_learned_subframe_count", "noise_replenish_count",
    "noise_effective_q",
)


def _summarize_frames(row: Dict[str, np.ndarray], name: str, mode: str,
                      latency: float) -> Dict[str, Any]:
    """Per-clip summary with the reference adapter's result keys
    (``edge/band_noise_processor.py:237-248``) plus framework extras."""
    T = int(row["E_band"].shape[0])
    med = lambda k: float(np.median(row[k])) if T else float("nan")
    metrics: Dict[str, Any] = {
        "processor": name,
        "mode": mode,
        "n_frames": T,
        "M_clean_med": med("M_clean"),
        "noise_E_med": med("N_E"),
        "gain_med": med("G_mag"),
        "noise_effective_q_last": (
            float(row["noise_effective_q"][-1]) if T else float("nan")
        ),
        "noise_effective_q_med": med("noise_effective_q"),
        "fft_rain_frac": (
            float(row["fft_rain_frame"].mean()) if T else float("nan")
        ),
        # framework extras
        "median_E_band": med("E_band"),
        "median_N_E": med("N_E"),
        "median_G_mag": med("G_mag"),
        "median_M_clean": med("M_clean"),
        "rain_submask_frac": float(row["rain_submask"].mean()) if T else 0.0,
        "latency_s": latency,
    }
    # final telemetry snapshot (read-at-end semantics) incl. derived means
    tele = {k: (float(row[k][-1]) if T else 0.0) for k in _TELEMETRY_KEYS}
    tele["noise_energy_mean"] = tele["noise_energy_sum"] / max(
        1, int(tele["noise_frame_count"])
    )
    tele["rain_energy_mean"] = tele["rain_energy_sum"] / max(
        1, int(tele["rain_frame_count"])
    )
    tele["total_energy_mean"] = tele["total_energy_sum"] / max(
        1, int(tele["total_frame_count"])
    )
    metrics.update({f"energy_stats__{k}": v for k, v in tele.items()})
    return metrics


class BandNoiseEstimatorProcessor:
    """Framework processor over the streaming estimator.

    Enforces ``hop == frame_len`` (streaming IIR state) like the reference
    adapter (``edge/band_noise_processor.py:99-107``); summary metrics are
    medians + detector fractions + final telemetry.
    """

    def __init__(self, name: str = "band_noise", mode: str = "fft"):
        self.name = name
        self.mode = mode  # kept for backward compatibility with result rows

    def run(self, audio_data: np.ndarray, params: Dict[str, Any]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        import time as _time

        audio_data = np.asarray(audio_data, np.float32).reshape(-1)
        hop = int(params.get("hop", params.get("frame_len", 512)))
        frame_len = int(params.get("frame_len", 512))
        if hop != frame_len:
            raise ValueError(
                f"hop ({hop}) must equal frame_len ({frame_len}): the "
                "estimator streams IIR state across contiguous frames"
            )
        cfg = build_band_noise_config(params)

        t0 = _time.perf_counter()
        out = band_noise_process(jnp.asarray(audio_data), cfg)
        out = jax.tree_util.tree_map(np.asarray, out)
        latency = _time.perf_counter() - t0

        metrics = _summarize_frames(out, self.name, self.mode, latency)

        state: Dict[str, Any] = dict(out)
        state["processor"] = self.name
        state["latency_s"] = latency
        return metrics, state

    def run_batch(self, audio_matrix: np.ndarray, params: Dict[str, Any]
                  ) -> list:
        """Device-batched path: vmapped streaming estimator over (B, N)."""
        import time as _time

        audio_matrix = np.asarray(audio_matrix, np.float32)
        B = audio_matrix.shape[0]
        hop = int(params.get("hop", params.get("frame_len", 512)))
        frame_len = int(params.get("frame_len", 512))
        if hop != frame_len:
            raise ValueError(
                f"hop ({hop}) must equal frame_len ({frame_len}): the "
                "estimator streams IIR state across contiguous frames"
            )
        cfg = build_band_noise_config(params)

        t0 = _time.perf_counter()
        out = jax.vmap(lambda x: band_noise_process(x, cfg))(
            jnp.asarray(audio_matrix)
        )
        out = jax.tree_util.tree_map(np.asarray, out)
        latency = (_time.perf_counter() - t0) / max(B, 1)

        pairs = []
        for i in range(B):
            row = {k: v[i] for k, v in out.items()}
            metrics = _summarize_frames(row, self.name, self.mode, latency)
            state = dict(row)
            state["processor"] = self.name
            state["latency_s"] = latency
            pairs.append((metrics, state))
        return pairs
