"""Legacy "RoE" harmonic-novelty rain classifier, accelerator-native.

Re-design of ``edge/dsp_rain_detection.py`` (the notebook-converted legacy
algorithm; public entry ``rain_detection_algo``, ``:2566-2575``).  The
reference mutates ~25 module globals and loops Python over 2-second firmware
chunks; here the whole clip is one traced function:

  * configuration is a frozen dataclass (``RoeConfig``),
  * the 2-s firmware chunking (``analyse_raw_audio_in_parts``,
    ``:2601-2636``) is a static unrolled loop with in-graph state concat
    (replacing ``merge_algo_state``),
  * the per-harmonic novelty search uses *data-dependent* band masks: the
    estimated natural frequency ``frain_mean`` (a traced value) re-centers
    every harmonic band, so band selection is mask arithmetic instead of
    dynamic slicing,
  * the "mean of the 3 smallest in a +-M window" local noise average
    (``compute_local_average``, ``:1892-1909``) is a ``top_k`` over strided
    windows,
  * per-frame frequency peak picking is the vectorized local-maxima op.

Known reference defects intentionally not replicated (SURVEY §7): the dead
``estimate_noise_lpf`` path (``nf != 0``) raises ``NotImplementedError``
instead of ``NameError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.ops.filters import butter_sos, sosfilt
from audio_processing_tools_tpu.ops.spectrogram import spectrogram_power
from audio_processing_tools_tpu.ops.framing import frame_signal
from audio_processing_tools_tpu.ops.peaks import local_maxima
from audio_processing_tools_tpu.ops.stats import kurtosis as kurtosis_op

MAX_DURATION_FW = 2  # firmware chunk seconds (``dsp_rain_detection.py:2601``)


@dataclass(frozen=True)
class RoeConfig:
    """Parameter set of ``default_params`` (``dsp_rain_detection.py:1097-1124``)."""

    sample_rate: int = 11162
    freq_resolution: int = 45
    time_resolution_ms: int = 10
    check_duration: float = 10
    op_freq_range: Tuple[float, float] = (400.0, 3500.0)
    n_freq_range: Tuple[float, float] = (400.0, 700.0)
    fn: float = 400.0
    num_harmonics: int = 6
    harmonic_threshold: Tuple[float, ...] = (4.5, 4.0, 3.5, 3.5, 3.5, 3.5)
    max_peaks: int = 3
    log_factor: float = 0.0
    ns_duration_ms: float = 470.0
    nf: float = 0.0
    min_drop_count: float = 0.3
    rain_drop_min_thr: float = 3
    rain_drop_max_thr: float = 50
    rain_peaks_min_thr: float = 9
    rain_peaks_max_thr: float = 30
    kurtosis_thr: float = 2.5
    crest_thr: float = 3.75
    diff_energy_thr: float = 6.5
    t_band: Tuple[float, float] = (400.0, 3500.0)
    handle_fp: bool = True
    handle_fn: bool = True
    # debug plotting payloads (``spectrum_db0``/``spectrum_db`` in
    # ``algo_state``, reference ``dsp_rain_detection.py:2336-2341``); off by
    # default in the batched paths to keep device->host transfers small
    return_spectra: bool = True

    # derived (``configure_parameters``, ``:1298-1391``)
    @property
    def frame_length(self) -> int:
        return 2 ** math.ceil(math.log2(self.sample_rate / self.freq_resolution))

    @property
    def hop_length(self) -> int:
        return 2 ** math.ceil(
            math.log2(self.time_resolution_ms * self.sample_rate / 1000)
        )

    @property
    def min_average_len(self) -> int:
        return math.ceil(
            ((self.ns_duration_ms * self.sample_rate / 1000) / self.hop_length - 1) / 2
        )

    @property
    def rain_thr_hn(self) -> float:
        t = self.harmonic_threshold
        return t[0] + t[1] + t[2]


def build_roe_config(**params) -> RoeConfig:
    fields_ = set(RoeConfig.__dataclass_fields__)
    kw = {}
    for k, v in params.items():
        if k not in fields_:
            continue
        if k in ("op_freq_range", "n_freq_range", "t_band", "harmonic_threshold"):
            v = tuple(float(x) for x in v)
        kw[k] = v
    return RoeConfig(**kw)


# ---------------------------------------------------------------------------
# novelty machinery
# ---------------------------------------------------------------------------


def _local_average_sorted3(x: jnp.ndarray, M: int) -> jnp.ndarray:
    """Mean of the smallest min(max(3, ...), M//6)-bounded count in a +-M
    window — with M=20 this is the mean of the 3 smallest
    (``compute_local_average``, ``dsp_rain_detection.py:1892-1909``)."""
    L = x.shape[-1]
    win_len = M // 6
    if win_len > L:
        win_len = L
    if win_len < 3:
        win_len = 3
    # +-M windows as 2M+1 shifted pad+slice views (+inf padding marks the
    # out-of-range positions) instead of an (L, 2M+1) index gather
    pos_inf = jnp.asarray(jnp.inf, x.dtype)
    xp = jnp.concatenate([
        jnp.full(x.shape[:-1] + (M,), pos_inf, x.dtype), x,
        jnp.full(x.shape[:-1] + (M,), pos_inf, x.dtype),
    ], axis=-1)
    w = jnp.stack([xp[..., k : k + L] for k in range(2 * M + 1)], axis=-1)
    K = w.shape[-1]
    kk = min(win_len, K)
    if kk <= 3:
        # rank-selection instead of top_k (a partial sorting network): the
        # stable rank of each window entry is one (K, K) comparison plane
        # (ties index-broken), and each of the 3 order statistics is an
        # exact one-hot masked sum (same trick as the band-noise
        # quantile).  Mean in a
        # FIXED ascending scalar order so it cannot be re-fused into a
        # reassociating reduce.
        idx = jnp.arange(K, dtype=jnp.int32)
        lt = w[..., None, :] < w[..., :, None]
        eq_before = (w[..., None, :] == w[..., :, None]) & (
            idx[None, :] < idx[:, None]
        )
        rank = jnp.sum(lt | eq_before, axis=-1)
        s = [jnp.sum(jnp.where(rank == r, w, 0.0), axis=-1) for r in range(kk)]
        acc = s[0]
        for r in range(1, kk):
            acc = acc + s[r]
        return acc / float(kk)
    smallest = -jax.lax.top_k(-w, kk)[0]
    # all windows have >= 3 valid entries for L >= 3
    return jnp.mean(smallest, axis=-1)


def _calculate_snr(nov: jnp.ndarray, M: int) -> jnp.ndarray:
    """(``calculate_snr``, ``dsp_rain_detection.py:1914-1922``)."""
    la = _local_average_sorted3(nov, M)
    la = jnp.where(la <= 0, jnp.max(nov) / 5.0, la)
    nov = jnp.where(nov == 0, 1.0, nov)
    la = jnp.where(la == 0, 1.0, la)
    return nov / la


def _novelty_spectrum(Y1: jnp.ndarray, M: int, threshold: float
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(``compute_novelty_spectrum_new``, ``dsp_rain_detection.py:1924-1954``).

    ``Y1`` is the band-masked magnitude spectrogram (F, T).  The novelty is
    the positive first difference along the FREQUENCY axis summed over
    frequency, SNR-normalized, peak-masked, then thresholded+clipped.
    """
    d = jnp.diff(Y1, axis=0)
    d = jnp.maximum(d, 0.0)
    nov = jnp.sum(d, axis=0)
    nov = jnp.concatenate([nov, jnp.zeros((1,), nov.dtype)])

    nov = _calculate_snr(nov, M)
    mask = local_maxima(nov).astype(nov.dtype)
    nov1 = nov * mask

    thr = float(threshold)
    nov_t = jnp.where(nov > thr, jnp.minimum(nov, thr * 1.5), 0.0)
    nov_t = nov_t * mask
    return nov_t, nov1


def _band_mask_bins(f1, f2, Fs: float, N: int, F: int) -> jnp.ndarray:
    """Rows kept by ``bp_filter_frequencies`` (``:1828-1846``):
    idx in [int(f1 // f_res + 1), int(f2 // f_res)] — data-dependent."""
    f_res = Fs / N
    idx1 = jnp.floor(f1 / f_res).astype(jnp.int32) + 1
    idx2 = jnp.floor(f2 / f_res).astype(jnp.int32)
    rows = jnp.arange(F)
    return (rows >= idx1) & (rows <= idx2)


def _find_first_peak_in_range(mag: jnp.ndarray, search_lo, search_hi,
                              accept_lo, accept_hi, Fs: float,
                              num_peaks: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(``find_peaks_in_frequency_range``, ``dsp_rain_detection.py:1649-1698``).

    ``mag`` is (F, T).  Bin mapping: ``bin = int(freq * F / (Fs/2))``,
    ``freq = bin * (Fs/2) / F``.  Among the first ``num_peaks`` spectral
    peaks (ascending bin) inside the search range, return (found_count,
    fpeak) for the first whose frequency lies strictly inside the accept
    range.
    """
    F, T = mag.shape
    fn_half = Fs / 2.0
    bin_lo = jnp.floor(search_lo * F / fn_half).astype(jnp.int32)
    bin_hi = jnp.floor(search_hi * F / fn_half).astype(jnp.int32)

    mT = jnp.swapaxes(mag, 0, 1)  # (T, F)
    is_max = local_maxima(mT)
    rows = jnp.arange(F)[None, :]
    # peaks found on the sliced band: interior of [bin_lo, bin_hi)
    in_search = (rows > bin_lo) & (rows < bin_hi - 1)
    pk = is_max & in_search

    # rank among peaks (ascending bin).  The in-range peak count at bin j
    # equals C(j) - C(bin_lo) with C the HARMONIC-INDEPENDENT global peak
    # cumsum (every in-(bin_lo, j] peak is in-search for in-search j, and
    # rank is only consumed under a ``pk`` mask) — so the six per-harmonic
    # (T, F) cumsums of the old ``cumsum(pk)`` form collapse to one
    # CSE-able scan plus elementwise offsets.
    C = jnp.cumsum(is_max.astype(jnp.int32), axis=-1)          # (T, F)
    C_lo = jnp.sum(jnp.where(rows == bin_lo, C, 0), axis=-1)   # (T,)
    rank = C - C_lo[:, None] - 1
    within_first = pk & (rank < num_peaks)
    freq = rows.astype(jnp.float32) * fn_half / F
    accept = (freq > accept_lo) & (freq < accept_hi)
    elig = within_first & accept
    found_any = jnp.any(elig, axis=-1)
    first_bin = jnp.argmax(elig, axis=-1)
    fpeak = jnp.where(found_any, first_bin.astype(jnp.float32) * fn_half / F, 0.0)
    return found_any.astype(jnp.int32), fpeak


def _nonzero_mean(x: jnp.ndarray) -> jnp.ndarray:
    cnt = jnp.sum(x != 0)
    return jnp.where(cnt > 0, jnp.sum(x) / jnp.maximum(cnt, 1), 0.0)


# ---------------------------------------------------------------------------
# TD pulse characteristics
# ---------------------------------------------------------------------------


def _pulse_characteristics(audio: jnp.ndarray, num_frames: int, cfg: RoeConfig
                           ) -> Dict[str, jnp.ndarray]:
    """(``calculate_pulse_characteristics``, ``dsp_rain_detection.py:657-767``).

    Arrays come back length ``num_frames + 1`` (reference pads a trailing 0).
    """
    N, H = cfg.frame_length, cfg.hop_length
    Fs = cfg.sample_rate
    padded = jnp.concatenate(
        [jnp.zeros((H,), audio.dtype), audio, jnp.zeros((H,), audio.dtype)]
    )
    # rain-band 400-900 Hz causal bandpass (butter 4)
    nyq = 0.5 * Fs
    sos = butter_sos(4, [400.0 / nyq, 900.0 / nyq], "bandpass")
    filtered = sosfilt(sos, padded)

    frames_f = frame_signal(filtered, N, H)
    energy = jnp.sum(frames_f * frames_f, axis=-1)  # strided block energy
    n_e = energy.shape[0]
    T = min(num_frames, n_e)
    energy = energy[:num_frames] if n_e >= num_frames else jnp.pad(
        energy, (0, num_frames - n_e)
    )

    # min over neighbors +-30 excluding padded edge frames 0 and n-1
    m = 30
    i = np.arange(num_frames)
    lo = np.maximum(1, i - m)
    hi = np.minimum(num_frames - 1, i + m + 1)  # exclusive
    offs = np.arange(-m, m + 1)
    idx = i[:, None] + offs[None, :]
    valid = (idx >= lo[:, None]) & (idx < hi[:, None])
    win = jnp.where(jnp.asarray(valid), energy[np.clip(idx, 0, num_frames - 1)], jnp.inf)
    min_energy = jnp.min(win, axis=-1)
    min_energy = jnp.where(jnp.asarray(lo >= hi), 0.0, min_energy)

    # diff energy (i >= 2): e[i] / min(e[i-1], e[i-2]) when rising
    e = energy
    e1 = jnp.concatenate([jnp.zeros(1, e.dtype), e[:-1]])
    e2 = jnp.concatenate([jnp.zeros(2, e.dtype), e[:-2]])
    last = jnp.where(e2 < e1, e2, e1)
    diff_energy = jnp.where(
        (jnp.arange(num_frames) >= 2) & (e > last), e / (last + 1e-12), 0.0
    )

    # per-frame kurtosis (fisher, biased) and crest (i > 0) over padded frames
    frames_p = frame_signal(padded, N, H)[:num_frames]
    k_list = kurtosis_op(frames_p, axis=-1, fisher=True, bias=True)
    crest = jnp.max(jnp.abs(frames_p), axis=-1) / (
        jnp.sqrt(jnp.mean(frames_p * frames_p, axis=-1)) + 1e-12
    )
    gate0 = jnp.arange(num_frames) > 0
    k_list = jnp.where(gate0, k_list, 0.0)
    crest = jnp.where(gate0, crest, 0.0)

    z1 = jnp.zeros((1,), e.dtype)
    times = jnp.concatenate(
        [z1, jnp.arange(num_frames, dtype=jnp.float32) * H / Fs]
    )
    return {
        "times": times,
        "kurtosis": jnp.concatenate([k_list, z1]),
        "crest_factor": jnp.concatenate([crest, z1]),
        "diff_energy": jnp.concatenate([diff_energy, z1]),
        "energy_list": jnp.concatenate([energy, z1]),
        "min_energy": jnp.concatenate([min_energy, z1]),
    }


def _amplitude_to_db_refmax(mag: jnp.ndarray, amin: float = 1e-5,
                            top_db: float = 80.0) -> jnp.ndarray:
    """librosa ``amplitude_to_db(..., ref=np.max)`` semantics."""
    m = jnp.maximum(mag, amin)
    ref = jnp.maximum(jnp.max(mag), amin)
    db = 20.0 * jnp.log10(m) - 20.0 * jnp.log10(ref)
    return jnp.maximum(db, jnp.max(db) - top_db)


# ---------------------------------------------------------------------------
# per-chunk analysis
# ---------------------------------------------------------------------------


def _analyse_chunk(chunk: jnp.ndarray, cfg: RoeConfig,
                   collect_raw: bool = False) -> Dict[str, Any]:
    """(``analyse_raw_audio``, ``dsp_rain_detection.py:2230-2562``) for one
    firmware chunk; returns per-chunk arrays + counts.

    ``collect_raw`` additionally returns the threshold-INDEPENDENT pieces of
    the decision chain (pre-threshold SNR novelties, peak gates, harmonic
    active flags) so threshold sweeps can re-evaluate decisions as pure
    elementwise math (see :func:`roe_sweep_features`)."""
    if cfg.nf != 0:
        raise NotImplementedError(
            "nf != 0 requires estimate_noise_lpf, which is undefined in the "
            "reference (dsp_rain_detection.py:2318 latent bug); not supported."
        )
    Fs = cfg.sample_rate
    N, H = cfg.frame_length, cfg.hop_length
    op_lo, op_hi = cfg.op_freq_range

    # operating-band causal bandpass, order 8 -> (``bandpass_filter_sos``)
    nyq = 0.5 * Fs
    sos = butter_sos(8, [op_lo / nyq, op_hi / nyq], "bandpass")
    audio = sosfilt(sos, chunk.astype(jnp.float32))

    # only |S| is consumed downstream, so the power-only spectrogram can
    # feed it (|S| = sqrt(|S|^2))
    mag = jnp.sqrt(spectrogram_power(audio, n_fft=N, hop=H, center=True))
    F, T = mag.shape

    t_res = _pulse_characteristics(audio, T, cfg)

    Y = mag if cfg.log_factor == 0 else jnp.log(1 + cfg.log_factor * mag)
    M = cfg.min_average_len
    thrs = cfg.harmonic_threshold

    # ---- harmonic 0: fixed band [fn, fn+300] ----
    f0_lo = jnp.float32(cfg.fn)
    f0_hi = jnp.float32(cfg.fn + 300.0)
    mask0 = _band_mask_bins(f0_lo, f0_hi, Fs, N, F)
    Y1 = jnp.where(mask0[:, None], Y, 0.0)
    novk, novt = _novelty_spectrum(Y1, M, thrs[0])

    peaks0, fpeak0 = _find_first_peak_in_range(
        mag, jnp.float32(op_lo), jnp.float32(op_hi), f0_lo, f0_hi, Fs,
        cfg.max_peaks,
    )
    # novelty arrays are length T+1 (trailing zero); the reference gates
    # only the first T entries (loop over len(fpeak_array) == T)
    raw_nov1 = [novt]                       # pre-threshold, pre-gate SNR nov
    raw_nopeak = [jnp.pad(peaks0 == 0, (0, 1))]
    gate0 = (novk[:T] != 0) & (peaks0 == 0)
    novk = novk.at[:T].set(jnp.where(gate0, 0.0, novk[:T]))
    novt = novt.at[:T].set(jnp.where(gate0, 0.0, novt[:T]))

    frain_mean = _nonzero_mean(fpeak0)

    # ---- harmonics 1..4 with frain-centered dynamic bands ----
    n_lo, n_hi = cfg.n_freq_range
    in_natural = (frain_mean >= n_lo) & (frain_mean <= n_hi)
    # the last harmonic is dropped when its search range overflows the band
    overflow_last = (frain_mean * cfg.num_harmonics + 300.0) > (op_hi + 100.0)

    nov_list = [novk]
    nov1_list = [novt]
    n_harm = cfg.num_harmonics - 1  # harmonics 1..5 candidates
    for hn in range(1, n_harm + 1):
        f1 = frain_mean * (hn + 1) - 100.0
        b_lo, b_hi = f1, f1 + 300.0
        maskh = _band_mask_bins(b_lo, b_hi, Fs, N, F)
        Yh = jnp.where(maskh[:, None], Y, 0.0)
        thr_h = thrs[hn] if hn < len(thrs) else thrs[-1]
        novx, nov1_h = _novelty_spectrum(Yh, M, thr_h)

        # search range re-centered by ``update_search_freq_range`` (:1393-1405)
        s_lo = jnp.maximum(frain_mean * (hn + 1) - 200.0, op_lo)
        s_hi = jnp.minimum(frain_mean * (hn + 1) + 300.0, op_hi)
        _, fpeak_h = _find_first_peak_in_range(
            mag, s_lo, s_hi, b_lo, b_hi, Fs, cfg.max_peaks
        )
        gate_h = (novx[:T] != 0) & (fpeak_h == 0)
        novx = novx.at[:T].set(jnp.where(gate_h, 0.0, novx[:T]))

        active = in_natural
        if hn == n_harm:
            active = active & (~overflow_last)
        raw_nov1.append(jnp.where(active, nov1_h, 0.0))
        raw_nopeak.append(jnp.pad(fpeak_h == 0, (0, 1)))
        nov_list.append(jnp.where(active, novx, 0.0))

    nov = jnp.stack(nov_list)  # (n_harmonics, T+1)
    # base gating: zero harmonics where harmonic-0 novelty is zero
    nov = nov.at[1:].set(jnp.where(nov[0] == 0.0, 0.0, nov[1:]))

    nov_hn = jnp.sum(nov, axis=0)
    # reference clamps >thr to thr, then zeroes <thr: thr survives at >= thr
    raining = jnp.where(nov_hn >= cfg.rain_thr_hn, cfg.rain_thr_hn, 0.0)
    rain_drops = jnp.sum(raining >= 1.0).astype(jnp.int32)

    # detect_rain_from_novelty variant (kept as state, ``:2190-2228``)
    clipped = []
    for hn in range(nov.shape[0]):
        thr_h = thrs[hn] if hn < len(thrs) else thrs[-1]
        v = nov[hn]
        cv = jnp.where(v > 1.6 * thr_h, 1.5 * thr_h, jnp.where(v > thr_h, v, 0.0))
        clipped.append(cv)
    nov_hn_new = jnp.sum(jnp.stack(clipped), axis=0)
    rain_status_new = nov_hn_new > cfg.rain_thr_hn

    out = {
        "rain_drops": rain_drops,
        "frain_mean": frain_mean,
        "raining": raining,
        "nov": nov,
        "novt": novt,
        "novk": novk,
        "Nov0": nov[0],
        "filtered": audio,
        "rain_status_new": rain_status_new,
        **t_res,
    }
    if cfg.return_spectra:
        # plotting payloads (``dsp_rain_detection.py:2336-2341``): db0 is
        # the post-noise-suppression spectrum, db the raw one; with the
        # supported nf == 0 they differ only through log compression
        out["spectrum_db0"] = _amplitude_to_db_refmax(Y)
        Yp = mag if cfg.log_factor == 0 else jnp.log(1 + cfg.log_factor * mag)
        out["spectrum_db"] = _amplitude_to_db_refmax(Yp)
    if collect_raw:
        # threshold-independent decision-chain features: pre-threshold SNR
        # novelties (active-gated for harmonics) and no-peak gate masks
        out["raw_nov1"] = jnp.stack(raw_nov1)        # (n_harm, T+1)
        out["raw_nopeak"] = jnp.stack(raw_nopeak)    # (n_harm, T+1) bool
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "n_samples"))
def _roe_traced(audio: jnp.ndarray, cfg: RoeConfig, n_samples: int
                ) -> Dict[str, Any]:
    """Whole-clip RoE: static chunk loop + in-graph state concat + combiner."""
    Fs = cfg.sample_rate
    duration = cfg.check_duration
    chunk_plan = []
    remaining = duration
    offset = 0.0
    while remaining > 0:
        part = min(remaining, MAX_DURATION_FW)
        n_frames = part * Fs / cfg.frame_length
        read_size = int(cfg.frame_length * n_frames)
        read_off = int(Fs * offset)
        chunk_plan.append((read_off, read_size))
        remaining -= part
        offset += part

    chunks_out = []
    rain_drop_count = jnp.int32(0)
    frain_mean = jnp.float32(0)
    for read_off, read_size in chunk_plan:
        if read_off >= n_samples or n_samples - read_off < Fs:
            continue  # reference: short chunk -> (0, 0, 0)
        take = min(read_size, n_samples - read_off)
        chunk = jax.lax.dynamic_slice(audio, (read_off,), (take,))
        res = _analyse_chunk(chunk, cfg)
        chunks_out.append(res)
        rain_drop_count = rain_drop_count + res["rain_drops"]
        frain_mean = res["frain_mean"]

    if not chunks_out:
        raise ValueError("audio too short for a single RoE chunk")

    merged: Dict[str, Any] = {}
    concat_keys = ("raining", "kurtosis", "crest_factor", "diff_energy",
                   "energy_list", "min_energy", "times", "novt", "novk",
                   "Nov0", "filtered", "rain_status_new")
    for k in concat_keys:
        merged[k] = jnp.concatenate([c[k] for c in chunks_out], axis=-1)
    merged["nov"] = jnp.concatenate([c["nov"] for c in chunks_out], axis=-1)
    if cfg.return_spectra:
        for k in ("spectrum_db0", "spectrum_db"):
            merged[k] = jnp.concatenate([c[k] for c in chunks_out], axis=-1)

    rain_drop_threshold = math.ceil(cfg.min_drop_count * duration)
    raining_flag = rain_drop_count > rain_drop_threshold

    # TD gate + FP/FN combiner (``time_domain_raining_status`` /
    # ``combine_raining_status``, ``:770-801, 2638-2674``)
    peaks = (
        (merged["kurtosis"] > cfg.kurtosis_thr)
        & (merged["crest_factor"] > cfg.crest_thr)
        & (merged["diff_energy"] > cfg.diff_energy_thr)
    )
    rain_peaks_count = jnp.sum(peaks).astype(jnp.int32)
    merged["rain_peaks"] = peaks

    rdc = rain_drop_count
    mod = rdc
    raining2 = raining_flag
    if cfg.handle_fn:
        promote = (~raining2) & (
            (rdc > cfg.rain_drop_max_thr) | (rain_peaks_count > cfg.rain_peaks_max_thr)
        )
        raining2 = raining2 | promote
        mod = jnp.where(promote, jnp.maximum(rdc, rain_peaks_count), mod)
    if cfg.handle_fp:
        demote = raining2 & (
            (rain_peaks_count < cfg.rain_peaks_min_thr)
            | (rdc < rain_drop_threshold)
        )
        raining2 = jnp.where(demote, False, raining2)
        mod = jnp.where(demote, 0, mod)

    # final zeroing when not raining (``analyse_raw_audio_wrapper:2723-2726``)
    if cfg.handle_fp or cfg.handle_fn:
        final_mod = jnp.where(raining2, mod, 0)
        final_count = jnp.where(raining2, rdc, 0)
    else:
        final_mod = jnp.where(raining_flag, rdc, 0)
        final_count = final_mod
        rain_peaks_count = final_mod

    merged["duration"] = jnp.float32(duration)
    merged["rain_drop_count"] = final_count
    merged["rain_drop_count_raw"] = rdc  # pre-combiner count (dsp_integ wrapper)
    merged["rain_peaks_count"] = rain_peaks_count
    merged["rain_drop_count_mod"] = final_mod
    merged["frain_mean"] = frain_mean
    return merged


def rain_detection_algo(audio_data, **kwargs) -> Tuple[int, float, Dict[str, Any]]:
    """Public API parity with ``rain_detection_algo``
    (``dsp_rain_detection.py:2566-2575``):
    returns ``(rain_drop_count_mod, frain_mean, algo_state)``."""
    cfg = build_roe_config(**kwargs)
    x = jnp.asarray(np.asarray(audio_data, np.float32).reshape(-1))
    out = _roe_traced(x, cfg, int(x.shape[-1]))
    out = jax.tree_util.tree_map(np.asarray, out)
    out["audio_data"] = np.asarray(audio_data)
    return int(out["rain_drop_count_mod"]), float(out["frain_mean"]), out


def python_classifier_boolean_wrapper(audio_signal, **kwargs):
    """Boolean wrapper (``dsp_rain_detection.py:2577-2598``)."""
    kwargs.setdefault("return_spectra", False)  # state is discarded
    drops, _, _ = rain_detection_algo(audio_signal, **kwargs)
    if drops > 0:
        return True
    if drops == 0:
        return False
    return np.nan


@partial(jax.jit, static_argnames=("cfg", "n_samples"))
def _roe_features_traced(audio: jnp.ndarray, cfg: RoeConfig, n_samples: int
                         ) -> Dict[str, jnp.ndarray]:
    """Threshold-INDEPENDENT features of the whole-clip decision chain.

    Runs the expensive front-end (filter, STFT, SNR novelties, peak search,
    TD pulse features) once; thresholds can then be swept as elementwise
    math via :func:`roe_apply_thresholds`."""
    Fs = cfg.sample_rate
    chunk_plan = []
    remaining, offset = cfg.check_duration, 0.0
    while remaining > 0:
        part = min(remaining, MAX_DURATION_FW)
        read_size = int(cfg.frame_length * (part * Fs / cfg.frame_length))
        chunk_plan.append((int(Fs * offset), read_size))
        remaining -= part
        offset += part

    parts = []
    for read_off, read_size in chunk_plan:
        if read_off >= n_samples or n_samples - read_off < Fs:
            continue
        take = min(read_size, n_samples - read_off)
        chunk = jax.lax.dynamic_slice(audio, (read_off,), (take,))
        parts.append(_analyse_chunk(chunk, cfg, collect_raw=True))
    if not parts:
        raise ValueError("audio too short for a single RoE chunk")
    return {
        "nov1": jnp.concatenate([p["raw_nov1"] for p in parts], axis=-1),
        "nopeak": jnp.concatenate([p["raw_nopeak"] for p in parts], axis=-1),
        "kurtosis": jnp.concatenate([p["kurtosis"] for p in parts], axis=-1),
        "crest_factor": jnp.concatenate(
            [p["crest_factor"] for p in parts], axis=-1),
        "diff_energy": jnp.concatenate(
            [p["diff_energy"] for p in parts], axis=-1),
    }


def roe_sweep_features(audio_matrix: np.ndarray, **kwargs) -> Dict[str, Any]:
    """Batched threshold-independent RoE features for (B, N) clips."""
    kwargs.setdefault("return_spectra", False)
    cfg = build_roe_config(**kwargs)
    xb = jnp.asarray(np.asarray(audio_matrix, np.float32))
    n = int(xb.shape[-1])
    feats = jax.vmap(lambda x: _roe_features_traced(x, cfg, n))(xb)
    feats["cfg"] = cfg
    return feats


def roe_apply_thresholds(
    feats: Dict[str, Any], *, harmonic_threshold, kurtosis_thr, crest_thr,
    diff_energy_thr, min_drop_count, rain_drop_min_thr, rain_drop_max_thr,
    rain_peaks_min_thr, rain_peaks_max_thr,
):
    """Elementwise re-evaluation of the RoE decision for one threshold set.

    All arguments may be traced scalars (``harmonic_threshold`` a length-6
    vector), so sweeps vmap over combos. Mirrors ``_analyse_chunk``'s
    threshold tail + ``_roe_traced``'s TD gate and FP/FN combiner exactly.
    Returns per-clip ``rain_drop_count_mod``.
    """
    cfg: RoeConfig = feats["cfg"]
    nov1 = feats["nov1"]          # (B, n_harm, T)
    nopeak = feats["nopeak"]
    thr6 = jnp.asarray(harmonic_threshold, jnp.float32)

    thr_b = thr6[None, :, None]
    nov_t = jnp.where(nov1 > thr_b, jnp.minimum(nov1, 1.5 * thr_b), 0.0)
    gated = jnp.where(nopeak, 0.0, nov_t)
    base = gated[:, :1, :]
    nov = jnp.concatenate(
        [base, jnp.where(base == 0.0, 0.0, gated[:, 1:, :])], axis=1
    )
    nov_hn = jnp.sum(nov, axis=1)                       # (B, T)
    thr_hn = thr6[0] + thr6[1] + thr6[2]
    raining = jnp.where(nov_hn >= thr_hn, thr_hn, 0.0)
    rdc = jnp.sum(raining >= 1.0, axis=-1).astype(jnp.int32)   # (B,)

    peaks = (
        (feats["kurtosis"] > kurtosis_thr)
        & (feats["crest_factor"] > crest_thr)
        & (feats["diff_energy"] > diff_energy_thr)
    )
    rain_peaks_count = jnp.sum(peaks, axis=-1).astype(jnp.int32)

    rain_drop_threshold = jnp.ceil(
        min_drop_count * cfg.check_duration
    ).astype(jnp.int32)
    raining2 = rdc > rain_drop_threshold
    mod = rdc
    if cfg.handle_fn:
        promote = (~raining2) & (
            (rdc > rain_drop_max_thr) | (rain_peaks_count > rain_peaks_max_thr)
        )
        raining2 = raining2 | promote
        mod = jnp.where(promote, jnp.maximum(rdc, rain_peaks_count), mod)
    if cfg.handle_fp:
        demote = raining2 & (
            (rain_peaks_count < rain_peaks_min_thr)
            | (rdc < rain_drop_threshold)
        )
        raining2 = jnp.where(demote, False, raining2)
        mod = jnp.where(demote, 0, mod)
    if cfg.handle_fp or cfg.handle_fn:
        return jnp.where(raining2, mod, 0)
    return jnp.where(rdc > rain_drop_threshold, rdc, 0)


def roe_detect_batch(audio_matrix: np.ndarray, **kwargs) -> Dict[str, np.ndarray]:
    """Batched RoE over (B, N) clips: one vmapped XLA program."""
    kwargs.setdefault("return_spectra", False)  # keep batch payloads small
    cfg = build_roe_config(**kwargs)
    xb = jnp.asarray(np.asarray(audio_matrix, np.float32))
    n = int(xb.shape[-1])
    fn = jax.vmap(lambda x: _roe_traced(x, cfg, n))
    return jax.tree_util.tree_map(np.asarray, fn(xb))
