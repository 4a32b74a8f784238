"""Time-domain frame features, fully vectorized over frames.

Re-design of ``extract_td_features_inline`` (reference
``edge/feature_extraction.py:174-538``): the reference loops over frames and
calls scipy per frame; here every feature is a batched tensor op so the whole
clip (and a batch of clips via vmap) is computed in one fused XLA program.

Features (registry parity with ``TD_FEATURE_NAMES``):
  core:     td_crest_factor, td_kurtosis, td_block_energy_crest,
            td_block_peak_width_50, td_block_post_pre_energy_ratio
  envelope: td_energy_envelope, td_rise/fall_time_sec, td_rise/fall_slope,
            td_peak_energy  (optional, off by default like the reference)
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple, Dict

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.ops.framing import frame_signal, num_frames
from audio_processing_tools_tpu.ops.filters import design_bandpass, sosfiltfilt, sosfilt
from audio_processing_tools_tpu.ops.stats import kurtosis, crest_factor

TD_CORE_FEATURE_NAMES = (
    "frame_times",
    "td_crest_factor",
    "td_kurtosis",
    "td_block_energy_crest",
    "td_block_peak_width_50",
    "td_block_post_pre_energy_ratio",
)

TD_ENVELOPE_FEATURE_NAMES = (
    "td_energy_envelope",
    "td_rise_time_sec",
    "td_fall_time_sec",
    "td_rise_slope",
    "td_fall_slope",
    "td_peak_energy",
)

TD_FEATURE_NAMES = TD_CORE_FEATURE_NAMES + TD_ENVELOPE_FEATURE_NAMES


def _bandpass_filtfilt_or_filt(x: jnp.ndarray, sr: float, band, order: int):
    """sosfiltfilt with the reference's fall-back-to-causal for short inputs
    (``edge/feature_extraction.py:206-209``)."""
    sos = design_bandpass(sr, float(band[0]), float(band[1]), order)
    n_sections = sos.shape[0]
    ntaps = 2 * n_sections + 1 - int(min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum()))
    padlen = 3 * ntaps
    if x.shape[-1] > padlen:
        return sosfiltfilt(sos, x)
    return sosfilt(sos, x)


def td_input_signal(
    x: jnp.ndarray,
    sr: float,
    *,
    td_input_mode: str = "default",
    td_input_band: Optional[Tuple[float, float]] = None,
    operating_band: Tuple[float, float] = (400.0, 3500.0),
    mode_bands: Optional[Tuple[Tuple[float, float], ...]] = None,
    bp_order: int = 4,
) -> jnp.ndarray:
    """Select the TD front-end waveform (``feature_extraction.py:468-482``)."""
    mode = str(td_input_mode).lower()
    if mode == "default":
        return x
    if mode == "comb_filter":
        if not mode_bands:
            return _bandpass_filtfilt_or_filt(x, sr, operating_band, bp_order)
        y = jnp.zeros_like(x)
        for band in mode_bands:
            y = y + _bandpass_filtfilt_or_filt(x, sr, band, bp_order)
        return y
    if mode == "bandpass":
        band = td_input_band if td_input_band is not None else operating_band
        return _bandpass_filtfilt_or_filt(x, sr, band, bp_order)
    raise ValueError(f"Unsupported td_input_mode={td_input_mode!r}")


# ---------------------------------------------------------------------------
# Vectorized peak-width-at-half-prominence for window argmax peaks
# ---------------------------------------------------------------------------


def _pick(a: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``a[t, idx[t]]`` as a one-hot reduction.

    A one-hot mask + sum in place of ``take_along_axis`` on the minor axis:
    elementwise work with no gather.
    """
    j = jnp.arange(a.shape[-1])
    return jnp.sum(jnp.where(j[None, :] == idx[:, None], a, 0.0), axis=-1)


def _window_argmax_peak_width(env_w: jnp.ndarray, valid: jnp.ndarray,
                              eps: float) -> jnp.ndarray:
    """Half-prominence width of each window's argmax peak.

    ``env_w``: (T, W) block-envelope windows; ``valid``: (T, W) mask.
    Replicates the reference gate (``feature_extraction.py:313-346``): width
    is nonzero only when the argmax is interior, is a strict local peak with
    adjacent prominence > eps, and peak value > eps.  The width itself matches
    ``scipy.signal.peak_widths(..., rel_height=0.5)`` for that peak: height =
    peak - 0.5 * prominence, crossings linearly interpolated; the prominence
    bases of a window maximum extend to the window borders.
    """
    T, W = env_w.shape
    neg = jnp.asarray(-jnp.inf, env_w.dtype)
    e = jnp.where(valid, env_w, neg)
    p = jnp.argmax(e, axis=-1)  # (T,)
    peak = jnp.max(e, axis=-1)
    count = jnp.sum(valid, axis=-1)

    j = jnp.arange(W)[None, :]
    left_of = (j <= p[:, None]) & valid
    right_of = (j >= p[:, None]) & valid
    pos_inf = jnp.asarray(jnp.inf, env_w.dtype)
    left_base = jnp.min(jnp.where(left_of, env_w, pos_inf), axis=-1)
    right_base = jnp.min(jnp.where(right_of, env_w, pos_inf), axis=-1)
    prom = peak - jnp.maximum(left_base, right_base)
    h = peak - 0.5 * prom

    # left crossing: largest j < p with env[j] <= h  -> stop index i
    le_mask = (j < p[:, None]) & valid & (env_w <= h[:, None])
    has_left = jnp.any(le_mask, axis=-1)
    i_stop = jnp.max(jnp.where(le_mask, j, -1), axis=-1)  # env[i_stop] <= h
    i_left = jnp.where(has_left, i_stop, 0)
    e_i = _pick(env_w, i_left)
    e_i1 = _pick(env_w, jnp.minimum(i_left + 1, W - 1))
    interp_l = jnp.where(
        has_left & (e_i < h),
        (h - e_i) / jnp.where(e_i1 != e_i, e_i1 - e_i, 1.0),
        0.0,
    )
    left_ip = i_left.astype(env_w.dtype) + interp_l

    # right crossing: smallest j > p with env[j] <= h
    re_mask = (j > p[:, None]) & valid & (env_w <= h[:, None])
    has_right = jnp.any(re_mask, axis=-1)
    j_stop = jnp.min(jnp.where(re_mask, j, W), axis=-1)
    i_right = jnp.where(has_right, j_stop, jnp.maximum(count - 1, 0))
    e_j = _pick(env_w, i_right)
    e_jm1 = _pick(env_w, jnp.maximum(i_right - 1, 0))
    interp_r = jnp.where(
        has_right & (e_j < h),
        (h - e_j) / jnp.where(e_jm1 != e_j, e_jm1 - e_j, 1.0),
        0.0,
    )
    right_ip = i_right.astype(env_w.dtype) - interp_r

    width = right_ip - left_ip

    # reference gating: interior strict peak with adjacent prominence > eps
    p_prev = _pick(env_w, jnp.maximum(p - 1, 0))
    p_next = _pick(env_w, jnp.minimum(p + 1, W - 1))
    adjacent_prom = peak - jnp.maximum(p_prev, p_next)
    ok = (
        (count >= 3)
        & (p > 0)
        & (p < count - 1)
        & (adjacent_prom > eps)
        & (peak > eps)
        & jnp.isfinite(width)
        & (width > 0.0)
    )
    return jnp.where(ok, width, 0.0)


# ---------------------------------------------------------------------------
# Block-energy features
# ---------------------------------------------------------------------------


def _block_envelope(x: jnp.ndarray, B: int, H: int, smooth: bool) -> jnp.ndarray:
    """RMS block-amplitude envelope (``feature_extraction.py:266-282``)."""
    n = x.shape[-1]
    n_blocks = 1 + (n - B) // H if n >= B else 0
    if n_blocks <= 0:
        return jnp.zeros(x.shape[:-1] + (0,), x.dtype)
    # framed sums (not a long cumsum: float32 cumsum over ~1e5 samples loses
    # ~1e-4 relative precision; per-block sums are exact enough)
    blocks = frame_signal(x, B, H)  # (..., n_blocks, B)
    sums = jnp.sum(blocks * blocks, axis=-1)
    env = jnp.sqrt(jnp.maximum(sums / float(B), 0.0))
    if smooth and n_blocks >= 3:
        k = jnp.asarray([0.25, 0.5, 0.25], env.dtype)
        padded = jnp.pad(env, [(0, 0)] * (env.ndim - 1) + [(1, 1)])
        env = (
            k[0] * padded[..., :-2] + k[1] * padded[..., 1:-1] + k[2] * padded[..., 2:]
        )
    return env


def block_energy_peak_features(
    x_td: jnp.ndarray,
    *,
    frame_len: int,
    hop: int,
    block_len: int = 8,
    block_hop: Optional[int] = None,
    post_pre_blocks: int = 4,
    smooth: bool = True,
    eps: float = 1e-9,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(crest, width50, log post/pre ratio) per frame, vectorized.

    Parity with ``_block_energy_peak_features``
    (``feature_extraction.py:253-366``).  1-D input only (vmap for batches).
    """
    B = max(1, int(block_len))
    H = int(block_hop) if block_hop is not None else B
    H = max(1, H)
    n = x_td.shape[-1]
    T = num_frames(n, frame_len, hop)
    if n < B or T == 0:
        z = jnp.zeros((T,), x_td.dtype)
        return z, z, z

    env = _block_envelope(x_td, B, H, smooth)  # (n_blocks,)
    n_blocks = env.shape[-1]
    blocks_per_frame = max(1, int(np.ceil(frame_len / H)))
    stride = max(1, int(np.round(hop / H)))

    # windows via framing (reshape/concat), not an index gather: window t is
    # env[t*stride : t*stride + W] with an m-block apron on both sides so the
    # pre/post sums below never leave the window.  All indexing here is
    # static padding + framing + range masks.
    W = blocks_per_frame
    m = max(1, int(post_pre_blocks))
    b0 = np.arange(T) * stride
    need = m + (T - 1) * stride + W + m
    env_pad = jnp.concatenate(
        [jnp.zeros((m,), env.dtype), env,
         jnp.zeros((max(need - m - n_blocks, 0),), env.dtype)]
    )
    We = W + 2 * m
    if We % stride == 0:
        env_we = frame_signal(env_pad, We, stride)[:T]  # (T, W + 2m)
    else:
        pad_w = -We % stride
        env_we = frame_signal(
            jnp.concatenate([env_pad, jnp.zeros((pad_w,), env.dtype)]),
            We + pad_w, stride,
        )[:T, :We]
    # global block index of extended-window column j is b0 - m + j
    jj_e = np.arange(We)[None, :]
    valid_e = jnp.asarray((b0[:, None] - m + jj_e >= 0)
                          & (b0[:, None] - m + jj_e < n_blocks))
    env_we = jnp.where(valid_e, env_we, 0.0)
    env_w = env_we[:, m : m + W]  # (T, W)
    valid = valid_e[:, m : m + W]

    count = jnp.sum(valid, axis=-1)
    nonempty = count > 0

    rms = jnp.sqrt(jnp.sum(env_w * env_w, axis=-1) / jnp.maximum(count, 1))
    neg = jnp.asarray(-jnp.inf, env.dtype)
    p_local = jnp.argmax(jnp.where(valid, env_w, neg), axis=-1)
    peak = jnp.max(jnp.where(valid, env_w, neg), axis=-1)
    peak = jnp.where(nonempty, peak, 0.0)
    crest = jnp.where(nonempty, peak / jnp.maximum(rms, eps), 0.0)

    width = jnp.where(nonempty, _window_argmax_peak_width(env_w, valid, eps), 0.0)

    # post/pre energy around the peak: range masks over the extended window
    # (columns q-m..q-1 and q+1..q+m of env_we, q = peak position there)
    q = p_local + m
    pre_member = (jj_e >= q[:, None] - m) & (jj_e <= q[:, None] - 1)
    post_member = (jj_e >= q[:, None] + 1) & (jj_e <= q[:, None] + m)
    pre_valid = pre_member & valid_e
    post_valid = post_member & valid_e
    pre_count = jnp.sum(pre_valid, axis=-1)
    post_count = jnp.sum(post_valid, axis=-1)
    pre_e = jnp.sum(jnp.where(pre_valid, env_we, 0.0), -1) / jnp.maximum(pre_count, 1)
    post_e = jnp.sum(jnp.where(post_valid, env_we, 0.0), -1) / jnp.maximum(post_count, 1)
    ratio = jnp.where(nonempty, jnp.log((post_e + eps) / (pre_e + eps)), 0.0)

    return crest, width, ratio


# ---------------------------------------------------------------------------
# Subframe energies + optional envelope shape features
# ---------------------------------------------------------------------------


def subframe_energy(x_td: jnp.ndarray, B: int, H: int) -> jnp.ndarray:
    """Mean-energy per subframe (``feature_extraction.py:233-251``), 1-D."""
    B, H = max(1, int(B)), max(1, int(H))
    n = x_td.shape[-1]
    if n == 0:
        return jnp.zeros((0,), x_td.dtype)
    if n < B:
        return jnp.mean(x_td * x_td, axis=-1, keepdims=True)
    subs = frame_signal(x_td, B, H)
    return jnp.sum(subs * subs, axis=-1) / float(B)


def _first_true_index(mask: jnp.ndarray, default: jnp.ndarray) -> jnp.ndarray:
    N = mask.shape[-1]
    j = jnp.arange(N)
    found = jnp.any(mask, axis=-1)
    first = jnp.min(jnp.where(mask, j, N), axis=-1)
    return jnp.where(found, first, default)


def _last_true_index(mask: jnp.ndarray, default: jnp.ndarray) -> jnp.ndarray:
    N = mask.shape[-1]
    j = jnp.arange(N)
    found = jnp.any(mask, axis=-1)
    last = jnp.max(jnp.where(mask, j, -1), axis=-1)
    return jnp.where(found, last, default)


def subframe_peak_shape_features(
    sub_energy_vals: jnp.ndarray,
    *,
    subframe_hop: int,
    fs: float,
    eps: float = 1e-9,
) -> Dict[str, jnp.ndarray]:
    """Envelope rise/fall shape features at local peaks of the subframe-energy
    envelope (``feature_extraction.py:368-445``), vectorized over positions.

    Returns per-subframe arrays: env_smooth, rise_time, fall_time, rise_slope,
    fall_slope, peak_level.
    """
    env = sub_energy_vals
    N = env.shape[-1]
    dt = float(subframe_hop) / float(fs)
    zeros = jnp.zeros((N,), env.dtype)
    if N == 0:
        return {k: zeros for k in
                ("env_smooth", "rise_time", "fall_time", "rise_slope",
                 "fall_slope", "peak_level")}

    if N >= 3:
        padded = jnp.pad(env, (1, 1))
        env_s = 0.25 * padded[:-2] + 0.5 * padded[1:-1] + 0.25 * padded[2:]
    else:
        env_s = env

    # peak mask (positions p): interior (env_s[p] >= env_s[p-1]) & (> env_s[p+1]);
    # N==2 -> argmax; N==1 -> position 0.
    if N >= 3:
        is_peak = jnp.zeros((N,), bool)
        is_peak = is_peak.at[1:-1].set(
            (env_s[1:-1] >= env_s[:-2]) & (env_s[1:-1] > env_s[2:])
        )
    elif N == 2:
        is_peak = jnp.zeros((N,), bool).at[jnp.argmax(env_s)].set(True)
    else:
        is_peak = jnp.ones((1,), bool)

    p = jnp.arange(N)
    peak = jnp.maximum(env_s, eps)
    lo = 0.1 * peak
    hi = 0.9 * peak
    j = jnp.arange(N)[None, :]
    ev = env_s[None, :]

    # left side: i_lo = last index <= p with env <= lo (else 0)
    left_mask = (j <= p[:, None]) & (ev <= lo[:, None])
    i_lo = _last_true_index(left_mask, jnp.zeros((N,), jnp.int32))
    # i_hi = first index in [i_lo, p] with env >= hi (else p)
    hi_mask = (j >= i_lo[:, None]) & (j <= p[:, None]) & (ev >= hi[:, None])
    i_hi = _first_true_index(hi_mask, p)
    rise_dt = jnp.maximum(i_hi - i_lo, 0).astype(env.dtype) * dt

    # right side: i_hi_fall = first offset >=1 from p with env <= hi (else 0)
    right_off = j - p[:, None]  # offset from p
    below_hi = (right_off >= 1) & (ev <= hi[:, None])
    off_hi = _first_true_index(below_hi, p) - p  # absolute index - p
    has_bh = jnp.any(below_hi, axis=-1)
    i_hi_fall = jnp.where(has_bh, off_hi, 0)
    # i_lo_fall = i_hi_fall + first offset >= i_hi_fall with env <= lo
    below_lo = (right_off >= i_hi_fall[:, None]) & (ev <= lo[:, None])
    off_lo = _first_true_index(below_lo, p) - p
    has_bl = jnp.any(below_lo, axis=-1)
    right_size = N - p
    i_lo_fall = jnp.where(has_bl, off_lo, jnp.maximum(right_size - 1, 0))
    fall_dt = jnp.maximum(i_lo_fall, 0).astype(env.dtype) * dt

    amp = jnp.maximum(hi - lo, 0.0)
    rise_slope = amp / jnp.maximum(rise_dt, dt)
    fall_slope = amp / jnp.maximum(fall_dt, dt)

    sel = is_peak
    return {
        "env_smooth": env_s,
        "rise_time": jnp.where(sel, rise_dt, 0.0),
        "fall_time": jnp.where(sel, fall_dt, 0.0),
        "rise_slope": jnp.where(sel, rise_slope, 0.0),
        "fall_slope": jnp.where(sel, fall_slope, 0.0),
        "peak_level": jnp.where(sel, peak, 0.0),
    }


def _frame_max_from_subframes(sub_vals: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """max(padded[t], padded[t+1]) (``feature_extraction.py:447-455``)."""
    if n_frames == 0 or sub_vals.shape[-1] == 0:
        return jnp.zeros((n_frames,), sub_vals.dtype)
    padded = jnp.zeros((n_frames + 1,), sub_vals.dtype)
    ncopy = min(sub_vals.shape[-1], n_frames + 1)
    padded = padded.at[:ncopy].set(sub_vals[:ncopy])
    return jnp.maximum(padded[:-1], padded[1:])


def _frame_sum_from_subframes(sub_vals: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """sub[t] + sub[t+1] with zero fill (``feature_extraction.py:457-466``)."""
    if n_frames == 0:
        return jnp.zeros((0,), sub_vals.dtype)
    n_sub = sub_vals.shape[-1]
    if n_sub == 0:
        return jnp.zeros((n_frames,), sub_vals.dtype)
    pad_to = n_frames + 1
    padded = jnp.zeros((pad_to,), sub_vals.dtype)
    ncopy = min(n_sub, pad_to)
    padded = padded.at[:ncopy].set(sub_vals[:ncopy])
    return padded[:-1] + padded[1:]


# ---------------------------------------------------------------------------
# Main entry
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=(
    "fs", "frame_len", "hop", "operating_band", "mode_bands", "td_input_mode",
    "td_input_band", "bp_order", "subframe_len", "subframe_hop",
    "block_energy_len", "block_energy_hop", "block_energy_post_pre_blocks",
    "block_energy_smooth_enable", "envelope_features_enable", "eps",
))
def extract_td_features(
    x: jnp.ndarray,
    *,
    fs: int,
    frame_len: int,
    hop: int,
    operating_band: Tuple[float, float],
    mode_bands: Optional[Tuple[Tuple[float, float], ...]],
    td_input_mode: str = "default",
    td_input_band: Optional[Tuple[float, float]] = None,
    bp_order: int = 4,
    subframe_len: int = 128,
    subframe_hop: int = 128,
    block_energy_len: int = 8,
    block_energy_hop: Optional[int] = None,
    block_energy_post_pre_blocks: int = 4,
    block_energy_smooth_enable: bool = True,
    envelope_features_enable: bool = False,
    eps: float = 1e-9,
) -> Dict[str, jnp.ndarray]:
    """TD feature extraction for one clip (vmap over a batch axis for many).

    Output dict matches the reference's ``extract_td_features_inline`` keys.
    """
    x = x.astype(jnp.float32).reshape(-1)
    x_td = td_input_signal(
        x, fs,
        td_input_mode=td_input_mode, td_input_band=td_input_band,
        operating_band=operating_band, mode_bands=mode_bands, bp_order=bp_order,
    )

    T = num_frames(x_td.shape[-1], frame_len, hop)
    frames = frame_signal(x_td, frame_len, hop)  # (T, frame_len)
    frame_times = jnp.arange(T, dtype=jnp.float32) * hop / float(fs)

    td_crest = crest_factor(frames, axis=-1, eps=eps, eps_in_rms=True)
    if frame_len >= 4:
        kv = kurtosis(frames, axis=-1, fisher=False, bias=False)
        td_kurt = jnp.where(jnp.isfinite(kv), kv, 0.0)
    else:
        td_kurt = jnp.zeros((T,), jnp.float32)

    crest_b, width_b, ratio_b = block_energy_peak_features(
        x_td, frame_len=frame_len, hop=hop, block_len=block_energy_len,
        block_hop=block_energy_hop, post_pre_blocks=block_energy_post_pre_blocks,
        smooth=block_energy_smooth_enable, eps=eps,
    )

    sub_e = subframe_energy(x_td, subframe_len, subframe_hop)
    if envelope_features_enable:
        shape = subframe_peak_shape_features(
            sub_e, subframe_hop=subframe_hop, fs=fs, eps=eps
        )
        env_frame = _frame_sum_from_subframes(shape["env_smooth"], T)
        rise_t = _frame_max_from_subframes(shape["rise_time"], T)
        fall_t = _frame_max_from_subframes(shape["fall_time"], T)
        rise_s = _frame_max_from_subframes(shape["rise_slope"], T)
        fall_s = _frame_max_from_subframes(shape["fall_slope"], T)
        peak_l = _frame_max_from_subframes(shape["peak_level"], T)
    else:
        z = jnp.zeros((T,), jnp.float32)
        env_frame = rise_t = fall_t = rise_s = fall_s = peak_l = z

    return {
        "frame_times": frame_times,
        "td_crest_factor": td_crest,
        "td_kurtosis": td_kurt,
        "td_block_energy_crest": crest_b,
        "td_block_peak_width_50": width_b,
        "td_block_post_pre_energy_ratio": ratio_b,
        "td_energy_envelope": env_frame,
        "td_rise_time_sec": rise_t,
        "td_fall_time_sec": fall_t,
        "td_rise_slope": rise_s,
        "td_fall_slope": fall_s,
        "td_peak_energy": peak_l,
    }
