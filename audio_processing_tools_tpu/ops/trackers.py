"""Causal noise trackers as ``lax.scan`` carries.

All per-frame scans are unrolled 8x: step bodies are a handful of
elementwise ops on small tensors, so compiled-loop per-iteration overhead
dominates; unrolling only regroups the same float ops (results unchanged).

These are the reference's sequential per-frame Python loops, re-expressed as
scans so they jit, vmap over files/bands, and stay on device:

  * :func:`causal_low_quantile_baseline` — the stochastic-gradient quantile
    tracker of ``edge/rain_frame_classifier.py:31-82`` (emits *before*
    ingesting, i.e. strictly causal).
  * :func:`noise_psd_track` — the quantile PSD tracker with asymmetric EMA,
    warmup gating, rain exclusion, adaptive-q and the ``N <= maxr * P`` clamp
    of ``edge/rain_signal_processor.py:555-721``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("q_percent", "samples_per_sec", "win_sec",
                                   "min_hist_sec", "floor"))
def causal_low_quantile_baseline(
    x: jnp.ndarray,
    *,
    q_percent: float,
    samples_per_sec: float,
    win_sec: float,
    min_hist_sec: float = 0.0,
    floor: float = 1e-6,
):
    """Causal stochastic low-quantile baseline over the last axis.

    Parity with ``causal_stochastic_low_quantile_baseline``
    (``edge/rain_frame_classifier.py:31-82``): the emitted baseline at index
    ``t`` is the estimate *before* ingesting ``x[t]``.

    Returns ``(baseline, warm_ok)`` with the input's shape.
    """
    q = float(np.clip(q_percent, 0.0, 100.0)) / 100.0
    floor = float(max(floor, 1e-12))
    sps = float(max(samples_per_sec, 1e-6))
    W = max(3, int(round(float(win_sec) * sps)))
    eta = float(np.clip(2.0 / max(W + 1, 2), 1e-4, 1.0))
    min_hist = max(1, int(round(float(min_hist_sec) * sps)))
    scale_alpha = float(np.clip(1.0 - eta, 0.0, 0.9999))

    x = x.astype(jnp.float32)
    T = x.shape[-1]
    if T == 0:
        return x, jnp.zeros(x.shape, dtype=bool)

    x0 = x[..., 0]
    init = (jnp.maximum(x0, floor), jnp.maximum(jnp.abs(x0), floor))

    xT = jnp.moveaxis(x, -1, 0)  # (T, ...)

    def step(carry, xt):
        baseline, scale = carry
        out = baseline
        err = xt - baseline
        scale = scale_alpha * scale + (1.0 - scale_alpha) * jnp.abs(err)
        step_sz = eta * jnp.maximum(scale, floor)
        delta = jnp.where(xt >= baseline, q * step_sz, -(1.0 - q) * step_sz)
        baseline = jnp.maximum(baseline + delta, floor)
        return (baseline, scale), out

    _, outs = jax.lax.scan(step, init, xT, unroll=8)
    baseline = jnp.moveaxis(outs, 0, -1)
    baseline = jnp.maximum(
        jnp.nan_to_num(baseline, nan=floor, posinf=floor, neginf=floor), floor
    )
    warm = np.arange(T) >= min_hist
    warm_ok = jnp.broadcast_to(jnp.asarray(warm), x.shape)
    return baseline, warm_ok


class PsdTrackParams(NamedTuple):
    """Static knobs of the PSD tracker (trace-time constants)."""

    W: int
    q: float
    ema_up: float
    ema_down: float
    eps: float
    maxr: float
    adaptive_q_enable: bool
    adaptive_q_min: float
    adaptive_q_alpha: float


def make_psd_params(cfg_q: float, win_sec: float, frames_per_sec: float,
                    ema_up: float, ema_down: float, eps: float,
                    noise_psd_max_ratio: float = 1.0,
                    adaptive_q_enable: bool = False,
                    adaptive_q_min: float = 0.10,
                    adaptive_q_alpha: float = 0.95) -> PsdTrackParams:
    """Derive tracker constants as ``_estimate_noise_psd_fft`` does
    (``edge/rain_signal_processor.py:683-684, 555-592``)."""
    W = max(10, int(win_sec * frames_per_sec))
    maxr = float(noise_psd_max_ratio)
    maxr = 1.0 if not np.isfinite(maxr) else float(np.clip(maxr, 0.0, 1.0))
    aq_base = float(cfg_q)
    aq_min = float(np.clip(adaptive_q_min, 1e-4, aq_base))
    aq_alpha = float(np.clip(adaptive_q_alpha, 0.0, 1.0))
    return PsdTrackParams(
        W=W, q=float(cfg_q), ema_up=float(ema_up), ema_down=float(ema_down),
        eps=float(eps), maxr=maxr, adaptive_q_enable=bool(adaptive_q_enable),
        adaptive_q_min=aq_min, adaptive_q_alpha=aq_alpha,
    )


@partial(jax.jit, static_argnames=("params",))
def noise_psd_track(P_band: jnp.ndarray, is_rain: jnp.ndarray,
                    params: PsdTrackParams) -> jnp.ndarray:
    """Track the noise PSD over time for one band block.

    Parameters
    ----------
    P_band : (..., K, T) linear power in the operating band
    is_rain : (..., T) bool — frames excluded from updates (after warmup)
    params : static tracker constants

    Returns
    -------
    N_band : (..., K, T) noise PSD estimate.

    Exact re-expression of ``_init_noise_psd_tracker`` /
    ``_update_noise_psd_frame`` / the per-``t`` loop of
    ``_estimate_noise_psd_fft`` (``edge/rain_signal_processor.py:555-721``)
    as one ``lax.scan`` with carry
    ``(tracker, tracker_scale, prev_N, warmup_count, rain_prev_ema)``.
    """
    p = params
    eta = float(np.clip(2.0 / max(p.W + 1, 2), 1e-4, 1.0))
    scale_alpha = float(p.ema_down)
    step_floor = float(max(p.eps, 1e-9))
    warmup_need = max(10, p.W // 2)

    P_band = P_band.astype(jnp.float32)
    first = P_band[..., 0]
    carry0 = (
        jnp.maximum(first, 0.0),                       # tracker
        jnp.maximum(jnp.abs(first), step_floor),       # tracker_scale
        jnp.zeros_like(first),                         # prev_N (unused at t=0)
        jnp.zeros(first.shape[:-1], dtype=jnp.int32),  # warmup_count
        jnp.zeros(first.shape[:-1], dtype=jnp.float32),  # rain_prev_ema
    )

    PT = jnp.moveaxis(P_band, -1, 0)        # (T, ..., K)
    rT = jnp.moveaxis(is_rain.astype(bool), -1, 0)  # (T, ...)

    def step(carry, inp):
        tracker, scale, prev_N, wcount, rain_ema = carry
        Pt, raint, is_first = inp
        allow = (wcount < warmup_need) | (~raint)        # scalar per batch
        allow_f = allow[..., None]

        # t > 0 branch: stochastic quantile step
        err = Pt - tracker
        scale_new = scale_alpha * scale + (1.0 - scale_alpha) * jnp.abs(err)
        step_sz = eta * jnp.maximum(scale_new, step_floor)
        if p.adaptive_q_enable:
            q_eff = p.q - (p.q - p.adaptive_q_min) * rain_ema
            q_eff = jnp.clip(q_eff, p.adaptive_q_min, p.q)[..., None]
        else:
            q_eff = p.q
        delta = jnp.where(Pt >= tracker, q_eff * step_sz, -(1.0 - q_eff) * step_sz)
        candidate = jnp.maximum(tracker + delta, 0.0)
        tracker_upd = jnp.where(allow_f, candidate, tracker)

        # first frame: tracker stays at init; scale not updated
        tracker_new = jnp.where(is_first, tracker, tracker_upd)
        scale_out = jnp.where(is_first, scale, scale_new)
        raw_q = tracker_new

        # asymmetric EMA vs previous output (skipped on first frame)
        lam = jnp.where(raw_q > prev_N, p.ema_up, p.ema_down)
        N_ema = lam * prev_N + (1.0 - lam) * raw_q
        N = jnp.where(is_first, raw_q, N_ema)

        N = jnp.minimum(N, p.maxr * Pt)
        N = jnp.maximum(N, 0.0)

        wcount_new = wcount + allow.astype(jnp.int32)
        rain_ema_new = p.adaptive_q_alpha * rain_ema + (
            1.0 - p.adaptive_q_alpha
        ) * raint.astype(jnp.float32)
        return (tracker_new, scale_out, N, wcount_new, rain_ema_new), N

    T = PT.shape[0]
    is_first = jnp.zeros((T,), dtype=bool).at[0].set(True)
    _, Ns = jax.lax.scan(step, carry0, (PT, rT, is_first), unroll=8)
    return jnp.moveaxis(Ns, 0, -1)


def causal_time_median(X: jnp.ndarray, L: int) -> jnp.ndarray:
    """Causal median filter over the last axis (window ``[t-L+1, t]``).

    Parity with ``_causal_time_median_filter``
    (``edge/rain_signal_processor.py:381-396``): even ``L`` is bumped to
    ``L+1``; early frames use the shorter available history.
    """
    if L <= 1:
        return X
    if L % 2 == 0:
        L += 1
    T = X.shape[-1]
    # windows as L shifted pad+slice views (no gather);
    # window column k holds X[t - (L-1) + k], left-invalid marked +inf
    big = jnp.asarray(jnp.finfo(X.dtype).max, dtype=X.dtype)
    Xp = jnp.concatenate(
        [jnp.full(X.shape[:-1] + (L - 1,), big, X.dtype), X], axis=-1
    )
    w = jnp.stack([Xp[..., k : k + T] for k in range(L)], axis=-1)
    ws = jnp.sort(w, axis=-1)  # (..., T, L)
    count = np.minimum(np.arange(T) + 1, L)  # per-frame valid count (static)
    lo = (count - 1) // 2
    hi = count // 2
    # static one-hot picks (take_along_axis lowers to a serial gather loop)
    oh_lo = jnp.asarray(np.arange(L)[None, :] == lo[:, None], X.dtype)
    oh_hi = jnp.asarray(np.arange(L)[None, :] == hi[:, None], X.dtype)
    v_lo = jnp.sum(ws * oh_lo, axis=-1)
    v_hi = jnp.sum(ws * oh_hi, axis=-1)
    return 0.5 * (v_lo + v_hi)


def causal_time_mean(X: jnp.ndarray, L: int) -> jnp.ndarray:
    """Causal moving average over the last axis, window ``[t-L+1, t]``.

    Parity with ``_time_smooth`` (``edge/rain_signal_processor.py:366-379``).
    """
    if L <= 1:
        return X
    T = X.shape[-1]
    csum = jnp.cumsum(X, axis=-1)
    shifted = jnp.concatenate(
        [jnp.zeros(X.shape[:-1] + (L,), X.dtype), csum[..., :-L]], axis=-1
    )[..., :T]
    count = jnp.asarray(np.minimum(np.arange(T) + 1, L), dtype=X.dtype)
    return (csum - shifted) / count


# ---------------------------------------------------------------------------
# Carry-in/out variants for streaming chunked inference
# ---------------------------------------------------------------------------


def baseline_carry_init(x0: jnp.ndarray, floor: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Initial (baseline, scale) carry from the first sample."""
    floor = float(max(floor, 1e-12))
    return (jnp.maximum(x0, floor), jnp.maximum(jnp.abs(x0), floor))


def causal_low_quantile_baseline_chunk(
    x: jnp.ndarray,
    carry: Tuple[jnp.ndarray, jnp.ndarray],
    *,
    q_percent: float,
    samples_per_sec: float,
    win_sec: float,
    floor: float = 1e-6,
):
    """One chunk of the causal baseline tracker with explicit carry.

    Semantics identical to :func:`causal_low_quantile_baseline` when the
    carry is threaded across consecutive chunks (the emitted baseline at t is
    the pre-ingest estimate).  Returns ``(baseline, new_carry)``.
    """
    q = float(np.clip(q_percent, 0.0, 100.0)) / 100.0
    floor = float(max(floor, 1e-12))
    sps = float(max(samples_per_sec, 1e-6))
    W = max(3, int(round(float(win_sec) * sps)))
    eta = float(np.clip(2.0 / max(W + 1, 2), 1e-4, 1.0))
    scale_alpha = float(np.clip(1.0 - eta, 0.0, 0.9999))

    x = x.astype(jnp.float32)
    xT = jnp.moveaxis(x, -1, 0)

    def step(c, xt):
        baseline, scale = c
        out = baseline
        err = xt - baseline
        scale = scale_alpha * scale + (1.0 - scale_alpha) * jnp.abs(err)
        step_sz = eta * jnp.maximum(scale, floor)
        delta = jnp.where(xt >= baseline, q * step_sz, -(1.0 - q) * step_sz)
        baseline = jnp.maximum(baseline + delta, floor)
        return (baseline, scale), out

    new_carry, outs = jax.lax.scan(step, carry, xT, unroll=8)
    baseline = jnp.moveaxis(outs, 0, -1)
    baseline = jnp.maximum(
        jnp.nan_to_num(baseline, nan=floor, posinf=floor, neginf=floor), floor
    )
    return baseline, new_carry


def psd_carry_init(first_band_frame: jnp.ndarray, params: PsdTrackParams):
    """Initial PSD-tracker carry from the first band frame."""
    step_floor = float(max(params.eps, 1e-9))
    first = first_band_frame.astype(jnp.float32)
    return (
        jnp.maximum(first, 0.0),                      # tracker
        jnp.maximum(jnp.abs(first), step_floor),      # tracker_scale
        jnp.zeros_like(first),                        # prev_N
        jnp.zeros(first.shape[:-1], jnp.int32),       # warmup_count
        jnp.zeros(first.shape[:-1], jnp.float32),     # rain_prev_ema
        jnp.asarray(True),                            # is_first flag
    )


def make_psd_track_step(params: PsdTrackParams):
    """The PSD tracker's single-frame transition, exposed so callers that
    fuse several per-frame stages into ONE scan body (the streaming
    suppressor) use bit-identical math to :func:`noise_psd_track_chunk`.

    Returns ``step(carry, (P_t, rain_t)) -> (new_carry, N_t)``.
    """
    p = params
    eta = float(np.clip(2.0 / max(p.W + 1, 2), 1e-4, 1.0))
    scale_alpha = float(p.ema_down)
    step_floor = float(max(p.eps, 1e-9))
    warmup_need = max(10, p.W // 2)

    def step(carry_in, inp):
        tracker, scale, prev_N, wcount, rain_ema, is_first = carry_in
        Pt, raint = inp
        allow = (wcount < warmup_need) | (~raint)
        allow_f = allow[..., None]

        err = Pt - tracker
        scale_new = scale_alpha * scale + (1.0 - scale_alpha) * jnp.abs(err)
        step_sz = eta * jnp.maximum(scale_new, step_floor)
        if p.adaptive_q_enable:
            q_eff = p.q - (p.q - p.adaptive_q_min) * rain_ema
            q_eff = jnp.clip(q_eff, p.adaptive_q_min, p.q)[..., None]
        else:
            q_eff = p.q
        delta = jnp.where(Pt >= tracker, q_eff * step_sz,
                          -(1.0 - q_eff) * step_sz)
        candidate = jnp.maximum(tracker + delta, 0.0)
        tracker_upd = jnp.where(allow_f, candidate, tracker)

        tracker_new = jnp.where(is_first, tracker, tracker_upd)
        scale_out = jnp.where(is_first, scale, scale_new)
        raw_q = tracker_new

        lam = jnp.where(raw_q > prev_N, p.ema_up, p.ema_down)
        N_ema = lam * prev_N + (1.0 - lam) * raw_q
        N = jnp.where(is_first, raw_q, N_ema)
        N = jnp.minimum(N, p.maxr * Pt)
        N = jnp.maximum(N, 0.0)

        wcount_new = wcount + allow.astype(jnp.int32)
        rain_ema_new = p.adaptive_q_alpha * rain_ema + (
            1.0 - p.adaptive_q_alpha
        ) * raint.astype(jnp.float32)
        new_carry = (tracker_new, scale_out, N, wcount_new, rain_ema_new,
                     jnp.asarray(False))
        return new_carry, N

    return step


def noise_psd_track_chunk(P_band: jnp.ndarray, is_rain: jnp.ndarray,
                          carry, params: PsdTrackParams, *, unroll: int = 8):
    """One chunk of the PSD tracker with explicit carry.

    ``carry`` from :func:`psd_carry_init` (or a previous chunk).  Threading
    carries across chunks reproduces :func:`noise_psd_track` on the
    concatenated signal.  Returns ``(N_band, new_carry)``.
    """
    P_band = P_band.astype(jnp.float32)
    PT = jnp.moveaxis(P_band, -1, 0)
    rT = jnp.moveaxis(is_rain.astype(bool), -1, 0)
    step = make_psd_track_step(params)
    new_carry, Ns = jax.lax.scan(step, carry, (PT, rT), unroll=unroll)
    return jnp.moveaxis(Ns, 0, -1), new_carry
