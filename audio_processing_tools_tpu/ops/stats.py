"""Statistical primitives with scipy/numpy-parity semantics, batched.

The reference uses ``scipy.stats.kurtosis`` in two flavors:
  * ``fisher=False, bias=False`` for TD frame features
    (``edge/feature_extraction.py:520``, ``edge/time_domain_detector.py:220``),
  * ``fisher=True`` (biased) in the legacy RoE TD gate
    (``edge/dsp_rain_detection.py:727``).
Quantiles use NumPy's default linear interpolation
(``edge/band_noise_estimator.py:678,888``).
"""

from __future__ import annotations

import jax.numpy as jnp


def kurtosis(x: jnp.ndarray, axis: int = -1, fisher: bool = True,
             bias: bool = True) -> jnp.ndarray:
    """``scipy.stats.kurtosis`` parity (propagate-nan not needed here)."""
    x = x.astype(jnp.float32)
    n = x.shape[axis]
    mean = jnp.mean(x, axis=axis, keepdims=True)
    d = x - mean
    m2 = jnp.mean(d * d, axis=axis)
    m4 = jnp.mean((d * d) * (d * d), axis=axis)
    g2 = m4 / jnp.where(m2 > 0, m2 * m2, 1.0) - 3.0
    g2 = jnp.where(m2 > 0, g2, -3.0 if fisher else 0.0)
    if not bias:
        if n < 4:
            # scipy returns nan for n<4 unbiased; callers guard on seg.size>=4
            out = jnp.full(g2.shape, jnp.nan, dtype=jnp.float32)
            return out if fisher else out + 3.0
        nf = float(n)
        G2 = ((nf + 1.0) * g2 + 6.0) * (nf - 1.0) / ((nf - 2.0) * (nf - 3.0))
        g2 = jnp.where(m2 > 0, G2, -3.0)
    return g2 if fisher else g2 + 3.0


def crest_factor(x: jnp.ndarray, axis: int = -1, eps: float = 1e-9,
                 eps_in_rms: bool = True) -> jnp.ndarray:
    """Peak-to-RMS ratio.

    ``eps_in_rms=True`` matches ``edge/feature_extraction.py:516-518``
    (``rms = sqrt(mean(x^2) + eps)``); ``False`` matches the legacy
    ``edge/dsp_rain_detection.py:602-603`` (``rms + 1e-12`` in denominator).
    """
    peak = jnp.max(jnp.abs(x), axis=axis)
    msq = jnp.mean(x * x, axis=axis)
    if eps_in_rms:
        rms = jnp.sqrt(msq + eps)
        return peak / jnp.maximum(rms, eps)
    return peak / (jnp.sqrt(msq) + 1e-12)


def masked_quantile(x: jnp.ndarray, valid: jnp.ndarray, q, axis: int = -1
                    ) -> jnp.ndarray:
    """``np.quantile(x[valid], q)`` with static shapes.

    Invalid entries are sorted to the end; the quantile uses NumPy's default
    linear interpolation over the first ``count`` sorted values.  Returns 0
    where no entries are valid.
    """
    x = jnp.moveaxis(x, axis, -1)
    valid = jnp.moveaxis(valid, axis, -1)
    big = jnp.asarray(jnp.finfo(x.dtype).max, dtype=x.dtype)
    xs = jnp.sort(jnp.where(valid, x, big), axis=-1)
    count = jnp.sum(valid, axis=-1)  # (...,)
    q = jnp.asarray(q, dtype=x.dtype)
    h = q * jnp.maximum(count - 1, 0).astype(x.dtype)
    lo = jnp.floor(h).astype(jnp.int32)
    hi = jnp.ceil(h).astype(jnp.int32)
    frac = h - lo.astype(x.dtype)
    # one-hot picks in place of take_along_axis (this runs inside the
    # band-noise estimator's per-frame scan).  The
    # masked sum is exact (one 1.0 multiply, all other terms exactly 0).
    idx = jnp.arange(xs.shape[-1], dtype=jnp.int32)
    v_lo = jnp.sum(jnp.where(idx == lo[..., None], xs, 0.0), axis=-1)
    v_hi = jnp.sum(jnp.where(idx == hi[..., None], xs, 0.0), axis=-1)
    out = v_lo + frac * (v_hi - v_lo)
    return jnp.where(count > 0, out, 0.0)


def masked_quantile_rankselect(x: jnp.ndarray, valid: jnp.ndarray, q
                               ) -> jnp.ndarray:
    """Bit-exact :func:`masked_quantile` over a small 1-D buffer, no sort.

    A quantile needs only two order statistics, not the whole sorted array.
    For a W-element buffer the stable rank of every element is one (W, W)
    comparison matrix (ties broken by index), and the lo/hi order statistics
    are exact one-hot masked sums — ~10 fused elementwise ops instead of a
    ~log^2(W)-stage bitonic sorting network.  Inside the band-noise
    estimator's per-frame scan (W=30, one call per frame) this is the
    difference between the sort dominating the scan body and vanishing.

    Exactness: ranks are a permutation (ties index-broken), so exactly one
    element holds rank ``lo`` and its value equals ``sort(x)[lo]`` bitwise —
    equal float values are interchangeable.  Same linear interpolation as
    :func:`masked_quantile`; returns 0 where no entries are valid.
    """
    x = x.astype(jnp.float32).reshape(-1)
    valid = valid.reshape(-1)
    W = x.shape[0]
    big = jnp.asarray(jnp.finfo(x.dtype).max, dtype=x.dtype)
    xv = jnp.where(valid, x, big)
    idx = jnp.arange(W, dtype=jnp.int32)
    lt = xv[None, :] < xv[:, None]
    eq_before = (xv[None, :] == xv[:, None]) & (idx[None, :] < idx[:, None])
    rank = jnp.sum(lt | eq_before, axis=-1).astype(jnp.int32)  # (W,)
    count = jnp.sum(valid)
    q = jnp.asarray(q, dtype=x.dtype)
    h = q * jnp.maximum(count - 1, 0).astype(x.dtype)
    lo = jnp.floor(h).astype(jnp.int32)
    hi = jnp.ceil(h).astype(jnp.int32)
    frac = h - lo.astype(x.dtype)
    v_lo = jnp.sum(jnp.where(rank == lo, xv, 0.0))
    v_hi = jnp.sum(jnp.where(rank == hi, xv, 0.0))
    out = v_lo + frac * (v_hi - v_lo)
    return jnp.where(count > 0, out, 0.0)


def quantile_linear(x: jnp.ndarray, q, axis: int = -1) -> jnp.ndarray:
    """``np.quantile`` (linear interpolation) along an axis, all entries valid."""
    return masked_quantile(x, jnp.ones(x.shape, dtype=bool), q, axis=axis)


def nan_to_num(x: jnp.ndarray, nan: float = 0.0, posinf: float = 0.0,
               neginf: float = 0.0) -> jnp.ndarray:
    """``np.nan_to_num`` with explicit replacements (reference default usage)."""
    x = jnp.where(jnp.isnan(x), nan, x)
    x = jnp.where(jnp.isposinf(x), posinf, x)
    x = jnp.where(jnp.isneginf(x), neginf, x)
    return x
