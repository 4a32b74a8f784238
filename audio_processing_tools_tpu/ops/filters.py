"""IIR (biquad cascade) filtering as batched device programs.

The reference leans on ``scipy.signal.butter(...) -> sosfiltfilt/sosfilt``
everywhere: the engine pre-filter (``edge/rain_signal_processor.py:347-364,
807-815``), TD feature front-ends (``edge/feature_extraction.py:199-219``),
the streaming estimator with persistent ``zi`` (``edge/band_noise_estimator.py
:781-830``), and the RoE bandpass (``edge/dsp_rain_detection.py:373-376``).

Accelerator-native design:

* **Design stays on host.** Butterworth design is a tiny trace-time
  computation producing constant SOS coefficients — done in NumPy (no scipy
  dependency at runtime; we implement the bilinear-transform design directly)
  and folded into the compiled program.

* **Run is a parallel scan.** A biquad in transposed direct-form II is an
  affine recurrence ``z[n] = A z[n-1] + B x[n]``, ``y[n] = b0 x[n] + z0[n-1]``.
  Affine recurrences compose associatively, so the whole filter runs as a
  ``jax.lax.associative_scan`` over (2x2 matrix, 2-vector) pairs: O(log T)
  depth instead of a length-T sequential loop.  Sections cascade.

* **Streaming mode** keeps the sequential ``lax.scan`` form with explicit
  carried ``zi`` for bit-parity with the firmware-shaped estimator.

``sosfiltfilt`` reproduces scipy's exact odd-extension padding and
``sosfilt_zi`` initial-condition scaling so zero-phase results match the CPU
reference.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Host-side Butterworth design (NumPy, trace-time)
# ---------------------------------------------------------------------------


def _butter_analog_poles(order: int) -> np.ndarray:
    k = np.arange(1, order + 1)
    theta = np.pi * (2 * k - 1) / (2 * order) + np.pi / 2
    return np.exp(1j * theta)  # unit-circle poles, left half plane


def butter_sos(order: int, wn, btype: str = "lowpass") -> np.ndarray:
    """Butterworth digital filter in second-order sections.

    Equivalent to ``scipy.signal.butter(order, wn, btype, output="sos")``
    for lowpass/highpass/bandpass/bandstop.  ``wn`` is normalized to Nyquist
    (scipy convention).  Pure NumPy float64; returns ``(n_sections, 6)``.

    When scipy is importable (it is in the supported environment) the design
    is delegated to ``scipy.signal.butter`` so the SOS *section ordering and
    zero pairing* match scipy exactly: the hand-rolled ``_zpk_to_sos`` below
    produces the same transfer function but orders the highest-Q section
    first, which measurably degrades float32 cascade numerics (a ~7% local
    deviation vs float64 sosfiltfilt on 2-s clips, found by the differential
    harness in ``tests/test_reference_differential.py``) and breaks
    decision-level parity with the reference's scipy filters.  Design runs at
    trace time on the host, so this costs nothing on device.
    """
    try:
        import scipy.signal as _spsig
    except ImportError:
        _spsig = None
    if _spsig is not None:
        return np.asarray(
            _spsig.butter(order, wn, btype=btype, output="sos"), np.float64
        )
    btype = btype.lower()
    if btype in ("band", "bandpass"):
        btype = "bandpass"
    if btype in ("bs", "bandstop"):
        btype = "bandstop"
    if btype in ("low", "lowpass"):
        btype = "lowpass"
    if btype in ("high", "highpass"):
        btype = "highpass"

    poles = _butter_analog_poles(order)
    zeros = np.array([], dtype=complex)
    gain = 1.0

    # Pre-warp
    if btype in ("lowpass", "highpass"):
        warped = 2.0 * 2.0 * np.tan(np.pi * float(np.atleast_1d(wn)[0]) / 2.0) / 2.0
        # fs=2 convention: warped = 2*fs*tan(pi*wn/(2)) / ... simplify below
        fs = 2.0
        warped = 2.0 * fs * np.tan(np.pi * float(np.atleast_1d(wn)[0]) / fs)
    else:
        wn = np.atleast_1d(np.asarray(wn, dtype=np.float64))
        fs = 2.0
        warped = 2.0 * fs * np.tan(np.pi * wn / fs)

    if btype == "lowpass":
        z, p, k = _lp2lp(zeros, poles, gain, warped)
    elif btype == "highpass":
        z, p, k = _lp2hp(zeros, poles, gain, warped)
    elif btype == "bandpass":
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = _lp2bp(zeros, poles, gain, wo, bw)
    elif btype == "bandstop":
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        z, p, k = _lp2bs(zeros, poles, gain, wo, bw)
    else:
        raise ValueError(f"unsupported btype {btype!r}")

    z, p, k = _bilinear_zpk(z, p, k, fs=2.0)
    return _zpk_to_sos(z, p, k)


def _lp2lp(z, p, k, wo):
    degree = len(p) - len(z)
    return z * wo, p * wo, k * wo**degree


def _lp2hp(z, p, k, wo):
    degree = len(p) - len(z)
    zh = wo / z if len(z) else np.array([], dtype=complex)
    ph = wo / p
    zh = np.append(zh, np.zeros(degree))
    kh = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(1.0 / np.prod(-p))
    return zh, ph, kh


def _lp2bp(z, p, k, wo, bw):
    degree = len(p) - len(z)
    z_lp = z * bw / 2
    p_lp = p * bw / 2
    z_bp = np.concatenate(
        [z_lp + np.sqrt(z_lp**2 - wo**2), z_lp - np.sqrt(z_lp**2 - wo**2)]
    ) if len(z_lp) else np.array([], dtype=complex)
    p_bp = np.concatenate(
        [p_lp + np.sqrt(p_lp**2 - wo**2), p_lp - np.sqrt(p_lp**2 - wo**2)]
    )
    z_bp = np.append(z_bp, np.zeros(degree))
    k_bp = k * bw**degree
    return z_bp, p_bp, k_bp


def _lp2bs(z, p, k, wo, bw):
    degree = len(p) - len(z)
    z_hp = (bw / 2) / z if len(z) else np.array([], dtype=complex)
    p_hp = (bw / 2) / p
    z_bs = np.concatenate(
        [z_hp + np.sqrt(z_hp**2 - wo**2), z_hp - np.sqrt(z_hp**2 - wo**2)]
    ) if len(z_hp) else np.array([], dtype=complex)
    p_bs = np.concatenate(
        [p_hp + np.sqrt(p_hp**2 - wo**2), p_hp - np.sqrt(p_hp**2 - wo**2)]
    )
    z_bs = np.append(z_bs, np.full(degree, 1j * wo))
    z_bs = np.append(z_bs, np.full(degree, -1j * wo))
    k_bs = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(1.0 / np.prod(-p))
    return z_bs, p_bs, k_bs


def _bilinear_zpk(z, p, k, fs):
    degree = len(p) - len(z)
    fs2 = 2.0 * fs
    z_d = (fs2 + z) / (fs2 - z)
    p_d = (fs2 + p) / (fs2 - p)
    z_d = np.append(z_d, -np.ones(degree))
    k_d = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return z_d, p_d, k_d


def _pair_conjugates(vals: np.ndarray):
    """Split roots into conjugate pairs + reals (sorted for determinism)."""
    vals = np.asarray(vals)
    complex_vals = vals[np.abs(vals.imag) > 1e-12]
    real_vals = np.real(vals[np.abs(vals.imag) <= 1e-12])
    # keep one of each conjugate pair
    upper = complex_vals[complex_vals.imag > 0]
    upper = upper[np.argsort(-np.abs(upper))]
    real_vals = real_vals[np.argsort(-np.abs(real_vals))]
    return upper, real_vals


def _zpk_to_sos(z, p, k) -> np.ndarray:
    """Convert zpk to SOS (simplified pairing valid for Butterworth designs).

    Butterworth digital designs have zeros only at z=+1/-1 (possibly +-j*w0
    for bandstop) and complex-conjugate pole pairs, so a greedy
    nearest-zero-to-pole pairing suffices and matches scipy's output up to
    section ordering/rounding.
    """
    z = np.asarray(z, dtype=complex).copy()
    p = np.asarray(p, dtype=complex).copy()
    n = max(len(z), len(p))
    if n % 2 == 1:
        z = np.append(z, 0.0) if len(z) < n else z
        p = np.append(p, 0.0) if len(p) < n else p
    # pad to equal length
    while len(z) < len(p):
        z = np.append(z, 0.0)
    while len(p) < len(z):
        p = np.append(p, 0.0)

    p_upper, p_real = _pair_conjugates(p)
    z_upper, z_real = _pair_conjugates(z)

    sections = []
    z_pool = list(z_upper) + list(z_real)

    def take_nearest(pool, target, count):
        got = []
        for _ in range(count):
            if not pool:
                break
            i = int(np.argmin([abs(c - target) for c in pool]))
            got.append(pool.pop(i))
        return got

    # complex pole pairs
    for pp in p_upper:
        zz = take_nearest(z_pool, pp, 1)
        num_roots = []
        for c in zz:
            if abs(np.imag(c)) > 1e-12:
                num_roots += [c, np.conj(c)]
            else:
                # try to grab a second real zero for a full biquad numerator
                extra = take_nearest([c2 for c2 in z_pool if abs(np.imag(c2)) <= 1e-12], c, 1)
                if extra:
                    z_pool.remove(extra[0])
                    num_roots += [c, extra[0]]
                else:
                    num_roots += [c]
        b = np.real(np.poly(num_roots)) if num_roots else np.array([1.0])
        a = np.real(np.poly([pp, np.conj(pp)]))
        b = np.concatenate([b, np.zeros(3 - len(b))])
        sections.append(np.concatenate([b, a]))
    # leftover real poles in pairs
    p_real = list(p_real)
    while p_real:
        pr = [p_real.pop(0)]
        if p_real:
            pr.append(p_real.pop(0))
        zz = take_nearest(z_pool, pr[0], len(pr))
        b = np.real(np.poly(zz)) if zz else np.array([1.0])
        a = np.real(np.poly(pr))
        b = np.concatenate([b, np.zeros(3 - len(b))])
        a = np.concatenate([a, np.zeros(3 - len(a))])
        sections.append(np.concatenate([b, a]))

    sos = np.asarray(sections, dtype=np.float64)
    sos[0, :3] *= np.real(k)
    return sos


# ---------------------------------------------------------------------------
# sosfilt / zi  (scipy parity)
# ---------------------------------------------------------------------------


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state initial conditions; matches ``scipy.signal.sosfilt_zi``.

    Per section solves the DF2T steady state for unit step input, scaled by
    the cascade's cumulative DC gain.
    """
    sos = np.asarray(sos, dtype=np.float64)
    n_sections = sos.shape[0]
    zi = np.empty((n_sections, 2))
    scale = 1.0
    for s in range(n_sections):
        b = sos[s, :3]
        a = sos[s, 3:]
        # steady state of DF2T: solve (I - A) zss = B for x=1
        a1, a2 = a[1], a[2]
        b0, b1, b2 = b
        A = np.array([[-a1, 1.0], [-a2, 0.0]])
        Bv = np.array([b1 - a1 * b0, b2 - a2 * b0])
        zss = np.linalg.solve(np.eye(2) - A, Bv)
        zi[s] = scale * zss
        scale *= b.sum() / a.sum()
    return zi


@partial(jax.jit, static_argnames=("a1", "a2", "bv0", "bv1", "b0", "axis",
                                   "block", "need_zf"))
def _sosfilt_section_pscan(x: jnp.ndarray, *, a1: float, a2: float,
                           bv0: float, bv1: float, b0: float,
                           zi: jnp.ndarray, axis: int = -1, block: int = 512,
                           need_zf: bool = True
                           ) -> tuple[jnp.ndarray, jnp.ndarray | None]:
    """One biquad over the last axis as a blocked two-level parallel scan.

    State-space form of DF2T with A = [[-a1, 1], [-a2, 0]],
    B = [b1 - a1*b0, b2 - a2*b0] (= ``bv0, bv1``):

        z[n] = A z[n-1] + B x[n],   y[n] = b0 x[n] + z0[n-1]

    The blocked form is HBM-light vs a flat associative scan:
      1. in-block prefix affines: one ``lax.scan`` of ``block`` steps,
         vectorized over (batch x n_blocks) — the time axis is folded so the
         sequential length is only ``block``;
      2. block-boundary states: a tiny ``lax.scan`` over n_blocks;
      3. per-sample states: prefix applied to the block-start state,
         elementwise.

    All 2x2 affine algebra is expanded to scalar mul/adds on purpose: these
    run as exact-float32 elementwise ops, whereas ``einsum``/``dot`` forms are
    matmuls whose default precision on an accelerator may be reduced
    (bfloat16 or TF32), which injects ~2e-3 relative error per section into
    the filtered signal.  Scalar FMAs also suit the shape: the operands are
    2-vectors, far below any matmul tile.

    The lean (``need_zf=False``) path unrolls both scans 8x: each step is
    ~30 scalar ops on small tensors, so the compiled while-loop's
    per-iteration overhead dominates.  Unrolling lets XLA regroup FMAs
    differently per compilation (ulp-level shifts), so the streaming ``zi``
    path stays un-unrolled — chunked and whole-clip streaming compilations
    are pinned bit-identical.
    """
    xT = jnp.moveaxis(x, axis, -1)
    shape = xT.shape
    T = shape[-1]
    dt = xT.dtype

    nb = -(-T // block)
    pad = nb * block - T
    xp = jnp.pad(xT, [(0, 0)] * (xT.ndim - 1) + [(0, pad)])
    xb = xp.reshape(shape[:-1] + (nb, block))          # (..., nb, block)
    xs = jnp.moveaxis(xb, -1, 0)                       # (block, ..., nb)

    ones = jnp.ones(shape[:-1] + (nb,), dt)
    zeros = jnp.zeros(shape[:-1] + (nb,), dt)

    def step(carry, x_t):
        m00, m01, m10, m11, v0, v1 = carry
        # M' = A @ M ; v' = A v + x_t * B   (A rows: [-a1, 1], [-a2, 0])
        n00 = m10 - a1 * m00
        n01 = m11 - a1 * m01
        n10 = -a2 * m00
        n11 = -a2 * m01
        w0 = v1 - a1 * v0 + bv0 * x_t
        w1 = -a2 * v0 + bv1 * x_t
        out = (n00, n01, n10, n11, w0, w1)
        return out, out

    init = (ones, zeros, zeros, ones, zeros, zeros)
    if need_zf:
        # emit the full 6-component prefix (the final state needs the
        # prefix at the last VALID sample, which padding keeps off the
        # block-final carry). NO unroll here: unrolling changes XLA's FMA
        # grouping per compilation, and the streaming (zi) path is pinned
        # bit-identical between chunked and whole-clip compilations
        # (tests/test_band_noise.py::test_streaming_class_matches_whole_clip)
        carry_fin, pref = jax.lax.scan(step, init, xs)
        p00, p01, p10, p11, pv0, pv1 = pref   # each (block, ..., nb)
        comp = tuple(jnp.moveaxis(c[-1], -1, 0) for c in pref)
    else:
        # y only needs (p00, p01, pv0); emitting just those halves the HBM
        # traffic of the pass (the block composites come from the final
        # carry, which IS the whole-block prefix)
        def step3(carry, x_t):
            out = step(carry, x_t)[0]
            return out, (out[0], out[1], out[4])

        carry_fin, (p00, p01, pv0) = jax.lax.scan(step3, init, xs, unroll=8)
        comp = tuple(jnp.moveaxis(c, -1, 0) for c in carry_fin)

    zi_b = jnp.broadcast_to(zi.astype(dt), shape[:-1] + (2,))

    def block_step(z, c):
        c00, c01, c10, c11, cv0, cv1 = c
        z0, z1 = z
        zn0 = c00 * z0 + c01 * z1 + cv0
        zn1 = c10 * z0 + c11 * z1 + cv1
        return (zn0, zn1), (z0, z1)  # emit the block-START state

    (zl0, zl1), (zs0, zs1) = jax.lax.scan(
        block_step, (zi_b[..., 0], zi_b[..., 1]), comp,
        unroll=8 if not need_zf else 1,
    )
    zs0 = jnp.moveaxis(zs0, 0, -1)  # (..., nb)
    zs1 = jnp.moveaxis(zs1, 0, -1)

    # per-sample z0[t] within each block (z1 only needed at the final sample)
    z0_all = p00 * zs0 + p01 * zs1 + pv0         # (block, ..., nb)
    z0_flat = jnp.moveaxis(z0_all, 0, -1)        # (..., nb, block)
    z0_flat = z0_flat.reshape(shape[:-1] + (nb * block,))[..., :T]

    z_prev0 = jnp.concatenate([zi_b[..., :1], z0_flat[..., :-1]], axis=-1)
    y = b0 * xT + z_prev0

    if not need_zf:
        return jnp.moveaxis(y, -1, axis), None

    # final state: prefix at the last *valid* sample applied to the last
    # block's start state
    t_last = T - 1 - (nb - 1) * block
    lb0 = zs0[..., -1]
    lb1 = zs1[..., -1]
    zf0 = (p00[t_last, ..., -1] * lb0 + p01[t_last, ..., -1] * lb1
           + pv0[t_last, ..., -1])
    zf1 = (p10[t_last, ..., -1] * lb0 + p11[t_last, ..., -1] * lb1
           + pv1[t_last, ..., -1])
    z_final = jnp.stack([zf0, zf1], axis=-1)
    return jnp.moveaxis(y, -1, axis), z_final


# LRU-bounded: grid searches over band edges/orders design many distinct
# filters, and each entry holds O(block^2 + block*4S^2) float64 constants.
# Recomputing on a miss is cheap host-side NumPy, so a small bound suffices.
_CASCADE_CONST_CACHE: OrderedDict = OrderedDict()
_CASCADE_CONST_CACHE_MAX = 32


def _cascade_state_space(sos: np.ndarray):
    """Combined state-space of a DF2T biquad cascade (float64, host).

    Returns ``(A, Bv, r, d0)`` with state ``s[n] = A s[n-1] + Bv x[n]`` and
    output ``y[n] = d0 x[n] + r . s[n-1]``; the 2S-dim state is the
    concatenation of the per-section DF2T states, so an initial ``s[-1]``
    assembled from per-section ``zi`` reproduces the sequential cascade
    exactly.
    """
    sos = np.asarray(sos, dtype=np.float64)
    S = sos.shape[0]
    A = np.zeros((2 * S, 2 * S))
    Bv = np.zeros(2 * S)
    r = np.zeros(2 * S)
    d0 = 1.0
    for s in range(S):
        b0, b1, b2, _, a1, a2 = sos[s]
        As = np.array([[-a1, 1.0], [-a2, 0.0]])
        Bs = np.array([b1 - a1 * b0, b2 - a2 * b0])
        # section input: u[n] = d0 x[n] + r . s[n-1]
        A[2 * s : 2 * s + 2, :] = np.outer(Bs, r)
        A[2 * s : 2 * s + 2, 2 * s : 2 * s + 2] += As
        Bv[2 * s : 2 * s + 2] = Bs * d0
        # section output: y[n] = b0 u[n] + z_s0[n-1]
        r = b0 * r
        r[2 * s] += 1.0
        d0 *= b0
    return A, Bv, r, d0


def _cascade_matmul_constants(sos: np.ndarray, block: int):
    """Trace-time constants that turn the cascade into matmuls.

    With in-block index ``i`` and block-start state ``z`` (the state before
    the block's first sample):

        s[i]  = A^{i+1} z + sum_u A^{i-u} Bv x[u]
        y[i]  = d0 x[i] + r . s[i-1]
              = (Zmat[i] . z) + sum_u L[i, u] x[u]

    so the per-sample output is two matmuls against constants built from the
    powers of ``A`` (the matrix prefix of the old blocked scan was
    data-independent — only the drift vector depends on x):

        L[i, u] = d0            if u == i        (direct feedthrough)
                  r . A^{i-1-u} Bv   if u < i    (in-block impulse response)
        Zmat[i] = r . A^i                        (block-start state pickup)
        Kblk[u] = A^{block-1-u} Bv               (block composite drift)
        Ablk    = A^block                        (block composite matrix)

    Everything is computed in float64 and cast at use.  Exact linear algebra
    — no truncation: cross-block history enters through the boundary states.
    """
    key = (sos.tobytes(), int(block))
    hit = _CASCADE_CONST_CACHE.get(key)
    if hit is not None:
        _CASCADE_CONST_CACHE.move_to_end(key)
        return hit
    A, Bv, r, d0 = _cascade_state_space(sos)
    n = A.shape[0]
    # powers[i] = A^i, i = 0..block
    powers = np.empty((block + 1, n, n))
    powers[0] = np.eye(n)
    for i in range(1, block + 1):
        powers[i] = A @ powers[i - 1]
    # g[d] = r . A^{d-1} Bv  (impulse response tail), d = 1..block-1
    g = np.einsum("s,dst,t->d", r, powers[: block - 1], Bv)
    L = np.zeros((block, block))
    idx = np.arange(block)
    L[idx, idx] = d0
    for d in range(1, block):
        L[idx[d:], idx[d:] - d] = g[d - 1]
    Zmat = r @ powers[:block]                      # (block, n)
    Kblk = powers[block - 1 :: -1] @ Bv            # (block, n): A^{block-1-u} Bv
    out = (L, Zmat, Kblk, powers[block])
    _CASCADE_CONST_CACHE[key] = out
    while len(_CASCADE_CONST_CACHE) > _CASCADE_CONST_CACHE_MAX:
        _CASCADE_CONST_CACHE.popitem(last=False)
    return out


def _boundary_logdepth_powers(sos: np.ndarray, block: int, nb: int):
    """Trace-time ``(A^block)^(2^k)`` ladder (float64) for the log-depth
    boundary prefix, k = 0..ceil(log2(nb))-1 — the boundary recurrence
    steps BLOCKS, so the doubling weights are powers of the block
    composite matrix."""
    A, _, _, _ = _cascade_state_space(sos)
    pows = []
    span = 1
    M = np.linalg.matrix_power(A, block)
    while span < nb:
        pows.append(M)
        M = M @ M
        span *= 2
    return pows


def _sosfilt_cascade_matmul(sos: np.ndarray, x: jnp.ndarray,
                            zi: jnp.ndarray, axis: int = -1,
                            block: int = 128,
                            reverse: bool = False,
                            return_zf: bool = False,
                            boundary: str = "scan"):
    """Whole-cascade ``sosfilt`` (y only) as two matmuls + a tiny scan.

    The lean path of :func:`sosfilt`.  Versus the blocked parallel scan this
    emits NO per-sample prefix arrays: HBM traffic is one read of ``x`` per
    matmul plus one write of ``y``, and the only sequential work left is the
    block-boundary state recurrence (``ceil(T/block)`` steps on a (..., 2S)
    carry).  All matmuls run at ``Precision.HIGHEST`` (full float32): a
    reduced-precision matmul injects ~2e-3/section error (see
    ``_sosfilt_section_pscan``).

    ``zi``: (..., n_sections, 2) initial conditions (scipy layout).

    ``reverse=True`` computes ``flip(filter(flip(x)))`` — the backward half
    of ``sosfiltfilt`` — WITHOUT materializing either flip: reversing the
    signal is a 180-degree rotation of the in-block constants
    (``L[i,u] -> L[B-1-i, B-1-u]``, row-reversals of ``Zmat``/``Kblk``)
    plus running the block-boundary scan right-to-left and prepending the
    alignment padding instead of appending it.

    ``boundary="logdepth"`` replaces the sequential block-boundary ``lax.scan``
    with a Hillis-Steele doubling prefix: level k adds the ``2^k``-shifted
    partial weighted by the trace-time constant ``A^(2^k)`` — O(log nb)
    BATCHED einsums instead of ``nb`` latency-bound sequential steps (the
    scan was most of the filtfilt's device time at nb=873).  Exact linear
    algebra; float32 summation order differs from the sequential scan
    (measured ~1e-7 rel on the engine prefilters), and the tree shape
    depends on nb, so this mode is reserved for the OFFLINE zero-phase
    :func:`sosfiltfilt` — the streaming/chunked entries keep ``"scan"``,
    whose per-block FLOP sequence is invariant to how a stream is chunked
    (the bit-exactness contract of the chunked paths).

    ``return_zf=True`` (forward only) additionally returns the final filter
    state in scipy's per-section ``(..., n_sections, 2)`` layout.  The
    combined 2S-dim state IS the concatenation of per-section DF2T states,
    so the export is a reshape; for a trailing partial block the state is
    advanced exactly ``P = T - (nb-1)*block`` samples with one constant
    ``A^P`` pickup plus the length-P drift (rows ``block-P:`` of ``Kblk``) —
    exact linear algebra, and bit-stable across chunk boundaries that are
    multiples of ``block`` (the chunked caller sees the same per-block
    recurrence as the whole-clip one).
    """
    if return_zf and reverse:
        raise ValueError("return_zf is only supported for forward filtering")
    sos = np.asarray(sos, dtype=np.float64)
    S = sos.shape[0]
    L, Zmat, Kblk, Ablk = _cascade_matmul_constants(sos, block)
    if reverse:
        L = L[::-1, ::-1]
        Zmat = Zmat[::-1]
        Kblk = Kblk[::-1]

    xT = jnp.moveaxis(x, axis, -1)
    shape = xT.shape
    T = shape[-1]
    dt = xT.dtype
    hp = jax.lax.Precision.HIGHEST

    nb = -(-T // block)
    pad = nb * block - T
    widths = [(0, 0)] * (xT.ndim - 1) + [(pad, 0) if reverse else (0, pad)]
    xp = jnp.pad(xT, widths)
    xb = xp.reshape(shape[:-1] + (nb, block))               # (..., nb, block)

    Lc = jnp.asarray(np.ascontiguousarray(L), dt)
    Zc = jnp.asarray(np.ascontiguousarray(Zmat), dt)
    Kc = jnp.asarray(np.ascontiguousarray(Kblk), dt)
    Ac = jnp.asarray(Ablk, dt)

    # block composite drifts: c[j] = sum_u A^{block-1-u} Bv x[j, u]
    # (for reverse, Kc is row-flipped so this is the drift of the
    # time-reversed block)
    cblk = jnp.einsum("...u,us->...s", xb, Kc, precision=hp)  # (..., nb, 2S)

    z0 = jnp.broadcast_to(
        zi.astype(dt).reshape(zi.shape[:-2] + (2 * S,)), shape[:-1] + (2 * S,)
    )

    if boundary == "logdepth":
        if return_zf:
            raise ValueError("return_zf requires boundary='scan'")
        # zstarts[j] = A^j z0 + sum_{u<j} A^{j-1-u} c_u  ==  the inclusive
        # matrix-weighted prefix of d = [z0, c_0, .., c_{nb-2}]; reverse
        # runs the same prefix on the flipped block axis
        cb = cblk[..., ::-1, :] if reverse else cblk
        d = jnp.concatenate([z0[..., None, :], cb[..., :-1, :]], axis=-2)
        p = d
        zeros_pad = [(0, 0)] * (d.ndim - 2)
        span = 1
        for Ak64 in _boundary_logdepth_powers(sos, block, nb):
            Ak = jnp.asarray(Ak64, dt)
            shifted = jnp.pad(p, zeros_pad + [(span, 0), (0, 0)])[..., :nb, :]
            p = p + jnp.einsum("...s,ts->...t", shifted, Ak, precision=hp)
            span *= 2
        zstarts = p[..., ::-1, :] if reverse else p
        zfin = None
    else:
        def boundary_step(z, c):
            return jnp.einsum("...s,ts->...t", z, Ac, precision=hp) + c, z

        cT = jnp.moveaxis(cblk, -2, 0)                       # (nb, ..., 2S)
        zfin, zstarts = jax.lax.scan(boundary_step, z0, cT, unroll=8,
                                     reverse=reverse)
        zstarts = jnp.moveaxis(zstarts, 0, -2)               # (..., nb, 2S)

    y = (
        jnp.einsum("...u,iu->...i", xb, Lc, precision=hp)
        + jnp.einsum("...s,is->...i", zstarts, Zc, precision=hp)
    )
    y = y.reshape(shape[:-1] + (nb * block,))
    y = y[..., pad:] if reverse else y[..., :T]
    y = jnp.moveaxis(y, -1, axis)
    if not return_zf:
        return y
    if pad == 0:
        zf = zfin
    else:
        # advance the last block-start state exactly P real samples
        P = block - pad
        A, _, _, _ = _cascade_state_space(sos)
        Ap = jnp.asarray(np.linalg.matrix_power(A, P), dt)
        z_last = zstarts[..., -1, :]                         # (..., 2S)
        drift = jnp.einsum("...u,us->...s", xb[..., -1, :P],
                           jnp.asarray(np.ascontiguousarray(Kblk[block - P:]),
                                       dt), precision=hp)
        zf = jnp.einsum("...s,ts->...t", z_last, Ap, precision=hp) + drift
    return y, zf.reshape(zf.shape[:-1] + (S, 2))


def sosfilt_matmul_zf(sos: np.ndarray, x: jnp.ndarray, zi: jnp.ndarray,
                      axis: int = -1):
    """``sosfilt`` returning ``(y, zf)`` through the lean cascade-matmul path.

    Same scipy semantics as ``sosfilt(sos, x, zi=zi)`` but with the whole
    cascade as two constant matmuls + the block-boundary scan (no
    per-sample prefix arrays), plus an exact final-state export.  Float32
    output differs from the per-section parallel scan only in FMA grouping
    (same accuracy class vs the float64 oracle).  Chunk-invariant when every
    chunk length is a multiple of the 128-sample block (the band-noise
    streaming adapter's frames are 512 samples).
    """
    sos = np.asarray(sos, dtype=np.float64)
    zi_arr = jnp.asarray(zi, dtype=x.dtype)
    return _sosfilt_cascade_matmul(sos, x, zi_arr, axis=axis, return_zf=True)


def sosfilt(sos: np.ndarray, x: jnp.ndarray, zi: jnp.ndarray | None = None,
            axis: int = -1, return_zf: bool | None = None):
    """Cascaded-biquad filter (scipy ``sosfilt`` semantics) on device.

    Parameters
    ----------
    sos : (n_sections, 6) NumPy constant (host-designed)
    x   : (..., T) traced array
    zi  : optional (n_sections, 2) or broadcastable initial conditions;
          when given, returns ``(y, zf)`` like scipy.
    return_zf : override the "zi given -> return final state" default;
          pass False when the caller discards ``zf`` (e.g. ``sosfiltfilt``) —
          the pass then emits half the prefix arrays (memory-bound).

    Runs each section as an O(log T)-depth associative scan.
    """
    sos = np.asarray(sos, dtype=np.float64)
    if return_zf is None:
        return_zf = zi is not None
    n_sections = sos.shape[0]
    if zi is None:
        zi_arr = jnp.zeros((n_sections, 2), dtype=x.dtype)
    else:
        zi_arr = jnp.asarray(zi, dtype=x.dtype)

    y = x
    if not return_zf:
        # lean whole-cascade path: the matrix prefix of the blocked scan is
        # data-independent, so the filter collapses to two constant matmuls
        # (in-block impulse response + block-start pickup) and a tiny
        # block-boundary scan — no per-sample prefix arrays at all.
        return _sosfilt_cascade_matmul(sos, y, zi_arr, axis=axis)

    zf = []
    for s in range(n_sections):
        b0, b1, b2, _, a1, a2 = [float(v) for v in sos[s]]
        y, zfs = _sosfilt_section_pscan(
            y, a1=a1, a2=a2, bv0=b1 - a1 * b0, bv1=b2 - a2 * b0, b0=b0,
            zi=zi_arr[..., s, :], axis=axis, need_zf=True,
        )
        zf.append(zfs)
    return y, jnp.stack(zf, axis=-2)  # (..., n_sections, 2)


def sosfiltfilt(sos: np.ndarray, x: jnp.ndarray, axis: int = -1,
                boundary: str = "logdepth") -> jnp.ndarray:
    """Zero-phase forward-backward filter; scipy ``sosfiltfilt`` parity.

    Reproduces scipy defaults: odd extension with
    ``padlen = 3 * (2*n_sections + 1 - min(#(b2==0), #(a2==0)))`` and
    ``sosfilt_zi``-scaled initial conditions (scaled by the first/last
    extended sample on the forward/backward pass respectively).

    Zero-phase filtering is inherently offline (it sees the whole clip), so
    both passes default to the log-depth block-boundary prefix
    (``boundary="logdepth"``): the nb-step sequential boundary scan was most
    of the filtfilt's device time.  Pass ``boundary="scan"`` for the
    sequential form (bit-identical to the pre-r5 output).
    """
    sos = np.asarray(sos, dtype=np.float64)
    n_sections = sos.shape[0]
    ntaps = 2 * n_sections + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    padlen = 3 * ntaps

    xT = jnp.moveaxis(x, axis, -1)
    n = xT.shape[-1]
    if n <= padlen:
        raise ValueError(
            f"The length of the input vector x must be greater than padlen={padlen}"
        )

    # odd extension: 2*x[0] - x[padlen:0:-1]  |  x  |  2*x[-1] - x[-2:-padlen-2:-1]
    left = 2.0 * xT[..., :1] - xT[..., 1 : padlen + 1][..., ::-1]
    right = 2.0 * xT[..., -1:] - xT[..., -padlen - 1 : -1][..., ::-1]
    ext = jnp.concatenate([left, xT, right], axis=-1)

    zi_base = sosfilt_zi(sos)  # (n_sections, 2)
    zi0 = jnp.asarray(zi_base, dtype=ext.dtype)

    x0 = ext[..., :1]  # (..., 1)
    y = _sosfilt_cascade_matmul(sos, ext, zi0 * x0[..., None],
                                boundary=boundary)
    # backward pass with the flips folded into the cascade constants —
    # no (..., T) reversal copies ever hit HBM
    y0 = y[..., -1:]
    zi_rev = (zi0 * y0[..., None]).astype(y.dtype)
    zi_rev = jnp.broadcast_to(zi_rev, y.shape[:-1] + zi0.shape)
    y = _sosfilt_cascade_matmul(np.asarray(sos), y, zi_rev, reverse=True,
                                boundary=boundary)
    y = y[..., padlen : padlen + n]
    return jnp.moveaxis(y, -1, axis)


# ---------------------------------------------------------------------------
# Reference prefilter designs (band edges clipped exactly like the engine)
# ---------------------------------------------------------------------------


def design_highpass(sr: float, cutoff_hz: float, order: int = 4) -> np.ndarray:
    """HP design clipped like ``edge/rain_signal_processor.py:360-362``."""
    nyq = 0.5 * sr
    wn = float(np.clip(cutoff_hz / nyq, 1e-4, 0.9999))
    return butter_sos(order, wn, "highpass")


def design_bandpass(sr: float, lo_hz: float, hi_hz: float, order: int = 4,
                    clip_mode: str = "engine") -> np.ndarray:
    """BP design with the engine's edge clipping.

    ``clip_mode="engine"`` matches ``edge/rain_signal_processor.py:352-358``
    (also used by TD features, ``edge/feature_extraction.py:199-209``):
    lo clipped to [1e-3, 0.999*nyq], hi to [lo+1e-3, 0.999*nyq].
    """
    nyq = 0.5 * sr
    if clip_mode == "engine":
        lo = float(np.clip(lo_hz, 1e-3, nyq * 0.999))
        hi = float(np.clip(hi_hz, lo + 1e-3, nyq * 0.999))
        wn = [lo / nyq, hi / nyq]
    else:
        wn = [lo_hz / nyq, hi_hz / nyq]
    return butter_sos(order, wn, "bandpass")
