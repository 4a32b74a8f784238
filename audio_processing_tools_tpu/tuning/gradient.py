"""Gradient-based decision-threshold tuning.

The reference tunes detector thresholds by exhaustive grid search
(``edge/parameter_tuning/grid_search.py``: ProcessPool over combos, ~1
min / 1000 test vectors).  On the device the decision layer is pure elementwise
math over precomputed flux features (see
:func:`..tuning.grid_search.grid_search_vmapped`), which means it is also
*differentiable* once the hard gates are relaxed to sigmoids.  This module
adds what the reference cannot do: fit all continuous thresholds jointly
with Adam in a few hundred fused device steps instead of enumerating a
combinatorial grid.

Method
------
Run the threshold-independent front-end ONCE (shared with the vmapped grid
sweep), then optimize a temperature-annealed soft relaxation of the exact
decision rule (``rain_frame_classifier.py:230-284`` semantics):

* TD gate ``crest > tdg``            → ``sigmoid(tau * (crest - tdg))``
* flux gates ``log1p(f) >= thr``     → ``sigmoid(tau * (log1p(f) - thr))``
* support vote ``hits >= k``         → ``sigmoid(tau * (hits - k + 0.5))``
* clip rule ``count >= c_min``       → ``sigmoid(tau * (count - c_min + 0.5))``

with binary cross-entropy against clip labels.  The temperature anneals
geometrically from soft to near-hard over the schedule, so late steps
optimize something close to the true step-function accuracy.  Integer knobs
(``min_support_count``, ``clip_rain_min_frames``) stay fixed — gradients
through count relaxations of those are poorly conditioned and the grid
handles them in a handful of combos.

The returned thresholds are evaluated with the EXACT hard rule (same code
path as the grid sweep) so reported accuracy is never the soft surrogate.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

TUNABLE = (
    "new_rain_primary_flux_min",
    "new_rain_mode1_flux_min",
    "new_rain_mode2_flux_min",
    "new_rain_mode3_flux_min",
    "td_gate_threshold",
)

_DEFAULTS = {
    "new_rain_primary_flux_min": 1.8,
    "new_rain_mode1_flux_min": 2.6,
    "new_rain_mode2_flux_min": 2.6,
    "new_rain_mode3_flux_min": 3.0,
    "td_gate_threshold": 2.5,
}


def _hard_predict(feats, thr: Dict[str, float], *, min_support: int,
                  clip_rain_min_frames: int):
    """Exact decision rule — identical math to grid_search_vmapped's
    eval_combo, so gradient results are scored on the real step
    functions."""
    import jax.numpy as jnp

    gate = (feats["td_crest"] > float(thr["td_gate_threshold"])).astype(
        jnp.float32
    )
    f0 = jnp.log1p(jnp.maximum(feats["primary"] * gate, 0.0))
    f1 = jnp.log1p(jnp.maximum(feats["s1"] * gate, 0.0))
    f2 = jnp.log1p(jnp.maximum(feats["s2"] * gate, 0.0))
    f3 = jnp.log1p(jnp.maximum(feats["s3"] * gate, 0.0))
    hits = (
        (f1 >= float(thr["new_rain_mode1_flux_min"])).astype(jnp.int32)
        + (f2 >= float(thr["new_rain_mode2_flux_min"])).astype(jnp.int32)
        + (f3 >= float(thr["new_rain_mode3_flux_min"])).astype(jnp.int32)
    )
    is_rain = (f0 >= float(thr["new_rain_primary_flux_min"])) & (
        hits >= int(min_support)
    )
    counts = jnp.sum(is_rain, axis=-1)
    return counts >= int(max(1, clip_rain_min_frames))


def gradient_tune_thresholds(
    clips: np.ndarray,
    labels: np.ndarray,
    base_params: Dict[str, Any] | None = None,
    *,
    init: Dict[str, float] | None = None,
    steps: int = 300,
    lr: float = 0.05,
    tau: tuple = (2.0, 24.0),
    anchor_weight: float = 1e-3,
) -> Dict[str, Any]:
    """Jointly fit the spectral detector's continuous thresholds by Adam.

    Parameters
    ----------
    clips : (B, N) float32 labeled audio batch
    labels : (B,) bool clip-level rain labels
    base_params : engine params (front-end config + fixed integer knobs
        ``new_rain_min_support_count`` / ``clip_rain_min_frames``)
    init : starting thresholds (defaults to the reference defaults, i.e.
        a possibly detuned production config)
    steps, lr : Adam schedule
    tau : (start, end) sigmoid temperatures, annealed geometrically
    anchor_weight : L2 pull toward ``init`` — keeps ill-identified
        thresholds (e.g. a mode that never fires on this corpus) from
        drifting arbitrarily far

    Returns a dict with ``thresholds`` (floats, ready to drop into
    ``params["detector"]``), hard-rule ``accuracy`` / ``init_accuracy``,
    confusion index lists, and the surrogate ``loss_history``.
    """
    import jax
    import jax.numpy as jnp
    import optax

    from audio_processing_tools_tpu.tuning.grid_search import (
        spectral_threshold_features,
    )

    feats, base = spectral_threshold_features(clips, base_params)
    labels_b = np.asarray(labels, bool)
    y = jnp.asarray(labels_b, jnp.float32)

    min_support = int(base.get("new_rain_min_support_count", 2))
    cmin = int(base.get("clip_rain_min_frames", 1))

    thr0 = dict(_DEFAULTS)
    thr0.update({k: float(v) for k, v in (init or {}).items() if k in thr0})
    theta0 = jnp.asarray([thr0[k] for k in TUNABLE], jnp.float32)

    crest = feats["td_crest"]
    lf = [jnp.log1p(jnp.maximum(feats[k], 0.0))
          for k in ("primary", "s1", "s2", "s3")]
    # log1p(f * g) for g in (0,1) is awkward to relax directly; instead gate
    # the *decision margins*: a frame whose TD gate is closed contributes a
    # strongly negative margin (same limit behavior as the hard rule, where
    # gate=0 zeroes the features and log1p(0)=0 < thr).
    tau0, tau1 = float(tau[0]), float(tau[1])
    n_steps = int(steps)

    def soft_forward(theta, temp):
        pm, m1, m2, m3, tdg = (theta[i] for i in range(5))
        g = jax.nn.sigmoid(temp * (crest - tdg))          # (B, T)
        p0 = jax.nn.sigmoid(temp * (lf[0] - pm)) * g
        h1 = jax.nn.sigmoid(temp * (lf[1] - m1)) * g
        h2 = jax.nn.sigmoid(temp * (lf[2] - m2)) * g
        h3 = jax.nn.sigmoid(temp * (lf[3] - m3)) * g
        hits = h1 + h2 + h3
        support = jax.nn.sigmoid(temp * (hits - (min_support - 0.5)))
        frame_p = p0 * support                             # (B, T)
        count = jnp.sum(frame_p, axis=-1)                  # (B,)
        clip_logit = temp * (count - (cmin - 0.5))
        return clip_logit

    def loss_fn(theta, temp):
        logit = soft_forward(theta, temp)
        bce = jnp.mean(optax.sigmoid_binary_cross_entropy(logit, y))
        anchor = anchor_weight * jnp.sum((theta - theta0) ** 2)
        return bce + anchor

    opt = optax.adam(lr)

    @jax.jit
    def fit(theta_init):
        state0 = opt.init(theta_init)

        def step(carry, i):
            theta, opt_state = carry
            frac = i.astype(jnp.float32) / max(n_steps - 1, 1)
            temp = tau0 * (tau1 / tau0) ** frac
            loss, grads = jax.value_and_grad(loss_fn)(theta, temp)
            updates, opt_state = opt.update(grads, opt_state, theta)
            theta = optax.apply_updates(theta, updates)
            return (theta, opt_state), loss

        (theta, _), losses = jax.lax.scan(
            step, (theta_init, state0), jnp.arange(n_steps)
        )
        return theta, losses

    theta, losses = fit(theta0)
    tuned = {k: float(v) for k, v in zip(TUNABLE, np.asarray(theta))}

    pred = np.asarray(_hard_predict(
        feats, tuned, min_support=min_support, clip_rain_min_frames=cmin
    ))
    pred0 = np.asarray(_hard_predict(
        feats, thr0, min_support=min_support, clip_rain_min_frames=cmin
    ))
    acc = float(np.mean(pred == labels_b))
    return {
        "thresholds": tuned,
        "accuracy": acc,
        "init_accuracy": float(np.mean(pred0 == labels_b)),
        "tp_classifications": np.flatnonzero(pred & labels_b).tolist(),
        "tn_classifications": np.flatnonzero(~pred & ~labels_b).tolist(),
        "fp_classifications": np.flatnonzero(pred & ~labels_b).tolist(),
        "fn_classifications": np.flatnonzero(~pred & labels_b).tolist(),
        "overall_accuracy": acc,  # grid_search result-dict compatibility
        "parameters": tuned,
        "loss_history": np.asarray(losses),
    }


# ---------------------------------------------------------------------------
# legacy RoE engine
# ---------------------------------------------------------------------------

ROE_TUNABLE_SCALARS = (
    "kurtosis_thr", "crest_thr", "diff_energy_thr", "min_drop_count",
)

_ROE_DEFAULTS = {
    "harmonic_threshold": (4.5, 4.0, 3.5, 3.5, 3.5, 3.5),
    "kurtosis_thr": 2.5,
    "crest_thr": 3.75,
    "diff_energy_thr": 6.5,
    "min_drop_count": 0.3,
}


def roe_gradient_tune_thresholds(
    clips: np.ndarray,
    labels: np.ndarray,
    base_params: Dict[str, Any] | None = None,
    *,
    init: Dict[str, Any] | None = None,
    steps: int = 300,
    lr: float = 0.05,
    tau: tuple = (0.25, 24.0),
    anchor_weight: float = 1e-3,
) -> Dict[str, Any]:
    """Adam fit of the RoE classifier's continuous thresholds.

    Same recipe as :func:`gradient_tune_thresholds`, applied to the legacy
    harmonic-novelty engine (``dsp_rain_detection.py`` semantics via
    ``models/roe.py``): the threshold-independent front-end
    (``roe_sweep_features``) runs once; the decision tail — per-harmonic
    novelty gates, base-harmonic gating, frame count vs
    ``min_drop_count x duration``, and the kurtosis/crest/diff-energy peak
    triple — is relaxed with annealed sigmoids (soft-OR / soft-AND for the
    combiners). Tunes the 6-vector ``harmonic_threshold`` plus
    ``kurtosis_thr`` / ``crest_thr`` / ``diff_energy_thr`` /
    ``min_drop_count``; the FP/FN combiner bounds stay fixed (integer-like
    guards, poorly conditioned under relaxation). Reported accuracy always
    comes from the exact hard rule (``roe_apply_thresholds``).

    The anneal starts much cooler than the spectral tuner's (0.25 vs 2.0):
    RoE margins are *counts* (drop/peak counts vs bounds like 9 or 50), an
    order of magnitude larger than log-flux margins, and a warm start
    saturates the combiner sigmoids into zero-gradient territory.
    """
    import jax
    import jax.numpy as jnp
    import optax

    from audio_processing_tools_tpu.models.roe import (
        roe_apply_thresholds,
        roe_sweep_features,
    )

    base = dict(base_params or {})
    feats = roe_sweep_features(np.asarray(clips, np.float32), **base)
    cfg = feats["cfg"]
    labels_b = np.asarray(labels, bool)
    y = jnp.asarray(labels_b, jnp.float32)

    init = dict(init or {})
    harm0 = np.asarray(
        init.get("harmonic_threshold", _ROE_DEFAULTS["harmonic_threshold"]),
        np.float32,
    )
    sc0 = np.asarray(
        [float(init.get(k, _ROE_DEFAULTS[k])) for k in ROE_TUNABLE_SCALARS],
        np.float32,
    )
    theta0 = jnp.asarray(np.concatenate([harm0, sc0]))

    nov1 = feats["nov1"]                      # (B, n_harm, T)
    valid = 1.0 - feats["nopeak"].astype(jnp.float32)
    kurt = feats["kurtosis"]
    crest = feats["crest_factor"]
    diffE = feats["diff_energy"]
    duration = float(cfg.check_duration)
    fixed = {
        "rain_drop_min_thr": float(base.get("rain_drop_min_thr", 3)),
        "rain_drop_max_thr": float(base.get("rain_drop_max_thr", 50)),
        "rain_peaks_min_thr": float(base.get("rain_peaks_min_thr", 9)),
        "rain_peaks_max_thr": float(base.get("rain_peaks_max_thr", 30)),
    }
    tau0, tau1 = float(tau[0]), float(tau[1])
    n_steps = int(steps)

    def soft_or(a, b):
        return a + b - a * b

    def soft_forward(theta, temp):
        thr6 = theta[:6]
        kt, ct, dt, mdc = (theta[6 + i] for i in range(4))
        thr_b = thr6[None, :, None]
        # per-harmonic novelty gate; magnitude clamp matters only through
        # the nov_hn comparison, so carry min(nov, 1.5 thr) as the value
        m = jax.nn.sigmoid(temp * (nov1 - thr_b)) * valid
        v = jnp.minimum(nov1, 1.5 * thr_b) * m
        sb = m[:, 0, :]                        # soft base-harmonic presence
        nov_hn = v[:, 0, :] + jnp.sum(v[:, 1:, :], axis=1) * sb
        thr_hn = thr6[0] + thr6[1] + thr6[2]
        p_frame = jax.nn.sigmoid(temp * (nov_hn - thr_hn))
        rdc = jnp.sum(p_frame, axis=-1)        # soft drop count (B,)

        p_peak = (
            jax.nn.sigmoid(temp * (kurt - kt))
            * jax.nn.sigmoid(temp * (crest - ct))
            * jax.nn.sigmoid(temp * (diffE - dt))
        )
        rpc = jnp.sum(p_peak, axis=-1)         # soft peak count (B,)

        rd_thr = mdc * duration
        raining = jax.nn.sigmoid(temp * (rdc - rd_thr))
        if cfg.handle_fn:
            promote = soft_or(
                jax.nn.sigmoid(temp * (rdc - fixed["rain_drop_max_thr"])),
                jax.nn.sigmoid(temp * (rpc - fixed["rain_peaks_max_thr"])),
            )
            raining = soft_or(raining, promote)
        if cfg.handle_fp:
            demote = soft_or(
                jax.nn.sigmoid(temp * (fixed["rain_peaks_min_thr"] - rpc)),
                jax.nn.sigmoid(temp * (rd_thr - rdc)),
            )
            raining = raining * (1.0 - demote)
        return raining                          # (B,) rain probability

    def loss_fn(theta, temp):
        # affine squash, NOT clip: a deeply-detuned start saturates p at
        # 0/1 and clip() would zero every gradient, freezing the tuner
        p = 1e-6 + (1.0 - 2e-6) * soft_forward(theta, temp)
        bce = -jnp.mean(y * jnp.log(p) + (1.0 - y) * jnp.log1p(-p))
        anchor = anchor_weight * jnp.sum((theta - theta0) ** 2)
        return bce + anchor

    opt = optax.adam(lr)

    @jax.jit
    def fit(theta_init):
        state0 = opt.init(theta_init)

        def step(carry, i):
            theta, opt_state = carry
            frac = i.astype(jnp.float32) / max(n_steps - 1, 1)
            temp = tau0 * (tau1 / tau0) ** frac
            loss, grads = jax.value_and_grad(loss_fn)(theta, temp)
            updates, opt_state = opt.update(grads, opt_state, theta)
            theta = optax.apply_updates(theta, updates)
            return (theta, opt_state), loss

        (theta, _), losses = jax.lax.scan(
            step, (theta_init, state0), jnp.arange(n_steps)
        )
        return theta, losses

    theta, losses = fit(theta0)
    theta_np = np.asarray(theta)
    tuned: Dict[str, Any] = {
        "harmonic_threshold": [float(v) for v in theta_np[:6]],
    }
    tuned.update({
        k: float(theta_np[6 + i]) for i, k in enumerate(ROE_TUNABLE_SCALARS)
    })

    def hard_acc(thr: Dict[str, Any]):
        mod = np.asarray(roe_apply_thresholds(
            feats,
            harmonic_threshold=thr["harmonic_threshold"],
            kurtosis_thr=thr["kurtosis_thr"], crest_thr=thr["crest_thr"],
            diff_energy_thr=thr["diff_energy_thr"],
            min_drop_count=thr["min_drop_count"], **fixed,
        ))
        return mod > 0

    init_thr = {"harmonic_threshold": [float(v) for v in harm0]}
    init_thr.update(
        {k: float(sc0[i]) for i, k in enumerate(ROE_TUNABLE_SCALARS)}
    )
    pred = hard_acc(tuned)
    pred0 = hard_acc(init_thr)
    acc = float(np.mean(pred == labels_b))
    return {
        "thresholds": tuned,
        "accuracy": acc,
        "init_accuracy": float(np.mean(pred0 == labels_b)),
        "tp_classifications": np.flatnonzero(pred & labels_b).tolist(),
        "tn_classifications": np.flatnonzero(~pred & ~labels_b).tolist(),
        "fp_classifications": np.flatnonzero(pred & ~labels_b).tolist(),
        "fn_classifications": np.flatnonzero(~pred & labels_b).tolist(),
        "overall_accuracy": acc,
        "parameters": tuned,
        "loss_history": np.asarray(losses),
    }
