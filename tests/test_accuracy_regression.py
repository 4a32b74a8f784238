"""Pinned labeled-corpus accuracy regression.

The reference's real test strategy (SURVEY §4): run the classifier over a
labeled test-vector corpus and split FP/FN
(``edge/dsp_rain_detection.py:3248-3282``). Here the corpus is synthesized
deterministically (rain / noise / wind / tonal classes with known labels),
run through the full framework path (LocalPath discovery -> MARK parse ->
device-batched detector), and the confusion counts are PINNED: a detector
regression that flips any clip fails the suite.
"""

import numpy as np
import pytest

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.evaluation import evaluate_corpus
from audio_processing_tools_tpu.framework import process_audio_batches_v2
from audio_processing_tools_tpu.models.spectral_noise import RainDetectorProcessor
from audio_processing_tools_tpu.utils.corpus import (
    CLASS_IS_RAIN,
    make_labeled_corpus,
    write_corpus_dir,
)

FS = 11162
SECONDS = 2.0


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    clips, labels, kinds = make_labeled_corpus(seed=7, seconds=SECONDS)
    d = tmp_path_factory.mktemp("acc") / "corpus"
    write_corpus_dir(str(d), clips, labels, kinds)
    return d, kinds


@pytest.fixture(scope="module")
def results(corpus_dir):
    d, kinds = corpus_dir
    proc = RainDetectorProcessor(name="rain_detector")
    res, _ = process_audio_batches_v2(
        processors=[proc],
        params_global={
            "sample_rate": FS, "check_duration": SECONDS,
            "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
            "clip_rain_min_frames": 3,
        },
        InputType="LocalPath", test_vector_path=str(d), batch_save_dir=None,
    )
    return res


def test_corpus_is_deterministic():
    a, la, ka = make_labeled_corpus(seed=7)
    b, lb, kb = make_labeled_corpus(seed=7)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert ka == kb
    c, _, _ = make_labeled_corpus(seed=8)
    assert not np.array_equal(a, c)


def test_accuracy_regression_pinned(results):
    stats = evaluate_corpus(
        results, predicted_col="rain_detector__clip_is_rain",
        actual_col="rain_actual",
    )
    # PINNED confusion counts for corpus seed=7 (24 clips: 10 rain / 14 not).
    # If a detector change flips any clip, this fails — inspect whether the
    # change is an improvement before re-pinning.
    assert stats["n"] == 24
    assert stats == {
        "n": 24, "n_tp": 10, "n_tn": 14, "n_fp": 0, "n_fn": 0,
        "accuracy": 1.0, "true_positive_rate": 1.0, "true_negative_rate": 1.0,
    }, stats


def test_accuracy_by_class(results):
    """Every adversarial non-rain class (wind gusts, tonal hum) stays clean,
    and both rain intensities are detected."""
    df = results.copy()
    df["kind"] = df["file_key"].map(lambda k: k.split("/")[-1].rsplit("_", 2)[0])
    for kind, group in df.groupby("kind"):
        expected = CLASS_IS_RAIN[kind]
        got = group["rain_detector__clip_is_rain"].astype(bool)
        assert (got == expected).all(), (
            f"{kind}: {int((got != expected).sum())}/{len(got)} misclassified"
        )


def test_evaluation_csv_outputs(results, tmp_path):
    stats = evaluate_corpus(
        results, predicted_col="rain_detector__clip_is_rain",
        actual_col="rain_actual", out_dir=str(tmp_path),
    )
    assert (tmp_path / "results_fp.csv").exists()
    assert (tmp_path / "results_fn.csv").exists()
    assert (tmp_path / "test_results.csv").exists()
    assert stats["accuracy"] == 1.0


# ---------------------------------------------------------------------------
# HARD tier: near-threshold corpus.  These
# classes sit at the default config's decision boundary: the pinned confusion
# is deliberately NOT perfect, so drift in either direction moves it.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hard_predictions():
    from audio_processing_tools_tpu.models.spectral_noise import (
        SpectralNoiseEngine,
        clip_aggregate,
    )
    from audio_processing_tools_tpu.utils.corpus import make_hard_corpus

    clips, labels, kinds = make_hard_corpus(seed=17, per_class=8)
    eng = SpectralNoiseEngine()
    eng.setup({
        "sample_rate": FS,
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
        "classifier_only_mode": True,
    })
    out = eng.process_batch(clips)
    fc = np.asarray(out["frame_class"])
    rc = np.asarray(out["rain_conf"])
    pred = np.array([
        bool(clip_aggregate(fc[i], rc[i], 3)["clip_is_rain"])
        for i in range(len(kinds))
    ])
    return pred, labels, kinds, clips


def test_hard_corpus_not_saturated(hard_predictions):
    pred, labels, kinds, _ = hard_predictions
    acc = float((pred == labels).mean())
    assert 0.55 <= acc < 1.0, (
        f"hard corpus must stay NEAR the boundary (got {acc}); if a detector "
        "improvement legitimately moved it, re-pin test_hard_corpus_confusion"
    )


def test_hard_corpus_confusion_pinned(hard_predictions):
    """Per-class correct counts for make_hard_corpus(seed=17, per_class=8)
    under the default detector config.  A threshold drift in EITHER
    direction changes these counts (misses move the rain_* rows, extra
    sensitivity moves wind_gusty)."""
    pred, labels, kinds, _ = hard_predictions
    correct = {}
    for kind in sorted(set(kinds)):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        correct[kind] = int((pred[idx] == labels[idx]).sum())
    assert correct == {
        "rain_faint": 7,
        "drizzle": 6,
        "rain_in_wind": 6,
        "wind_gusty": 5,
    }, correct


# ---------------------------------------------------------------------------
# BEAT tier: the shipped opt-in profile
# tuning.profiles.TUNED_ACCURACY_V1 — found by sweeping FROM the
# reference-default thresholds — must be strictly better than the defaults
# on the hard corpus, better on a held-out seed, and exactly as good on the
# easy corpus.  The DEFAULT profile stays reference-exact: its pins above
# (test_accuracy_regression_pinned, test_hard_corpus_confusion_pinned) and
# the 56-clip product-parity suite are untouched by this opt-in.
# ---------------------------------------------------------------------------


def _engine_predictions(clips, kinds, params, clip_rain_min_frames):
    from audio_processing_tools_tpu.models.spectral_noise import (
        SpectralNoiseEngine,
        clip_aggregate,
    )

    eng = SpectralNoiseEngine()
    eng.setup(params)
    out = eng.process_batch(clips)
    fc = np.asarray(out["frame_class"])
    rc = np.asarray(out["rain_conf"])
    return np.array([
        bool(clip_aggregate(fc[i], rc[i], clip_rain_min_frames)
             ["clip_is_rain"])
        for i in range(len(kinds))
    ])


def _tuned_params():
    from audio_processing_tools_tpu.tuning import (
        TUNED_ACCURACY_V1,
        apply_profile,
    )

    params = apply_profile({
        "sample_rate": FS,
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
        "classifier_only_mode": True,
    }, TUNED_ACCURACY_V1)
    cmin = params.pop("clip_rain_min_frames")
    return params, cmin


def _per_class_correct(pred, labels, kinds):
    return {
        kind: int(sum(pred[i] == labels[i]
                      for i, k in enumerate(kinds) if k == kind))
        for kind in sorted(set(kinds))
    }


def test_tuned_profile_beats_reference_defaults_on_hard_corpus(
        hard_predictions):
    """Full-engine confusion with the tuned profile, pinned: 28/32 vs the
    default's 24/32 on the pinned hard corpus — strictly better in every
    moved class, no class degraded."""
    default_pred, labels, kinds, clips = hard_predictions
    params, cmin = _tuned_params()
    pred = _engine_predictions(clips, kinds, params, cmin)

    default_correct = int((default_pred == labels).sum())
    tuned_correct = int((pred == labels).sum())
    assert default_correct == 24  # the reference-default pin, restated
    assert tuned_correct == 28, _per_class_correct(pred, labels, kinds)
    assert _per_class_correct(pred, labels, kinds) == {
        "rain_faint": 7,     # == default
        "drizzle": 8,        # default 6
        "rain_in_wind": 6,   # == default
        "wind_gusty": 7,     # default 5
    }
    # no class falls below the default profile's per-class counts
    d = _per_class_correct(default_pred, labels, kinds)
    t = _per_class_correct(pred, labels, kinds)
    assert all(t[k] >= d[k] for k in d), (t, d)


def test_tuned_profile_generalizes_to_held_out_seed():
    """Same profile on a hard corpus the sweep did NOT pin (seed=29;
    seed 23/29 were held-out selectors): 27/32 vs the default's 20/32."""
    from audio_processing_tools_tpu.utils.corpus import make_hard_corpus

    clips, labels, kinds = make_hard_corpus(seed=29, per_class=8)
    default_params = {
        "sample_rate": FS,
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
        "classifier_only_mode": True,
    }
    default_pred = _engine_predictions(clips, kinds, default_params, 3)
    params, cmin = _tuned_params()
    tuned_pred = _engine_predictions(clips, kinds, params, cmin)
    assert int((default_pred == labels).sum()) == 20
    assert int((tuned_pred == labels).sum()) == 27


def test_tuned_profile_keeps_easy_corpus_perfect():
    """The tuned profile must not trade easy-corpus accuracy for hard-corpus
    accuracy: 24/24, same as the default pin."""
    clips, labels, kinds = make_labeled_corpus(seed=7, seconds=SECONDS)
    params, cmin = _tuned_params()
    pred = _engine_predictions(clips, kinds, params, cmin)
    assert int((pred == labels).sum()) == 24


def test_profile_registry_roundtrip():
    from audio_processing_tools_tpu.tuning import (
        TUNED_ACCURACY_V1,
        apply_profile,
        available_profiles,
        get_profile,
    )

    assert TUNED_ACCURACY_V1 in available_profiles()
    base = {"sample_rate": FS, "detector": {"mode_bands": [(1, 2)]}}
    out = apply_profile(base, TUNED_ACCURACY_V1)
    # base dict untouched; mode_bands preserved; overrides applied
    assert "new_rain_primary_flux_min" not in base["detector"]
    assert out["detector"]["mode_bands"] == [(1, 2)]
    assert out["detector"]["td_gate_threshold"] == 3.75
    assert out["clip_rain_min_frames"] == 2
    import pytest as _pytest
    with _pytest.raises(KeyError, match="unknown profile"):
        get_profile("nope")


def test_tuning_improves_detuned_config_on_hard_corpus(hard_predictions):
    """grid_search_vmapped provably improves a detuned config on the hard
    corpus (SURVEY §4 corpus harness; reference
    dsp_rain_detection.py:3248-3282 + grid_search.py)."""
    from audio_processing_tools_tpu.tuning.grid_search import grid_search_vmapped

    _, labels, kinds, clips = hard_predictions

    grid = {
        "new_rain_primary_flux_min": [1.0, 1.4, 1.8, 2.6, 4.0],
        "clip_rain_min_frames": [1, 3],
    }
    results = grid_search_vmapped(
        clips, labels, grid, base_params={"sample_rate": FS},
    )
    by_combo = {
        (r["parameters"]["new_rain_primary_flux_min"],
         r["parameters"]["clip_rain_min_frames"]): r["overall_accuracy"]
        for r in results
    }
    detuned = by_combo[(4.0, 3)]   # way too high: misses near-threshold rain
    best = max(by_combo.values())
    assert detuned < 0.7, detuned
    assert best >= detuned + 0.15, (
        f"tuning must find a clearly better combo: best={best}, "
        f"detuned={detuned}, grid={by_combo}"
    )
