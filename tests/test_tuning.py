"""Grid-search resume semantics + device-vmapped threshold sweep."""

import json
import glob

import numpy as np
import pytest

from audio_processing_tools_tpu.tuning.grid_search import (
    grid_search,
    generate_param_combinations,
    load_processed_param_ids,
    grid_search_vmapped,
)
from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS

FS = 11162


def test_generate_param_combinations():
    combos = generate_param_combinations({"a": [1, 2], "b": ["x", "y", "z"]})
    assert len(combos) == 6
    assert {"a": 1, "b": "x"} in combos


def test_grid_search_resume(tmp_path):
    calls = []

    def alg(df, **params):
        calls.append(params)
        return 0.9, [1], [2], [], []

    grid = {"thr": [1, 2]}
    grid_search(None, alg, grid, "t1", str(tmp_path))
    assert len(calls) == 2
    files = glob.glob(str(tmp_path / "t1_*.json"))
    assert len(files) == 2
    with open(files[0]) as f:
        saved = json.load(f)
    assert saved["overall_accuracy"] == 0.9
    assert "parameters" in saved

    # resume: nothing re-runs
    grid_search(None, alg, grid, "t1", str(tmp_path))
    assert len(calls) == 2
    assert len(load_processed_param_ids(str(tmp_path / "t1_*.json"))) == 2


def test_grid_search_vmapped(rng):
    def rain(n):
        x = 0.005 * rng.standard_normal(n)
        for t0 in rng.integers(FS // 4, n - 2000, 20):
            k = np.arange(800)
            ping = sum(a * np.sin(2 * np.pi * f * k / FS)
                       for f, a in [(520, 1), (900, 0.5), (1600, 0.35), (2450, 0.25)])
            x[t0 : t0 + 800] += 0.5 * np.exp(-k / 60.0) * ping
        return x.astype(np.float32)

    n = FS * 2
    clips = np.stack([rain(n), rain(n),
                      (0.02 * rng.standard_normal(n)).astype(np.float32),
                      (0.01 * rng.standard_normal(n)).astype(np.float32)])
    labels = np.array([True, True, False, False])

    results = grid_search_vmapped(
        clips, labels,
        {"new_rain_primary_flux_min": [1.8, 6.0],
         "clip_rain_min_frames": [3]},
        base_params={"sample_rate": FS},
    )
    assert len(results) == 2
    by_thr = {r["parameters"]["new_rain_primary_flux_min"]: r for r in results}
    # the standard threshold should classify the corpus correctly
    assert by_thr[1.8]["overall_accuracy"] == 1.0
    # an absurdly high threshold kills the rain detections
    assert by_thr[6.0]["overall_accuracy"] <= 0.5
    assert set(by_thr[1.8]["tp_classifications"]) == {0, 1}


def test_roe_vmapped_sweep_matches_full_engine(rng):
    """roe_grid_search_vmapped predictions == rain_detection_algo run
    combo-by-combo (the front-end is shared; thresholds re-applied
    elementwise)."""
    from audio_processing_tools_tpu.models.roe import rain_detection_algo
    from audio_processing_tools_tpu.tuning.grid_search import (
        roe_grid_search_vmapped,
    )

    FS = 11162
    n = FS * 4

    def harmonic_rain(drops, fn=520.0):
        x = 0.003 * rng.standard_normal(n)
        k = np.arange(1000)
        ping = sum((1.0 / h) * np.sin(2 * np.pi * fn * h * k / FS)
                   for h in range(1, 6))
        for t0 in rng.integers(0, n - 1200, drops):
            x[t0 : t0 + 1000] += 0.6 * np.exp(-k / 80.0) * ping
        return x

    clips = np.stack([
        harmonic_rain(40), harmonic_rain(12),
        0.02 * rng.standard_normal(n), 0.004 * rng.standard_normal(n),
    ]).astype(np.float32)
    labels = np.array([True, True, False, False])

    base = {"sample_rate": FS, "check_duration": 4}
    grid = {
        "harmonic_threshold": [
            [4.5, 4.0, 3.5, 3.5, 3.5, 3.5],
            [3.5, 3.0, 2.5, 2.5, 2.5, 2.5],
            [6.0, 5.0, 4.5, 4.5, 4.5, 4.5],
        ],
        "crest_thr": [3.75, 3.0],
        "min_drop_count": [0.3, 1.0],
    }
    res = roe_grid_search_vmapped(clips, labels, grid, base)
    assert len(res) == 12

    for r in res[:6]:  # exactness vs the full engine for half the combos
        p = {**base, **r["parameters"]}
        for i, clip in enumerate(clips):
            mod, _, _ = rain_detection_algo(clip, return_spectra=False, **p)
            assert mod == r["rain_drop_count_mod"][i], (r["parameters"], i)

    # the sweep must separate the corpus at the default thresholds
    default = next(r for r in res
                   if r["parameters"]["harmonic_threshold"][0] == 4.5
                   and r["parameters"]["crest_thr"] == 3.75
                   and r["parameters"]["min_drop_count"] == 0.3)
    assert default["overall_accuracy"] >= 0.75


def test_gradient_tuning_improves_detuned_config():
    """gradient_tune_thresholds recovers a detuned config on the hard
    corpus by SGD instead of grid enumeration (an addition over
    the reference's grid_search.py; decision semantics pinned to
    rain_frame_classifier.py:230-284 via the shared hard evaluator)."""
    from audio_processing_tools_tpu.tuning.gradient import (
        gradient_tune_thresholds,
    )
    from audio_processing_tools_tpu.utils.corpus import make_hard_corpus

    clips, labels, kinds = make_hard_corpus(seed=17, per_class=8)
    detuned = {"new_rain_primary_flux_min": 4.0}  # way too high

    res = gradient_tune_thresholds(
        clips, labels,
        base_params={"sample_rate": FS, "clip_rain_min_frames": 3},
        init=detuned, steps=250, lr=0.05,
    )
    assert res["init_accuracy"] < 0.7, res["init_accuracy"]
    assert res["accuracy"] >= res["init_accuracy"] + 0.15, (
        f"gradient tuning must clearly improve the detuned config: "
        f"{res['init_accuracy']} -> {res['accuracy']} ({res['thresholds']})"
    )
    # the over-tight primary threshold must have been pulled down
    assert res["thresholds"]["new_rain_primary_flux_min"] < 3.5
    # surrogate history is recorded and finite (NOT monotone: the
    # temperature anneal rescales the BCE as gates harden)
    lh = res["loss_history"]
    assert len(lh) == 250 and np.all(np.isfinite(lh))
    # result dict is grid_search-compatible
    assert set(res) >= {"parameters", "overall_accuracy",
                        "tp_classifications", "fn_classifications"}


def test_roe_gradient_tuning_improves_detuned_config():
    """roe_gradient_tune_thresholds recovers a detuned RoE config: the
    soft-relaxed harmonic/peak decision tail (models/roe.py:610-665)
    trains by Adam, scored with the exact hard rule."""
    from audio_processing_tools_tpu.tuning.gradient import (
        roe_gradient_tune_thresholds,
    )

    rng = np.random.default_rng(9)
    n = FS * 4

    def harmonic_rain(drops, fn=520.0):
        x = 0.003 * rng.standard_normal(n)
        k = np.arange(1000)
        ping = sum((1.0 / h) * np.sin(2 * np.pi * fn * h * k / FS)
                   for h in range(1, 6))
        for t0 in rng.integers(0, n - 1200, drops):
            x[t0 : t0 + 1000] += 0.6 * np.exp(-k / 80.0) * ping
        return x

    clips = np.stack([
        harmonic_rain(40), harmonic_rain(15), harmonic_rain(25),
        0.02 * rng.standard_normal(n), 0.004 * rng.standard_normal(n),
        0.01 * rng.standard_normal(n),
    ]).astype(np.float32)
    labels = np.array([True, True, True, False, False, False])

    # strict on BOTH decision paths (the FN combiner otherwise rescues
    # heavy rain through the peak count): misses nearly all rain
    detuned = {"harmonic_threshold": [9.0, 8.0, 7.0, 7.0, 7.0, 7.0],
               "min_drop_count": 2.0, "kurtosis_thr": 8.0,
               "crest_thr": 8.0, "diff_energy_thr": 20.0}
    res = roe_gradient_tune_thresholds(
        clips, labels,
        base_params={"sample_rate": FS, "check_duration": 4},
        init=detuned, steps=250, lr=0.08,
    )
    assert res["init_accuracy"] <= 0.5, res["init_accuracy"]
    assert res["accuracy"] >= res["init_accuracy"] + 0.3, (
        f"RoE gradient tuning must clearly improve: "
        f"{res['init_accuracy']} -> {res['accuracy']} ({res['thresholds']})"
    )
    # strictness must have been relaxed toward detections
    assert res["thresholds"]["min_drop_count"] < 2.0
    assert len(res["thresholds"]["harmonic_threshold"]) == 6
