"""Native C++ classifier: build, ABI, and Python<->native differential tests."""

import numpy as np
import pytest

from audio_processing_tools_tpu.tuning.call_native import (
    load_native_library,
    rain_detection_algo as native_algo,
    get_version,
)
from audio_processing_tools_tpu.tuning.classification_algo import (
    python_classifier_wrapper,
    c_classifier_wrapper,
)

FS = 11162


@pytest.fixture(scope="module")
def lib():
    return load_native_library()


def _harmonic_rain(rng, seconds=10, fn=500.0, drops=80):
    n = FS * seconds
    x = 0.003 * rng.standard_normal(n)
    for t0 in rng.integers(0, n - 1200, drops):
        k = np.arange(1000)
        ping = sum((1.0 / h) * np.sin(2 * np.pi * fn * h * k / FS)
                   for h in range(1, 6))
        x[t0 : t0 + 1000] += 0.6 * np.exp(-k / 80.0) * ping
    return x.astype(np.float32)


def test_version(lib):
    v = get_version(lib)
    assert "apt-native-roe" in v


def test_native_detects_rain(lib, rng):
    rain = _harmonic_rain(rng)
    count, frain = native_algo(
        rain, lib=lib, sample_rate=FS, check_duration=10,
        op_freq_range=[400, 3500], n_freq_range=[400, 700],
        harmonic_threshold=[4.5, 4.0, 3.5, 3.5, 3.5, 3.5], min_drop_count=0.3,
    )
    assert count > 0
    assert 400 <= frain <= 700
    noise = (0.02 * rng.standard_normal(FS * 10)).astype(np.float32)
    count_n, _ = native_algo(
        noise, lib=lib, sample_rate=FS, check_duration=10,
        op_freq_range=[400, 3500], n_freq_range=[400, 700],
        harmonic_threshold=[4.5, 4.0, 3.5, 3.5, 3.5, 3.5], min_drop_count=0.3,
    )
    assert count_n == 0


def test_python_native_differential(lib, rng):
    """The classification_algo.py pattern: same boolean decision from both
    implementations across a small labeled corpus."""
    params = dict(
        sample_rate=FS, check_duration=10, op_freq_range=[400, 3500],
        n_freq_range=[400, 700], harmonic_threshold=[4.5, 4.0, 3.5, 3.5, 3.5, 3.5],
        min_drop_count=0.3,
    )
    clips = [
        ("rain_heavy", _harmonic_rain(rng, drops=100), True),
        ("rain_light", _harmonic_rain(rng, drops=40), True),
        ("noise", (0.02 * rng.standard_normal(FS * 10)).astype(np.float32), False),
        ("quiet", (0.002 * rng.standard_normal(FS * 10)).astype(np.float32), False),
    ]
    for name, x, label in clips:
        py = python_classifier_wrapper(x, **params)
        cc = c_classifier_wrapper(x, **params)
        assert py == cc == label, f"{name}: python={py} native={cc} label={label}"


def test_native_counts_close_to_python(lib, rng):
    """Drop counts should agree closely (float32 JAX vs float64 C++)."""
    params = dict(
        sample_rate=FS, check_duration=10, op_freq_range=[400, 3500],
        n_freq_range=[400, 700], harmonic_threshold=[4.5, 4.0, 3.5, 3.5, 3.5, 3.5],
        min_drop_count=0.3,
    )
    from audio_processing_tools_tpu.models.roe import rain_detection_algo

    x = _harmonic_rain(rng, drops=80)
    drops_py, frain_py, _ = rain_detection_algo(x, **params)
    drops_c, frain_c = native_algo(x, lib=lib, **params)
    assert abs(drops_py - drops_c) <= max(3, 0.2 * drops_py), (drops_py, drops_c)
    assert abs(frain_py - frain_c) < 30, (frain_py, frain_c)


def test_native_bad_input(lib):
    import ctypes

    from audio_processing_tools_tpu.tuning.call_native import (
        evmgr_data_input_t,
        rain_cl_optional_data_t,
        rain_cl_config_param_t,
    )

    inp = evmgr_data_input_t()
    inp.audio_len = 0
    out = rain_cl_optional_data_t()
    cfg = rain_cl_config_param_t()
    r = lib.sample_classifier_to_evaluate_impl(
        ctypes.byref(inp), ctypes.byref(out), ctypes.byref(cfg)
    )
    assert r == -1


def test_python_native_differential_corpus_classes(lib, rng):
    """Three-way agreement on the synthetic corpus's adversarial classes
    (wind gusts, tonal hum): JAX == C++ on every clip."""
    from audio_processing_tools_tpu.utils.corpus import (
        CLASS_IS_RAIN,
        make_labeled_corpus,
    )

    params = dict(
        sample_rate=FS, check_duration=2, op_freq_range=[400, 3500],
        n_freq_range=[400, 700],
        harmonic_threshold=[4.5, 4.0, 3.5, 3.5, 3.5, 3.5],
        min_drop_count=0.3,
    )
    clips, labels, kinds = make_labeled_corpus(
        seed=21, seconds=2.0,
        counts={"noise": 2, "wind": 3, "tonal": 3},
    )
    for x, kind in zip(clips, kinds):
        py = python_classifier_wrapper(x, **params)
        cc = c_classifier_wrapper(x, **params)
        assert py == cc, f"{kind}: python={py} native={cc}"
        # none of these non-rain classes should trip the RoE classifier
        assert py == CLASS_IS_RAIN[kind] == False  # noqa: E712
