"""Test configuration: force a virtual 8-device CPU mesh.

All unit + sharding tests run on the CPU backend against an 8-device
virtual mesh (``xla_force_host_platform_device_count``).  What needs the
GPU runs in ``chip_smoke.py`` and ``bench.py`` on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Fast/slow tiers: the full suite is ~42 min on the 1-core host; the inner
# loop is `pytest -m "not slow"` (~15 min).  Tests are tiered by measured
# duration (everything >=15 s in a clean full run gets `slow`; re-measure
# with --durations=40 when retiering) and the reference-differential suites
# additionally get `ref` (they execute the actual /root/reference code):
#   pytest -m "not slow"      fast inner loop
#   pytest -m ref             just the reference-differential evidence
#   pytest                    everything (CI / end-of-round)
_SLOW = {
    "test_backfill_cli.py": ("test_backfill_distributed",
                             "test_backfill_single_process"),
    "test_band_noise.py": ("test_chunked_streaming_matches_full",),
    "test_bench_contract.py": ("test_bench_quick_schema",
                               "test_chip_checks_smoke_cpu"),
    "test_compat_shims.py": ("test_dsp_integ_two_pass",),
    "test_dsd_transform.py": ("test_dsp_classification_from_audio_keys"
                              "_fake_db",
                              "test_duty_cycled_device_path_bit_parity"),
    "test_examples.py": ("test_streaming_detect_example",
                         "test_tune_thresholds_example",
                         "test_end_to_end_example"),
    "test_engine_configs.py": ("test_adaptive_q",
                               "test_bandpass_prefilter_and_none",
                               "test_peak_gate_path_compiles",
                               "test_lagged_noise_psd_and_median"),
    "test_framework.py": ("test_orchestrator_per_file_path_matches",),
    "test_native.py": ("test_python_native_differential",
                       "test_python_native_differential_corpus_classes"),
    "test_parallel.py": ("test_sharded_pipeline_roe_model",
                         "test_grid_search_vmapped_sharded_matches_unsharded"),
    "test_peaks_spec.py": ("test_find_peaks_with_filters",),
    "test_properties.py": ("test_sosfilt_linearity_and_chunk_invariance",),
    "test_reference_differential.py": ("test_time_domain_detector",
                                       "test_td_features_match_reference"),
    "test_reference_differential_engine.py": (
        "test_roe_boolean_wrapper_matches_reference",),
    "test_reference_differential_product.py": (
        "test_clip_decisions_identical",),
    "test_roe.py": ("test_roe_batch_matches_single",),
    "test_serve_cli.py": ("test_serve_dynamic_batching",
                          "test_serve_emit_audio_end_to_end",
                          "test_serve_band_noise",
                          "test_serve_connections_are_independent",
                          "test_serve_detects_rain_and_matches_offline",
                          "test_serve_packetization_invariant"),
    "test_spectral_noise.py": ("test_long_clip_60s",
                               "test_feature_dump_sparse_tier"),
    "test_streaming.py": ("test_chunk_invariance",
                          "test_streaming_detects_rain"),
    "test_streaming_audio.py": ("test_chunk_invariance_bitexact",),
    "test_time_domain.py": ("test_confirmer_matches_oracle",),
    "test_tuning.py": ("test_roe_vmapped_sweep_matches_full_engine",
                       "test_roe_gradient_tuning_improves_detuned_config",
                       "test_gradient_tuning_improves_detuned_config"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = os.path.basename(str(item.fspath))
        if fname.startswith("test_reference_differential"):
            item.add_marker(pytest.mark.ref)
        base = item.name.split("[", 1)[0]
        if any(base.startswith(p) for p in _SLOW.get(fname, ())):
            item.add_marker(pytest.mark.slow)


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    # regardless of which other tests ran before it
    return np.random.default_rng(1234)
