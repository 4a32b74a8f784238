"""Parameter tuning: grid search, classifier wrappers, native/device bridges.

Parity with the reference ``edge/parameter_tuning/`` package, with a
device-vectorized sweep path: on the device, parameter grids whose knobs are
traced values (thresholds, gates) run as a single ``vmap`` over combos.
"""

from audio_processing_tools_tpu.tuning.grid_search import (
    grid_search,
    grid_search_parallel,
    grid_search_vmapped,
    roe_grid_search_vmapped,
    generate_param_combinations,
    spectral_threshold_features,
)
from audio_processing_tools_tpu.tuning.gradient import (
    gradient_tune_thresholds,
    roe_gradient_tune_thresholds,
)
from audio_processing_tools_tpu.tuning.classification_algo import (
    python_classifier_wrapper,
    c_classifier_wrapper,
    grid_search_classification_wrapper,
)
from audio_processing_tools_tpu.tuning.call_native import (
    rain_detection_algo as rain_detection_algo_native,
    get_version,
    load_native_library,
)
from audio_processing_tools_tpu.tuning.profiles import (
    TUNED_ACCURACY_V1,
    apply_profile,
    available_profiles,
    get_profile,
)

__all__ = [
    "TUNED_ACCURACY_V1",
    "apply_profile",
    "available_profiles",
    "get_profile",
    "grid_search",
    "grid_search_parallel",
    "grid_search_vmapped",
    "roe_grid_search_vmapped",
    "generate_param_combinations",
    "spectral_threshold_features",
    "gradient_tune_thresholds",
    "roe_gradient_tune_thresholds",
    "python_classifier_wrapper",
    "c_classifier_wrapper",
    "grid_search_classification_wrapper",
    "rain_detection_algo_native",
    "get_version",
    "load_native_library",
]
