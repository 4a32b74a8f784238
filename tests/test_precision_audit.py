"""Matmul precision audit: every ``dot_general`` in every engine step asks
for ``Precision.HIGHEST``.

On the GPU a float32 matmul without an explicit precision may run in TF32
(about three decimal digits); the CPU backend ignores the request, so no
CPU numerics test can see the difference.  This audit reads the traced
programs instead, so a new ``@`` / ``einsum`` / ``dot`` on a compute path
fails here before it reaches the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from audio_processing_tools_tpu.config import (
    DEFAULT_MODE_BANDS,
    build_noise_config,
)

FS = 11162
HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(value):
    if type(value).__name__ == "ClosedJaxpr":
        yield value.jaxpr
    elif type(value).__name__ == "Jaxpr":
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _dot_precisions(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params.get("precision")
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from _dot_precisions(sub)


def _engine(params):
    from audio_processing_tools_tpu.models.spectral_noise import (
        SpectralNoiseEngine,
    )

    eng = SpectralNoiseEngine(build_noise_config(FS, {
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)}, **params}))
    return lambda x: eng._trace_single(x, FS)


def _classifier():
    return _engine({"classifier_only_mode": True}), (jnp.zeros(FS),)


def _suppressor():
    return _engine({"compute_output_audio": True}), (jnp.zeros(FS),)


def _streaming_chunk():
    from audio_processing_tools_tpu.models.streaming import (
        StreamingRainDetector,
    )

    det = StreamingRainDetector()
    det.setup({"sample_rate": FS,
               "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
               "compute_output_audio": True})
    return det._trace_chunk, (det.init_state(), jnp.zeros(128 * 16))


def _roe():
    from audio_processing_tools_tpu.models.roe import (
        _roe_traced,
        build_roe_config,
    )

    cfg = build_roe_config(sample_rate=FS, check_duration=2)
    return (lambda x: _roe_traced(x, cfg, 2 * FS)), (jnp.zeros(2 * FS),)


def _band_noise():
    from audio_processing_tools_tpu.models.band_noise import (
        BandNoiseEstimatorConfig,
        band_noise_process,
    )

    cfg = BandNoiseEstimatorConfig()
    return (lambda x: band_noise_process(x, cfg)), (jnp.zeros(FS),)


def _mel():
    from audio_processing_tools_tpu.models.mel_classifier import (
        MelRainClassifier,
    )

    mel = MelRainClassifier()
    mel.setup({"sample_rate": FS})
    return mel._traced, (jnp.zeros((2, FS)),)


def _td_features():
    from audio_processing_tools_tpu.ops.features_td import extract_td_features

    def fn(x):
        return extract_td_features(
            x, fs=FS, frame_len=256, hop=128, operating_band=(400.0, 3500.0),
            mode_bands=tuple(DEFAULT_MODE_BANDS), td_input_mode="comb_filter")

    return fn, (jnp.zeros(FS),)


STEPS = {
    "classifier": _classifier, "suppressor": _suppressor,
    "streaming_chunk": _streaming_chunk, "roe": _roe,
    "band_noise": _band_noise, "mel": _mel, "td_features": _td_features,
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_every_matmul_is_highest_precision(name):
    fn, args = STEPS[name]()
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    precisions = list(_dot_precisions(jaxpr))
    loose = [p for p in precisions if p != (HIGHEST, HIGHEST)]
    assert not loose, (
        f"{name}: {len(loose)} of {len(precisions)} dot_general ops without "
        f"Precision.HIGHEST: {loose[:3]}")


def test_audit_sees_a_default_precision_matmul():
    """The walker reaches matmuls nested in scans and flags a default one."""
    def body(c, x):
        return c + jnp.dot(x, x), None

    jaxpr = jax.make_jaxpr(
        lambda xs: jax.lax.scan(body, jnp.zeros(()), xs))(np.ones((3, 4)))
    assert list(_dot_precisions(jaxpr.jaxpr)) == [None]
