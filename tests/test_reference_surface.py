"""Reference API-surface audit as a test.

Walks the reference package's top-level public functions/classes and asserts
each name resolves — by actually IMPORTING every module of this package and
``getattr``-ing the name — to a live callable (for reference functions) or
class (for reference classes).  A name that is merely *mentioned* somewhere
(a string, a comment, an unrelated import alias) does not pass; the
previous regex-union audit had exactly that weakness.

The two notebook-converted modules are exempt: their ~80 near-duplicate
internals are deliberately deduplicated into ``models/roe.py``, with the
public entry points (``rain_detection_algo``, wrappers, batch APIs) covered.
"""

import ast
import importlib
import inspect
import os
import pkgutil

import pytest

REF = "/root/reference/audio_processing_tools"
PKG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "audio_processing_tools_tpu")

# notebook-converted modules whose internals are deliberately deduplicated
NOTEBOOK_MODULES = {
    "edge/dsp_rain_detection.py",
    "edge/parameter_tuning/dsp_integ.py",
}
# even there, these public entry points must exist
NOTEBOOK_REQUIRED = {
    "rain_detection_algo",
    "python_classifier_boolean_wrapper",
    "sample_classifier_to_evaluate",
    "analyse_raw_audio_wrapper",
}

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference checkout not available"
)


def _reference_names():
    """{rel_path: [(name, kind)]} with kind in {'function', 'class'}."""
    out = {}
    for root, _, files in os.walk(REF):
        for f in files:
            if not f.endswith(".py"):
                continue
            p = os.path.join(root, f)
            rel = os.path.relpath(p, REF)
            try:
                tree = ast.parse(open(p).read())
            except SyntaxError:
                continue
            names = [
                (n.name, "class" if isinstance(n, ast.ClassDef) else "function")
                for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
                and not n.name.startswith("_")
            ]
            if names:
                out[rel] = names
    return out


def _our_attributes():
    """Import EVERY module of the package; return {name: object} over all
    module attributes (so compat re-exports/aliases count, mentions don't)."""
    import audio_processing_tools_tpu as pkg

    attrs = {}
    failures = {}
    for info in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."):
        try:
            mod = importlib.import_module(info.name)
        except Exception as e:  # a module that cannot import cannot satisfy parity
            failures[info.name] = repr(e)
            continue
        for name, obj in vars(mod).items():
            if name.startswith("_") or inspect.ismodule(obj):
                continue
            attrs.setdefault(name, obj)
    assert not failures, f"package modules failed to import: {failures}"
    return attrs


def _covers(obj, kind: str) -> bool:
    if kind == "class":
        return inspect.isclass(obj)
    # reference functions may be covered by functions, bound methods of a
    # compat object, or callable class instances — but not by plain data
    return callable(obj)


def test_reference_public_surface_is_covered():
    ref = _reference_names()
    ours = _our_attributes()
    assert ref, "reference scan found nothing — wrong path?"
    missing = {}
    for rel, names in sorted(ref.items()):
        if rel in NOTEBOOK_MODULES:
            names = [(n, k) for n, k in names if n in NOTEBOOK_REQUIRED]
        gone = sorted(
            f"{n} ({k})" for n, k in names
            if n not in ours or not _covers(ours[n], k)
        )
        if gone:
            missing[rel] = gone
    assert not missing, f"uncovered reference names: {missing}"


def test_audit_rejects_mentions():
    """The audit must NOT be satisfiable by a mere mention: a name that no
    module actually exposes as a callable/class is reported missing."""
    ours = _our_attributes()
    assert "definitely_not_a_real_function_name" not in ours
    # a known module-level constant is present but does not satisfy a
    # function/class requirement
    assert "DEFAULT_FS" in ours and not _covers(ours["DEFAULT_FS"], "class")


def test_compat_mixin_runs():
    """The RainFrameClassifierMixin compat surface actually classifies."""
    import numpy as np

    from audio_processing_tools_tpu.config import (
        DEFAULT_MODE_BANDS,
        build_noise_config,
    )
    from audio_processing_tools_tpu.edge.rain_frame_classifier import (
        FrameClass,
        RainFrameClassifierMixin,
    )

    class Host(RainFrameClassifierMixin):
        def __init__(self):
            self.cfg = build_noise_config(
                11162, {"detector": {"mode_bands": list(DEFAULT_MODE_BANDS)}}
            )

    rng = np.random.default_rng(0)
    fs = 11162
    x = (0.01 * rng.standard_normal(fs)).astype(np.float32)
    from audio_processing_tools_tpu.ops.stft import stft_power

    P = np.asarray(stft_power(x))
    P_det = 10.0 * np.log10(P + 1e-9)
    frame_class, rain_conf, det_debug, dump = Host()._detect_rain_over_time(
        P_det, input_audio=x, raw_power=P
    )
    assert frame_class.shape == rain_conf.shape
    assert int(np.sum(np.asarray(frame_class) == int(FrameClass.RAIN))) <= 1
    assert "td_crest_factor" in det_debug
