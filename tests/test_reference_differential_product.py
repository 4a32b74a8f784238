"""Corpus-wide PRODUCT-level parity: the reference makes the same calls.

The module/engine differential suites prove >=98% frame agreement per clip;
this suite closes the last tier: every clip of BOTH
labeled corpora (24-clip easy + 32-clip hard) runs through the REFERENCE
``RainDetectorProcessor.run`` clip aggregation
(``edge/rain_signal_processor.py:1205-1344``, executed via the librosa
mini-shim in ``tests/ref_shims.py``) and through this framework's
device-batched product path, and the clip-level outputs are pinned EQUAL:

  * ``clip_is_rain`` — identical on all 56 clips (no divergence table
    needed: measured agreement is exact),
  * ``rain_frame_count`` — identical integer per clip,
  * confusion matrices vs ground truth — identical,
  * ``clip_rain_conf`` / ``clip_rain_fraction`` — equal to float tolerance.

Skipped automatically when /root/reference is not mounted.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

REF_ROOT = Path("/root/reference")
pytestmark = pytest.mark.skipif(
    not REF_ROOT.is_dir(), reason="reference repo not mounted"
)
if REF_ROOT.is_dir():
    if str(REF_ROOT) not in sys.path:
        sys.path.insert(0, str(REF_ROOT))
    from tests import ref_shims  # noqa: F401  (importing installs the shims)

ref_rsp = pytest.importorskip("audio_processing_tools.edge.rain_signal_processor")

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS  # noqa: E402
from audio_processing_tools_tpu.evaluation import evaluate_corpus  # noqa: E402
from audio_processing_tools_tpu.models.spectral_noise import (  # noqa: E402
    RainDetectorProcessor,
)
from audio_processing_tools_tpu.utils.corpus import (  # noqa: E402
    make_hard_corpus,
    make_labeled_corpus,
)

FS = 11162
# The product configuration: the same params the accuracy-regression suite
# (and the reference's corpus harness) runs clips with.
PARAMS = {
    "sample_rate": FS,
    "detector": {"mode_bands": [list(b) for b in DEFAULT_MODE_BANDS]},
    "clip_rain_min_frames": 3,
}


def _run_both(clips):
    """(reference metrics list, framework metrics list) for a clip stack."""
    ref_proc = ref_rsp.RainDetectorProcessor()
    ref_metrics = [ref_proc.run(c, dict(PARAMS))[0] for c in clips]
    got_pairs = RainDetectorProcessor().run_batch(np.stack(clips), dict(PARAMS))
    return ref_metrics, [m for m, _state in got_pairs]


@pytest.fixture(scope="module")
def easy():
    clips, labels, kinds = make_labeled_corpus(seed=7, seconds=2.0)
    ref_m, got_m = _run_both(clips)
    return ref_m, got_m, labels, kinds


@pytest.fixture(scope="module")
def hard():
    clips, labels, kinds = make_hard_corpus(seed=17, per_class=8)
    ref_m, got_m = _run_both(clips)
    return ref_m, got_m, labels, kinds


def _col(metrics, key):
    return np.array([m[key] for m in metrics])


@pytest.mark.parametrize("corpus", ["easy", "hard"])
def test_clip_decisions_identical(corpus, request):
    """Every clip decision the product makes is the decision the reference
    makes — measured EXACT on all 56 clips, so it is pinned exact (any
    future divergence must come with a root cause, not a tolerance bump)."""
    ref_m, got_m, _labels, kinds = request.getfixturevalue(corpus)
    ref_dec = _col(ref_m, "clip_is_rain")
    got_dec = _col(got_m, "clip_is_rain")
    diverged = [
        f"clip {i} ({kinds[i]}): ref={ref_dec[i]} got={got_dec[i]}"
        for i in np.flatnonzero(ref_dec != got_dec)
    ]
    assert not diverged, "product decisions diverged:\n" + "\n".join(diverged)


@pytest.mark.parametrize("corpus", ["easy", "hard"])
def test_rain_frame_counts_identical(corpus, request):
    """Not just the boolean: the integer rain-frame count behind it is
    identical per clip (frame classes agree everywhere it matters)."""
    ref_m, got_m, _labels, _kinds = request.getfixturevalue(corpus)
    np.testing.assert_array_equal(
        _col(got_m, "rain_frame_count"), _col(ref_m, "rain_frame_count")
    )


@pytest.mark.parametrize("corpus", ["easy", "hard"])
def test_confusion_matrices_equal(corpus, request):
    """The headline claim: reference and framework produce the SAME
    confusion matrix against ground truth on each corpus."""
    import pandas as pd

    ref_m, got_m, labels, _kinds = request.getfixturevalue(corpus)

    def confusion(metrics):
        df = pd.DataFrame({
            "pred": _col(metrics, "clip_is_rain").astype(bool),
            "rain_actual": np.asarray(labels, bool),
        })
        return evaluate_corpus(df, predicted_col="pred",
                               actual_col="rain_actual")

    assert confusion(got_m) == confusion(ref_m)


@pytest.mark.parametrize("corpus", ["easy", "hard"])
def test_clip_confidences_match(corpus, request):
    """clip_rain_conf / clip_rain_fraction agree to float tolerance (the
    fraction is exact — same frame counts over the same frame totals; the
    confidence folds float32 medians, so it gets an epsilon)."""
    ref_m, got_m, _labels, _kinds = request.getfixturevalue(corpus)
    np.testing.assert_allclose(
        _col(got_m, "clip_rain_fraction").astype(np.float64),
        _col(ref_m, "clip_rain_fraction").astype(np.float64),
        atol=1e-9,
    )
    np.testing.assert_allclose(
        _col(got_m, "clip_rain_conf").astype(np.float64),
        _col(ref_m, "clip_rain_conf").astype(np.float64),
        atol=5e-3,
    )
