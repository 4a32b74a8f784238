"""The driver artifact contract: bench.py must print one valid JSON line.

Runs the real ``python bench.py --quick`` as a subprocess (CPU) and
validates the schema the driver and the docs rely on. A bench.py broken by
refactors would otherwise only be discovered at round end on hardware.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench_json():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--quick"],
        capture_output=True, text=True, timeout=900, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    return json.loads(line)


def test_bench_quick_schema(bench_json):
    j = bench_json
    assert j["unit"] == "audio-hours/hour"
    assert isinstance(j["value"], (int, float)) and j["value"] > 0
    assert j["vs_baseline"] == round(j["value"] / 500.0, 3)
    for key in ("decode_ms", "h2d_ms", "compute_ms", "dispatch_floor_ms",
                "device_audio_sec_per_sec"):
        assert isinstance(j[key], (int, float)), key
    # sub-measurements present (values may be null only if a codec is
    # unavailable; the quick CPU path has all of them)
    for key in ("suppress_value", "mel_value", "stream_value"):
        assert isinstance(j[key], (int, float)) and j[key] > 0, key
    assert j["backend"] in ("cpu", "gpu")
    assert isinstance(j["runs"], list) and len(j["runs"]) >= 1


def test_bench_quick_stream_value_is_realtime_capable(bench_json):
    # 8 quick-mode streams of 2 s chunks: even the CPU smoke must beat
    # realtime (8 streams x 1x) comfortably, else serving claims are hollow
    assert bench_json["stream_value"] > 8 * 2


# ---------------------------------------------------------------------------
# FULL-run contract: bench.py asserts its own artifact before printing, so a
# silent sub-bench regression (e.g. a missing ALAC shim nulling alac_value)
# FAILS the run instead of producing a "valid" JSON.  The validator is
# exercised here directly.


def _bench_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _complete_artifact():
    vals = {k: 1.0 for k in (
        "value", "mulaw_value", "p50_file_latency_ms", "decode_ms", "h2d_ms",
        "compute_ms",
        "device_loop_audio_sec_per_sec", "hbm_program_bytes",
        "alac_value", "suppress_value", "suppress_p50_ms", "mel_value",
        "stream_value", "stream_p50_ms", "stream_p99_ms",
        "stream_unbatched_value", "stream_audio_value",
        "roe_loop_audio_sec_per_sec", "band_noise_loop_audio_sec_per_sec",
        "stream_lowlat_p50_ms", "stream_lowlat_p99_ms",
        "engine_cpu_accel_frame_agreement", "suppress_cpu_accel_y_rel_dev",
        "band_noise_cpu_accel_frame_agreement", "spectrogram_vs_numpy_f64_rel",
    )}
    vals["backend"] = "gpu"
    vals["chip_checks"] = {"ok": True, "failures": []}
    return vals


def test_full_artifact_validator_accepts_complete():
    _bench_module().validate_full_artifact(_complete_artifact())


@pytest.mark.parametrize("broken", [
    "alac_value", "suppress_value", "mel_value", "stream_value",
    "device_loop_audio_sec_per_sec", "hbm_program_bytes",
    "engine_cpu_accel_frame_agreement", "band_noise_cpu_accel_frame_agreement",
    "roe_loop_audio_sec_per_sec", "band_noise_loop_audio_sec_per_sec",
    "stream_lowlat_p50_ms", "stream_lowlat_p99_ms",
])
def test_full_artifact_validator_rejects_null_field(broken):
    bench = _bench_module()
    art = _complete_artifact()
    art[broken] = None
    with pytest.raises(AssertionError, match=broken):
        bench.validate_full_artifact(art)


def test_full_artifact_validator_requires_tpu_checks():
    """On any accelerator the on-card verification suite is part of the
    number of record: a missing sub-object or any failed bound sinks the
    artifact."""
    bench = _bench_module()
    art = _complete_artifact()
    del art["chip_checks"]
    with pytest.raises(AssertionError, match="chip_checks"):
        bench.validate_full_artifact(art)
    art["chip_checks"] = {"ok": False,
                          "failures": ["roe_drop_count_abs_diff=1"]}
    with pytest.raises(AssertionError, match="on-card verification failed"):
        bench.validate_full_artifact(art)
    # CPU artifacts (e.g. --quick promoted by mistake) don't carry it
    art2 = {k: v for k, v in _complete_artifact().items()
            if k not in ("chip_checks",)}
    art2["backend"] = "cpu"
    bench.validate_full_artifact(art2)


def test_full_artifact_validator_no_subbench_optout():
    bench = _bench_module()
    art = _complete_artifact()
    art["alac_value"] = None       # relaxed only under the explicit opt-out
    bench.validate_full_artifact(art, subbench=False)
    with pytest.raises(AssertionError):
        bench.validate_full_artifact(art)


def test_chip_checks_smoke_cpu():
    """The on-card verification script is part of the bench's number of
    record (bench.py embeds run_checks() on an accelerator); its *logic*
    must stay runnable — a drifted import or check body would otherwise
    only be discovered on the card."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "chip_checks.py"),
         "--smoke-cpu"],
        capture_output=True, text=True, timeout=900, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    j = json.loads(out.stdout.strip().splitlines()[-1])
    assert j["ok"] is True and j["failures"] == []
    # the fields bench.py's validator relies on
    assert j["backend"] == "cpu"
    assert "sosfilt_accel_vs_scipy_rel" in j
    for key in _bench_module().ACCEL_RUN_REQUIRED:
        assert key in j, key
