"""The examples/ scripts are the user-facing front door; run each one for
real so a signature drift can't ship silently.

Each example self-forces the CPU platform and asserts its own outcome
(detection timing / tuning improvement / accuracy 1.0), so a plain
exit-code check is a behavior check, not just an import smoke.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_example(name, args=(), timeout=900):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name), *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env,
    )
    assert out.returncode == 0, (
        f"{name} failed:\n{out.stderr[-3000:]}\n{out.stdout[-1000:]}"
    )
    return out.stdout


def test_streaming_detect_example():
    stdout = _run_example("streaming_detect.py")
    assert "first rain detected at t=" in stdout
    assert stdout.strip().endswith("OK")


def test_tune_thresholds_example():
    stdout = _run_example("tune_thresholds.py")
    assert "RoE gradient fit" in stdout
    assert stdout.strip().endswith("OK")


def test_end_to_end_example(tmp_path):
    out_dir = str(tmp_path / "demo")
    stdout = _run_example("end_to_end.py", (out_dir,))
    assert "accuracy:" in stdout
    for f in ("overview.png", "classifier_debug.png"):
        assert os.path.exists(os.path.join(out_dir, f)), f
