"""Installable-wheel round trip for the native layer.

The reference ships its classifier dylib inside the wheel
(``pyproject.toml:49-50``, ``MANIFEST.in:1``); here the packaged
``audio_processing_tools_tpu/native/`` directory carries the prebuilt
``.so``s plus the C++ sources + Makefile.  This test builds a real wheel,
installs it into a temp prefix, and — in a subprocess whose import path
does NOT contain the repo checkout — loads the native RoE classifier and
the fast ALAC decoder from the installed tree and runs both.
"""

import os
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    out = tmp_path_factory.mktemp("wheel")
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "-w", str(out), str(REPO)],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    wheels = list(out.glob("audio_processing_tools_tpu-*.whl"))
    assert len(wheels) == 1, wheels
    return wheels[0]


def test_wheel_contains_native_layer(wheel):
    names = zipfile.ZipFile(wheel).namelist()
    native = sorted(n for n in names
                    if n.startswith("audio_processing_tools_tpu/native/"))
    base = {Path(n).name for n in native}
    # prebuilt libraries (the reference's dylib analogue) AND the
    # from-source fallback must both ship
    assert "libdsp_native.so" in base, native
    assert "libalac_fast.so" in base, native
    assert "roe_classifier.cpp" in base and "alac_decode.cpp" in base, native
    assert "Makefile" in base, native


def test_installed_wheel_loads_native_libraries(wheel, tmp_path):
    target = tmp_path / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps",
         "--target", str(target), str(wheel)],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert (target / "audio_processing_tools_tpu" / "native"
            / "libdsp_native.so").exists()

    probe = r"""
import sys
assert {target!r} in sys.path[:3], sys.path[:4]
import audio_processing_tools_tpu as apt
assert apt.__file__.startswith({target!r}), apt.__file__

import numpy as np
from audio_processing_tools_tpu.tuning.call_native import (
    load_native_library, rain_detection_algo, get_version,
)
lib = load_native_library()
count, mean_freq = rain_detection_algo(
    (np.random.default_rng(0).standard_normal(11162 * 2) * 0.01
     ).astype(np.float32),
    lib=lib,
)
assert isinstance(count, int)
assert get_version(lib)

from audio_processing_tools_tpu.io.alac_native import (
    have_fast_decoder, load_alac_fast,
)
assert have_fast_decoder()
load_alac_fast()
print("INSTALLED_NATIVE_OK", count)
"""
    env = dict(os.environ)
    # only the installed tree on the path, so the repo checkout cannot
    # shadow the wheel
    env["PYTHONPATH"] = str(target)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c", probe.replace("{target!r}", repr(str(target)))],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(tmp_path),  # NOT the repo root
    )
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    assert "INSTALLED_NATIVE_OK" in r.stdout
