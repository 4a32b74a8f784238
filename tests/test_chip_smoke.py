"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU, and each of
its one-card phases runs at a tiny size with the CPU on both sides of every
comparison.  At full size the phases run only on the card."""

import importlib.util
import os

import numpy as np
import pytest
from jax import monitoring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_main_refuses_cpu_before_compiling(chip_smoke, capsys, monkeypatch):
    # main() narrows the visible cards to one; keep that to this test
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    compiles = []

    def on_duration(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles.append(duration)

    monitoring.register_event_duration_secs_listener(on_duration)
    try:
        rc = chip_smoke.main([])
    finally:
        monitoring.unregister_event_duration_listener(on_duration)
    out = capsys.readouterr()
    assert rc != 0
    assert compiles == []
    assert '"ok"' not in out.out
    assert "not a GPU" in out.err


def test_alac_clip_decodes_to_tiled_golden(chip_smoke, tmp_path):
    from audio_processing_tools_tpu.io.mark import parse_mark_audio_file

    path = chip_smoke.write_alac_clip(str(tmp_path), 10.0)
    with open(path, "rb") as f:
        pcm, meta = parse_mark_audio_file(f.read())
    golden = np.load(os.path.join(REPO, "tests", "fixtures",
                                  "alac_golden_pcm.npy"))
    assert meta["format"] == "alac"
    np.testing.assert_array_equal(pcm, np.tile(golden, 20))


def test_phase_backfill_tiny(chip_smoke, tmp_path):
    res = chip_smoke.phase_backfill(str(tmp_path), n_clips=10, seconds=1.0,
                                    batch=4, n_check=4)
    assert res["files"] == 11
    assert res["checked_clips"] == 4
    assert res["frame_agreement"] == 1.0
    assert res["accuracy"] == res["accuracy_cpu"]
    assert res["rain_clips"] > 0


def test_phase_serve_tiny(chip_smoke, tmp_path):
    res = chip_smoke.phase_serve(str(tmp_path), n_streams=4, n_mulaw=1,
                                 seconds=1.0, packet=2048)
    assert res["batched_calls"] >= 1
    assert res["fallback_groups"] == 0
    assert res["rain_frames"] > 0
    assert res["emit_audio_rel_dev"] < 1e-3


def test_phase_compile_tiny(chip_smoke):
    from audio_processing_tools_tpu.utils import compile_cache

    res = chip_smoke.phase_compile(batch=4, seconds=1.0, require_hit=False)
    expected = (os.environ.get(compile_cache.ENV_VAR)
                or compile_cache.DEFAULT_CACHE_DIR)
    assert res["cache_dir"] == expected
    assert res["first_call_s"] > 0 and res["warm_call_s"] > 0


def test_phase_numerics_smoke(chip_smoke):
    res = chip_smoke.phase_numerics(smoke=True)
    assert res["ok"] and res["backend"] == "cpu"
    assert "spectrogram_vs_numpy_f64_rel" in res
