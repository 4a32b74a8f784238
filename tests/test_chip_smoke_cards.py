"""``chip_smoke.py --cards 4``'s phase rehearsed on the 8-device virtual
CPU mesh: every engine family sharded against one device, the
sequence-parallel and 2-D meshes, and a 2-process distributed backfill
against a single-process run."""

import importlib.util
import os

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_cards_on_cpu_mesh(tmp_path):
    devices = jax.devices()[:8]
    assert len(devices) == 8
    res = _chip_smoke().phase_cards(devices, str(tmp_path), full=False,
                                    backfill_clips=6, seconds=1.0, batch=4,
                                    nproc=2, cpu_devices=1)
    assert res["devices"] == 8
    assert res["seq_dev"] < 1e-5 and res["mesh_2d"] == "2x4"
    assert res["distributed_backfill"]["processes"] == 2
    assert res["distributed_backfill"]["total_clips"] == 6
