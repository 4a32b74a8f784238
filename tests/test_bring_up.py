"""What running on a GPU host needs of the main path: nothing beyond numpy,
scipy and JAX; one fixed compile-cache directory; one card per process in
the distributed backfill."""

import argparse
import os
import subprocess
import sys

import jax
import pytest

from audio_processing_tools_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAIN_PATH = (
    "audio_processing_tools_tpu.cli.backfill",
    "audio_processing_tools_tpu.cli.serve",
    "audio_processing_tools_tpu.parallel",
    "audio_processing_tools_tpu.models.spectral_noise",
    "audio_processing_tools_tpu.models.streaming",
    "audio_processing_tools_tpu.models.roe",
    "audio_processing_tools_tpu.models.band_noise",
    "audio_processing_tools_tpu.models.mel_classifier",
    "audio_processing_tools_tpu.io.audio",
    "audio_processing_tools_tpu.io.mark",
    "audio_processing_tools_tpu.utils.corpus",
    "audio_processing_tools_tpu.host_analysis.dsd_device",
)

_BLOCKER = """
import importlib.abc, sys
BLOCKED = ("pandas", "pyarrow", "matplotlib")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked optional package: " + name)
sys.meta_path.insert(0, Block())
import importlib
for mod in MODULES:
    importlib.import_module(mod)
print("IMPORTED", len(MODULES))
"""


def test_main_path_imports_without_optional_packages():
    code = f"MODULES = {MAIN_PATH!r}\n" + _BLOCKER
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"IMPORTED {len(MAIN_PATH)}" in r.stdout


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself: nothing is set in code
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
            got = compile_cache.enable_compile_cache()
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            with open(os.path.join(REPO, ".gitignore")) as f:
                assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _args(**kw):
    base = dict(coordinator="localhost:1234", num_processes=4,
                process_id=None, local_device_id=None, cpu_devices=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_distributed_backfill_one_local_device_per_process():
    from audio_processing_tools_tpu.cli.backfill import (
        distributed_init_kwargs,
    )

    for pid in range(4):
        kw = distributed_init_kwargs(_args(process_id=pid))
        assert kw["local_device_ids"] == [pid]
        assert kw["process_id"] == pid and kw["num_processes"] == 4
    assert distributed_init_kwargs(_args(
        coordinator="127.0.0.1:1234", process_id=2))["local_device_ids"] == [2]
    # virtual CPU devices are not cards
    assert "local_device_ids" not in distributed_init_kwargs(
        _args(process_id=1, cpu_devices=2))
    assert "local_device_ids" not in distributed_init_kwargs(_args())


@pytest.mark.parametrize("process_id,local_device_id,want", [
    (5, None, None),   # one process per host: every local card
    (5, 1, [1]),       # several processes per host, launched by hand
    (None, None, None),  # cluster launcher: JAX takes the local rank
], ids=["one_per_host", "explicit_card", "auto_detect"])
def test_distributed_backfill_across_hosts(process_id, local_device_id, want):
    from audio_processing_tools_tpu.cli.backfill import (
        distributed_init_kwargs,
    )

    kw = distributed_init_kwargs(_args(
        coordinator="node0.cluster:1234", num_processes=8,
        process_id=process_id, local_device_id=local_device_id))
    assert kw.get("local_device_ids") == want
    assert kw["coordinator_address"] == "node0.cluster:1234"
