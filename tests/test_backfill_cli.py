"""Fleet backfill CLI: single-process run + REAL 2-process distributed run.

The multi-host path (BASELINE config #5) is exercised with two actual OS
processes coordinated by ``jax.distributed`` over local Gloo: each host
loads its stripe of every global batch, the pipeline assembles the global
sharded array from process-local rows, collectives all-reduce the corpus
aggregates, and each host writes its own parquet shard.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from audio_processing_tools_tpu.utils.corpus import (
    make_labeled_corpus,
    write_corpus_dir,
)

FS = 11162
SECONDS = 1.0


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    clips, labels, kinds = make_labeled_corpus(
        seed=11, seconds=SECONDS,
        counts={"rain_heavy": 3, "noise": 3, "wind": 1},
    )
    d = tmp_path_factory.mktemp("bf") / "corpus"
    write_corpus_dir(str(d), clips, labels, kinds)
    return d


def _run_cli(extra, tmp_out, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    cmd = [
        sys.executable, "-m", "audio_processing_tools_tpu.cli.backfill",
        "--clip-sec", str(SECONDS), "--batch", "4", "--cpu-devices", "2",
        "--out", str(tmp_out),
    ] + extra
    return subprocess.Popen(
        cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=os.path.dirname(os.path.dirname(__file__)),
    )


def _summary_line(stdout: str) -> dict:
    for line in stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON summary in output:\n{stdout}")


def test_backfill_single_process(corpus_dir, tmp_path):
    out = tmp_path / "res.parquet"
    p = _run_cli(["--input-type", "LocalPath", "--path", str(corpus_dir)], out)
    stdout, stderr = p.communicate(timeout=600)
    assert p.returncode == 0, stderr
    summary = _summary_line(stdout)
    assert summary["total_clips"] == 7
    df = pd.read_parquet(out)
    assert len(df) == 7
    # labels travel through and the detector gets the heavy rain
    rain = df[df["file_key"].str.contains("rain_heavy")]
    assert rain["clip_is_rain"].all()
    assert summary["total_rain_clips"] == int(df["clip_is_rain"].sum())


def _run_distributed(corpus_dir, out, nproc, extra=()):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    common = [
        "--input-type", "LocalPath", "--path", str(corpus_dir),
        "--distributed", "--coordinator", f"localhost:{port}",
        "--num-processes", str(nproc),
    ] + list(extra)
    procs = [
        _run_cli(common + ["--process-id", str(i)], out) for i in range(nproc)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr
    return [_summary_line(o[0]) for o in outs]


@pytest.mark.parametrize("nproc", [2, 4])
def test_backfill_distributed(corpus_dir, tmp_path, nproc):
    """nproc real processes; sharded work list,
    lockstep collectives, disjoint shards, distributed == single-process."""
    out = tmp_path / "dist.parquet"
    summaries = _run_distributed(corpus_dir, out, nproc)

    # replicated global aggregates agree across all hosts
    for k in ("total_clips", "total_rain_frames", "total_rain_clips"):
        assert len({s[k] for s in summaries}) == 1, k
    assert summaries[0]["total_clips"] == 7

    # per-host parquet shards: disjoint stripes covering the corpus
    shards = [pd.read_parquet(f"{out}.host{i}") for i in range(nproc)]
    all_keys = pd.concat(shards)["file_key"]
    assert len(all_keys) == 7 and all_keys.is_unique

    # distributed result == single-process result per file
    ref_out = tmp_path / "ref.parquet"
    p = _run_cli(["--input-type", "LocalPath", "--path", str(corpus_dir)],
                 ref_out)
    stdout, stderr = p.communicate(timeout=600)
    assert p.returncode == 0, stderr
    ref = pd.read_parquet(ref_out).set_index("file_key").sort_index()
    got = pd.concat(shards).set_index("file_key").sort_index()
    pd.testing.assert_series_equal(
        got["rain_frame_count"], ref["rain_frame_count"]
    )
    pd.testing.assert_series_equal(got["clip_is_rain"], ref["clip_is_rain"])


def test_backfill_distributed_dsd(tmp_path):
    """2-process distributed run with --dsd.  61 s clips -> 2 DSD minutes
    each (full + trailing partial); the per-minute integer vectors must be
    EXACTLY equal to the single-process run's, per file."""
    clips, labels, kinds = make_labeled_corpus(
        seed=5, seconds=61.0, counts={"rain_heavy": 1, "noise": 1},
    )
    d = tmp_path / "corpus61"
    write_corpus_dir(str(d), clips, labels, kinds)

    out = tmp_path / "dsd_dist.parquet"
    extra = ["--dsd", "--clip-sec", "61", "--batch", "2"]
    summaries = _run_distributed(d, out, 2, extra)
    assert summaries[0]["total_clips"] == 2

    ref_out = tmp_path / "dsd_ref.parquet"
    p = _run_cli(["--input-type", "LocalPath", "--path", str(d)] + extra,
                 ref_out)
    stdout, stderr = p.communicate(timeout=600)
    assert p.returncode == 0, stderr

    shards = pd.concat(
        [pd.read_parquet(f"{out}.host{i}") for i in range(2)]
    ).set_index("file_key").sort_index()
    ref = pd.read_parquet(ref_out).set_index("file_key").sort_index()
    assert list(shards.index) == list(ref.index)
    for fk in ref.index:
        got_v = np.asarray(list(shards.loc[fk, "dsd_minutes"]), np.float64)
        ref_v = np.asarray(list(ref.loc[fk, "dsd_minutes"]), np.float64)
        assert got_v.shape == ref_v.shape == (2, 100), fk
        np.testing.assert_array_equal(got_v, ref_v, err_msg=fk)
    # the rainy clip's minute-0 loudness histogram is non-empty
    rain_key = [k for k in ref.index if "rain_heavy" in k][0]
    assert np.asarray(list(ref.loc[rain_key, "dsd_minutes"]))[0].any()
