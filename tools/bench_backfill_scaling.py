"""Measure distributed-backfill scaling: files/sec at n in {1, 2, 4} procs.

The fleet story needs a measured scaling table past n=2.  Runs the real
``cli.backfill`` Gloo flow (same pattern as
``tests/test_backfill_cli.py``) over a synthetic corpus at 1/2/4
coordinated processes on the CPU mesh and prints files/sec + parallel
efficiency per n.

Caveat printed with the table: all processes share one host's CPU cores,
so n>1 measures coordination overhead under oversubscription, not
speedup — the number that matters is that aggregate equality holds and
the overhead is bounded.  In a deployment each process owns its own card
and the per-process work is embarrassingly parallel (only the work list
is shared).

Usage: python tools/bench_backfill_scaling.py [--clips 16] [--sec 2.0]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(extra, out, clip_sec):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    cmd = [
        sys.executable, "-m", "audio_processing_tools_tpu.cli.backfill",
        "--clip-sec", str(clip_sec), "--batch", "8", "--cpu-devices", "2",
        "--out", out,
    ] + extra
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO)


def _summary(stdout: str) -> dict:
    for line in stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON summary:\n{stdout}")


def measure(corpus, nproc, clip_sec, nfiles):
    common = ["--input-type", "LocalPath", "--path", corpus]
    if nproc > 1:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        common += ["--distributed", "--coordinator", f"localhost:{port}",
                   "--num-processes", str(nproc)]
    t0 = time.time()
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "r.parquet")
        if nproc == 1:
            procs = [_run_cli(common, out, clip_sec)]
        else:
            procs = [_run_cli(common + ["--process-id", str(i)], out, clip_sec)
                     for i in range(nproc)]
        outs = [p.communicate(timeout=900) for p in procs]
    wall = time.time() - t0
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"n={nproc} rc={p.returncode}:\n{se[-2000:]}")
    summaries = [_summary(so) for so, _ in outs]
    # aggregate equality across hosts (the correctness half of the story)
    for k in ("total_clips", "total_rain_frames", "total_rain_clips"):
        assert len({s[k] for s in summaries}) == 1, k
    # pipeline wall time = max over hosts (launch/compile excluded);
    # end-to-end wall includes python + jax import + compile per process
    pipe_wall = max(s["wall_time_sec"] for s in summaries)
    return {
        "nproc": nproc,
        "files_per_sec": round(nfiles / pipe_wall, 2),
        "pipeline_wall_s": pipe_wall,
        "e2e_wall_s": round(wall, 1),
        "aggregates": {k: summaries[0][k] for k in
                       ("total_clips", "total_rain_frames", "total_rain_clips")},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=16)
    ap.add_argument("--sec", type=float, default=2.0)
    ap.add_argument("--nprocs", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from audio_processing_tools_tpu.utils.corpus import (
        make_labeled_corpus, write_corpus_dir,
    )

    per_kind = max(1, args.clips // 2)
    clips, labels, kinds = make_labeled_corpus(
        seed=11, seconds=args.sec,
        counts={"rain_heavy": per_kind, "noise": args.clips - per_kind},
    )
    rows = []
    with tempfile.TemporaryDirectory() as td:
        corpus = os.path.join(td, "corpus")
        write_corpus_dir(corpus, clips, labels, kinds)
        for n in args.nprocs:
            r = measure(corpus, n, args.sec, len(clips))
            rows.append(r)
            print(f"# n={n}: {r['files_per_sec']} files/s "
                  f"(pipeline {r['pipeline_wall_s']}s, e2e {r['e2e_wall_s']}s)",
                  file=sys.stderr)
    base = rows[0]["files_per_sec"]
    for r in rows:
        r["efficiency_vs_n1"] = round(r["files_per_sec"] / (base * r["nproc"]), 3)
    agg0 = rows[0].pop("aggregates")
    for r in rows[1:]:
        assert r.pop("aggregates") == agg0, "aggregate drift across n"
    print(json.dumps({"clips": len(clips), "clip_sec": args.sec,
                      "host_cores": os.cpu_count(), "rows": rows}))


if __name__ == "__main__":
    main()
