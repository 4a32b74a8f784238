"""Fleet backfill CLI: sharded rain classification over a corpus.

The multi-host entry point for BASELINE config #5 ("fleet backfill:
multi-host sharded spectrogram + postprocess/host_analysis aggregation").

With ``--distributed`` every process runs this same command (one process
per card on one host; see :func:`distributed_init_kwargs` for the cards of
each process across hosts): ``jax.distributed.initialize`` wires the
processes, each loads
its stripe of the key list (only the work list is shared; audio bytes never
leave the process that loaded them), and the flagship pipeline runs sharded
over the global ``files`` mesh axis with corpus aggregates all-reduced by
the collectives.  Without it the run uses every local device.

Example:
    python -m audio_processing_tools_tpu.cli.backfill \
        --input-type LocalPath --path ./test_vectors --clip-sec 10 \
        --out results.parquet
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


FS = 11162


def pipeline_params(clip_rain_min_frames: int = 3) -> dict:
    """Engine parameters of the backfill step (flagship detector)."""
    from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS

    return {"sample_rate": FS,
            "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
            "clip_rain_min_frames": clip_rain_min_frames}


_LOOPBACK = ("localhost", "127.0.0.1", "::1")


def distributed_init_kwargs(args) -> dict:
    """Arguments for ``jax.distributed.initialize``.

    Which local cards a process drives:

    * coordinator on ``localhost``: every process shares this host, so each
      takes one card, the one of its process id;
    * ``--local-device-id``: that one card (hand-launched hosts that run
      several processes each);
    * otherwise JAX decides: under a cluster launcher (SLURM, Open MPI, ...)
      each process takes the card of its local rank, and a process launched
      by hand drives every card of its host (one process per host).

    Virtual CPU devices (``--cpu-devices``) are not cards and are left to
    the CPU backend.
    """
    kw = {
        "coordinator_address": args.coordinator,
        "num_processes": args.num_processes,
        "process_id": args.process_id,
    }
    host = (args.coordinator or "").rpartition(":")[0].strip("[]")
    local = args.local_device_id
    if local is None and host in _LOOPBACK:
        local = args.process_id
    if local is not None and not args.cpu_devices:
        kw["local_device_ids"] = [int(local)]
    return kw


def main(argv=None):
    """Run the backfill; returns ``(summary, rows)`` after printing the
    summary line (and writing ``--out`` when given)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input-type", default="LocalPath",
                    choices=["LocalPath", "RemotePath", "CsvInput", "KeyList"])
    ap.add_argument("--path", default=None, help="corpus dir for LocalPath")
    ap.add_argument("--csv", default=None, help="csv for CsvInput")
    ap.add_argument("--clip-sec", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-files", type=int, default=None)
    ap.add_argument("--clip-rain-min-frames", type=int, default=3)
    ap.add_argument("--out", default=None, help="parquet output path")
    ap.add_argument("--distributed", action="store_true",
                    help="call jax.distributed.initialize(), one process per card")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address for --distributed "
                         "(e.g. localhost:12340; default: auto-detect)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="process count for --distributed (default: auto)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's id for --distributed (default: auto)")
    ap.add_argument("--local-device-id", type=int, default=None,
                    help="the one local card this process drives under "
                         "--distributed (default: the process id when the "
                         "coordinator is on localhost, else the launcher's "
                         "local rank or every local card)")
    ap.add_argument("--cpu-devices", type=int, default=None,
                    help="force N virtual CPU devices per process (testing)")
    ap.add_argument("--dsd", action="store_true",
                    help="also emit per-minute DSD vectors (host_analysis)")
    args = ap.parse_args(argv)

    if args.cpu_devices:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_devices}"
        ).strip()

    import jax

    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")
    if args.distributed:
        jax.distributed.initialize(**distributed_init_kwargs(args))
    from audio_processing_tools_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from audio_processing_tools_tpu.io.audio import get_keys, get_input_data
    from audio_processing_tools_tpu.parallel import (
        local_rows,
        make_mesh,
        ShardedRainPipeline,
    )

    keys = get_keys(args.input_type, test_vector_path=args.path,
                    csv_inp_file=args.csv)
    if args.max_files:
        keys = keys[: args.max_files]
    # Every host computes the SAME global batch schedule from the full key
    # list and loads only its stripe of each global batch (DCN only for the
    # work-list; audio bytes never cross hosts). Identical step counts keep
    # the collective program in lockstep across processes.
    pid, nproc = jax.process_index(), jax.process_count()
    print(f"[host {pid}/{nproc}] {len(keys[pid::nproc])} of {len(keys)} keys")

    mesh = make_mesh()
    pipe = ShardedRainPipeline(pipeline_params(args.clip_rain_min_frames),
                               mesh)

    t0 = time.time()
    rows = []
    agg_totals = {"total_rain_frames": 0, "total_rain_clips": 0, "total_clips": 0}
    n_samp = int(FS * args.clip_sec)
    for start in range(0, len(keys), args.batch):
        gkeys = keys[start : start + args.batch]
        my_keys = gkeys[pid::nproc]
        # equal local rows on every host (collective lockstep): pad with
        # silence rows up to the widest stripe
        b_local = -(-len(gkeys) // nproc)
        data = get_input_data(my_keys, args.input_type, FS, args.clip_sec,
                              True, None, None, 2) if my_keys else {}
        file_keys = list(data.keys())
        mat = np.zeros((b_local, n_samp), np.float32)
        for i, fk in enumerate(file_keys):
            v = np.asarray(data[fk]["file_contents"], np.float32)[:n_samp]
            mat[i, : v.shape[0]] = v
        out = pipe.step(mat)
        counts = local_rows(out["per_clip"]["rain_frame_count"])
        is_rain = local_rows(out["per_clip"]["clip_is_rain"])
        frac = local_rows(out["per_clip"]["clip_rain_fraction"])
        for i, fk in enumerate(file_keys):
            rows.append({
                "file_key": fk,
                "rain_actual": data[fk].get("raining"),
                "rain_frame_count": int(counts[i]),
                "clip_is_rain": bool(is_rain[i]),
                "clip_rain_fraction": float(frac[i]),
            })
        # replicated GLOBAL aggregates (all-reduced) — identical on
        # every host; silence-pad rows contribute zero rain frames
        agg = out["aggregates"]
        agg_totals["total_rain_frames"] += int(np.asarray(agg["total_rain_frames"]))
        agg_totals["total_rain_clips"] += int(np.asarray(agg["total_rain_clips"]))
        agg_totals["total_clips"] += len(gkeys)

        if args.dsd:
            from audio_processing_tools_tpu.host_analysis.dsd_device import (
                dsd_minutes_device,
            )

            # device-resident DSD: all local clips' minute vectors in one
            # batched program (host emulator parity-tested)
            vecs_b = dsd_minutes_device(mat, FS)
            for i, fk in enumerate(file_keys):
                rows[-len(file_keys) + i]["dsd_minutes"] = (
                    vecs_b[i].tolist() if vecs_b.shape[1] else []
                )

    wall = time.time() - t0
    summary = {
        **agg_totals,
        "wall_time_sec": round(wall, 3),
        "audio_hours_per_hour": round(
            agg_totals["total_clips"] * args.clip_sec / max(wall, 1e-9), 1
        ),
        "host": pid,
    }
    print(json.dumps(summary))

    if args.out and rows:
        import pandas as pd

        df = pd.DataFrame(rows)
        out_path = args.out if nproc == 1 else f"{args.out}.host{pid}"
        df.to_parquet(out_path, index=False)
        print(f"wrote {len(df)} rows -> {out_path}", file=sys.stderr)
    return summary, rows


if __name__ == "__main__":
    main()
