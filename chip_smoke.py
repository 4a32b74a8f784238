#!/usr/bin/env python3
"""Smoke run of the system's main paths on the GPU, through the entry points
a user calls, each compared with the plain CPU reference.

One card (``python chip_smoke.py``), in order:

  a. fleet backfill: 512 synthetic 10 s MARK clips of the five labelled
     classes plus one 10 s ALAC clip, through ``cli/backfill.py::main`` at
     ``--batch 128``; per-clip results against the same
     ``ShardedRainPipeline`` step on the CPU backend, aggregates against
     the per-clip rows, accuracy against the CPU run's;
  b. live serving: 16 concurrent socket streams (14 int16, 2 mu-law) into
     ``cli/serve.py::make_server(batch_window_ms=5)`` and one
     ``--emit-audio`` stream, against offline CPU ``StreamingRainDetector``
     runs of what the server received;
  c. on-card numerics: ``tools/chip_checks.py`` (every engine against the
     CPU backend, filters against scipy, the spectrogram against float64);
  d. compile cache: the engine step's first and warm call.

Four cards (``python chip_smoke.py --cards 4``): only the multi-card phase,
``__graft_entry__.multichip_checks`` over the cards (every engine family
sharded over ``files`` against one card, a 1-hour recording sharded over
time, the 2x2 ``files x seq`` mesh) and ``cli.backfill --distributed`` with
one process per card against a single-process run.

The script refuses to run anywhere but on a GPU backend.  Every phase's
failure fails the run; only a run in which all passed prints, as its last
line, ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
FS = 11162
CARD = "card unknown"


def log(msg: str) -> None:
    print(msg, flush=True)


class CacheEvents:
    """Counts JAX persistent-cache hits and writes while active."""

    HIT = "/jax/compilation_cache/cache_hits"
    WRITE = "/jax/compilation_cache/cache_misses"  # recorded on write

    def __enter__(self):
        from jax import monitoring

        self.hits = self.writes = 0
        monitoring.register_event_listener(self._count)
        return self

    def _count(self, event, **_):
        self.hits += event == self.HIT
        self.writes += event == self.WRITE

    def __exit__(self, *exc):
        from jax import monitoring

        monitoring.unregister_event_listener(self._count)


def labelled_corpus(n: int, seconds: float, seed: int):
    """``n`` synthetic clips spread evenly over the five labelled classes:
    ``(clips, labels, kinds)`` from ``utils/corpus.py``."""
    from audio_processing_tools_tpu.utils.corpus import (
        CLIP_CLASSES,
        make_labeled_corpus,
    )

    k = len(CLIP_CLASSES)
    counts = {c: n // k + (i < n % k) for i, c in enumerate(CLIP_CLASSES)}
    return make_labeled_corpus(seed, seconds=seconds, counts=counts)


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def build_native() -> dict:
    """Build the native libraries from the committed sources; report which
    ALAC routes can run.  A failed build fails the phase: only the libavcodec
    shim may be missing, and the Makefile skips it where ffmpeg's libraries
    are absent."""
    r = subprocess.run(
        ["make", "-B", "-C",
         os.path.join(REPO, "audio_processing_tools_tpu", "native")],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"make failed (rc {r.returncode}): {r.stderr[-2000:]}"
    from audio_processing_tools_tpu.io.alac_native import (
        have_alac_shim,
        have_fast_decoder,
    )
    from audio_processing_tools_tpu.tuning.call_native import (
        load_native_library,
    )

    load_native_library()
    assert have_fast_decoder(), "libalac_fast.so did not load"
    return {"make_rc": r.returncode, "alac_fast": True,
            "alac_libavcodec": have_alac_shim()}


# ---------------------------------------------------------------------------
# a. fleet backfill
# ---------------------------------------------------------------------------


def write_alac_clip(out_dir: str, seconds: float) -> str:
    """A ``seconds``-long ALAC MARK file: the packets of
    ``tests/fixtures/alac_golden.bin`` (0.5 s) repeated, which decodes to
    the tiled golden PCM (no ALAC encoder is needed)."""
    from audio_processing_tools_tpu.utils.corpus import repeat_alac_mark

    with open(os.path.join(REPO, "tests", "fixtures", "alac_golden.bin"),
              "rb") as f:
        data = f.read()
    reps = int(round(seconds / 0.5))
    path = os.path.join(out_dir, "alac_golden_x%d.bin" % reps)
    with open(path, "wb") as f:
        f.write(repeat_alac_mark(data, reps))
    return path


def phase_backfill(workdir: str, *, n_clips: int = 512, seconds: float = 10.0,
                   batch: int = 128, n_check: int = 32, seed: int = 3) -> dict:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from audio_processing_tools_tpu.cli import backfill
    from audio_processing_tools_tpu.io.alac_native import have_alac_shim
    from audio_processing_tools_tpu.io.audio import get_input_data
    from audio_processing_tools_tpu.io.mark import parse_mark_audio_file
    from audio_processing_tools_tpu.parallel import ShardedRainPipeline
    from audio_processing_tools_tpu.utils.corpus import write_corpus_dir

    clips, labels, kinds = labelled_corpus(n_clips, seconds, seed)
    corpus = os.path.join(workdir, "corpus")
    write_corpus_dir(corpus, clips, labels, kinds)
    del clips
    alac_path = write_alac_clip(corpus, seconds)

    # the ALAC clip decodes through the fast native decoder (the backfill's
    # route); where the libavcodec shim was built, through it too
    with open(alac_path, "rb") as f:
        alac_bytes = f.read()
    pcm_fast = parse_mark_audio_file(alac_bytes)[0]
    assert pcm_fast.size == int(FS * seconds), pcm_fast.size
    if have_alac_shim():
        os.environ["APT_ALAC_DECODER"] = "avcodec"
        try:
            pcm_av = parse_mark_audio_file(alac_bytes)[0]
        finally:
            os.environ.pop("APT_ALAC_DECODER")
        assert np.array_equal(pcm_fast, pcm_av), "ALAC routes disagree"
        log("  alac: fast decoder and libavcodec route ran, equal")
    else:
        log("  alac: fast decoder ran; libavcodec route did not run "
            "(libalac_shim.so not built: no libavcodec on this host)")

    t0 = time.perf_counter()
    with CacheEvents() as cache:
        summary, rows = backfill.main([
            "--input-type", "LocalPath", "--path", corpus,
            "--clip-sec", str(seconds), "--batch", str(batch)])
    wall = time.perf_counter() - t0
    assert len(rows) == n_clips + 1, len(rows)

    # replicated aggregates == sums of the per-clip rows
    assert summary["total_clips"] == len(rows)
    assert summary["total_rain_frames"] == sum(r["rain_frame_count"] for r in rows)
    assert summary["total_rain_clips"] == sum(r["clip_is_rain"] for r in rows)

    # the same step jitted for the CPU backend, over the same decoded audio
    keys = [{"source_file": r["file_key"], "raining": r["rain_actual"]}
            for r in rows]
    cpu_pipe = ShardedRainPipeline(
        backfill.pipeline_params(),
        Mesh(np.array(jax.devices("cpu")[:1]), ("files",)))
    n_samp = int(FS * seconds)
    cpu_counts, cpu_rain = [], []
    for s in range(0, len(keys), batch):
        data = get_input_data(keys[s: s + batch], "LocalPath", FS, seconds,
                              True, None, None, 2)
        mat = np.zeros((batch, n_samp), np.float32)
        for i, k in enumerate(keys[s: s + batch]):
            mat[i] = data[k["source_file"]]["file_contents"]
        out = cpu_pipe.step(mat)["per_clip"]
        m = min(batch, len(keys) - s)
        cpu_counts.append(np.asarray(out["rain_frame_count"])[:m])
        cpu_rain.append(np.asarray(out["clip_is_rain"])[:m])
    cpu_counts = np.concatenate(cpu_counts)
    cpu_rain = np.concatenate(cpu_rain)
    counts_acc = np.array([r["rain_frame_count"] for r in rows])
    rain_acc = np.array([r["clip_is_rain"] for r in rows])

    # n_check clips: the ALAC clip and n_check - 1 spread over the rest
    labelled = np.array([r["file_key"] != alac_path for r in rows])
    rest = np.flatnonzero(labelled)
    check = sorted(set(rest[np.linspace(0, rest.size - 1, n_check - 1)
                            .astype(int)]) | set(np.flatnonzero(~labelled)))
    frame_agreement = float((counts_acc[check] == cpu_counts[check]).mean())
    assert frame_agreement == 1.0, (
        f"rain_frame_count agreement {frame_agreement} on {len(check)} clips")
    assert np.array_equal(rain_acc[check], cpu_rain[check]), "clip decisions"

    truth = np.array([bool(r["rain_actual"]) for r in rows])
    acc = float((rain_acc == truth)[labelled].mean())
    acc_cpu = float((cpu_rain == truth)[labelled].mean())
    assert acc == acc_cpu, f"accuracy {acc} vs CPU {acc_cpu}"
    res = {
        "files": len(rows), "wall_s": wall, "files_per_s": len(rows) / wall,
        "checked_clips": len(check), "frame_agreement": frame_agreement,
        "accuracy": acc, "accuracy_cpu": acc_cpu,
        "all_clip_decisions_equal": bool(np.array_equal(rain_acc, cpu_rain)),
        "rain_clips": summary["total_rain_clips"],
        "cache_hits": cache.hits, "cache_writes": cache.writes,
    }
    log(f"  backfill: {len(rows)} files in {wall:.3f} s = "
        f"{res['files_per_s']:.1f} files/s, compiles included "
        f"(persistent cache: {cache.hits} hits, {cache.writes} writes) "
        f"[{CARD}]")
    return res


# ---------------------------------------------------------------------------
# b. live serving
# ---------------------------------------------------------------------------


def _server_input(path: str, wire: str):
    """The float32 samples the server hands its detector for ``path`` sent
    over ``wire`` (the client's int16 quantisation and, for mu-law, the
    companding round trip)."""
    import numpy as np

    from audio_processing_tools_tpu.cli import serve
    from audio_processing_tools_tpu.ops.wire import mulaw_decode_np, mulaw_encode

    x = serve._load_audio_float(path)
    pcm = np.clip(x * serve.INT16_SCALE, -32768, 32767).astype("<i2")
    if wire == "mulaw":
        return mulaw_decode_np(mulaw_encode(pcm)) * np.float32(
            32768.0 / serve.INT16_SCALE)
    return pcm.astype(np.float32) / np.float32(serve.INT16_SCALE)


def _start(srv) -> None:
    threading.Thread(target=srv.serve_forever, daemon=True).start()


def phase_serve(workdir: str, *, n_streams: int = 16, n_mulaw: int = 2,
                seconds: float = 10.0, packet: int = 8192,
                seed: int = 5) -> dict:
    import jax
    import numpy as np

    from audio_processing_tools_tpu.cli import serve
    from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
    from audio_processing_tools_tpu.models.frame_classifier import FrameClass
    from audio_processing_tools_tpu.models.streaming import (
        StreamingRainDetector,
    )

    clips, _, kinds = labelled_corpus(n_streams, seconds, seed)
    paths = []
    for i, c in enumerate(clips):
        p = os.path.join(workdir, f"stream{i:02d}_{kinds[i]}.i16")
        (np.clip(c, -1, 1) * 32767).astype("<i2").tofile(p)
        paths.append(p)
    wires = ["mulaw" if i < n_mulaw else "int16" for i in range(n_streams)]
    params = {"sample_rate": FS,
              "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)}}

    def run_streams(srv, jobs):
        port = srv.server_address[1]
        replies = [None] * len(jobs)
        errors = []
        go = threading.Barrier(len(jobs))

        def client(i, path, wire):
            try:
                go.wait()
                replies[i] = list(serve.stream_file(
                    path, port=port, packet_samples=packet, wire=wire))
            except Exception as e:  # surfaced below
                errors.append(f"stream {i}: {e!r}")

        threads = [threading.Thread(target=client, args=(i, p, w))
                   for i, (p, w) in enumerate(jobs)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        srv.shutdown()
        srv.server_close()
        assert not errors, errors
        return replies, wall

    srv = serve.make_server(params, port=0, batch_window_ms=5)
    _start(srv)
    replies, wall = run_streams(srv, list(zip(paths, wires)))
    batcher = srv.batcher
    assert batcher.batched_calls >= 1, "the batcher made no batched call"
    assert batcher.fallback_groups == 0, (
        f"{batcher.fallback_groups} batched calls fell back")

    # offline CPU runs of what the server received
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        det = StreamingRainDetector()
        det.setup(params)
        for i, (path, wire) in enumerate(zip(paths, wires)):
            x = _server_input(path, wire)
            out = det.process_stream(x)
            want = int(np.sum(out["frame_class"] == int(FrameClass.RAIN)))
            got = replies[i][-1]
            assert got.get("eos"), got
            assert got["rain_frames"] == want, (
                f"stream {i} ({wire}): server {got['rain_frames']} rain "
                f"frames, offline CPU {want}")
    total_rain = sum(r[-1]["rain_frames"] for r in replies)

    # one --emit-audio stream: the denoised audio against the CPU run
    srv_a = serve.make_server(params, port=0, batch_window_ms=5,
                              emit_audio=True)
    _start(srv_a)
    a_replies, a_wall = run_streams(srv_a, [(paths[-1], "int16")])
    audio = np.concatenate([r["audio"] for r in a_replies[0] if "audio" in r])
    with jax.default_device(cpu):
        det_a = StreamingRainDetector()
        det_a.setup({**params, "compute_output_audio": True})
        x = _server_input(paths[-1], "int16")
        x = x[: x.size // det_a.cfg.hop * det_a.cfg.hop]
        state = det_a.init_state()
        ys = []
        step = int(FS * 2) // det_a.cfg.hop * det_a.cfg.hop
        for s in range(0, x.size, step):
            state, out = det_a.process_chunk(state, x[s: s + step])
            ys.append(np.asarray(out["y"]))
        ys.append(det_a.drain_audio(state))
    want_audio = serve._to_pcm16(np.concatenate(ys))
    assert audio.shape == want_audio.shape, (audio.shape, want_audio.shape)
    audio_dev = float(np.max(np.abs(audio.astype(np.int32) - want_audio))
                      / max(int(np.abs(want_audio.astype(np.int32)).max()), 1))
    assert audio_dev < 1e-3, f"emit-audio relative deviation {audio_dev:.2e}"
    res = {
        "streams": n_streams, "mulaw_streams": n_mulaw, "wall_s": wall,
        "audio_s_per_s": n_streams * seconds / wall,
        "batched_calls": batcher.batched_calls,
        "batched_requests": batcher.batched_requests,
        "fallback_groups": batcher.fallback_groups,
        "rain_frames": total_rain, "emit_audio_rel_dev": audio_dev,
        "emit_audio_wall_s": a_wall,
    }
    log(f"  serve: {n_streams} streams x {seconds:g} s in {wall:.3f} s, "
        f"{batcher.batched_calls} batched calls, emit-audio stream "
        f"{a_wall:.3f} s [{CARD}]")
    return res


# ---------------------------------------------------------------------------
# c. on-card numerics
# ---------------------------------------------------------------------------


def phase_numerics(smoke: bool = False) -> dict:
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from chip_checks import run_checks

    res = run_checks(smoke=smoke)
    for name in sorted(res):
        if name not in ("failures", "ok", "backend", "precision"):
            log(f"  {name}: {res[name]:.4g}")
    assert res["ok"], res["failures"]
    return res


# ---------------------------------------------------------------------------
# d. compile cache
# ---------------------------------------------------------------------------


def phase_compile(*, batch: int = 128, seconds: float = 10.0,
                  require_hit: bool = True) -> dict:
    """First and warm call of a fresh engine step.  The backfill phase
    compiled the same program, so with the persistent cache working the
    first call loads it from disk (counted by JAX's cache events)."""
    import jax
    import numpy as np

    from audio_processing_tools_tpu.cli.backfill import pipeline_params
    from audio_processing_tools_tpu.parallel import (
        ShardedRainPipeline,
        make_mesh,
    )
    from audio_processing_tools_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    cache_dir = enable_compile_cache()
    with CacheEvents() as cache:
        pipe = ShardedRainPipeline(pipeline_params(), make_mesh(1))
        x = np.zeros((batch, int(FS * seconds)), np.float32)
        t0 = time.perf_counter()
        jax.block_until_ready(pipe.step(x))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(pipe.step(x))
        warm = time.perf_counter() - t0
    hits = cache.hits
    res = {"cache_dir": cache_dir, "first_call_s": first, "warm_call_s": warm,
           "cache_hits": hits, "cache_writes": cache.writes,
           "cache_files": (len(os.listdir(cache_dir))
                           if os.path.isdir(cache_dir) else 0)}
    log(f"  engine step ({batch} x {seconds:g} s): first call {first:.3f} s, "
        f"warm call {warm:.4f} s, persistent cache {cache_dir}: {hits} hits "
        f"[{CARD}]")
    if require_hit:
        assert hits >= 1, f"no persistent-cache hit in {cache_dir}"
    return res


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_cards(devices, workdir: str, *, full: bool = True,
                backfill_clips: int = 64, seconds: float = 10.0,
                batch: int = 32, nproc: int | None = None,
                cpu_devices: int | None = None) -> dict:
    """The multi-card checks over ``devices``, then the distributed
    backfill with one process per card against a single-process run."""
    import __graft_entry__
    from audio_processing_tools_tpu.cli import backfill
    from audio_processing_tools_tpu.utils.corpus import write_corpus_dir

    t0 = time.perf_counter()
    if full:
        n = len(devices)
        one_hour = FS * 3600
        res = __graft_entry__.multichip_checks(
            devices, clip_sec=10.0, batch=128, roe_batch=32, roe_sec=3.0,
            seq_samples=one_hour, seq2d_sec=600.0)
        assert res["seq_samples"] >= one_hour - n * 128
    else:
        res = __graft_entry__.multichip_checks(devices)
    log(f"  multichip checks on {len(devices)} devices: {res} "
        f"({time.perf_counter() - t0:.1f} s) [{CARD}]")

    # cli.backfill --distributed, one process per card
    nproc = nproc or len(devices)
    clips, labels, kinds = labelled_corpus(backfill_clips, seconds, 9)
    corpus = os.path.join(workdir, "corpus_dist")
    write_corpus_dir(corpus, clips, labels, kinds)
    common = ["--input-type", "LocalPath", "--path", corpus,
              "--clip-sec", str(seconds), "--batch", str(batch)]
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    # the parent holds its own share of every card
    env["XLA_PYTHON_CLIENT_MEM_FRACTION"] = "0.2"
    extra = []
    if cpu_devices:  # CPU rehearsal: virtual devices, set by the CLI itself
        extra = ["--cpu-devices", str(cpu_devices)]
        env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "audio_processing_tools_tpu.cli.backfill",
         *common, *extra, "--distributed", "--coordinator",
         f"localhost:{port}", "--num-processes", str(nproc),
         "--process-id", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO) for i in range(nproc)]
    t0 = time.perf_counter()
    outs = [p.communicate(timeout=900) for p in procs]
    dist_wall = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    summaries = [json.loads([ln for ln in out.splitlines()
                             if ln.startswith("{")][-1]) for out, _ in outs]
    single, _ = backfill.main(common)
    for key in ("total_clips", "total_rain_frames", "total_rain_clips"):
        got = {s[key] for s in summaries}
        assert got == {single[key]}, f"{key}: distributed {got} vs {single[key]}"
    res["distributed_backfill"] = {
        "processes": nproc, "wall_s": dist_wall,
        **{k: single[k] for k in ("total_clips", "total_rain_frames",
                                  "total_rain_clips")}}
    log(f"  backfill --distributed, {nproc} processes: "
        f"{res['distributed_backfill']} [{CARD}]")
    return res


# ---------------------------------------------------------------------------


def _run_phase(name: str, fn, failed: list, results: dict) -> None:
    log(f"phase {name}")
    t0 = time.perf_counter()
    try:
        results[name] = fn()
        log(f"phase {name}: passed in {time.perf_counter() - t0:.1f} s "
            f"[{CARD}]")
    except Exception:
        traceback.print_exc()
        log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
        failed.append(name)


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card phase over four cards")
    args = ap.parse_args(argv)
    if not __debug__:
        print("chip_smoke: the checks are asserts; run without -O",
              file=sys.stderr)
        return 2

    # the CPU backend is the reference side of every comparison: never
    # restrict JAX to the GPU alone
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    if args.cards > 1:
        # children of the distributed phase take a share of each card too
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.6")
    else:
        # one card: the first visible one, so that the backfill's local mesh
        # on a multi-card host spans only it
        visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        os.environ["CUDA_VISIBLE_DEVICES"] = visible.strip() or "0"
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX's default backend is {backend!r}, not a GPU; "
              "nothing was run", file=sys.stderr)
        return 2
    if len(jax.devices()) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    devices = jax.devices()[: args.cards]
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from audio_processing_tools_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    cache_dir = enable_compile_cache()
    failed: list = []
    results: dict = {}
    try:
        CARD = card_line()
    except Exception as e:
        failed.append("nvidia-smi")
        log(f"nvidia-smi failed: {e!r}")
    log(f"card: {CARD}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}, "
        f"compile cache {cache_dir}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.cards > 1:
            _run_phase("cards", lambda: phase_cards(devices, workdir),
                       failed, results)
        else:
            _run_phase("native", build_native, failed, results)
            if results.get("native"):
                log(f"  native: {results['native']}")
            _run_phase("a_backfill", lambda: phase_backfill(workdir),
                       failed, results)
            _run_phase("b_serve", lambda: phase_serve(workdir), failed,
                       results)
            _run_phase("c_numerics", phase_numerics, failed, results)
            _run_phase("d_compile_cache", phase_compile, failed, results)

    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    log(f"all phases passed [{CARD}]")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
