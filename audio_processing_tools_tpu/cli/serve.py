"""Live detection server: stream PCM in, JSON detections out.

Production-serving front door for the streaming detector: a socket server
that accepts length-prefixed int16 PCM packets from a live feed and answers
each with one JSON line of causal detection results, threading
:class:`~audio_processing_tools_tpu.models.streaming.StreamingRainDetector`
state across packets (no lookahead — the reference firmware's causality
contract, ``edge/rain_frame_classifier.py``; chunk-size invariance is
pinned bit-exactly in ``tests/test_streaming.py``).

The reference has no serving surface (its closest analogue is the m3cli
device-in-loop flow, ``edge/parameter_tuning/call_c_fun.py``); this is a
framework addition for deployments where recordings arrive as a stream
rather than as S3 MARK files.

Wire protocol (one TCP or Unix-domain connection per stream)
-----------------------------------------------------------
request  := b"APT1" + uint32le(n_bytes) + n_bytes of int16-LE PCM
mu-law   := b"APT2" + uint32le(n_bytes) + n_bytes of mu-law int8 codes
eos      := b"APT0" + uint32le(0)
response := one JSON line per request (and a final summary line for eos)

``APT2`` carries the companded wire (1 byte/sample, G.711 mu-law at 8 bits,
``ops/wire.py``) for bandwidth-constrained uplinks — the edge device
companding its PCM halves its transmit bytes vs int16; the server expands
server-side and the stream is otherwise identical (same causal state, same
replies; a stream may even mix APT1 and APT2 packets).  Client side:
``stream_file(..., wire="mulaw")`` / ``--wire mulaw``.

With ``--emit-audio`` the server additionally streams DENOISED audio back
(the causal suppressor product ``y = OLA-ISTFT(G*S)``, reference
``edge/rain_signal_processor.py:1113-1125``; for ``--model band_noise``
the firmware estimator's per-frame Wiener gain applied to the frame,
``band_noise_estimator.py:949-956``): each JSON line then carries
``audio_samples`` and is followed by one binary blob
``b"APTA" + uint32le(n_bytes) + int16-LE PCM``.  The eos summary is
followed by the drained OLA tail.  The spectral audio lags the input by a
constant ``audio_delay_samples`` (~11.5 ms at defaults) and is bit-identical for any
packetization (``tests/test_streaming_audio.py``).

Samples may arrive in any quantity; the server buffers to the detector's
hop boundary and carries the remainder, so packetization never changes
results. Each connection gets fresh stream state; the jitted chunk
programs are shared and guarded by a lock.

Run: ``python -m audio_processing_tools_tpu.cli.serve --port 8765``
(or ``--unix /tmp/apt.sock``; ``--params params.json`` for detector
config). ``--port 0`` picks an ephemeral port and prints it.
"""

from __future__ import annotations

import argparse
import json
import socket
import socketserver
import struct
import sys
import threading
from typing import Any, Dict, Optional

import numpy as np

MAGIC_DATA = b"APT1"
MAGIC_MULAW = b"APT2"
MAGIC_EOS = b"APT0"
MAGIC_AUDIO = b"APTA"
_HDR = struct.Struct("<4sI")
MAX_PACKET_BYTES = 64 << 20

INT16_SCALE = 32767.0


def _to_pcm16(y: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(y, np.float32) * INT16_SCALE,
                   -32768, 32767).astype("<i2")


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        piece = sock.recv(n - len(buf))
        if not piece:
            return None
        buf += piece
    return buf


class _SpectralService:
    """Flagship spectral detector; per-connection stream state.

    ``block`` is the sample granularity the server buffers to; ``process``
    returns ``(new_state, reply_fields)`` where reply_fields carries
    ``frames`` and ``rain_frames`` plus model-specific extras.
    """

    def __init__(self, params: Dict[str, Any], emit_audio: bool = False):
        from audio_processing_tools_tpu.models.streaming import (
            StreamingRainDetector,
        )

        p = dict(params)
        if emit_audio:
            p["compute_output_audio"] = True
        self.emit_audio = emit_audio
        self.det = StreamingRainDetector()
        self.det.setup(p)
        self.block = int(self.det.cfg.hop)
        self.min_event_frames = max(
            1, int(params.get("clip_rain_min_frames", 3))
        )
        self.lock = threading.Lock()

    def new_state(self):
        with self.lock:
            return self.det.init_state()

    def drain(self, state) -> np.ndarray:
        """Final OLA tail at stream end (empty when audio is off)."""
        if not self.emit_audio:
            return np.zeros(0, "<i2")
        with self.lock:
            return _to_pcm16(self.det.drain_audio(state))

    def process(self, state, samples: np.ndarray):
        import jax

        with self.lock:
            state, out = self.det.process_chunk(state, samples)
        out = jax.tree_util.tree_map(np.asarray, out)
        return state, self._fields(out)

    def _fields(self, out) -> Dict[str, Any]:
        from audio_processing_tools_tpu.models.frame_classifier import (
            FrameClass,
        )

        fc = np.asarray(out["frame_class"])
        fields = {
            "frames": int(fc.size),
            "rain_frames": int(np.sum(fc == int(FrameClass.RAIN))),
            "rain_conf_mean": float(np.mean(np.asarray(out["rain_conf"]))),
        }
        if self.emit_audio:
            fields["_audio"] = _to_pcm16(out["y"])
        return fields

    def process_many(self, states, sample_rows):
        """Batched fast path: one vmapped device program for B lockstep
        requests of equal chunk length (bit-identical per stream to
        ``process`` — models/streaming.py ``process_chunk_batch``)."""
        import jax

        B = len(states)
        stacked = jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]), *states
        )
        batch = np.stack(sample_rows)
        with self.lock:
            new_stacked, out = self.det.process_chunk_batch(stacked, batch)
        new_stacked = jax.tree_util.tree_map(np.asarray, new_stacked)
        out = jax.tree_util.tree_map(np.asarray, out)
        new_states = [
            jax.tree_util.tree_map(lambda a, i=i: a[i], new_stacked)
            for i in range(B)
        ]
        fields = [
            self._fields(jax.tree_util.tree_map(lambda a, i=i: a[i], out))
            for i in range(B)
        ]
        return new_states, fields


class _BandNoiseService:
    """Streaming band-noise estimator (``edge/band_noise_estimator.py``
    semantics): per-frame FFT-rain decisions + Wiener telemetry."""

    def __init__(self, params: Dict[str, Any], emit_audio: bool = False):
        from audio_processing_tools_tpu.models.band_noise import (
            band_noise_init_state,
            band_noise_process_chunk,
            build_band_noise_config,
        )

        self.cfg = build_band_noise_config(dict(params))
        self.emit_audio = emit_audio
        self._init_state = band_noise_init_state
        self._chunk = band_noise_process_chunk
        self.block = int(self.cfg.frame_len)
        self.min_event_frames = max(
            1, int(params.get("clip_rain_min_frames", 3))
        )
        self.lock = threading.Lock()

    def new_state(self):
        return self._init_state(self.cfg)

    def drain(self, _state) -> np.ndarray:
        return np.zeros(0, "<i2")  # per-frame gain: nothing buffered

    def process(self, state, samples: np.ndarray):
        import jax
        import jax.numpy as jnp

        samples = np.asarray(samples, np.float32)
        with self.lock:
            outs, state = self._chunk(
                jnp.asarray(samples), self.cfg, state
            )
        outs = jax.tree_util.tree_map(np.asarray, outs)
        return state, self._fields(outs, samples)

    def _fields(self, outs, samples=None) -> Dict[str, Any]:
        rain = np.asarray(outs["fft_rain_frame"]).astype(bool)
        fields = {
            "frames": int(rain.size),
            "rain_frames": int(rain.sum()),
            "N_E_last": float(np.asarray(outs["N_E"])[-1]),
            "G_mag_mean": float(np.mean(np.asarray(outs["G_mag"]))),
        }
        if self.emit_audio and samples is not None:
            # the firmware estimator's Wiener gain is a per-frame band
            # magnitude scalar (M_clean = G_mag * M_band, reference
            # band_noise_estimator.py:949-956); its time-domain rendering
            # applies that gain to the frame — zero added latency
            g = np.asarray(outs["G_mag"], np.float32)
            frames = samples.reshape(g.size, -1)
            fields["_audio"] = _to_pcm16((frames * g[:, None]).reshape(-1))
        return fields

    def process_many(self, states, sample_rows):
        """Batched fast path: vmap the (bit-identical) chunked engine over
        B lockstep streams."""
        import jax
        import jax.numpy as jnp

        if not hasattr(self, "_vmapped"):
            cfg = self.cfg
            chunk = self._chunk
            self._vmapped = jax.jit(
                jax.vmap(lambda x, st: chunk(x, cfg, st))
            )
        B = len(states)
        stacked = jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]), *states
        )
        batch = jnp.asarray(np.stack(
            [np.asarray(r, np.float32) for r in sample_rows]
        ))
        with self.lock:
            outs, new_stacked = self._vmapped(batch, stacked)
        outs = jax.tree_util.tree_map(np.asarray, outs)
        new_stacked = jax.tree_util.tree_map(np.asarray, new_stacked)
        new_states = [
            jax.tree_util.tree_map(lambda a, i=i: a[i], new_stacked)
            for i in range(B)
        ]
        fields = [
            self._fields(
                jax.tree_util.tree_map(lambda a, i=i: a[i], outs),
                np.asarray(sample_rows[i], np.float32),
            )
            for i in range(B)
        ]
        return new_states, fields


_SERVICES = {"spectral": _SpectralService, "band_noise": _BandNoiseService}


class _Batcher:
    """Dynamic batching: coalesce concurrent requests into vmapped calls.

    Handler threads block in :meth:`submit`; a dispatcher thread drains the
    queue for up to ``window_ms`` after the first arrival, groups requests
    by chunk length, and runs each multi-request group through the
    service's ``process_many`` (one vmapped device program — per-stream
    bit-identical to the unbatched path). Singles and services without
    ``process_many`` fall through to ``process``.
    """

    def __init__(self, svc, window_ms: float, max_batch: int = 64):
        import queue

        self.svc = svc
        self.window = float(window_ms) / 1e3
        self.max_batch = int(max_batch)
        self.q: "queue.Queue" = queue.Queue()
        self._empty = queue.Empty
        self.batched_calls = 0      # vmapped group dispatches (telemetry)
        self.batched_requests = 0   # requests served through them
        self.fallback_groups = 0    # batched calls that failed and reran
        t = threading.Thread(target=self._loop, daemon=True,
                             name="apt-serve-batcher")
        t.start()

    def submit(self, state, samples: np.ndarray):
        ev = threading.Event()
        box: Dict[str, Any] = {}
        self.q.put((state, samples, ev, box))
        ev.wait()
        if "err" in box:
            raise box["err"]
        return box["state"], box["fields"]

    def _loop(self) -> None:
        import time as _t

        while True:
            batch = [self.q.get()]
            deadline = _t.monotonic() + self.window
            while len(batch) < self.max_batch:
                left = deadline - _t.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=left))
                except self._empty:
                    break
            groups: Dict[int, list] = {}
            for item in batch:
                groups.setdefault(int(item[1].size), []).append(item)
            for items in groups.values():
                self._run_group(items)

    def _run_group(self, items) -> None:
        if len(items) > 1 and hasattr(self.svc, "process_many"):
            try:
                states = [it[0] for it in items]
                rows = [it[1] for it in items]
                new_states, fields = self.svc.process_many(states, rows)
                self.batched_calls += 1
                self.batched_requests += len(items)
                for (st, row, ev, box), ns, f in zip(items, new_states,
                                                     fields):
                    box["state"], box["fields"] = ns, f
                    ev.set()
                return
            except Exception as e:
                # re-run each request through the per-request path so one
                # poisoned group member cannot fail its neighbours; count
                # and report it, since a batched path that always fails
                # would otherwise serve everything unbatched in silence
                self.fallback_groups += 1
                print(f"serve: batched call of {len(items)} requests failed "
                      f"({type(e).__name__}: {e}); rerunning them one by one",
                      file=sys.stderr, flush=True)
        for st, row, ev, box in items:
            try:
                box["state"], box["fields"] = self.svc.process(st, row)
            except Exception as e:
                box["err"] = e
            ev.set()


class _StreamHandler(socketserver.BaseRequestHandler):
    """One live stream per connection."""

    def handle(self) -> None:  # noqa: C901 - linear protocol loop
        svc = self.server.svc  # type: ignore[attr-defined]
        state = svc.new_state()
        pending = np.zeros(0, np.float32)
        chunk_idx = 0
        total_frames = 0
        total_rain = 0

        while True:
            hdr = _recv_exact(self.request, _HDR.size)
            if hdr is None:
                return  # client vanished mid-stream
            magic, n_bytes = _HDR.unpack(hdr)
            if magic not in (MAGIC_DATA, MAGIC_MULAW, MAGIC_EOS) or (
                n_bytes > MAX_PACKET_BYTES
            ):
                self._send({"error": "bad packet header"})
                return
            if magic == MAGIC_EOS:
                tail = (svc.drain(state) if hasattr(svc, "drain")
                        else np.zeros(0, "<i2"))
                summary = {
                    "eos": True,
                    "chunks": chunk_idx,
                    "frames": total_frames,
                    "rain_frames": total_rain,
                    "stream_is_rain": total_rain >= svc.min_event_frames,
                    "dropped_tail_samples": int(pending.size),
                }
                if getattr(svc, "emit_audio", False):
                    summary["audio_samples"] = int(tail.size)
                    self._send(summary)
                    self._send_audio(tail)
                else:
                    self._send(summary)
                return
            payload = _recv_exact(self.request, n_bytes)
            if payload is None:
                return
            if magic == MAGIC_MULAW:
                from audio_processing_tools_tpu.ops.wire import (
                    mulaw_decode_np,
                )

                # expand the 1-byte/sample companded wire; x32768/32767
                # lands on the same full-scale convention as the int16 path
                pcm = mulaw_decode_np(np.frombuffer(payload, np.int8))
                pcm *= 32768.0 / INT16_SCALE
            else:
                if n_bytes % 2:
                    self._send({"error": "odd payload length (int16 PCM)"})
                    return
                pcm = np.frombuffer(payload, "<i2").astype(np.float32)
                pcm /= INT16_SCALE
            pending = np.concatenate([pending, pcm])

            usable = pending.size // svc.block * svc.block
            if usable == 0:
                empty = {
                    "chunk": chunk_idx, "frames": 0, "rain_frames": 0,
                    "buffered_samples": int(pending.size),
                }
                if getattr(svc, "emit_audio", False):
                    empty["audio_samples"] = 0
                    self._send(empty)
                    self._send_audio(np.zeros(0, "<i2"))
                else:
                    self._send(empty)
                chunk_idx += 1
                continue
            piece, pending = pending[:usable], pending[usable:]
            batcher = getattr(self.server, "batcher", None)
            if batcher is not None:
                state, fields = batcher.submit(state, piece)
            else:
                state, fields = svc.process(state, piece)
            audio = fields.pop("_audio", None)
            total_frames += fields["frames"]
            total_rain += fields["rain_frames"]
            reply = {
                "chunk": chunk_idx,
                **fields,
                "stream_rain_frames": total_rain,
                "event": total_rain >= svc.min_event_frames,
                "buffered_samples": int(pending.size),
            }
            if audio is not None:
                reply["audio_samples"] = int(audio.size)
                self._send(reply)
                self._send_audio(audio)
            else:
                self._send(reply)
            chunk_idx += 1

    def _send(self, obj: Dict[str, Any]) -> None:
        self.request.sendall(json.dumps(obj).encode() + b"\n")

    def _send_audio(self, pcm: np.ndarray) -> None:
        blob = np.ascontiguousarray(pcm).tobytes()
        self.request.sendall(_HDR.pack(MAGIC_AUDIO, len(blob)) + blob)


class _TcpServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _UnixServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True


def make_server(params: Dict[str, Any], *, host: str = "127.0.0.1",
                port: int = 0, unix_path: Optional[str] = None,
                model: str = "spectral", batch_window_ms: float = 0.0,
                emit_audio: bool = False):
    """Build (not start) a server; ``.server_address`` has the bound port.

    ``batch_window_ms`` > 0 enables dynamic batching: concurrent
    connections whose chunks arrive within the window run as ONE vmapped
    device program (throughput mode; adds up to one window of latency).
    ``emit_audio`` streams denoised PCM back after every JSON reply.
    """
    svc = _SERVICES[model](params, emit_audio=emit_audio)
    if unix_path:
        srv = _UnixServer(unix_path, _StreamHandler)
    else:
        srv = _TcpServer((host, port), _StreamHandler)
    srv.svc = svc  # type: ignore[attr-defined]
    srv.batcher = (  # type: ignore[attr-defined]
        _Batcher(svc, batch_window_ms) if batch_window_ms > 0 else None
    )
    return srv


def _load_audio_float(path: str) -> np.ndarray:
    """WAV / MARK container / raw ``.f32``/``.i16`` -> mono float32 [-1,1]."""
    low = path.lower()
    if low.endswith(".wav"):
        from audio_processing_tools_tpu.io.audio import load_wav

        y, _sr = load_wav(path)
        return y[0] if y.ndim > 1 else y
    if low.endswith(".f32"):
        return np.fromfile(path, np.float32)
    if low.endswith(".i16"):
        return np.fromfile(path, "<i2").astype(np.float32) / INT16_SCALE
    from audio_processing_tools_tpu.io.mark import parse_mark_audio_file

    with open(path, "rb") as f:
        sig, _meta = parse_mark_audio_file(f.read())
    return np.asarray(sig, np.float32) / 32768.0


def stream_file(path: str, *, host: str = "127.0.0.1", port: int = 8765,
                unix_path: Optional[str] = None, packet_samples: int = 8192,
                sample_rate: int = 11162, wire: str = "int16"):
    """Client helper: stream an audio file to a running server.

    Accepts a WAV, a MARK container, or raw ``.f32``/``.i16`` PCM; yields
    the server's JSON replies (the last one is the stream summary).
    ``wire="mulaw"`` sends companded APT2 packets (half the uplink bytes;
    the server expands).
    """
    if wire not in ("int16", "mulaw"):
        raise ValueError(f"unknown wire format: {wire!r}")
    x = _load_audio_float(path)
    pcm = np.clip(np.asarray(x, np.float32) * INT16_SCALE,
                  -32768, 32767).astype("<i2")
    if wire == "mulaw":
        from audio_processing_tools_tpu.ops.wire import mulaw_encode

        pcm = mulaw_encode(pcm)
    magic = MAGIC_MULAW if wire == "mulaw" else MAGIC_DATA
    if unix_path:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(unix_path)
    else:
        sock = socket.create_connection((host, port), timeout=600)
    with sock:
        f = sock.makefile("rb")

        def read_reply():
            reply = json.loads(f.readline())
            if "audio_samples" in reply:
                hdr = f.read(_HDR.size)
                magic, n_bytes = _HDR.unpack(hdr)
                assert magic == MAGIC_AUDIO, magic
                reply["audio"] = np.frombuffer(f.read(n_bytes), "<i2")
            return reply

        for start in range(0, len(pcm), packet_samples):
            chunk = pcm[start : start + packet_samples].tobytes()
            sock.sendall(_HDR.pack(magic, len(chunk)) + chunk)
            yield read_reply()
        sock.sendall(_HDR.pack(MAGIC_EOS, 0))
        yield read_reply()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Live rain-detection server (length-prefixed int16 PCM "
                    "in, JSON lines out)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765,
                    help="TCP port (0 = ephemeral; printed on start)")
    ap.add_argument("--unix", default=None, metavar="PATH",
                    help="serve on a Unix-domain socket instead of TCP")
    ap.add_argument("--sample-rate", type=int, default=11162)
    ap.add_argument("--params", default=None,
                    help="JSON file of engine params (merged over defaults)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (jax.config)")
    ap.add_argument("--client", default=None, metavar="AUDIO_FILE",
                    help="act as a client: stream this file to the server "
                         "and print its JSON replies")
    ap.add_argument("--packet-samples", type=int, default=8192,
                    help="client mode: samples per packet")
    ap.add_argument("--wire", default="int16", choices=("int16", "mulaw"),
                    help="client mode: uplink encoding (mulaw = companded "
                         "APT2 packets, half the bytes of int16)")
    ap.add_argument("--model", default="spectral",
                    choices=sorted(_SERVICES),
                    help="engine family to serve")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="dynamic batching window: concurrent connections "
                         "coalesce into one vmapped device call (0 = off)")
    ap.add_argument("--emit-audio", action="store_true",
                    help="stream denoised PCM back (APTA blob after each "
                         "JSON reply; spectral: causal suppressor OLA-ISTFT"
                         ", band_noise: per-frame Wiener gain)")
    args = ap.parse_args(argv)

    if args.client:
        for reply in stream_file(
            args.client, host=args.host, port=args.port,
            unix_path=args.unix, packet_samples=args.packet_samples,
            sample_rate=args.sample_rate, wire=args.wire,
        ):
            # Against an --emit-audio server, stream_file attaches the PCM
            # as a numpy array; keep the printed line JSON by replacing it
            # with its sample count (the JSON reply already carries
            # audio_samples, so nothing is lost).
            audio = reply.pop("audio", None)
            if audio is not None:
                reply["audio"] = {"samples": int(len(audio))}
            print(json.dumps(reply), flush=True)
        return 0

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from audio_processing_tools_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS

    params: Dict[str, Any] = {
        "sample_rate": args.sample_rate,
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
    }
    if args.params:
        with open(args.params) as f:
            params.update(json.load(f))

    srv = make_server(params, host=args.host, port=args.port,
                      unix_path=args.unix, model=args.model,
                      batch_window_ms=args.batch_window_ms,
                      emit_audio=args.emit_audio)
    where = args.unix or "%s:%d" % srv.server_address[:2]
    print(f"serving live rain detection on {where} "
          f"(model={args.model}, sample_rate={params['sample_rate']})",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
