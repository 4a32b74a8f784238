"""Live detection server: protocol, state threading, packetization.

Drives ``cli/serve.py`` over a real loopback socket: a client streams a
quiet-then-rain recording in odd-sized packets (NOT hop multiples — the
server must buffer to hop boundaries), and the responses must agree with
the offline StreamingRainDetector on the same signal.
"""

import json
import socket
import struct
import threading

import numpy as np
import pytest

from audio_processing_tools_tpu.cli.serve import (
    MAGIC_DATA,
    MAGIC_EOS,
    make_server,
)
from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.models.frame_classifier import FrameClass
from audio_processing_tools_tpu.models.streaming import StreamingRainDetector
from audio_processing_tools_tpu.utils.corpus import synth_clip

FS = 11162
PARAMS = {
    "sample_rate": FS,
    "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
    "clip_rain_min_frames": 3,
}
_HDR = struct.Struct("<4sI")


@pytest.fixture(scope="module")
def server():
    srv = make_server(PARAMS, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def stream_i16():
    rng = np.random.default_rng(7)
    quiet = synth_clip("noise", rng, fs=FS, seconds=2.0)
    rainy = synth_clip("rain_heavy", rng, fs=FS, seconds=2.0)
    x = np.concatenate([quiet, rainy])
    return np.clip(x * 32767.0, -32768, 32767).astype("<i2")


def _lines(sock_file, n):
    return [json.loads(sock_file.readline()) for _ in range(n)]


def _stream(addr, pcm_i16, packet_samples):
    """Send pcm in fixed-size packets; return (per-packet replies, summary)."""
    with socket.create_connection(addr, timeout=120) as s:
        f = s.makefile("rb")
        replies = []
        for start in range(0, len(pcm_i16), packet_samples):
            chunk = pcm_i16[start : start + packet_samples].tobytes()
            s.sendall(_HDR.pack(MAGIC_DATA, len(chunk)) + chunk)
            replies.extend(_lines(f, 1))
        s.sendall(_HDR.pack(MAGIC_EOS, 0))
        summary = _lines(f, 1)[0]
    return replies, summary


def _offline_counts(pcm_i16):
    det = StreamingRainDetector()
    det.setup(dict(PARAMS))
    x = pcm_i16.astype(np.float32) / 32767.0
    out = det.process_stream(x, chunk_sec=1.0)
    fc = np.asarray(out["frame_class"])
    return int(fc.size), int(np.sum(fc == int(FrameClass.RAIN)))


def test_serve_detects_rain_and_matches_offline(server, stream_i16):
    # 1000 samples/packet: deliberately NOT a hop multiple
    replies, summary = _stream(server, stream_i16, packet_samples=1000)
    assert summary["eos"] is True
    frames_off, rain_off = _offline_counts(stream_i16)
    assert summary["frames"] == frames_off
    assert summary["rain_frames"] == rain_off
    assert summary["rain_frames"] > 0 and summary["stream_is_rain"] is True
    # rain must be reported DURING the stream, in the rainy half
    eventful = [r for r in replies if r.get("event")]
    assert eventful, "no packet ever reported a sustained event"
    # buffering: tail remainder smaller than one hop
    assert summary["dropped_tail_samples"] < 128


def test_serve_packetization_invariant(server, stream_i16):
    """Same audio, very different packet sizes -> identical totals."""
    _, s_small = _stream(server, stream_i16, packet_samples=700)
    _, s_large = _stream(server, stream_i16, packet_samples=50000)
    assert s_small["rain_frames"] == s_large["rain_frames"]
    assert s_small["frames"] == s_large["frames"]


def test_serve_connections_are_independent(server, stream_i16):
    """A noise-only stream right after a rain stream must not inherit
    state: its counts must equal a FRESH-state offline run of the same
    clip (which may include a benign warmup transient frame)."""
    rng = np.random.default_rng(11)
    quiet = synth_clip("noise", rng, fs=FS, seconds=2.0)
    quiet_i16 = np.clip(quiet * 32767.0, -32768, 32767).astype("<i2")
    _stream(server, stream_i16, packet_samples=4096)
    _, summary = _stream(server, quiet_i16, packet_samples=4096)
    frames_off, rain_off = _offline_counts(quiet_i16)
    assert summary["frames"] == frames_off
    assert summary["rain_frames"] == rain_off
    assert summary["stream_is_rain"] is False


def test_serve_rejects_bad_magic(server):
    with socket.create_connection(server, timeout=30) as s:
        s.sendall(b"XXXX" + struct.pack("<I", 4) + b"\0\0\0\0")
        f = s.makefile("rb")
        reply = json.loads(f.readline())
        assert "error" in reply


def test_client_streams_wav_file(server, tmp_path):
    """stream_file loads a WAV and yields per-packet replies + summary."""
    from audio_processing_tools_tpu.cli.serve import stream_file
    from audio_processing_tools_tpu.io.audio import write_wav

    rng = np.random.default_rng(5)
    x = np.concatenate([
        synth_clip("noise", rng, fs=FS, seconds=1.0),
        synth_clip("rain_heavy", rng, fs=FS, seconds=1.0),
    ])
    wav = tmp_path / "clip.wav"
    write_wav(str(wav), np.clip(x * 32767, -32768, 32767).astype(np.int16),
              FS)
    host, port = server
    replies = list(stream_file(str(wav), host=host, port=port,
                               packet_samples=4096))
    summary = replies[-1]
    assert summary["eos"] is True and summary["rain_frames"] > 0
    assert all("chunk" in r for r in replies[:-1])


def test_serve_band_noise_model(stream_i16):
    """--model band_noise serves the streaming estimator: per-frame
    fft-rain decisions, and results equal the offline chunked engine
    (chunk threading is bit-identical by contract)."""
    import jax

    from audio_processing_tools_tpu.models.band_noise import (
        band_noise_init_state,
        band_noise_process_chunk,
        build_band_noise_config,
    )

    srv = make_server({"sample_rate": FS}, port=0, model="band_noise")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        replies, summary = _stream(srv.server_address, stream_i16,
                                   packet_samples=3000)
        assert summary["eos"] is True
        # offline: same audio through the chunked engine in one pass
        cfg = build_band_noise_config({"sample_rate": FS})
        x = stream_i16.astype(np.float32) / 32767.0
        usable = x.size // cfg.frame_len * cfg.frame_len
        outs, _ = band_noise_process_chunk(
            x[:usable], cfg, band_noise_init_state(cfg)
        )
        rain_off = int(np.asarray(outs["fft_rain_frame"]).astype(bool).sum())
        frames_off = int(np.asarray(outs["fft_rain_frame"]).size)
        assert summary["frames"] == frames_off
        assert summary["rain_frames"] == rain_off
        assert summary["rain_frames"] > 0
        # model-specific telemetry present in data replies
        data = [r for r in replies if r.get("frames", 0) > 0]
        assert data and all("N_E_last" in r and "G_mag_mean" in r
                            for r in data)
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_dynamic_batching_concurrent_streams_exact():
    """4 clients streaming DIFFERENT clips concurrently through a batched
    server (batch_window_ms>0): every stream's totals must equal its own
    fresh-state offline run — dynamic batching must never mix streams or
    change results (process_chunk_batch is bit-identical per stream)."""
    import concurrent.futures as cf

    srv = make_server(PARAMS, port=0, batch_window_ms=30.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clips = []
        for i in range(4):
            rng = np.random.default_rng(300 + i)
            kind = "rain_heavy" if i % 2 == 0 else "noise"
            x = np.concatenate([
                synth_clip("noise", rng, fs=FS, seconds=1.0),
                synth_clip(kind, rng, fs=FS, seconds=1.0),
            ])
            clips.append(
                np.clip(x * 32767.0, -32768, 32767).astype("<i2")
            )

        with cf.ThreadPoolExecutor(4) as pool:
            futs = [
                pool.submit(_stream, srv.server_address, c,
                            4096 + 512 * i)  # varied packet sizes too
                for i, c in enumerate(clips)
            ]
            summaries = [f.result()[1] for f in futs]

        for i, (clip, summary) in enumerate(zip(clips, summaries)):
            frames_off, rain_off = _offline_counts(clip)
            assert summary["frames"] == frames_off, f"stream {i}"
            assert summary["rain_frames"] == rain_off, f"stream {i}"
        # the rainy streams must actually detect
        assert summaries[0]["rain_frames"] > 0
        assert summaries[2]["rain_frames"] > 0
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_dynamic_batching_actually_batches():
    """With equal packet sizes and a generous window, concurrent streams
    MUST coalesce into vmapped group dispatches (not just fall through to
    singles), and results still match offline exactly."""
    import concurrent.futures as cf

    srv = make_server(PARAMS, port=0, batch_window_ms=150.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clips = []
        for i in range(3):
            rng = np.random.default_rng(400 + i)
            x = np.concatenate([
                synth_clip("rain_heavy", rng, fs=FS, seconds=1.0),
                synth_clip("noise", rng, fs=FS, seconds=1.0),
            ])
            clips.append(np.clip(x * 32767.0, -32768, 32767).astype("<i2"))

        with cf.ThreadPoolExecutor(3) as pool:
            futs = [pool.submit(_stream, srv.server_address, c, 4096)
                    for c in clips]
            summaries = [f.result()[1] for f in futs]

        batcher = srv.batcher
        assert batcher.batched_calls > 0, "no vmapped group ever dispatched"
        assert batcher.batched_requests >= 2 * batcher.batched_calls
        for i, (clip, summary) in enumerate(zip(clips, summaries)):
            frames_off, rain_off = _offline_counts(clip)
            assert summary["frames"] == frames_off, f"stream {i}"
            assert summary["rain_frames"] == rain_off, f"stream {i}"
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_rejects_oversized_packet(server):
    """A length header beyond MAX_PACKET_BYTES is refused up front
    (no attempt to buffer gigabytes from a bad client)."""
    from audio_processing_tools_tpu.cli.serve import MAX_PACKET_BYTES

    with socket.create_connection(server, timeout=30) as s:
        s.sendall(_HDR.pack(MAGIC_DATA, MAX_PACKET_BYTES + 1))
        f = s.makefile("rb")
        reply = json.loads(f.readline())
        assert "error" in reply


def test_serve_band_noise_dynamic_batching_exact():
    """Band-noise model + dynamic batching: concurrent streams coalesce
    into a vmapped chunked-engine call, per-stream exact vs offline."""
    import concurrent.futures as cf

    from audio_processing_tools_tpu.models.band_noise import (
        band_noise_init_state,
        band_noise_process_chunk,
        build_band_noise_config,
    )

    srv = make_server({"sample_rate": FS}, port=0, model="band_noise",
                      batch_window_ms=150.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clips = []
        for i in range(3):
            rng = np.random.default_rng(700 + i)
            x = np.concatenate([
                synth_clip("rain_heavy", rng, fs=FS, seconds=1.0),
                synth_clip("noise", rng, fs=FS, seconds=1.0),
            ])
            clips.append(np.clip(x * 32767.0, -32768, 32767).astype("<i2"))

        with cf.ThreadPoolExecutor(3) as pool:
            futs = [pool.submit(_stream, srv.server_address, c, 4096)
                    for c in clips]
            summaries = [f.result()[1] for f in futs]

        assert srv.batcher.batched_calls > 0, "vmapped path never engaged"
        cfg = build_band_noise_config({"sample_rate": FS})
        for i, (clip, summary) in enumerate(zip(clips, summaries)):
            x = clip.astype(np.float32) / 32767.0
            usable = x.size // cfg.frame_len * cfg.frame_len
            outs, _ = band_noise_process_chunk(
                x[:usable], cfg, band_noise_init_state(cfg)
            )
            rain_off = int(
                np.asarray(outs["fft_rain_frame"]).astype(bool).sum()
            )
            assert summary["frames"] == int(
                np.asarray(outs["fft_rain_frame"]).size), f"stream {i}"
            assert summary["rain_frames"] == rain_off, f"stream {i}"
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_rejects_odd_payload_length(server):
    with socket.create_connection(server, timeout=30) as s:
        s.sendall(_HDR.pack(MAGIC_DATA, 3) + b"\0\0\0")
        f = s.makefile("rb")
        reply = json.loads(f.readline())
        assert "error" in reply and "odd" in reply["error"]


# ---------------------------------------------------------------------------
# --emit-audio: stream in -> denoised stream out

from audio_processing_tools_tpu.cli.serve import MAGIC_AUDIO  # noqa: E402


def _stream_audio(addr, pcm_i16, packet_samples):
    """Stream with audio replies: returns (replies, summary, denoised pcm
    including the drained eos tail)."""
    audio = []

    def read_reply(f):
        reply = json.loads(f.readline())
        hdr = f.read(_HDR.size)
        magic, n_bytes = _HDR.unpack(hdr)
        assert magic == MAGIC_AUDIO, magic
        audio.append(np.frombuffer(f.read(n_bytes), "<i2"))
        return reply

    with socket.create_connection(addr, timeout=120) as s:
        f = s.makefile("rb")
        replies = []
        for start in range(0, len(pcm_i16), packet_samples):
            chunk = pcm_i16[start : start + packet_samples].tobytes()
            s.sendall(_HDR.pack(MAGIC_DATA, len(chunk)) + chunk)
            replies.append(read_reply(f))
        s.sendall(_HDR.pack(MAGIC_EOS, 0))
        summary = read_reply(f)
    return replies, summary, np.concatenate(audio)


@pytest.fixture(scope="module")
def audio_server():
    srv = make_server(PARAMS, port=0, emit_audio=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


def test_serve_emit_audio_end_to_end(audio_server, stream_i16):
    """Denoised PCM comes back; sample count == consumed samples + drained
    tail; packetization does not change a single sample."""
    replies, summary, y1 = _stream_audio(audio_server, stream_i16, 1000)
    assert summary["audio_samples"] == 128  # the drained OLA tail
    usable = len(stream_i16) // 128 * 128
    assert y1.size == usable + 128
    assert any(r.get("audio_samples", 0) > 0 for r in replies)
    # bit-identical under a totally different packetization
    _, _, y2 = _stream_audio(audio_server, stream_i16, 49999)
    np.testing.assert_array_equal(y1, y2)
    # and equal to the offline streaming suppressor on the same signal
    det = StreamingRainDetector()
    det.setup({**PARAMS, "compute_output_audio": True})
    x = stream_i16.astype(np.float32) / 32767.0
    st = det.init_state()
    st, out = det.process_chunk(st, x[:usable])
    y_direct = np.concatenate([np.asarray(out["y"]),
                               det.drain_audio(st)])
    y_direct_i16 = np.clip(y_direct * 32767.0, -32768, 32767).astype("<i2")
    np.testing.assert_array_equal(y1, y_direct_i16)
    # the output is actually denoised: quieter than the input on the
    # noise-only first half (past tracker warmup)
    seg = slice(FS, FS * 2)
    assert (np.sqrt(np.mean(y1[seg].astype(np.float64) ** 2))
            < 0.9 * np.sqrt(np.mean(stream_i16[seg].astype(np.float64) ** 2)))


def test_serve_emit_audio_band_noise():
    srv = make_server({"sample_rate": FS}, port=0, model="band_noise",
                      emit_audio=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        rng = np.random.default_rng(3)
        x = synth_clip("noise", rng, fs=FS, seconds=2.0)
        pcm = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
        replies, summary, y = _stream_audio(srv.server_address, pcm, 4096)
        block = srv.svc.block
        usable = len(pcm) // block * block
        assert y.size == usable  # per-frame gain: no delay, no tail
        assert summary["audio_samples"] == 0
        # audio == per-frame Wiener gain applied to the input frames
        from audio_processing_tools_tpu.models.band_noise import (
            band_noise_init_state,
            band_noise_process_chunk,
        )
        import jax
        import jax.numpy as jnp

        cfg = srv.svc.cfg
        xs = pcm[:usable].astype(np.float32) / 32767.0
        outs, _st = band_noise_process_chunk(
            jnp.asarray(xs), cfg, band_noise_init_state(cfg))
        g = np.asarray(outs["G_mag"], np.float32)
        expect = (xs.reshape(g.size, -1) * g[:, None]).reshape(-1)
        expect_i16 = np.clip(expect * 32767.0, -32768, 32767).astype("<i2")
        np.testing.assert_array_equal(y, expect_i16)
        assert float(np.mean(g)) < 1.0  # some suppression happened
    finally:
        srv.shutdown()
        srv.server_close()


def test_client_mode_against_emit_audio_server(audio_server, tmp_path,
                                               capsys):
    """``--client`` prints valid JSON against an ``--emit-audio`` server:
    the PCM array stream_file attaches is replaced by its sample count
    (it is not JSON-serializable and the bytes are already accounted for
    by ``audio_samples``)."""
    from audio_processing_tools_tpu.cli.serve import main
    from audio_processing_tools_tpu.io.audio import write_wav

    rng = np.random.default_rng(11)
    x = synth_clip("rain_heavy", rng, fs=FS, seconds=1.0)
    wav = tmp_path / "clip.wav"
    write_wav(str(wav), np.clip(x * 32767, -32768, 32767).astype(np.int16),
              FS)
    host, port = audio_server
    assert main(["--client", str(wav), "--host", host,
                 "--port", str(port), "--packet-samples", "4096"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    replies = [json.loads(ln) for ln in lines]  # every line parses
    assert replies[-1]["eos"] is True
    data = [r for r in replies if "audio" in r]
    assert data and all(r["audio"]["samples"] == r["audio_samples"]
                        for r in data)


# ---------------------------------------------------------------------------
# APT2 mu-law wire: companded uplink, server-side expansion

def _stream_wire(addr, pcm_i16, packet_samples, wires):
    """Stream with a per-packet wire choice cycling through ``wires``
    ("int16" | "mulaw"); returns (replies, summary)."""
    from audio_processing_tools_tpu.cli.serve import MAGIC_MULAW
    from audio_processing_tools_tpu.ops.wire import mulaw_encode

    with socket.create_connection(addr, timeout=120) as s:
        f = s.makefile("rb")
        replies = []
        for i, start in enumerate(range(0, len(pcm_i16), packet_samples)):
            chunk = pcm_i16[start : start + packet_samples]
            if wires[i % len(wires)] == "mulaw":
                payload = mulaw_encode(chunk).tobytes()
                s.sendall(_HDR.pack(MAGIC_MULAW, len(payload)) + payload)
            else:
                payload = chunk.tobytes()
                s.sendall(_HDR.pack(MAGIC_DATA, len(payload)) + payload)
            replies.extend(_lines(f, 1))
        s.sendall(_HDR.pack(MAGIC_EOS, 0))
        summary = _lines(f, 1)[0]
    return replies, summary


def test_serve_mulaw_wire_matches_int16_decision(server, stream_i16):
    """APT2 packets carry half the bytes; the expanded stream must see the
    same frame count and reach the same clip decision as the int16 wire
    (mu-law is lossy, so rain_frames may differ by a few frames)."""
    _, s16 = _stream(server, stream_i16, packet_samples=4096)
    _, smu = _stream_wire(server, stream_i16, 4096, wires=("mulaw",))
    assert smu["frames"] == s16["frames"]
    assert smu["stream_is_rain"] == s16["stream_is_rain"] is True
    assert abs(smu["rain_frames"] - s16["rain_frames"]) <= max(
        3, int(0.02 * s16["frames"]))


def test_serve_mixed_wire_packets_one_stream(server, stream_i16):
    """A stream may alternate APT1 and APT2 packets: state threads through
    both identically (frame count exact, decision unchanged)."""
    _, s16 = _stream(server, stream_i16, packet_samples=4096)
    _, smix = _stream_wire(server, stream_i16, 4096,
                           wires=("int16", "mulaw"))
    assert smix["frames"] == s16["frames"]
    assert smix["stream_is_rain"] == s16["stream_is_rain"]


def test_client_mulaw_wire_end_to_end(server, tmp_path):
    """stream_file(wire="mulaw") round-trips: rain detected, eos summary."""
    from audio_processing_tools_tpu.cli.serve import stream_file
    from audio_processing_tools_tpu.io.audio import write_wav

    rng = np.random.default_rng(5)
    x = np.concatenate([
        synth_clip("noise", rng, fs=FS, seconds=1.0),
        synth_clip("rain_heavy", rng, fs=FS, seconds=1.0),
    ])
    wav = tmp_path / "clip.wav"
    write_wav(str(wav), np.clip(x * 32767, -32768, 32767).astype(np.int16),
              FS)
    host, port = server
    replies = list(stream_file(str(wav), host=host, port=port,
                               packet_samples=4096, wire="mulaw"))
    assert replies[-1]["eos"] is True and replies[-1]["rain_frames"] > 0
    with pytest.raises(ValueError):
        next(stream_file(str(wav), host=host, port=port, wire="adpcm"))


# ---------------------------------------------------------------------------
# batched-path failures are counted, and the client path stays off JAX


class _FlakyBatchService:
    """Per-request path works; the batched path always fails."""

    def process(self, state, samples):
        return state + 1, {"frames": int(samples.size)}

    def process_many(self, states, rows):
        raise RuntimeError("batched path broken")


def test_batcher_counts_and_logs_fallback(capsys):
    from audio_processing_tools_tpu.cli.serve import _Batcher

    batcher = _Batcher(_FlakyBatchService(), window_ms=300.0)
    out = [None, None]

    def submit(i):
        out[i] = batcher.submit(i, np.zeros(128))

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert out == [(1, {"frames": 128}), (2, {"frames": 128})]
    assert batcher.fallback_groups == 1
    assert batcher.batched_calls == 0
    assert "batched call of 2 requests failed" in capsys.readouterr().err


def test_client_mode_never_initialises_jax(server, tmp_path):
    """``--client`` streams without touching any JAX backend: with the
    platform list pointing at a backend that does not exist, any backend
    initialisation in the client process would fail it."""
    import os
    import subprocess
    import sys

    from audio_processing_tools_tpu.io.audio import write_wav

    x = synth_clip("noise", np.random.default_rng(3), fs=FS, seconds=1.0)
    wav = tmp_path / "clip.wav"
    write_wav(str(wav), np.clip(x * 32767, -32768, 32767).astype(np.int16),
              FS)
    host, port = server
    env = dict(os.environ, JAX_PLATFORMS="no_such_backend")
    r = subprocess.run(
        [sys.executable, "-m", "audio_processing_tools_tpu.cli.serve",
         "--client", str(wav), "--host", host, "--port", str(port),
         "--packet-samples", "4096"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["eos"] is True
