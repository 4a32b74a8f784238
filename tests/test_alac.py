"""ALAC codec tests: real ALAC bytes through the full ingest path.

Closes the round-1 gap: the ``file_version >= 1`` branch of
``parse_mark_audio_file`` now executes on genuine ALAC payloads, decoded by
libavcodec (the same decoder the reference's ffmpeg subprocess uses —
reference ``parse.py:373-472``). A golden fixture is checked in so the
decode is pinned against byte rot.
"""

import os

import numpy as np
import pytest

from audio_processing_tools_tpu.io.alac import decode_alac_to_pcm, have_ffmpeg
from audio_processing_tools_tpu.io.alac_native import (
    decode_alac_payload,
    encode_alac_frames,
    encode_alac_payload,
    have_alac_shim,
    split_ber_packets,
)
from audio_processing_tools_tpu.io.caf import (
    FIRMWARE_MAGIC_COOKIE,
    rearrange_bytes,
)
from audio_processing_tools_tpu.io.mark import (
    parse_mark_audio_file,
    write_mark_audio_file,
)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")

needs_shim = pytest.mark.skipif(
    not have_alac_shim(), reason="libalac_shim.so unavailable"
)


def _test_signal(rng, n=5581):
    t = np.arange(n)
    sig = 0.2 * np.sin(2 * np.pi * 523.0 * t / 11162.0)
    sig += 0.01 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


@needs_shim
def test_alac_roundtrip_lossless(rng):
    pcm = _test_signal(rng)
    payload = encode_alac_payload(pcm, 11162)
    # genuinely compressed, not verbatim PCM
    assert len(payload) < pcm.nbytes
    dec = decode_alac_payload(payload)
    np.testing.assert_array_equal(dec, pcm)


@needs_shim
def test_alac_roundtrip_odd_lengths(rng):
    # non-multiple-of-128 tails and odd payload padding both survive
    for n in (1, 127, 128, 129, 1000):
        pcm = _test_signal(rng, n)
        dec = decode_alac_payload(encode_alac_payload(pcm, 11162))
        np.testing.assert_array_equal(dec, pcm)


@needs_shim
def test_alac_packets_are_firmware_geometry(rng):
    pcm = _test_signal(rng, 128 * 5 + 17)
    packets, cookie = encode_alac_frames(pcm, 11162)
    assert len(packets) == 6
    assert len(cookie) == 24
    # the BER framing round-trips
    payload = encode_alac_payload(pcm, 11162)
    assert split_ber_packets(payload) == packets
    # packets decode under the firmware's fixed cookie (128-frame geometry)
    dec = decode_alac_payload(payload, FIRMWARE_MAGIC_COOKIE)
    np.testing.assert_array_equal(dec, pcm)


@needs_shim
def test_mark_alac_ingest_end_to_end(rng):
    """file_version >= 1 ALAC branch of parse_mark_audio_file on real bytes."""
    pcm = _test_signal(rng)
    blob = write_mark_audio_file(
        pcm, sample_rate=11162, timestamp=1700000001, file_version=1,
        device_id="ALACDEV",
    )
    sig, meta = parse_mark_audio_file(blob)
    assert meta["format"] == "alac"
    assert meta["audio_file_version"] == 1
    assert meta["sample_rate"] == 11162
    assert meta["device_id"] == "ALACDEV"
    np.testing.assert_array_equal(sig, pcm)


@needs_shim
def test_alac_golden_fixture_decodes():
    """Checked-in golden container decodes to the checked-in PCM."""
    with open(os.path.join(FIXTURE_DIR, "alac_golden.bin"), "rb") as f:
        blob = f.read()
    expected = np.load(os.path.join(FIXTURE_DIR, "alac_golden_pcm.npy"))
    sig, meta = parse_mark_audio_file(blob)
    assert meta["format"] == "alac"
    assert meta["device_id"] == "GOLDEN01"
    np.testing.assert_array_equal(sig, expected)


@needs_shim
def test_caf_rearrange_carries_real_packets(rng):
    """CAF re-containerization (ffmpeg-binary route) on real ALAC packets."""
    pcm = _test_signal(rng, 128 * 4)
    packets, _ = encode_alac_frames(pcm, 11162)
    payload = encode_alac_payload(pcm, 11162)
    caf = rearrange_bytes(payload)
    assert caf[:8] == b"caff\x00\x01\x00\x00"
    # every real packet's bytes land in the CAF data section, in order
    didx = caf.index(b"data") + 16
    data = caf[didx : didx + sum(len(p) for p in packets)]
    assert data == b"".join(packets)


@needs_shim
@pytest.mark.skipif(have_ffmpeg(), reason="ffmpeg present: route would work")
def test_explicit_ffmpeg_route_reports_missing_binary(rng):
    payload = encode_alac_payload(_test_signal(rng, 128), 11162)
    with pytest.raises(FileNotFoundError, match="ffmpeg"):
        decode_alac_to_pcm(payload, method="ffmpeg")


@needs_shim
def test_corrupt_packet_raises(rng):
    # stomp the first packet's frame header (element tag / header bits) —
    # structurally invalid for every decoder; ALAC has no CRC, so corruption
    # confined to the entropy-coded residuals may decode to garbage instead
    payload = bytearray(encode_alac_payload(_test_signal(rng, 256), 11162))
    payload[3] = 0x40  # element tag 2 (CCE): not a valid ALAC element
    with pytest.raises(RuntimeError, match="ALAC decode failed"):
        decode_alac_payload(bytes(payload))


def test_decode_method_validation():
    with pytest.raises(ValueError, match="unknown ALAC decode method"):
        decode_alac_to_pcm(b"", method="bogus")


# ---------------------------------------------------------------------------
# fast native decoder (native/alac_decode.cpp): libavcodec is the oracle


from audio_processing_tools_tpu.io.alac_native import (  # noqa: E402
    decode_alac_packets,
    encode_alac_frames as _encode_frames,
    have_fast_decoder,
)

needs_fast = pytest.mark.skipif(
    not have_fast_decoder(), reason="libalac_fast.so unavailable"
)


def _fast_corpus(rng, sr=11162, sec=1.2):
    """Signal classes spanning the rice/LPC/verbatim/zero-block code paths."""
    n = int(sr * sec)
    t = np.arange(n) / sr
    return {
        "gauss": rng.normal(0, 2000, n).astype(np.int16),
        "tone": (8000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16),
        "silence": np.zeros(n, np.int16),
        "ramp": (np.arange(n) % 30000 - 15000).astype(np.int16),
        "mixed": (3000 * np.sin(2 * np.pi * 100 * t)
                  + rng.normal(0, 50, n)).astype(np.int16),
        "loud": rng.normal(0, 20000, n).clip(-32768, 32767).astype(np.int16),
        "dc": np.full(n, 137, np.int16),
        "tiny_amp": rng.normal(0, 1.5, n).astype(np.int16),
        "impulses": np.where(rng.random(n) < 0.001, 30000, 0).astype(np.int16),
        "partial": rng.normal(0, 500, 1234).astype(np.int16),
        "one": np.array([-32768], np.int16),
        "extremes": np.tile(np.array([-32768, 32767], np.int16), 500),
    }


@needs_fast
def test_fast_decoder_loads():
    from audio_processing_tools_tpu.io.alac_native import load_alac_fast

    assert load_alac_fast().apt_alac_fast_version() >= 1


@needs_fast
@needs_shim
def test_fast_vs_avcodec_bit_exact(rng, monkeypatch):
    """Every corpus class decodes bit-identically through both routes."""
    for name, pcm in _fast_corpus(rng).items():
        payload = encode_alac_payload(pcm, 11162)
        monkeypatch.setenv("APT_ALAC_DECODER", "avcodec")
        ref = decode_alac_payload(payload)
        monkeypatch.setenv("APT_ALAC_DECODER", "fast")
        got = decode_alac_payload(payload)
        np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_array_equal(got[: len(pcm)], pcm, err_msg=name)


@needs_fast
def test_fast_payload_equals_fast_packets(rng, monkeypatch):
    """The one-call BER walk matches split_ber_packets + packet decode."""
    monkeypatch.setenv("APT_ALAC_DECODER", "fast")
    pcm = _test_signal(rng, 5581)
    payload = encode_alac_payload(pcm, 11162)
    via_payload = decode_alac_payload(payload)
    via_packets = decode_alac_packets(split_ber_packets(payload))
    np.testing.assert_array_equal(via_payload, via_packets)


@needs_fast
def test_fast_route_rejects_outside_subset(rng, monkeypatch):
    """A non-mono cookie is outside the fast subset; forcing it must fail
    loudly rather than silently fall back."""
    monkeypatch.setenv("APT_ALAC_DECODER", "fast")
    pcm = _test_signal(rng, 256)
    payload = encode_alac_payload(pcm, 11162)
    stereo_cookie = bytearray(FIRMWARE_MAGIC_COOKIE)
    stereo_cookie[9] = 2
    with pytest.raises(RuntimeError, match="fast ALAC decode requested"):
        decode_alac_payload(payload, bytes(stereo_cookie))


@needs_fast
def test_fast_corrupt_packet_raises(rng, monkeypatch):
    # structural header corruption (see test_corrupt_packet_raises)
    monkeypatch.setenv("APT_ALAC_DECODER", "fast")
    payload = bytearray(encode_alac_payload(_test_signal(rng, 256), 11162))
    payload[3] = 0x40  # element tag 2 (CCE): not a valid ALAC element
    with pytest.raises(RuntimeError, match="ALAC decode failed"):
        decode_alac_payload(bytes(payload))


@needs_fast
def test_fast_golden_fixture_decodes(monkeypatch):
    """The checked-in golden payload decodes identically via the fast route."""
    payload_path = os.path.join(FIXTURE_DIR, "alac_golden.bin")
    pcm_path = os.path.join(FIXTURE_DIR, "alac_golden_pcm.npy")
    if not (os.path.exists(payload_path) and os.path.exists(pcm_path)):
        pytest.skip("golden ALAC fixture not present")
    with open(payload_path, "rb") as f:
        payload = f.read()
    expected = np.load(pcm_path)
    monkeypatch.setenv("APT_ALAC_DECODER", "fast")
    np.testing.assert_array_equal(decode_alac_payload(payload), expected)


@needs_fast
@needs_shim
def test_fast_vs_avcodec_fuzz(rng, monkeypatch):
    """Randomized property fuzz: arbitrary lengths, amplitudes, and spectral
    shapes all decode bit-identically through both routes (the from-scratch
    decoder has no oracle other than libavcodec — keep hammering it)."""
    for trial in range(25):
        n = int(rng.integers(1, 4000))
        kind = trial % 5
        if kind == 0:
            pcm = rng.normal(0, float(rng.uniform(0.5, 25000)), n)
        elif kind == 1:
            f = float(rng.uniform(10, 5000))
            pcm = 30000 * np.sin(2 * np.pi * f * np.arange(n) / 11162)
        elif kind == 2:  # lowpassed noise: strong LPC predictability
            pcm = np.cumsum(rng.normal(0, 300, n))
        elif kind == 3:  # sparse spikes over silence: zero-run blocks
            pcm = np.where(rng.random(n) < 0.01, 25000.0, 0.0)
        else:  # hard-clipped square-ish: verbatim escapes
            pcm = np.sign(rng.normal(0, 1, n)) * 32767
        pcm = np.clip(pcm, -32768, 32767).astype(np.int16)
        payload = encode_alac_payload(pcm, 11162)
        monkeypatch.setenv("APT_ALAC_DECODER", "avcodec")
        ref = decode_alac_payload(payload)
        monkeypatch.setenv("APT_ALAC_DECODER", "fast")
        got = decode_alac_payload(payload)
        np.testing.assert_array_equal(
            got, ref, err_msg=f"trial {trial} kind {kind} n {n}"
        )
