"""Device-resident DSD minute-histogram pipeline (JAX).

The firmware emulator (``dsd_emulator.py``) is a per-frame Python loop — an
analysis oracle. This module maps the same per-minute 32+30+38 vector
computation onto the device as pure tensor math (SURVEY §7.5's plan):

  * per-frame |FFT| over the minute's frames — one batched FFT,
  * loudness histogram — ``segment_sum`` over log-binned indices,
  * pft 2-second slots — a (slot x bin) ``segment_sum`` + per-slot argmax
    (the emulator's running ``peak_histogram`` resets exactly at slot
    boundaries, so each slot's final written value is the argmax of that
    slot's own peak counts),
  * fft windows — peak-energy ``segment_sum`` + log scaling.

The frame->minute / frame->slot schedules are the emulator's timestamp
arithmetic evaluated at trace time (static), so outputs match the scalar
emulator for the always-raining case.  Duty cycling (the firmware's default
operating mode) is data-dependent control flow across minutes:
:func:`dsd_minutes_device_duty_cycled` keeps it on device by computing both
candidate vectors per minute (full window and 3-s check window) in one
batched program and resolving the tiny raining chain on the host.  Parity is
asserted in ``tests/test_dsd_transform.py``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from audio_processing_tools_tpu.host_analysis.dsd_emulator import (
    DsdProcessingEmulator,
)


def _minute_schedule(n_samples: int, fs: int, frame_length: int
                     ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Static (frame index, pft slot) arrays per complete minute at ts=0,
    mirroring the emulator's ``get_frames_to_next_interval`` arithmetic."""
    emu = DsdProcessingEmulator(fs, frame_length, frame_length, False, 0)
    emu.set_audio_timestamp(0, n_samples)
    hop = frame_length
    minutes_frames, minutes_slots = [], []
    pos_frames = 0
    total_frames = n_samples // hop
    while True:
        t_next = emu.rain_chk_period_seconds - (
            emu.ts_current % emu.rain_chk_period_seconds
        )
        if t_next < hop / fs:
            t_next += emu.rain_chk_period_seconds
        frames = int(t_next * fs / hop)
        partial = pos_frames + frames > total_frames
        if partial:
            # trailing partial minute: the emulator processes the remaining
            # frames and still emits a vector
            frames = total_frames - pos_frames
            if frames <= 0:
                break
        idxs = np.arange(pos_frames, pos_frames + frames)
        ts = idxs * hop / fs
        slots = ((ts % 60.0) / 2.0).astype(np.int64)
        minutes_frames.append(idxs)
        minutes_slots.append(slots)
        pos_frames += frames
        emu.frame_count += frames
        emu.ts_current = emu.frame_count * hop / fs
        if partial:
            break
    return minutes_frames, minutes_slots


@partial(jax.jit, static_argnames=("fs", "frame_length", "slots_tuple"))
def _dsd_minute(frames: jnp.ndarray, *, fs: int, frame_length: int,
                slots_tuple: tuple) -> jnp.ndarray:
    """One minute's (T, frame_length) frames -> the 100-bin vector."""
    emu = DsdProcessingEmulator(fs, frame_length, frame_length, False, 0)
    T = frames.shape[0]
    slots = jnp.asarray(np.asarray(slots_tuple, np.int64))
    nb = emu.fft_n_bins

    spec = jnp.abs(jnp.fft.fft(frames.astype(jnp.float32), axis=-1))

    # loudness: log-binned count histogram of rain-band energy
    drop_e = jnp.sum(spec[:, emu.rain_low_idx : emu.rain_high_idx + 1], axis=-1)
    above = drop_e > emu.rain_energy_threshold
    rain_e = jnp.maximum(
        (drop_e - emu.rain_energy_threshold) * emu.rain_log_factor, 0.0
    )
    hidx = jnp.floor(
        jnp.log1p(rain_e) / math.log(emu.rain_log_base)
    ).astype(jnp.int32)
    hidx = jnp.clip(hidx, 0, emu.loudness_bins - 1)
    loudness = jax.ops.segment_sum(
        above.astype(jnp.float32), hidx, num_segments=emu.loudness_bins
    )

    # per-frame pft peak
    pft_spec = spec[:, emu.pft_low_idx : emu.pft_high_idx]
    pk = jnp.argmax(pft_spec, axis=-1).astype(jnp.int32) + emu.pft_low_idx
    pk_energy = jnp.take_along_axis(spec, pk[:, None], axis=-1)[:, 0]
    valid = pk_energy != 0

    # pft slots: per-slot peak-index counts -> argmax (ties -> lowest index,
    # matching np.argmax in the emulator)
    seg = slots.astype(jnp.int32) * nb + pk
    counts = jax.ops.segment_sum(
        valid.astype(jnp.float32), seg, num_segments=emu.pft_bins * nb
    ).reshape(emu.pft_bins, nb)
    pft_vals = jnp.argmax(counts, axis=-1).astype(jnp.float32)
    # slots with no frames this minute keep 0 (full minutes cover all 30)
    has_frames = jax.ops.segment_sum(
        jnp.ones((T,), jnp.float32), slots.astype(jnp.int32),
        num_segments=emu.pft_bins,
    ) > 0
    pft_vals = jnp.where(has_frames, pft_vals, 0.0)

    # fft windows: accumulated peak energy, log-scaled
    freq_hist = jax.ops.segment_sum(
        jnp.where(valid, pk_energy, 0.0), pk, num_segments=nb
    )
    j = jnp.minimum(
        jnp.floor(jnp.log(freq_hist + 2.719) * 25.0), 255.0
    )
    half = emu.fft_bins // 2
    lower = j[emu.lwin_start_idx : emu.lwin_start_idx + half]
    if emu.hwin_start_idx == emu.lwin_end_idx:
        upper = jnp.zeros((half,), j.dtype)
    else:
        upper = j[emu.hwin_start_idx : emu.hwin_start_idx + half]

    return jnp.concatenate([loudness, pft_vals, lower, upper])


def dsd_minutes_device_duty_cycled(
    audio, fs: int = 11162, frame_length: int = 512, ts: float = 0.0
):
    """Duty-cycled per-minute DSD vectors with the frame math on device.

    The firmware's default operating mode (reference
    ``device_dsd_processing_emulator.py:256-314``): minute ``m`` processes
    its full frames when minute ``m-1`` saw rain, else skips to the last-3 s
    rain-check window; ``raining`` is re-decided from the emitted loudness
    bins.  The chain is data-dependent across minutes — and the frame
    *alignment* is too: the check loop has no ``t < hop/fs`` boundary push,
    so a non-raining minute consumes one boundary-straddling frame that a
    raining minute would defer, shifting every subsequent minute's schedule.
    A fixed per-minute precompute therefore cannot be bit-faithful; instead
    this walks the emulator's exact control flow on the host while every
    processed segment (full minute or 66-frame check window) runs as one
    jitted device program (``_dsd_minute``).  Segment shapes repeat
    (1307/1308-frame minutes, 65/66-frame checks), so the jit cache holds a
    handful of compiles regardless of recording length.

    Returns the emulator's output: a list of 100-bin vectors for (n,) input,
    or a list of such lists for (B, n).
    """
    x = jnp.asarray(audio, jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    n = int(x.shape[-1])
    outs = []

    emu0 = DsdProcessingEmulator(fs, frame_length, frame_length, False, 0)
    hop = frame_length
    period = float(emu0.rain_chk_period_seconds)
    duration = float(emu0.rain_chk_duration_seconds)
    L = emu0.loudness_bins

    def segment_vec(row, f0: int, f1: int, fc0: int, ts0: float) -> np.ndarray:
        """Frames [f0, f1) of this recording; the emulator's per-frame slot
        uses the GLOBAL timestamp ``ts0 + (fc0 + i) * hop / fs``."""
        frame_ts = ts0 + (fc0 + np.arange(f1 - f0)) * hop / fs
        slots = ((frame_ts % period) / 2.0).astype(np.int64)
        frames = x[row, f0 * hop : f1 * hop].reshape(f1 - f0, hop)
        return np.asarray(_dsd_minute(
            frames, fs=fs, frame_length=frame_length,
            slots_tuple=tuple(int(s) for s in slots),
        ))

    for b in range(x.shape[0]):
        vectors = []
        # emulator state for ts-aligned recordings (set_audio_timestamp)
        ts_start = ts - (ts % period)
        ts_cur = float(ts)
        fc = int((ts % period) * fs / hop)
        f_pos = 0  # frames consumed from THIS recording
        raining = True
        num_minutes = math.ceil(n / (fs * period))
        if n < frame_length:
            outs.append(vectors)
            continue
        ok = True
        for _ in range(int(num_minutes)):
            remaining = (n - f_pos * hop) // hop
            if raining:
                t_next = period - (ts_cur % period)
                if t_next < hop / fs:
                    t_next += period
                seg = min(int(t_next * fs / hop), remaining)
                if (n - f_pos * hop) < frame_length:
                    seg = 0
                vec = (segment_vec(b, f_pos, f_pos + seg, fc, ts_start)
                       if seg > 0 else np.zeros(100))
                f_pos += seg
                fc += seg
                ts_cur = ts_start + fc * hop / fs
            else:
                t_next = period - (ts_cur % period)
                if t_next < hop / fs:
                    t_next += period
                rct = ts_cur + t_next - duration
                # skip to the rain-check window
                while ts_cur < rct:
                    f_pos += 1
                    fc += 1
                    ts_cur = ts_start + fc * hop / fs
                    if (n - f_pos * hop) < frame_length:
                        ok = False
                        break
                if not ok:
                    break
                f0 = f_pos
                while ts_cur < rct + duration:
                    if (n - f_pos * hop) >= frame_length:
                        f_pos += 1
                        fc += 1
                        ts_cur = ts_start + fc * hop / fs
                    else:
                        ok = False
                        break
                if not ok:
                    break
                vec = segment_vec(b, f0, f_pos, fc - (f_pos - f0),
                                  ts_start).copy()
                # the emulator's check path never calls
                # calculate_fft_energies: the 38 fft-window bins stay zero
                vec[L + emu0.pft_bins :] = 0.0
            vectors.append(vec)
            raining = bool(np.any(vec[:L] != 0))
            if (n - f_pos * hop) < frame_length:
                break
        outs.append(vectors)
    return outs[0] if squeeze else outs


def dsd_minutes_device(audio, fs: int = 11162, frame_length: int = 512
                       ) -> np.ndarray:
    """Per-minute DSD vectors computed on device (always-raining case).

    ``audio`` is (n,) or (B, n) float in [-1, 1]; returns (M, 100) or
    (B, M, 100) for the M complete minutes at ts=0. Matches
    :class:`DsdProcessingEmulator` / ``dsd_minutes_vectorized`` bit-for-bit
    on integer bins (float32 FFT; bin-edge values could differ by one count
    in principle — the parity test pins exactness on real signals).
    """
    x = jnp.asarray(audio, jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    n = x.shape[-1]
    minutes_frames, minutes_slots = _minute_schedule(n, fs, frame_length)
    if not minutes_frames:
        out = np.zeros((x.shape[0], 0, 100))
        return out[0] if squeeze else out

    vecs = []
    for idxs, slots in zip(minutes_frames, minutes_slots):
        lo = int(idxs[0]) * frame_length
        hi = (int(idxs[-1]) + 1) * frame_length
        frames = x[:, lo:hi].reshape(x.shape[0], len(idxs), frame_length)
        fn = jax.vmap(
            lambda fr: _dsd_minute(
                fr, fs=fs, frame_length=frame_length,
                slots_tuple=tuple(int(s) for s in slots),
            )
        )
        vecs.append(fn(frames))
    # one device->host fetch for all minutes (per-minute np.asarray would
    # cost M dispatch round trips)
    out = np.asarray(jnp.stack(vecs, axis=1))  # (B, M, 100)
    return out[0] if squeeze else out
