"""Sequence parallelism for very long single recordings.

The audio analogue of context parallelism (SURVEY §2.3): shard the *time*
axis of one recording across devices.  Overlapped framing (``hop < n_fft``)
makes shard boundaries need a halo — each device fetches the leading
``n_fft - hop`` samples of its right neighbor with a ring ``ppermute`` inside
``shard_map`` (frames are anchored at their start sample), then
frames/windows/FFTs its local span.  The per-frame flux features exchange a
2-frame history halo from the left neighbor.

The causal noise trackers are small recurrences over (K,) vectors; after the
heavy sharded tensor work, their inputs (band power / flux, a few hundred
KB/minute) are all-gathered and the scans run replicated — sharding the
FLOP/HBM-heavy stage and replicating the tiny sequential stage is the
standard split (ring-passing the carry would serialize devices for no win at
these state sizes).

Exactness: outputs equal the unsharded causal computation bit-for-bit
(verified in ``tests/test_sequence_parallel.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from audio_processing_tools_tpu.ops.stft import fft_frequencies
from audio_processing_tools_tpu.ops.spectrogram import spectrogram_power


def sequence_sharded_stft_power(
    x: jnp.ndarray, mesh: Mesh, *, n_fft: int = 256, hop: int = 128,
    axis: str = "files",
) -> jnp.ndarray:
    """Causal |STFT|^2 of one long recording, time-sharded over the mesh.

    ``x`` length must be a multiple of ``n_devices * hop``.  Returns
    ``(F, T)`` with ``T = n/hop - (n_fft/hop - 1)`` frames (causal framing),
    time-sharded on the same axis.
    """
    n_dev = mesh.devices.size
    n = x.shape[-1]
    if n % (n_dev * hop) != 0:
        raise ValueError(
            f"signal length {n} must be a multiple of n_devices*hop "
            f"({n_dev}*{hop})"
        )
    overlap = n_fft - hop

    def local(x_loc):
        # x_loc: (n/n_dev,) local span; frames starting in this span reach
        # `overlap` samples into the right neighbor -> fetch a RIGHT halo
        # (each device sends its head to its left neighbor)
        idx = jax.lax.axis_index(axis)
        head = x_loc[:overlap]
        perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        halo = jax.lax.ppermute(head, axis, perm)  # right neighbor's head
        # last device has no right context: zero halo (frames past the end
        # are dropped by the caller)
        halo = jnp.where(idx == n_dev - 1, jnp.zeros_like(halo), halo)
        xa = jnp.concatenate([x_loc, halo])
        # len(xa) = n_loc + (n_fft - hop) -> exactly n_loc/hop causal frames
        Pw = spectrogram_power(xa, n_fft=n_fft, hop=hop, center=False)
        return jnp.swapaxes(Pw, 0, 1)  # (T_loc, F)

    fn = shard_map(
        local, mesh=mesh, in_specs=P(axis), out_specs=P(axis),
    )
    Pw = fn(x.astype(jnp.float32))          # (n/hop, F) time-sharded
    # the last (n_fft/hop - 1) frames spill past the signal end (computed
    # from the zero right-halo on the final device) — drop them
    T = n // hop - (n_fft // hop - 1)
    return jnp.swapaxes(Pw, 0, 1)[:, :T]


def batch_sequence_sharded_stft_power(
    xb: jnp.ndarray, mesh: Mesh, *, n_fft: int = 256, hop: int = 128,
    files_axis: str = "files", seq_axis: str = "seq",
) -> jnp.ndarray:
    """Composite 2-D sharding: clips over ``files`` (DP) x time over ``seq``
    (the CP analogue), in one ``shard_map``.

    ``xb`` is (B, n); B must divide the mesh's ``files`` extent and n must be
    a multiple of ``seq_extent * hop``. Each device holds a
    (B/files, n/seq) tile, exchanges the ``n_fft - hop`` right halo with its
    ``seq`` neighbor via ring ``ppermute`` (the ``files`` axis needs no
    communication), and frames/windows/FFTs its local span. Output
    (B, F, T) is sharded (files, -, seq) and equals the unsharded causal
    computation.
    """
    files_n = mesh.shape[files_axis]
    seq_n = mesh.shape[seq_axis]
    B, n = xb.shape
    if B % files_n != 0:
        raise ValueError(f"batch {B} must divide the '{files_axis}' extent {files_n}")
    if n % (seq_n * hop) != 0:
        raise ValueError(
            f"signal length {n} must be a multiple of seq_extent*hop "
            f"({seq_n}*{hop})"
        )
    overlap = n_fft - hop

    def local(x_loc):                       # (B_loc, n_loc)
        idx = jax.lax.axis_index(seq_axis)
        head = x_loc[:, :overlap]
        perm = [(i, (i - 1) % seq_n) for i in range(seq_n)]
        halo = jax.lax.ppermute(head, seq_axis, perm)
        halo = jnp.where(idx == seq_n - 1, jnp.zeros_like(halo), halo)
        xa = jnp.concatenate([x_loc, halo], axis=-1)
        # n_loc/hop causal frames per stream
        return spectrogram_power(xa, n_fft=n_fft, hop=hop, center=False)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=P(files_axis, seq_axis),
        out_specs=P(files_axis, None, seq_axis),
    )
    Pw = fn(xb.astype(jnp.float32))
    T = n // hop - (n_fft // hop - 1)
    return Pw[..., :T]


def sequence_sharded_band_flux(
    x: jnp.ndarray, mesh: Mesh, *, fs: int = 11162, n_fft: int = 256,
    hop: int = 128, mode_bands: Tuple[Tuple[float, float], ...] = (
        (450.0, 650.0), (800.0, 1050.0), (1500.0, 1800.0),
        (2350.0, 2550.0), (3150.0, 3350.0),
    ),
    axis: str = "files",
) -> Dict[str, jnp.ndarray]:
    """Time-sharded heavy stage of the detector front-end for one long clip.

    Per device: halo-exchange framing -> windowed FFT power -> band gather ->
    t-vs-(t-2) positive flux (2-frame halo via a second ppermute).  Returns
    per-frame mode flux (n_modes, T) plus band power, both gathered
    (replicated) for the downstream small recurrences.
    """
    n_dev = mesh.devices.size
    n = x.shape[-1]
    if n % (n_dev * hop) != 0:
        raise ValueError(
            f"signal length {n} must be a multiple of n_devices*hop"
        )
    overlap = n_fft - hop
    freqs = fft_frequencies(fs, n_fft)
    band_rows = np.flatnonzero((freqs >= 400.0) & (freqs <= 3500.0))
    freqs_band = freqs[band_rows]
    masks = np.stack(
        [(freqs_band >= lo) & (freqs_band <= hi) for lo, hi in mode_bands]
    ).astype(np.float32)

    def local(x_loc):
        idx = jax.lax.axis_index(axis)
        # sample halo: right neighbor's head (frames start in-shard)
        perm_left = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        halo = jax.lax.ppermute(x_loc[:overlap], axis, perm_left)
        halo = jnp.where(idx == n_dev - 1, jnp.zeros_like(halo), halo)
        xa = jnp.concatenate([x_loc, halo])
        T_loc = x_loc.shape[0] // hop
        Pw = spectrogram_power(xa, n_fft=n_fft, hop=hop, center=False)
        Pb = jnp.swapaxes(Pw[band_rows, :], 0, 1)   # (T_loc, K)

        # frame halo: the t-2 flux history comes from the LEFT neighbor
        perm_right = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        pb_halo = jax.lax.ppermute(Pb[-2:, :], axis, perm_right)
        pb_halo = jnp.where(idx == 0, jnp.zeros_like(pb_halo), pb_halo)
        hist = jnp.concatenate([pb_halo, Pb], axis=0)   # (T_loc+2, K)
        d2 = jnp.maximum(Pb - hist[:-2], 0.0)
        # global frames 0,1 are warm-up zeros
        gidx = idx * T_loc + jnp.arange(T_loc)
        d2 = jnp.where((gidx >= 2)[:, None], d2, 0.0)
        flux = jax.lax.dot(d2, jnp.asarray(masks).T,
                           precision=jax.lax.Precision.HIGHEST)  # (T_loc, n_modes)
        return Pb, flux

    fn = shard_map(local, mesh=mesh, in_specs=P(axis),
                   out_specs=(P(axis), P(axis)))
    Pb, flux = fn(x.astype(jnp.float32))
    T = n // hop - (n_fft // hop - 1)
    return {
        "band_power": jnp.swapaxes(Pb[:T], 0, 1),   # (K, T)
        "mode_flux": jnp.swapaxes(flux[:T], 0, 1),  # (n_modes, T)
    }
