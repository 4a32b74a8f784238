"""Strided framing as a gather — the JAX analogue of ``np.lib.stride_tricks``.

The reference builds frame views with ``as_strided`` in several places
(``edge/feature_extraction.py:221-231``, ``edge/dsp_rain_detection.py:638-654``,
``edge/band_noise_estimator.py:42-53``).  JAX has no strided views; a static
index gather compiles to an efficient XLA gather/reshape and keeps shapes
static for the compiler.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def num_frames(n_samples: int, frame_len: int, hop: int) -> int:
    """Number of complete frames for a non-centered framing.

    Matches ``1 + (n - frame_len) // hop`` used throughout the reference
    (e.g. ``edge/feature_extraction.py:224``).  Returns 0 when the signal is
    shorter than one frame.
    """
    if n_samples < frame_len:
        return 0
    return 1 + (n_samples - frame_len) // hop


def frame_signal(x: jnp.ndarray, frame_len: int, hop: int) -> jnp.ndarray:
    """Frame the last axis of ``x`` into overlapping windows.

    Parameters
    ----------
    x : (..., n) array
    frame_len, hop : static ints

    Returns
    -------
    (..., T, frame_len) array with ``T = 1 + (n - frame_len) // hop``.
    """
    n = x.shape[-1]
    t = num_frames(n, frame_len, hop)
    if t == 0:
        return jnp.zeros(x.shape[:-1] + (0, frame_len), dtype=x.dtype)
    if frame_len % hop == 0:
        # frame_len = m * hop: frame t is m adjacent hop-blocks, so framing is
        # reshape + m shifted block views + concat — pure BW-bound data
        # movement.  The generic path below is a (T, frame_len) index
        # gather.
        m = frame_len // hop
        nb = (t + m - 1)  # blocks needed; (t+m-1)*hop <= n always holds
        blocks = x[..., : nb * hop].reshape(x.shape[:-1] + (nb, hop))
        if m == 1:
            return blocks
        return jnp.concatenate(
            [blocks[..., j : j + t, :] for j in range(m)], axis=-1
        )
    # Static gather indices: folded into the compiled executable.
    idx = np.arange(t)[:, None] * hop + np.arange(frame_len)[None, :]
    return x[..., idx]
