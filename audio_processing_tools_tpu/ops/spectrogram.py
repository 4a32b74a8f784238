"""The detector front-end's power spectrogram: frame -> window -> rFFT -> |.|^2.

Every engine's power-only path (the classifier, RoE, mel, the sequence-
parallel shards) calls :func:`spectrogram_power`; the paths that need the
complex spectrum call :func:`~audio_processing_tools_tpu.ops.stft.stft`.
It is :func:`~audio_processing_tools_tpu.ops.stft.stft_power`, plain
``jax.numpy`` left to XLA, which hands the batched 256-point real FFT to
cuFFT on the GPU.
"""

from __future__ import annotations

from audio_processing_tools_tpu.ops.stft import stft_power

spectrogram_power = stft_power
