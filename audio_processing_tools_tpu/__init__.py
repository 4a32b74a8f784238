"""audio_processing_tools_tpu — a JAX rain-detection audio framework.

A ground-up JAX/XLA re-design of Arable's ``audio_processing_tools``
(rain-detection stack for the Mark-3 acoustic disdrometer).  The reference is
per-file NumPy/SciPy loops on CPU; this framework inverts that design:

* compute operates on ``(batch, time)`` / ``(batch, freq, frames)`` tensors,
  jit-compiled end-to-end for the accelerator (an NVIDIA GPU),
* every causal tracker (noise floors, quantile baselines, IIR state, firmware
  histograms) is a ``jax.lax.scan`` carry,
* the hot spectrogram path (frame -> window -> rFFT -> power) is one
  batched XLA program (cuFFT on the GPU),
* multi-chip scaling is a ``jax.sharding.Mesh`` over a ``files`` axis with
  XLA collectives for corpus aggregates (no process pools).

Layer map (mirrors SURVEY.md of the reference):
  io/          host-side: MARK container, ALAC/CAF, S3/DB (gated), loaders
  ops/         batched JAX primitives: stft, filters, features, trackers
  models/      engines: spectral noise suppressor+detector, band-noise
               estimator, time-domain confirmer, legacy RoE, DSD emulator
  framework/   processor protocol + batch orchestrator (API parity with
               audio_processing_framework.process_audio_batches_v2)
  parallel/    device mesh, sharded batch step, vmapped grid search
  postprocess/ legacy output-shape converters
"""

__version__ = "0.1.0"

from audio_processing_tools_tpu import ops  # noqa: F401
