"""Engine layer: the reference's DSP "model families", accelerator-native.

  spectral_noise   — STFT detector + noise suppressor (the flagship engine)
  frame_classifier — per-frame rain/noise/uncertain decision
  band_noise       — streaming firmware-shaped band-noise estimator
  time_domain      — stage-2 time-domain droplet confirmation
  roe              — legacy harmonic-novelty ("RoE") classifier
  dsd_emulator     — bit-faithful firmware DSD minute-histogram emulator
  mel_classifier   — mel band-energy rain classifier (BASELINE config #3)
"""
