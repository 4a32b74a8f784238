"""DSD firmware-emulator + transform ETL tests."""

import datetime as dt

import numpy as np
import pandas as pd
import pytest

from audio_processing_tools_tpu.host_analysis.dsd_emulator import (
    DsdProcessingEmulator,
    DsdProcessingEmualtor,
    dsd_minutes_vectorized,
)
from audio_processing_tools_tpu.transform import (
    emulator_output_to_df,
    reverse_binning_func,
    add_weighted_dsd_data,
    get_real_fft_df,
)

FS = 11162


def _rain_audio(rng, seconds=120):
    n = FS * seconds
    x = 0.01 * rng.standard_normal(n)
    for t0 in rng.integers(0, n - 700, 40 * seconds // 60):
        k = np.arange(600)
        x[t0 : t0 + 600] += 1.5 * np.exp(-k / 100.0) * np.sin(2 * np.pi * 520 * k / FS)
    return x.astype(np.float64)


def test_emulator_config_indices():
    emu = DsdProcessingEmulator()
    assert emu.fft_n_bins == 256
    assert emu.rain_low_idx == 19 and emu.rain_high_idx == 32
    assert emu.pft_low_idx == 5 and emu.pft_high_idx == 67
    assert emu.lwin_start_idx == 13 and emu.lwin_end_idx == 31
    assert emu.hwin_start_idx == 45 and emu.hwin_end_idx == 63
    assert DsdProcessingEmualtor is DsdProcessingEmulator  # compat alias


def test_emulator_minute_vectors(rng):
    x = _rain_audio(rng)
    emu = DsdProcessingEmulator(FS, 512, 512, False, 0)
    out = emu.process_audio_data(x, ts=0)
    assert len(out) == 2  # two minutes
    for vec in out:
        assert vec.shape == (100,)
        assert vec[:32].sum() > 0  # rain-band energy detected
        assert (vec[62:] <= 255).all()  # fft bins are uint8-bounded


def test_emulator_duty_cycle_on_quiet_audio(rng):
    """No rain -> emulator skips to the last 3 s of each minute."""
    x = (1e-5 * rng.standard_normal(FS * 120)).astype(np.float64)
    emu = DsdProcessingEmulator(FS, 512, 512, False, 0)
    out = emu.process_audio_data(x, ts=0)
    # first minute processed fully (starts raining=True), no rain found;
    # second minute duty-cycled: only ~3 s examined
    assert len(out) >= 1
    assert not emu.raining
    assert all(v[:32].sum() == 0 for v in out)


def test_emulator_short_audio():
    emu = DsdProcessingEmulator()
    assert emu.process_audio_data(np.zeros(100), ts=0) == []


def test_vectorized_matches_scalar_when_raining(rng):
    x = _rain_audio(rng, seconds=120)
    emu = DsdProcessingEmulator(FS, 512, 512, False, 0)
    ref = np.asarray(emu.process_audio_data(x.copy(), ts=0))
    fast = dsd_minutes_vectorized(x, FS, 512, ts=0.0)
    assert fast.shape[0] >= ref.shape[0]
    np.testing.assert_allclose(fast[: ref.shape[0]], ref, atol=1e-9)


def test_emulator_output_to_df(rng):
    out = [np.arange(100.0), np.arange(100.0) * 2]
    df = emulator_output_to_df(out, "DEV1", dt.datetime(2024, 1, 1, 12, 0, 0))
    assert list(df.columns[:3]) == ["dsd0", "dsd1", "dsd2"]
    assert df["time"].iloc[0] == pd.Timestamp(2024, 1, 1, 12, 1, 0)
    assert df["time"].iloc[1] == pd.Timestamp(2024, 1, 1, 12, 2, 0)
    assert (df["device"] == "DEV1").all()
    assert {"pft0", "fft37"}.issubset(df.columns)


def test_reverse_binning_and_weighting():
    assert abs(reverse_binning_func(0) - (0.0 / 0.6 + 0.6)) < 1e-12
    # inverse property: forward binning of the weight recovers the bin index
    for b in range(1, 32):
        w = reverse_binning_func(b)
        fwd = np.log(1 + (w - 0.6) * 0.6) / np.log(1.13)
        assert abs(fwd - b) < 1e-9

    df = pd.DataFrame({f"dsd{i}": [1.0, 2.0] for i in range(32)})
    out = add_weighted_dsd_data(df, add_weighted_dsd_sum=True)
    assert "dsd5_weighted" in out.columns
    assert "weighted_dsd_sum" in out.columns
    expected = sum(reverse_binning_func(i) for i in range(32))
    assert abs(out["weighted_dsd_sum"].iloc[0] - expected) < 1e-9


def test_get_real_fft_df(rng):
    sig = np.sin(2 * np.pi * 500 * np.arange(FS) / FS)
    df = get_real_fft_df(sig, FS)
    peak_freq = df.loc[df["amplitude"].idxmax(), "frequency"]
    assert abs(peak_freq - 500) < 2


def test_dsp_classification_from_audio_keys_fake_db(rng, monkeypatch, tmp_path):
    """Classification ETL (reference transform.py:148-248) on a fake DB:
    cache check, per-minute vmapped classification, version stamping,
    upsert to dsp_classification_from_raw_audio, cache skip on re-run."""
    import audio_processing_tools_tpu.transform as tr
    import audio_processing_tools_tpu.io.db as db
    import audio_processing_tools_tpu.io.fetch as fetch
    from audio_processing_tools_tpu.io.mark import write_mark_audio_file
    from audio_processing_tools_tpu import __version__

    def _roe_rain(seconds=120, fn=500.0, drops_per_10s=60):
        # harmonic-ping rain the RoE classifier is built for
        n = FS * seconds
        x = 0.003 * rng.standard_normal(n)
        k = np.arange(1000)
        ping = sum((1.0 / h) * np.sin(2 * np.pi * fn * h * k / FS)
                   for h in range(1, 6))
        for t0 in rng.integers(0, n - 1200, drops_per_10s * seconds // 10):
            x[t0 : t0 + 1000] += 0.6 * np.exp(-k / 80.0) * ping
        return np.clip(x, -1, 1)

    ts = 1700000000
    keys = [f"audio/DEV{i}/field/{ts + 60 * i}" for i in range(2)]
    blobs = {
        k: write_mark_audio_file(
            (_roe_rain() * 32767).astype(np.int16),
            sample_rate=FS, timestamp=ts, device_id=f"DEV{i}",
        )
        for i, k in enumerate(keys)
    }

    calls = {"upserts": [], "queries": []}

    def fake_get_device_raw_audio_data(keys=(), **kw):
        return {k: blobs[k] for k in keys}

    def fake_get_db_data(query, engine, **kw):
        calls["queries"].append(query)
        return fake_get_db_data.existing

    fake_get_db_data.existing = pd.DataFrame()

    def fake_upsert_df(df, table, engine, **kw):
        calls["upserts"].append((table, df.reset_index()))

    monkeypatch.setattr(tr, "validate_db_engine", lambda e: None)
    monkeypatch.setattr(db, "get_db_data", fake_get_db_data)
    monkeypatch.setattr(db, "upsert_df", fake_upsert_df)
    monkeypatch.setattr(fetch, "get_device_raw_audio_data",
                        fake_get_device_raw_audio_data)

    out = tr.dsp_classification_from_audio_keys(
        keys, db_engine=object(), verbose=False,
        local_cache_location=str(tmp_path),
    )
    # 2 keys x 2 complete minutes each
    assert len(out) == 4
    assert set(out["key"]) == set(keys)
    for col in ("time", "rain_drop_count", "frain_mean", "sample_rate",
                "dsp_classifier_version", "device", "update_time",
                "create_time"):
        assert col in out.columns, col
    assert (out["dsp_classifier_version"] == __version__).all()
    # right-edge minute labels: start + 1 min, start + 2 min
    t0 = dt.datetime.fromtimestamp(ts)
    k0 = out[out["key"] == keys[0]].sort_values("time")
    assert list(k0["time"]) == [t0 + dt.timedelta(minutes=1),
                                t0 + dt.timedelta(minutes=2)]
    assert (k0["device"] == "DEV0").all()
    # heavy synthetic rain: the classifier should count drops
    assert out["rain_drop_count"].max() > 0

    table, upserted = calls["upserts"][0]
    assert table == "dsp_classification_from_raw_audio"
    assert len(upserted) == 4

    # second run: DB cache now covers the keys -> nothing reprocessed
    fake_get_db_data.existing = out
    out2 = tr.dsp_classification_from_audio_keys(
        keys, db_engine=object(), local_cache_location=str(tmp_path),
    )
    assert len(calls["upserts"]) == 1  # no new upsert
    assert len(out2) == len(out)


def test_classification_worker_rejects_short_audio(rng, monkeypatch, tmp_path):
    import audio_processing_tools_tpu.io.fetch as fetch
    import audio_processing_tools_tpu.transform as tr
    from audio_processing_tools_tpu.io.mark import write_mark_audio_file

    blob = write_mark_audio_file(
        (rng.standard_normal(FS * 30) * 500).astype(np.int16),
        sample_rate=FS, timestamp=1700000000, device_id="SHORT",
    )
    monkeypatch.setattr(fetch, "get_device_raw_audio_data",
                        lambda keys=(), **kw: {k: blob for k in keys})
    with pytest.raises(ValueError, match="less than 1 minute"):
        tr.process_audio_file_classification(
            "audio/SHORT/field/1700000000", str(tmp_path), False, False)


def test_dsd_device_matches_scalar_emulator(rng):
    """Device (JAX) DSD minutes == the scalar firmware emulator, bin for bin,
    on a 2-minute raining recording."""
    from audio_processing_tools_tpu.host_analysis.dsd_device import (
        dsd_minutes_device,
    )

    x = _rain_audio(rng, seconds=130)
    emu = DsdProcessingEmulator(FS, 512, 512, False, 0)
    ref = np.asarray(emu.process_audio_data(x, ts=0))
    got = dsd_minutes_device(x.astype(np.float32), FS)
    assert got.shape == ref.shape == (3, 100)  # 2 full + 1 partial minute
    # integer count/index bins must agree exactly
    np.testing.assert_array_equal(got[:, :62], ref[:, :62])
    # fft log bins: f32 vs f64 FFT can flip a log boundary by at most 1
    assert np.max(np.abs(got[:, 62:] - ref[:, 62:])) <= 1
    assert (got[:, 62:] == ref[:, 62:]).mean() > 0.95


def test_dsd_device_batched(rng):
    from audio_processing_tools_tpu.host_analysis.dsd_device import (
        dsd_minutes_device,
    )

    xb = np.stack([_rain_audio(rng, seconds=65) for _ in range(3)])
    got = dsd_minutes_device(xb.astype(np.float32), FS)
    assert got.shape == (3, 2, 100)  # full minute + 5 s partial
    for i in range(3):
        emu = DsdProcessingEmulator(FS, 512, 512, False, 0)
        ref = np.asarray(emu.process_audio_data(xb[i], ts=0))
        np.testing.assert_array_equal(got[i, :, :62], ref[:, :62])


def test_dsd_device_short_audio(rng):
    from audio_processing_tools_tpu.host_analysis.dsd_device import (
        dsd_minutes_device,
    )

    # 10 s -> one partial-minute vector, same as the scalar emulator
    x = np.zeros(FS * 10, np.float32)
    emu = DsdProcessingEmulator(FS, 512, 512, False, 0)
    ref = np.asarray(emu.process_audio_data(x.astype(np.float64), ts=0))
    out = dsd_minutes_device(x, FS)
    assert out.shape == ref.shape == (1, 100)
    np.testing.assert_array_equal(out[:, :62], ref[:, :62])
    # too short for a single frame -> nothing
    assert dsd_minutes_device(np.zeros(100, np.float32), FS).shape == (0, 100)


def test_duty_cycled_device_path_bit_parity(rng):
    """Duty-cycled DSD on device: the skip path
    actually ENGAGES (rain stops, minutes drop to the 3-s check window,
    then rain in a check window re-engages full processing) and every
    emitted minute is bit-equal to the scalar emulator — including the
    one-frame schedule shift a non-raining minute introduces (the check
    loop has no boundary push) and a non-zero start timestamp."""
    from audio_processing_tools_tpu.host_analysis.dsd_device import (
        dsd_minutes_device_duty_cycled,
    )
    from audio_processing_tools_tpu.host_analysis.dsd_emulator import (
        DsdProcessingEmulator,
    )

    FS = 11162
    k = np.arange(800)
    ping = np.exp(-k / 60.0) * sum(
        a * np.sin(2 * np.pi * f * k / FS) for f, a in [(520, 1.0), (900, 0.5)]
    )
    n = FS * 200  # 3 full minutes + a partial one

    def build(rain_windows):
        x = 0.0005 * rng.standard_normal(n)
        for lo_s, hi_s, m in rain_windows:
            for t0 in rng.integers(int(FS * lo_s), int(FS * hi_s), m):
                x[t0 : t0 + 800] += 0.5 * ping
        return np.clip(x, -1, 1)

    scenarios = {
        # rain in minute 0 only: duty cycle engages from minute 1 on
        "rain_then_dry": (build([(0.25, 50, 25)]), 0.0),
        # dry minutes, rain lands in minute 2's check window (177-180 s):
        # minute 3 re-engages full processing
        "re_engage": (build([(0.25, 50, 25), (177.2, 179.5, 8),
                             (181, 198, 12)]), 0.0),
        "all_silent": (np.zeros(n), 0.0),
        # recording starting mid-minute exercises the ts alignment
        "ts_offset": (build([(0.25, 50, 25)])[: FS * 150], 23.0),
    }
    for name, (x, ts) in scenarios.items():
        emu = DsdProcessingEmulator(FS, 512, 512, False, 0)
        ref = emu.process_audio_data(x.astype(np.float64), ts)
        got = dsd_minutes_device_duty_cycled(x.astype(np.float32), FS, 512,
                                             ts=ts)
        assert len(ref) == len(got), (name, len(ref), len(got))
        assert len(ref) >= 2, name  # the chain actually ran multiple minutes
        for m, (r, g) in enumerate(zip(ref, got)):
            np.testing.assert_array_equal(
                np.asarray(g), r, err_msg=f"{name}: minute {m} not bit-equal"
            )
        if name == "rain_then_dry":
            # prove the skip path engaged: some minute after the rainy first
            # one is a check window — zero fft-window bins, because the check
            # path never runs calculate_fft_energies
            assert np.any(ref[0][:32] != 0)       # minute 0 saw rain
            assert any(np.all(v[62:] == 0) for v in ref[1:]), (
                "duty cycle never engaged in this scenario"
            )
