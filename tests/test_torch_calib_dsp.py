"""The calibration pipeline's signal analysis in the PyTorch port against
the JAX package's (CPU, float64): `goertzel`, `harmonics`, `notes`,
`residuals` and `alias_audit.analyze` / `plateau_metric`, on the same
seeded NumPy inputs, plus the JAX package's own cases of these modules
(`tests/test_calib_pipeline.py:25-80`,
`tests/test_alias_audit_regression.py::test_baseline_file_is_complete`).

Tolerances: single-bin magnitudes within 1e-12 relative (the sum order of
the einsum and the libm differ); a refined f0 is the same candidate of the
scan (within 1e-12 relative, a different candidate is ≥ 0.1 Hz away);
feature dicts within 1e-9 relative; the alias audit's dB values within
1e-9 dB; the NumPy modules (notes, residuals) equal.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu.calib import alias_audit as jalias
from openwurli_tpu.calib import goertzel as jg
from openwurli_tpu.calib import harmonics as jh
from openwurli_tpu.calib import notes as jnotes
from openwurli_tpu.calib import residuals as jres
from openwurli_tpu_torch.calib import (alias_audit, goertzel, harmonics,
                                       notes, residuals)

torch.set_num_threads(1)

SR = 44100.0
CPU = "cpu"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300),
                  initial=0.0)


def _synthetic_note(f0=220.0, seconds=1.6):
    """tests/test_calib_pipeline.py:68-73: two decaying partials."""
    t = np.arange(int(SR * seconds)) / SR
    return (np.exp(-t * 0.576) * np.sin(2 * np.pi * f0 * t)
            + 0.1 * np.sin(2 * np.pi * 2 * f0 * t) * np.exp(-t * 1.0))


def _noisy_tone(seed, f0, seconds, harmonics_=6):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    x = sum(rng.uniform(0.05, 1.0) / k * np.sin(2 * np.pi * k * f0 * t
                                                 + rng.uniform(0, 6))
            for k in range(1, harmonics_ + 1))
    return x * np.exp(-t * 1.3) + 1e-3 * rng.normal(size=t.size)


# ── goertzel ──


def test_dft_magnitude_matches_reference():
    rng = np.random.default_rng(0)
    sig = rng.normal(size=(3, 4410))
    for freqs in (np.array([100.0, 440.0, 1234.5, 8000.0]),
                  rng.uniform(50, 5000, (3, 5))):
        port = goertzel.dft_magnitude(sig, freqs, SR, CPU)
        ref = np.asarray(jg.dft_magnitude(jnp.asarray(sig),
                                          jnp.asarray(freqs), SR))
        assert port.dtype == torch.float64 and port.shape == ref.shape
        assert _rel(port.numpy(), ref) <= 1e-12
    one = goertzel.dft_magnitude(sig[0], [440.0], SR, CPU)
    assert one.shape == (1,)


@pytest.mark.parametrize("steps", [21, 101])
def test_refine_f0_and_ladder_match_reference(steps):
    sigs = np.stack([_noisy_tone(s, f, 0.5) for s, f in
                     ((1, 220.0), (2, 443.7), (3, 1046.5))])
    guess = np.array([221.0, 440.0, 1049.0])
    port = goertzel.refine_f0(sigs, guess, SR, steps=steps, device=CPU)
    ref = np.asarray(jg.refine_f0(jnp.asarray(sigs), jnp.asarray(guess),
                                  SR, steps=steps))
    assert _rel(port.numpy(), ref) <= 1e-12
    f0, mags = goertzel.harmonic_ladder(sigs, guess, SR, device=CPU)
    jf0, jmags = jg.harmonic_ladder(jnp.asarray(sigs), jnp.asarray(guess),
                                    SR)
    assert _rel(f0.numpy(), jf0) <= 1e-12
    assert _rel(mags.numpy(), jmags) <= 1e-12
    band = goertzel.band_rms(sigs, 5000.0, 18000.0, SR, CPU)
    assert _rel(band.numpy(), jg.band_rms(jnp.asarray(sigs), 5000.0,
                                          18000.0, SR)) <= 1e-12


# the JAX package's own cases (tests/test_calib_pipeline.py:25-52)


def test_goertzel_recovers_known_sinusoid():
    f, amp = 1000.0, 0.7
    t = np.arange(int(SR * 0.5)) / SR
    mag = float(goertzel.dft_magnitude(amp * np.sin(2 * np.pi * f * t), [f],
                                       SR, CPU)[0])
    assert abs(mag - amp) < 0.01


def test_goertzel_batched():
    t = np.arange(int(SR * 0.2)) / SR
    sigs = np.stack([np.sin(2 * np.pi * 440 * t),
                     0.5 * np.sin(2 * np.pi * 880 * t)])
    mags = goertzel.dft_magnitude(sigs, [440.0, 880.0], SR, CPU)
    assert mags.shape == (2, 2)
    assert abs(float(mags[0, 0]) - 1.0) < 0.02
    assert abs(float(mags[1, 1]) - 0.5) < 0.02
    assert float(mags[0, 1]) < 0.05


def test_refine_f0():
    true_f = 443.7
    t = np.arange(int(SR * 0.5)) / SR
    refined = float(goertzel.refine_f0(np.sin(2 * np.pi * true_f * t),
                                       440.0, SR, span_hz=5.0, steps=101,
                                       device=CPU))
    assert abs(refined - true_f) < 0.2


# ── harmonics ──


def _assert_features_close(port, ref):
    assert set(port) == set(ref)
    for k, v in ref.items():
        if k == "windows":
            assert set(port[k]) == set(v)
            for name, amps in v.items():
                a, b = np.asarray(port[k][name]), np.asarray(amps)
                assert np.array_equal(np.isnan(a), np.isnan(b)), name
                ok = ~np.isnan(b)
                assert _rel(a[ok], b[ok]) <= 1e-9, (name, a, b)
        else:
            a, b = np.asarray(port[k], np.float64), np.asarray(v, np.float64)
            assert np.array_equal(np.isnan(a), np.isnan(b)), k
            ok = ~np.isnan(b)
            assert _rel(a[ok], b[ok]) <= 1e-9, (k, a, b)


@pytest.mark.parametrize("case", ["synthetic", "noisy", "short"])
def test_extract_note_features_matches_reference(case):
    if case == "synthetic":
        audio, f0, onset, dur = _synthetic_note(), 220.0 * 1.01, 0.0, None
    elif case == "noisy":
        audio = np.concatenate([np.zeros(4410), _noisy_tone(5, 311.1, 1.7)])
        f0, onset, dur = 311.1, 0.1, 1.6
    else:  # shorter than the sustain window and the late decay points
        audio, f0, onset, dur = _noisy_tone(6, 523.3, 0.4), 523.3, 0.0, None
    port = harmonics.extract_note_features(audio, SR, f0, onset, dur,
                                           device=CPU)
    ref = jh.extract_note_features(audio, SR, f0, onset, dur)
    _assert_features_close(port, ref)
    assert json.loads(json.dumps(port)).keys() == ref.keys()
    assert harmonics.decay_rate_db_per_s(port["decay_db"],
                                         port["decay_times"]) == \
        pytest.approx(jh.decay_rate_db_per_s(ref["decay_db"],
                                             ref["decay_times"]),
                      rel=1e-9, nan_ok=True)
    snr = harmonics.measure_interharmonic_snr(audio, SR, port["f0_hz"],
                                              device=CPU)
    ref_snr = jh.measure_interharmonic_snr(audio, SR, ref["f0_hz"])
    assert np.max(np.abs(snr - ref_snr)) <= 1e-9


def test_harmonic_features_on_synthetic_note():
    """tests/test_calib_pipeline.py:66-80."""
    f0 = 220.0
    f = harmonics.extract_note_features(_synthetic_note(f0), SR, f0 * 1.01,
                                        device=CPU)
    assert abs(f["f0_hz"] - f0) < 1.0
    es = f["windows"]["early_sustain"]
    assert abs((es[1] - es[0]) - 20 * np.log10(0.1)) < 2.0
    d = harmonics.decay_rate_db_per_s(f["decay_db"], f["decay_times"])
    assert 3.0 < d < 7.0, d


# ── notes ──


def _recording():
    """Three tones with gaps, one pair overlapping (NumPy, seeded)."""
    x = np.zeros(int(SR * 3.2))
    for onset, f0, seed in ((0.3, 261.6, 1), (1.2, 392.0, 2),
                            (1.5, 523.3, 3), (2.4, 196.0, 4)):
        tone = _noisy_tone(seed, f0, 0.7)
        i = int(onset * SR)
        x[i:i + tone.size] += 0.3 * tone
    return x + 1e-4 * np.random.default_rng(9).normal(size=x.size)


def test_notes_match_reference():
    audio = _recording()
    np.testing.assert_array_equal(notes.detect_onsets(audio, SR),
                                  jnotes.detect_onsets(audio, SR))
    seg = audio[int(1.2 * SR):int(1.7 * SR)]
    assert notes.estimate_pitch(seg, SR) == jnotes.estimate_pitch(seg, SR)
    found = notes.extract_notes(audio, SR, method="spectral", device=CPU)
    ref = jnotes.extract_notes(audio, SR, method="spectral")
    assert found == ref and len(found) >= 3
    assert notes.score_isolation(found, audio, SR) == \
        jnotes.score_isolation(ref, audio, SR)
    assert notes.TIER_WEIGHTS == jnotes.TIER_WEIGHTS


# ── residuals ──


def _feature_pair(seed):
    rng = np.random.default_rng(seed)

    def feats():
        return {"f0_hz": 440.0 * (1 + rng.normal() * 0.01),
                "windows": {"early_sustain":
                            list(-20 - np.cumsum(rng.uniform(0, 8, 8)))},
                "decay_db": list(-20 - np.cumsum(rng.uniform(0.5, 3, 6))),
                "decay_times": [0.1, 0.3, 0.5, 0.8, 1.0, 1.5]}

    return feats(), feats(), rng.uniform(5, 30, 8)


def test_residuals_match_reference():
    obs, ref_obs = [], []
    for seed in range(12):
        real, model, snr = _feature_pair(seed)
        if seed % 4 == 1:
            real["windows"]["early_sustain"][3] = -5.0  # an anomaly
        if seed % 4 == 2:
            real["decay_db"] = [float("nan")] * 6
        args = (real, model, 40 + seed, 0.1 * (seed % 9),
                ("gold", "silver", "bronze", "other")[seed % 4])
        o = residuals.compute_observation(*args, real_snr_db=snr)
        r = jres.compute_observation(*args, real_snr_db=snr)
        for a, b in zip(o, r):
            np.testing.assert_array_equal(a, b)
        obs.append(o)
        ref_obs.append(r)
    batch = residuals.assemble_batch(obs, device=CPU)
    ref = jres.assemble_batch(ref_obs)
    for k in ref._fields:
        a, b = getattr(batch, k), np.asarray(getattr(ref, k))
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    assert batch.mask.dtype == torch.bool
    assert [residuals.bucket_velocity(v) for v in (0.0, 0.5, 1.0)] == \
        [jres.bucket_velocity(v) for v in (0.0, 0.5, 1.0)]


# ── alias audit ──


def test_plateau_metric_fixtures():
    """tests/test_calib_pipeline.py:55-63 (the reference's fixtures)."""
    desc = [-50.0 - 5.0 * i for i in range(12)]
    delta, _ = alias_audit.plateau_metric(desc)
    assert delta < 0.0
    prefix = [0.0, -10.0, -20.0, -30.0, -50.0,
              -67.0, -63.0, -58.0, -58.0, -58.0, -61.0, -70.0]
    delta, from_h = alias_audit.plateau_metric(prefix)
    assert abs(delta - 5.0) < 0.001
    assert (delta, from_h) == jalias.plateau_metric(prefix)


@pytest.mark.parametrize("note", [72, 91])
def test_analyze_matches_reference(note):
    f0 = 440.0 * 2 ** ((note - 69) / 12)
    rng = np.random.default_rng(note)
    n = int(SR * 0.6)
    t = np.arange(n) / SR
    sig = sum(10 ** (-(k - 1) * rng.uniform(0.3, 0.8)) * np.sin(
        2 * np.pi * k * (f0 + 0.7) * t) for k in range(1, 13))
    sig = sig + 1e-5 * rng.normal(size=n)
    port = alias_audit.analyze(sig, SR, f0, device=CPU)
    ref = jalias.analyze(sig, SR, f0)
    assert abs(port.f0_hz - ref.f0_hz) <= 1e-12 * ref.f0_hz
    for k in ("h1_dbfs", "harmonic_db", "harmonic_dbc", "max_step_up_db",
              "hf_band_dbc"):
        assert np.max(np.abs(np.asarray(getattr(port, k))
                             - np.asarray(getattr(ref, k)))) <= 1e-9, k
    assert port.max_step_up_from_harmonic == ref.max_step_up_from_harmonic


def test_baseline_file_is_complete():
    """tests/test_alias_audit_regression.py:73-78."""
    path = os.path.join(os.path.dirname(__file__), "baselines",
                        "alias_audit_v0_1_0.json")
    baseline = json.load(open(path))
    assert set(baseline) == {str(n) for n in alias_audit.STIMULUS_NOTES}
    for v in baseline.values():
        assert "max_step_up_db" in v and "hf_band_dbc" in v
        assert len(v["harmonic_dbc"]) == alias_audit.NUM_HARMONICS
