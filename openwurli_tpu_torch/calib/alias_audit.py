"""Click-band aliasing detector for the full engine chain.

Measures two indicators on the steady-state tail of canonical note renders
(C5/C6/G6 at v=120, vol=0.5, tremolo off): the H6-H11 plateau metric
(`max_step_up_db` — alias-folded energy breaks the monotonic harmonic
descent) and the broadband 5-18 kHz `hf_band_dbc`. Port of
`openwurli_tpu/calib/alias_audit.py`: the stimulus renders through the
port's f64 `engine.Engine` (E1 and E2 on the card), the analysis runs
through `goertzel` in float64 on `device`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from openwurli_tpu_torch.calib import goertzel

STIMULUS_NOTE = 84
STIMULUS_VELOCITY = 120
STIMULUS_VOLUME = 0.5
STIMULUS_NOTES = (72, 84, 91)
STIMULUS_SAMPLE_RATE = 44_100.0
STIMULUS_RENDER_SECONDS = 1.5
STIMULUS_ANALYZE_SECONDS = 0.5

NUM_HARMONICS = 12
PLATEAU_FIRST_HARMONIC = 6
PLATEAU_LAST_HARMONIC = 11
HF_BAND_LO_HZ = 5_000.0
HF_BAND_HI_HZ = 18_000.0


@dataclasses.dataclass
class AliasAuditResult:
    f0_hz: float
    h1_dbfs: float
    harmonic_db: list
    harmonic_dbc: list
    max_step_up_db: float
    max_step_up_from_harmonic: int
    hf_band_dbc: float


def _midi_hz(note):
    return 440.0 * 2.0 ** ((note - 69.0) / 12.0)


def plateau_metric(harmonic_dbc):
    """Largest positive step between adjacent harmonics in H6..H11."""
    first, last = PLATEAU_FIRST_HARMONIC - 1, PLATEAU_LAST_HARMONIC - 1
    worst, worst_from = -np.inf, PLATEAU_FIRST_HARMONIC
    for i in range(first, last):
        delta = harmonic_dbc[i + 1] - harmonic_dbc[i]
        if delta > worst:
            worst, worst_from = delta, i + 1
    return worst, worst_from


def analyze(signal, sample_rate, nominal_f0,
            device="cuda") -> AliasAuditResult:
    """Tail analysis of one render (alias_audit.rs:163-210)."""
    analyze_n = int(sample_rate * STIMULUS_ANALYZE_SECONDS)
    assert len(signal) >= analyze_n, "alias_audit signal too short"
    tail = goertzel.as_f64(signal[-analyze_n:], device)

    # ±5 Hz refinement at 0.1 Hz steps (matches the reference grid).
    f0 = float(goertzel.refine_f0(tail, nominal_f0, sample_rate,
                                  span_hz=5.0, steps=101))
    harmonics = f0 * np.arange(1, NUM_HARMONICS + 1)
    mags = goertzel.dft_magnitude(tail, harmonics, sample_rate).cpu().numpy()
    h1 = mags[0]
    harmonic_db = [20 * np.log10(m) if m > 0 else -200.0 for m in mags]
    harmonic_dbc = [20 * np.log10(m / h1) if h1 > 0 else -200.0 for m in mags]
    harmonic_dbc[0] = 0.0

    max_step, from_h = plateau_metric(harmonic_dbc)

    hf_rms = float(goertzel.band_rms(tail, HF_BAND_LO_HZ, HF_BAND_HI_HZ,
                                     sample_rate))
    hf_band_dbc = 20 * np.log10(hf_rms / h1) if h1 > 0 else -200.0

    return AliasAuditResult(
        f0_hz=f0,
        h1_dbfs=20 * np.log10(h1) if h1 > 0 else -200.0,
        harmonic_db=harmonic_db,
        harmonic_dbc=harmonic_dbc,
        max_step_up_db=max_step,
        max_step_up_from_harmonic=from_h,
        hf_band_dbc=hf_band_dbc,
    )


def render_stimulus(note, velocity=STIMULUS_VELOCITY,
                    sample_rate=STIMULUS_SAMPLE_RATE, pa_model="circuit",
                    device="cuda"):
    """Canonical stimulus render through the full engine on `device`.

    pa_model="behavioral" reproduces the reference's v0.5.1 alias-audit
    baseline config (its baselines/alias_audit_v0_5_1.json was captured
    with the behavioral power amp)."""
    from openwurli_tpu_torch.engine import Engine

    eng = Engine(sample_rate, device=device, pa_model=pa_model)
    eng.set_volume(STIMULUS_VOLUME)
    eng.set_tremolo_depth(0.0)
    eng.set_speaker_character(0.0)
    eng.set_mlp_enabled(True)
    eng.render(1536)  # settle smoothers
    eng.note_on(note, velocity / 127.0)
    out = eng.render(int(sample_rate * STIMULUS_RENDER_SECONDS))
    return out.cpu().numpy().astype(np.float64)


def run_with_note(note, velocity=STIMULUS_VELOCITY, pa_model="circuit",
                  device="cuda"):
    signal = render_stimulus(note, velocity, pa_model=pa_model,
                             device=device)
    return analyze(signal, STIMULUS_SAMPLE_RATE, _midi_hz(note), device)


def run_sweep(pa_model="circuit", device="cuda"):
    """The canonical 3-note sweep (C5, C6, G6 at v=120)."""
    return [(note, STIMULUS_VELOCITY,
             run_with_note(note, pa_model=pa_model, device=device))
            for note in STIMULUS_NOTES]
