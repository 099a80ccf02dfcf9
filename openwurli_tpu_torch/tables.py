"""Per-note parameter tables for the 200A reed model (float64 NumPy).

Port of `openwurli_tpu/tables.py` — the subset the note-on packers use.
Everything is vectorised over MIDI-note arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NUM_MODES = 7
MIDI_LO = 33  # A1
MIDI_HI = 96  # C7

BASE_MODE_AMPLITUDES = np.array(
    [1.0, 0.005, 0.0035, 0.0018, 0.0011, 0.0007, 0.0005], dtype=np.float64)

# Cantilever eigenvalues beta_n (columns) per tip-mass ratio mu (rows).
_EIG_MU = np.array([0.00, 0.01, 0.05, 0.10, 0.15, 0.20, 0.30, 0.50])
_EIG_BETAS = np.array([
    [1.8751, 4.6941, 7.8548, 10.9955, 14.1372, 17.2788, 20.4204],
    [1.8584, 4.6849, 7.8504, 10.9930, 14.1356, 17.2776, 20.4195],
    [1.7920, 4.6477, 7.8316, 10.9830, 14.1288, 17.2726, 20.4158],
    [1.7227, 4.6024, 7.8077, 10.9700, 14.1198, 17.2660, 20.4110],
    [1.6625, 4.5618, 7.7859, 10.9580, 14.1114, 17.2598, 20.4065],
    [1.6097, 4.5254, 7.7659, 10.9470, 14.1036, 17.2540, 20.4023],
    [1.5201, 4.4620, 7.7310, 10.9280, 14.0894, 17.2434, 20.3946],
    [1.3853, 4.3601, 7.6745, 10.8970, 14.0650, 17.2252, 20.3814],
])

_MU_ANCHOR_MIDI = np.array([33.0, 52.0, 62.0, 74.0, 96.0])
_MU_ANCHOR_VAL = np.array([0.10, 0.00, 0.00, 0.02, 0.01])

DS_AT_C4 = 0.85
DS_EXPONENT = 0.75
DS_CLAMP = (0.02, 0.95)
PLATE_ACTIVE_LENGTH_MM = 6.0
MIN_DECAY_RATE = 3.0

_TRIM_ANCHOR_MIDI = np.array([36.0, 40.0, 44.0, 48.0, 52.0, 56.0, 60.0,
                              64.0, 68.0, 72.0, 76.0, 80.0, 84.0])
_TRIM_ANCHOR_DB = np.array([-1.3, 0.0, -1.3, 0.7, 0.2, -1.0, 0.0, 0.9, 1.2,
                            0.0, 1.8, 2.4, 3.6])

POST_SPEAKER_GAIN_DB = 17.5
POST_SPEAKER_GAIN = 10.0 ** (POST_SPEAKER_GAIN_DB / 20.0)
FIXED_CIRCUIT_DRIVE = 0.25

PICKUP_HPF_FC = 2312.0


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Runtime-overridable calibration parameters."""

    ds_at_c4: float = DS_AT_C4
    ds_exponent: float = DS_EXPONENT
    ds_clamp: tuple = DS_CLAMP
    target_db: float = -35.0
    voicing_slope: float = -0.04
    zero_trim: bool = False


def _f64(x):
    return np.asarray(x, dtype=np.float64)


def midi_to_freq(midi):
    """MIDI note number → fundamental frequency (Hz), A440 tuning."""
    return 440.0 * np.power(2.0, (_f64(midi) - 69.0) / 12.0)


def tip_mass_ratio(midi):
    return np.interp(_f64(midi), _MU_ANCHOR_MIDI, _MU_ANCHOR_VAL)


def eigenvalues(mu):
    """mu (...) → betas (..., NUM_MODES), linear in mu over the table."""
    mu = np.clip(_f64(mu), 0.0, 0.5)
    return np.stack([np.interp(mu, _EIG_MU, _EIG_BETAS[:, i])
                     for i in range(NUM_MODES)], axis=-1)


def mode_ratios(mu):
    betas = eigenvalues(mu)
    return betas ** 2 / betas[..., 0:1] ** 2


def reed_length_mm(midi):
    n = np.clip(_f64(midi) - 32.0, 1.0, 64.0)
    inches = np.where(n <= 20.0, 3.0 - n / 20.0, 2.0 - (n - 20.0) / 44.0)
    return inches * 25.4


def reed_blank_dims(midi):
    """(width_mm, thickness_mm) from the 200A blank dimensions."""
    reed = np.clip(np.floor(_f64(midi)) - 32.0, 1.0, 64.0)
    width_inch = np.select(
        [reed <= 14, reed <= 20, reed <= 42, reed <= 50],
        [0.151, 0.127, 0.121, 0.111], default=0.098)
    t_mid = 0.026 + (reed - 16.0) / 10.0 * (0.034 - 0.026)
    thickness_inch = np.select(
        [reed <= 16, reed <= 26],
        [np.full_like(reed, 0.026), t_mid], default=np.full_like(reed, 0.034))
    return width_inch * 25.4, thickness_inch * 25.4


def reed_compliance(midi):
    length = reed_length_mm(midi)
    w, t = reed_blank_dims(midi)
    return length ** 3 / (w * t ** 3)


def pickup_displacement_scale(midi, cfg: CalibrationConfig = CalibrationConfig()):
    ds = cfg.ds_at_c4 * (reed_compliance(midi) / reed_compliance(60.0)) \
        ** cfg.ds_exponent
    return np.clip(ds, cfg.ds_clamp[0], cfg.ds_clamp[1])


def mode_shape(beta, xi):
    beta, xi = _f64(beta), _f64(xi)
    sigma = (np.cosh(beta) + np.cos(beta)) / (np.sinh(beta) + np.sin(beta))
    bx = beta * xi
    return np.cosh(bx) - np.cos(bx) - sigma * (np.sinh(bx) - np.sin(bx))


_N_SIMPSON = 32


def spatial_coupling_coefficients(mu, reed_len_mm_val):
    """Pickup spatial coupling per mode, normalised to mode 1 (Simpson)."""
    betas = eigenvalues(mu)
    ell_over_l = np.clip(PLATE_ACTIVE_LENGTH_MM / _f64(reed_len_mm_val),
                         0.0, 1.0)[..., None]
    xi_start = 1.0 - ell_over_l
    h = ell_over_l / _N_SIMPSON
    j = np.arange(_N_SIMPSON + 1, dtype=np.float64)
    weights = np.where(j % 2 == 1, 4.0, 2.0)
    weights[0] = weights[-1] = 1.0
    xi = xi_start[..., None] + j * h[..., None]
    phi = mode_shape(betas[..., None], xi)
    integral = np.sum(phi * weights, axis=-1) * h / 3.0
    tip_val = mode_shape(betas, np.ones_like(betas))
    kappa_raw = np.clip(np.abs(integral / (ell_over_l * tip_val)), 0.0, 1.0)
    degenerate = (np.abs(tip_val) < 1e-30) | (ell_over_l < 1e-12)
    kappa_raw = np.where(degenerate, 1.0, kappa_raw)
    k1 = kappa_raw[..., 0:1]
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(k1 > 1e-30, np.clip(kappa_raw / k1, 0.0, 1.0), 1.0)


def fundamental_decay_rate(midi):
    return np.maximum(0.005 * midi_to_freq(midi) ** 1.22, MIN_DECAY_RATE)


def mode_decay_rates(midi, ratios):
    return fundamental_decay_rate(midi)[..., None] * ratios * ratios


def pickup_rms_proxy(ds, f0, fc=PICKUP_HPF_FC):
    """Multi-harmonic RMS proxy of y/(1-y), y = ds·sin, through the HPF."""
    ds, f0 = _f64(ds), _f64(f0)
    ds_safe = np.maximum(ds, 1e-10)
    root = np.sqrt(np.maximum(1.0 - ds_safe * ds_safe, 1e-300))
    r = (1.0 - root) / ds_safe
    n = np.arange(1, 9, dtype=np.float64)
    cn = 2.0 * r[..., None] ** n * (1.0 / root)[..., None]
    nf = n * f0[..., None]
    hpf_n = nf / np.sqrt(nf * nf + fc * fc)
    rms = np.sqrt(np.sum((cn * hpf_n) ** 2, axis=-1))
    return np.where(ds < 1e-10, 0.0, rms)


def register_trim_db(midi):
    return np.interp(_f64(midi), _TRIM_ANCHOR_MIDI, _TRIM_ANCHOR_DB)


def velocity_exponent(midi):
    """Register-dependent velocity exponent (Gaussian bell at D4)."""
    m = _f64(midi)
    center, sigma, max_exp = 62.0, 15.0, 1.7
    t = np.exp(-0.5 * ((m - center) / sigma) ** 2)
    min_exp = np.where(m < center, 0.55, 1.3)
    return min_exp + t * (max_exp - min_exp)


def velocity_scurve(velocity):
    v = _f64(velocity)
    k = 1.5
    s = 1.0 / (1.0 + np.exp(-k * (v - 0.5)))
    s0 = 1.0 / (1.0 + np.exp(k * 0.5))
    s1 = 1.0 / (1.0 + np.exp(-k * 0.5))
    return (s - s0) / (s1 - s0)


def output_scale(midi, velocity_norm, cfg: CalibrationConfig = CalibrationConfig()):
    """Per-note output scaling that balances the keyboard."""
    m, v = np.broadcast_arrays(_f64(midi), _f64(velocity_norm))
    ds = pickup_displacement_scale(m, cfg)
    f0 = midi_to_freq(m)
    scurve_v = velocity_scurve(v)
    vel_scale = scurve_v ** velocity_exponent(m)
    vel_scale_c4 = scurve_v ** velocity_exponent(60.0)
    effective_ds = np.maximum(ds * vel_scale, 1e-6)
    effective_ds_ref = np.maximum(cfg.ds_at_c4 * vel_scale_c4, 1e-6)
    rms = pickup_rms_proxy(effective_ds, f0)
    rms_ref = pickup_rms_proxy(effective_ds_ref,
                               midi_to_freq(np.full_like(m, 60.0)))
    flat_db = -20.0 * np.log10(rms / rms_ref)
    voicing_db = cfg.voicing_slope * np.maximum(m - 60.0, 0.0)
    trim = np.zeros_like(m) if cfg.zero_trim else register_trim_db(m)
    return 10.0 ** ((cfg.target_db + flat_db + voicing_db + trim * v ** 1.3)
                    / 20.0)


def note_params(midi):
    """All per-note parameters, batched: a dict of float64 arrays."""
    m = _f64(midi)
    mu = tip_mass_ratio(m)
    ratios = mode_ratios(mu)
    coupling = spatial_coupling_coefficients(mu, reed_length_mm(m))
    return {
        "fundamental_hz": midi_to_freq(m),
        "mode_ratios": ratios,
        "mode_amplitudes": BASE_MODE_AMPLITUDES * coupling,
        "mode_decay_rates": mode_decay_rates(m, ratios),
    }
