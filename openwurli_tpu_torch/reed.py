"""Modal reed oscillator: 7 damped quadrature modes with OU pitch jitter.

Port of `openwurli_tpu/reed.py`. At note-on (NumPy float64): the
rotation/decay/onset constants and the initial state (LCG seeding, the
Box-Muller jitter start). Per sample (torch, batched over voices): the
three-phase damper, `step` in the reference's order (damper → onset →
jitter draws every 16 samples → output and rotation → renorm every 1024),
`is_silent` and `release_seconds`. The f64 engine's voice kernel (E1)
repeats `step` op for op.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import torch

from openwurli_tpu_torch import prng
from openwurli_tpu_torch.ops import exact
from openwurli_tpu_torch.tables import NUM_MODES

JITTER_SIGMA = 0.0004
JITTER_TAU = 0.020
JITTER_SUBSAMPLE = 16
RENORM_INTERVAL = 1024
TAU = 6.283185307179586
DB_PER_NEPER = 8.686


class ReedParams(NamedTuple):
    cos_inc: np.ndarray  # (..., 7)
    sin_inc: np.ndarray  # (..., 7)
    phase_inc: np.ndarray  # (..., 7)
    amplitude: np.ndarray  # (..., 7)
    decay_mult: np.ndarray  # (..., 7)
    onset_ramp_samples: np.ndarray  # (...,) int64
    onset_ramp_inc: np.ndarray  # (...,)
    onset_shape_exp: np.ndarray  # (...,)
    jitter_revert: np.ndarray  # (...,)
    jitter_diffusion: np.ndarray  # (...,)


class ReedState(NamedTuple):
    s: np.ndarray  # (..., 7)
    c: np.ndarray  # (..., 7)
    envelope: np.ndarray  # (..., 7)
    jitter_drift: np.ndarray  # (..., 7)
    jitter_state: np.ndarray  # (...,) u32 word
    n: np.ndarray  # (...,) int64 sample counter
    damper_active: np.ndarray  # (...,) bool
    damper_rate: np.ndarray  # (..., 7) nepers/sample
    damper_mult: np.ndarray  # (..., 7)
    damper_ramp_samples: np.ndarray  # (...,)
    damper_release_count: np.ndarray  # (...,)
    damper_ramp_done: np.ndarray  # (...,) bool


def make_params(fundamental_hz, mode_ratios, amplitudes, decay_rates_db,
                onset_time_s, velocity, sample_rate) -> ReedParams:
    f0 = np.asarray(fundamental_hz, dtype=np.float64)
    phase_inc = TAU * (f0[..., None] * mode_ratios) / sample_rate
    decay_per_sample = decay_rates_db / DB_PER_NEPER / sample_rate
    revert = np.exp(-(1.0 / sample_rate) / JITTER_TAU)
    diffusion = JITTER_SIGMA * np.sqrt(1.0 - revert * revert)
    ramp_samps = np.round(np.asarray(onset_time_s, np.float64)
                          * sample_rate).astype(np.int64)
    ramp_inc = np.where(ramp_samps > 0,
                        np.pi / np.maximum(ramp_samps, 1), 0.0)
    return ReedParams(
        cos_inc=np.cos(phase_inc),
        sin_inc=np.sin(phase_inc),
        phase_inc=phase_inc,
        amplitude=np.asarray(amplitudes, dtype=np.float64),
        decay_mult=np.exp(-decay_per_sample),
        onset_ramp_samples=ramp_samps,
        onset_ramp_inc=ramp_inc,
        onset_shape_exp=1.0 + (1.0 - np.asarray(velocity, np.float64)),
        jitter_revert=np.broadcast_to(revert, f0.shape),
        jitter_diffusion=np.broadcast_to(diffusion, f0.shape),
    )


def init_state(params: ReedParams, jitter_seed) -> ReedState:
    """Note-on state: quadrature at phase 0, OU drift from its stationary
    distribution via Box-Muller (NumPy)."""
    state, draws = prng.box_muller_draws(jitter_seed, NUM_MODES)
    batch = params.amplitude.shape[:-1]
    zeros7 = np.zeros(batch + (NUM_MODES,))
    return ReedState(
        s=zeros7, c=np.ones_like(zeros7), envelope=np.ones_like(zeros7),
        jitter_drift=JITTER_SIGMA * draws * np.ones(batch + (NUM_MODES,)),
        jitter_state=np.broadcast_to(state, batch),
        n=np.zeros(batch, dtype=np.int64),
        damper_active=np.zeros(batch, dtype=bool),
        damper_rate=zeros7, damper_mult=np.ones_like(zeros7),
        damper_ramp_samples=np.zeros(batch),
        damper_release_count=np.zeros(batch),
        damper_ramp_done=np.zeros(batch, dtype=bool))


# ── per-sample steps (torch; every field a tensor on one device) ──


def damper_constants(midi_note, sample_rate):
    """Damper (rate (..., 7), mult (..., 7), ramp samples (...,), undamped
    (...,)) for float64 tensor notes: top 5 keys undamped, higher modes
    ×3^m faster, register ramps of 50/25/8 ms."""
    m = midi_note
    base_rate = torch.clamp(55.0 * torch.pow(2.0, (m - 60.0) / 24.0),
                            min=0.5)
    mode_pow = 3.0 ** torch.arange(NUM_MODES, dtype=torch.float64,
                                   device=m.device)
    factor = torch.clamp(base_rate[..., None] * mode_pow, max=2000.0)
    rate = factor / sample_rate
    ramp_time = torch.where(m < 48.0, 0.050,
                            torch.where(m < 72.0, torch.full_like(m, 0.025),
                                        0.008))
    return rate, torch.exp(-rate), ramp_time * sample_rate, m >= 92.0


def start_damper(state: ReedState, midi_note, sample_rate, active=True):
    """Three-phase progressive damper; `active` masks batched note-offs."""
    rate, mult, ramp, undamped = damper_constants(midi_note, sample_rate)
    act = torch.as_tensor(active, device=midi_note.device) & ~undamped
    a = act[..., None]
    return state._replace(
        damper_rate=torch.where(a, rate, state.damper_rate),
        damper_mult=torch.where(a, mult, state.damper_mult),
        damper_ramp_samples=torch.where(act, ramp,
                                        state.damper_ramp_samples),
        damper_active=state.damper_active | act,
        damper_release_count=torch.where(act, 0.0,
                                         state.damper_release_count),
        damper_ramp_done=state.damper_ramp_done & ~act)


def step(params: ReedParams, state: ReedState):
    """One sample for all batched voices → (state, output)."""
    # damper advance
    rel_count = torch.where(state.damper_active,
                            state.damper_release_count + 1.0,
                            state.damper_release_count)
    ramp = state.damper_ramp_samples
    past_ramp = rel_count > ramp
    in_ramp = state.damper_active & ~state.damper_ramp_done & ~past_ramp
    ramp_done = state.damper_ramp_done | (state.damper_active & past_ramp)
    inst_rate = state.damper_rate * (
        rel_count / exact.maximum(ramp, 1e-30))[..., None]
    env = state.envelope * torch.where(in_ramp[..., None],
                                       torch.exp(-inst_rate), 1.0)
    env = env * torch.where((state.damper_active & ramp_done)[..., None],
                            state.damper_mult, 1.0)

    # onset ramp
    n_f = state.n.to(torch.float64)
    cosine = 0.5 * (1.0 - torch.cos(n_f * params.onset_ramp_inc))
    e = params.onset_shape_exp
    shaped = torch.where(
        e <= 1.001, cosine,
        torch.where(e >= 1.999, cosine * cosine,
                    torch.pow(exact.maximum(cosine, 0.0), e)))
    onset = torch.where(state.n < params.onset_ramp_samples, shaped, 1.0)

    # jitter: 7 sequential LCG draws, used every 16th sample
    do_jitter = (state.n & (JITTER_SUBSAMPLE - 1)) == 0
    jst = state.jitter_state
    noises = []
    for _ in range(NUM_MODES):
        jst, nz = prng.lcg_uniform_scaled(jst)
        noises.append(nz)
    noise = torch.stack(noises, dim=-1)
    new_drift = (params.jitter_revert[..., None] * state.jitter_drift
                 + params.jitter_diffusion[..., None] * noise)
    drift = torch.where(do_jitter[..., None], new_drift, state.jitter_drift)
    jitter_state = torch.where(do_jitter, jst, state.jitter_state)

    # output (modes summed in index order), rotation, natural decay
    terms = (params.amplitude * state.s * onset[..., None] * env).unbind(-1)
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    delta_phase = drift * params.phase_inc
    ci = params.cos_inc - delta_phase * params.sin_inc
    si = params.sin_inc + delta_phase * params.cos_inc
    s_new = state.s * ci + state.c * si
    c_new = state.c * ci - state.s * si
    env = env * params.decay_mult

    # renorm every 1024 samples
    do_renorm = ((state.n & (RENORM_INTERVAL - 1)) == 0) & (state.n > 0)
    r_inv = 1.0 / torch.sqrt(s_new * s_new + c_new * c_new)
    scale = torch.where(do_renorm[..., None], r_inv, 1.0)
    return state._replace(
        s=s_new * scale, c=c_new * scale, envelope=env, jitter_drift=drift,
        jitter_state=jitter_state, n=state.n + 1,
        damper_release_count=rel_count, damper_ramp_done=ramp_done), out


def render(params: ReedParams, state: ReedState, num_samples: int):
    """num_samples of `step` → (state, output (num_samples, ...batch))."""
    out = torch.empty((int(num_samples),) + tuple(state.n.shape),
                      dtype=torch.float64, device=state.n.device)
    for t in range(int(num_samples)):
        state, out[t] = step(params, state)
    return state, out


def is_silent(params: ReedParams, state: ReedState, threshold_db=-80.0):
    thr = 10.0 ** (threshold_db / 20.0)
    return torch.all(torch.abs(params.amplitude * state.envelope) <= thr,
                     dim=-1)


def release_seconds(state: ReedState, sample_rate):
    return torch.where(state.damper_active,
                       exact.div(state.damper_release_count, sample_rate),
                       0.0)
