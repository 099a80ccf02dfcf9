"""Voice bank (kernels K1 and K3): 7 modal reed modes + attack noise +
pickup, per voice lane, in float32 deviation form.

Port of `openwurli_tpu/kernels/voice_bank.py`: the plain variant (K1) and
the events variant (K3: per-voice onset and release schedules, pre-onset
lanes frozen bit for bit, the 3-phase damper). Three pieces live here:

  * the host packers (`make_kernel_params`, `damper_rows`, `steady_limits`,
    `init_bank_state`), float64 NumPy producing the reference's packed
    (N_ROWS, 8, V) layout;
  * `render_voice_bank_plain`, the same function in plain torch ops:
    Python loop over 8-sample groups, vectorised over lanes — the CPU
    path and the oracle the CUDA kernel is held to;
  * `render_voice_bank`, the wrapper: a CPU tensor goes to the plain
    version, a CUDA tensor to `csrc/voice_bank.cu`. No fallback.

Events variant: a lane is active from its onset sample (a multiple of 16,
so constant over an 8-sample group). Before it nothing of the lane moves:
not its LCG streams, drift, noise filter, quadrature state or envelope.
Groups that end at or before `min_release`, the earliest release of the
WHOLE call, take the fast stage (K1's folded coefficients, P/Q masked by
the active flag); later groups take the legacy stage, which applies the
damper and the natural decay per sub-step and reads raw rotation powers
R¹..R⁷. The two stages round differently, so `min_release` is always the
global value over all lanes, never a per-lane or per-chunk one.

The arithmetic follows the reference kernel op for op: composed rotation
powers R¹..R⁸ with amplitude·decayʲ folded into the output coefficients,
refreshed only when the OU drift changes (every 16 samples, from ONE
composed-LCG step per mode), cached onset/noise group rows gated off past
the `steady` horizon, the f32 sample counter, and the batched pickup.

Renorm timing: the reference applies the quadrature renorm at the end of
each output tile whose span holds a multiple of RENORM_INTERVAL, and its
tile follows the lane count (`_render_voice_bank_jit`). `render_tile`
reproduces that rule from the lane count, so the port renorms on exactly
the reference's samples (a bank wider than 4096 lanes uses the tile of a
4096-lane chunk for every lane).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from openwurli_tpu_torch import pickup as pickup_mod
from openwurli_tpu_torch import voice
from openwurli_tpu_torch.tables import NUM_MODES

LANES = 128
SUBLANES = 8  # ≥ NUM_MODES
JITTER_SUBSAMPLE = 16
RENORM_INTERVAL = 1024
NOISE_FADE_IN = 16
T_TILE = 512
UNROLL = 8  # samples per group
NEVER = 1.0e12  # release sentinel: voice is never damped
MAX_CHUNK_LANES = 4096  # the reference's per-call lane chunk (tile rule)

# params rows (deviation form: cos−1 and 1−decay, computed in f64)
ROW_COSM1, ROW_SIN, ROW_PHASE, ROW_AMP, ROW_DECAYM1 = 0, 1, 2, 3, 4
ROW_SCAL, ROW_DRIFT0, ROW_RNG0, ROW_NOISE = 5, 6, 7, 8
ROW_EVT, ROW_DRATE, ROW_DM1 = 9, 10, 11
ROW_DM8M1 = 12  # 1 − decay_mult^8
N_ROWS = 13
EVT_ONSET_F, EVT_RELEASE_F, EVT_RAMP, EVT_ONSET_I = 0, 1, 2, 3

# Packed carry state (STATE_ROWS, V) f32, int rows as bit patterns:
#   s 0:8 | c 8:16 | env 16:24 | drift 24:32 | nstate 32:40 | irng 40:48
# nstate rows: 0 noise amp, 1 z1, 2 z2, 3 onset cache, 4 noise cache,
#              5 pickup q; irng rows: 0 jitter LCG, 1 noise LCG.
STATE_ROWS = 48
_S0, _C0, _E0, _D0, _N0, _I0 = 0, 8, 16, 24, 32, 40

LCG_A, LCG_C = 1664525, 1013904223
# s_k = LCG_A_POW[k]·s + LCG_C_ACC[k] (mod 2^32) equals k sequential draws.
LCG_A_POW = [1]
LCG_C_ACC = [0]
for _k in range(8):
    LCG_A_POW.append((LCG_A_POW[-1] * LCG_A) & 0xFFFFFFFF)
    LCG_C_ACC.append((LCG_C_ACC[-1] * LCG_A + LCG_C) & 0xFFFFFFFF)

# Launch counters: KERNEL_LAUNCHES counts CUDA launches (one per call on
# the card), PLAIN_CALLS counts calls served by the plain version. The
# per-variant counts say which kernel a launch was ("voice_bank" is K1,
# "voice_bank_events" K3).
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0
LAUNCHES_BY_KERNEL = {"voice_bank": 0, "voice_bank_events": 0}


# ───────────────────────────── host packers ─────────────────────────────


def damper_rows(midi_notes, sample_rate):
    """Per-voice damper constants → (rate (8, V), one_minus_mult (8, V),
    ramp_samples (V,), undamped (V,) bool), float64."""
    m = np.asarray(midi_notes, dtype=np.float64)
    base_rate = np.maximum(55.0 * 2.0 ** ((m - 60.0) / 24.0), 0.5)
    mode_pow = 3.0 ** np.arange(NUM_MODES, dtype=np.float64)
    factor = np.minimum(base_rate[None, :] * mode_pow[:, None], 2000.0)
    rate8 = np.zeros((SUBLANES, m.shape[0]))
    rate8[:NUM_MODES] = factor / sample_rate
    ramp_time = np.select([m < 48.0, m < 72.0], [0.050, 0.025], 0.008)
    return rate8, -np.expm1(-rate8), ramp_time * sample_rate, m >= 92.0


def make_kernel_params(midi_notes, velocities, sample_rate,
                       mlp_enabled=False, lanes=None, onsets=None,
                       releases=None, n_active=None, device="cpu"):
    """Pack per-voice note-on parameters into the kernel layout.

    midi_notes/velocities: up to `lanes` entries (padded with silent
    voices); lanes defaults to the next multiple of 128. onsets/releases:
    per-voice schedule rows (only read by the events variant). Returns
    (params (N_ROWS, 8, lanes) float32 tensor on `device`, n_active).
    """
    m = np.asarray(midi_notes, dtype=np.float64)
    v = np.asarray(velocities, dtype=np.float64)
    if n_active is None:
        n_active = m.shape[0]
    if n_active > m.shape[0]:
        raise ValueError(f"n_active={n_active} > {m.shape[0]} notes")
    lanes = lanes or max(LANES, -(-n_active // LANES) * LANES)
    if n_active > lanes:
        raise ValueError(f"{n_active} voices do not fit {lanes} lanes")
    p = _pack_params_np(m, v, n_active, sample_rate, mlp_enabled, lanes,
                        onsets, releases)
    return torch.from_numpy(p).to(device), n_active


def _pack_params_np(m, v, n_active, sample_rate, mlp_enabled, lanes,
                    onsets=None, releases=None):
    vparams, detuned = voice.note_on_params(m, v, sample_rate,
                                            mlp_enabled=mlp_enabled)
    state = voice.init_state(vparams, detuned, v, sample_rate,
                             voice.default_note_seed(m))

    def pad_modes(x):  # (G, 7) → (8, lanes)
        arr = np.zeros((SUBLANES, lanes), dtype=np.float32)
        arr[:NUM_MODES, :n_active] = \
            np.asarray(x, dtype=np.float32).T[:, :n_active]
        return arr

    def pad_scalar(x, fill=0.0):
        arr = np.full(lanes, fill, dtype=np.float32)
        arr[:n_active] = np.asarray(x, dtype=np.float32)[..., :n_active]
        return arr

    rp = vparams.reed
    scal = np.zeros((SUBLANES, lanes), dtype=np.float32)
    scal[0] = pad_scalar(rp.onset_ramp_samples)
    scal[1] = pad_scalar(rp.onset_ramp_inc)
    scal[2] = pad_scalar(rp.onset_shape_exp, fill=1.0)
    scal[3] = pad_scalar(rp.jitter_revert, fill=1.0)
    scal[4] = pad_scalar(rp.jitter_diffusion)
    scal[5] = pad_scalar(vparams.pickup.beta)
    scal[6] = pad_scalar(vparams.pickup.displacement_scale)
    scal[7] = pad_scalar(vparams.post_pickup_gain)

    # int RNG states: row 0 jitter (post-Box-Muller), row 1 noise (raw seed)
    rng0 = np.zeros((SUBLANES, lanes), dtype=np.uint32)
    rng0[0, :n_active] = np.asarray(state.reed.jitter_state,
                                    np.uint32)[:n_active]
    rng0[1, :n_active] = np.asarray(state.noise.rng_state,
                                    np.uint32)[:n_active]

    nrow = np.zeros((SUBLANES, lanes), dtype=np.float32)
    nrow[0] = pad_scalar(state.noise.amplitude)
    nrow[1] = pad_scalar(vparams.noise.decay_per_sample)
    nrow[2] = pad_scalar(state.noise.remaining)
    nrow[3] = pad_scalar(vparams.noise.bpf.b0)
    nrow[4] = pad_scalar(vparams.noise.bpf.b2)
    nrow[5] = pad_scalar(vparams.noise.bpf.a1)
    nrow[6] = pad_scalar(vparams.noise.bpf.a2)

    if onsets is None:
        on = np.zeros(n_active)
    else:
        on = np.round(np.asarray(onsets, np.float64) / JITTER_SUBSAMPLE) \
            * JITTER_SUBSAMPLE
    if releases is None:
        rel = np.full(n_active, NEVER)
    else:
        rel = np.asarray(releases, dtype=np.float64).copy()
        rel[~np.isfinite(rel)] = NEVER
    rate8, dm1, ramp, undamped = damper_rows(m, sample_rate)
    rel = np.where(undamped, NEVER, rel)
    evt = np.zeros((SUBLANES, lanes), dtype=np.float32)
    evt[EVT_ONSET_F] = pad_scalar(on)
    evt[EVT_RELEASE_F] = pad_scalar(rel, fill=NEVER)
    evt[EVT_RAMP] = pad_scalar(ramp, fill=1.0)
    oi = np.zeros(lanes, dtype=np.int32)
    oi[:n_active] = on.astype(np.int64).astype(np.int32)[:n_active]
    evt[EVT_ONSET_I] = oi.view(np.float32)
    drate_rows = np.zeros((SUBLANES, lanes), dtype=np.float32)
    drate_rows[:, :n_active] = rate8.astype(np.float32)[:, :n_active]
    dm1_rows = np.zeros((SUBLANES, lanes), dtype=np.float32)
    dm1_rows[:, :n_active] = dm1.astype(np.float32)[:, :n_active]

    decay_mult = np.asarray(rp.decay_mult, dtype=np.float64)
    return np.stack([
        pad_modes(np.asarray(rp.cos_inc, dtype=np.float64) - 1.0),
        pad_modes(rp.sin_inc),
        pad_modes(rp.phase_inc),
        pad_modes(rp.amplitude),
        pad_modes(1.0 - decay_mult),
        scal,
        pad_modes(state.reed.jitter_drift),
        rng0.view(np.float32),
        nrow,
        evt,
        drate_rows,
        dm1_rows,
        pad_modes(1.0 - decay_mult ** 8),
    ], axis=0)


def init_bank_state(params):
    """Fresh note-on state for packed params → (STATE_ROWS, V) float32
    tensor on the params' device."""
    p = params
    lanes = p.shape[-1]
    st = torch.zeros((STATE_ROWS, lanes), dtype=torch.float32,
                     device=p.device)
    st[_C0:_C0 + NUM_MODES] = 1.0              # c = 1 (modes only)
    st[_E0:_E0 + 8] = 1.0                      # env = 1
    st[_D0:_D0 + 8] = p[ROW_DRIFT0]            # OU drift init
    st[_N0 + 0] = p[ROW_NOISE][0]              # noise amplitude
    st[_N0 + 5] = 1.0                          # pickup q
    st[_I0:_I0 + 8] = p[ROW_RNG0]              # LCG seeds (bit patterns)
    return st


def steady_limits(params):
    """(onset_done, noise_done) global sample counts after which every
    voice's onset ramp / attack noise has finished (+64-sample margin)."""
    p = _host(params)
    onset0 = p[ROW_EVT][EVT_ONSET_F] if p.shape[0] > ROW_EVT else 0.0
    onset = int(np.ceil((onset0 + p[ROW_SCAL][0]).max())) + 64
    noise = int(np.ceil((onset0 + p[ROW_NOISE][2]).max())) + 64
    return onset, noise


def _host(x):
    """A tensor (any device) or array as a NumPy array."""
    return x.detach().to("cpu").numpy() if torch.is_tensor(x) \
        else np.asarray(x)


def _has_events(params) -> bool:
    """Whether the packed schedule holds any onset > 0 or any release.
    Compared in float32: NEVER is stored as 999999995904."""
    if params.shape[0] <= ROW_EVT:
        return False
    evt = _host(params[ROW_EVT, :2])  # the two schedule rows only
    return bool((evt[EVT_ONSET_F] > 0).any()
                or (evt[EVT_RELEASE_F] < np.float32(NEVER)).any())


def _min_release(params) -> float:
    """The earliest release sample over all lanes (NEVER without lanes)."""
    rel = _host(params[ROW_EVT, EVT_RELEASE_F])
    return float(rel.min()) if rel.size else NEVER


def render_tile(lanes: int, num_samples: int, exact_state: bool) -> int:
    """The reference's output tile for this width: it sets when the
    quadrature renorm fires (see the module docstring)."""
    width = min(lanes, MAX_CHUNK_LANES)
    t_tile = max(16, min(T_TILE, (1 << 20) // (width * 4) // 16 * 16))
    if exact_state:
        t_tile = 1 << (int(t_tile).bit_length() - 1)
        while t_tile > 16 and num_samples % t_tile:
            t_tile //= 2
        if num_samples % t_tile:
            raise ValueError("state-carried renders need num_samples "
                             f"divisible by 16 (got {num_samples})")
    return t_tile


# ───────────────────────────── plain version ────────────────────────────

_MASK32 = 0xFFFFFFFF


def _u32_bits(x_f32):
    """f32 bit-pattern rows → int64 holding the unsigned 32-bit value."""
    return x_f32.contiguous().view(torch.int32).to(torch.int64) & _MASK32


def _f32_bits(x_u32):
    """int64 unsigned 32-bit values → f32 rows with those bit patterns."""
    x = x_u32 & _MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32) \
        .view(torch.float32)


def _mul_u32(a: int, x):
    """(a·x) mod 2^32 for a Python-int constant a and int64 x < 2^32,
    without int64 overflow (16-bit split of a)."""
    lo = (a & 0xFFFF) * x
    hi = (((a >> 16) * x) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _lcg(x):
    return (_mul_u32(LCG_A, x) + LCG_C) & _MASK32


def render_voice_bank_plain(params, num_samples: int, steady=None,
                            state=None, n0: int = 0,
                            return_state: bool = False,
                            events: bool = False, min_release=None):
    """Plain-torch K1 (events=False) or K3 (events=True) on the params'
    device: the same call and result as `render_voice_bank`, tile (and so
    renorm timing) included.

    Loops over 8-sample groups in Python and vectorises over lanes, with
    the reference kernel's arithmetic (see the module docstring). The
    render covers whole tiles; the state returned is the state after
    them, exactly as the reference returns it. min_release (events only)
    defaults to the schedule's earliest release."""
    f32 = torch.float32
    p = params
    lanes = p.shape[-1]
    dev = p.device
    if state is None:
        state = init_bank_state(p)
    t_tile = render_tile(lanes, num_samples, return_state)
    n_tiles = -(-num_samples // t_tile)

    cosm1, sin_inc, phase_inc = p[ROW_COSM1], p[ROW_SIN], p[ROW_PHASE]
    amplitude, decaym1, dm8m1 = p[ROW_AMP], p[ROW_DECAYM1], p[ROW_DM8M1]
    scal = p[ROW_SCAL]
    onset_samps, onset_inc, onset_exp = scal[0:1], scal[1:2], scal[2:3]
    revert, diffusion, beta = scal[3:4], scal[4:5], scal[5:6]
    ds, post_gain = scal[6:7], scal[7:8]
    nz = p[ROW_NOISE]
    noise_decay, noise_dur = nz[1:2], nz[2:3]
    nb0, nb2, na1, na2 = nz[3:4], nz[4:5], nz[5:6], nz[6:7]
    legacy = False
    if events:
        evt = p[ROW_EVT]
        onset_f = evt[EVT_ONSET_F:EVT_ONSET_F + 1]
        release_f = evt[EVT_RELEASE_F:EVT_RELEASE_F + 1]
        ramp_f = evt[EVT_RAMP:EVT_RAMP + 1]
        drate, dm1 = p[ROW_DRATE], p[ROW_DM1]
        if min_release is None:
            min_release = _min_release(p)
        # a schedule that never releases never takes the legacy stage
        legacy = float(min_release) < 0.5 * NEVER
        min_rel_f = float(np.float32(min_release))

    s = state[_S0:_S0 + 8].clone()
    c = state[_C0:_C0 + 8].clone()
    env = state[_E0:_E0 + 8].clone()
    drift = state[_D0:_D0 + 8].clone()
    nstate = state[_N0:_N0 + 8].clone()
    irng = _u32_bits(state[_I0:_I0 + 8])
    onset8 = torch.ones((UNROLL, lanes), dtype=f32, device=dev)
    noise8 = torch.zeros((UNROLL, lanes), dtype=f32, device=dev)
    mode_mask = (torch.arange(SUBLANES, device=dev) < NUM_MODES)[:, None]

    knee = float(np.float32(pickup_mod.PICKUP_KNEE_Y))
    rng_sat = float(np.float32(pickup_mod.PICKUP_MAX_Y
                               - pickup_mod.PICKUP_KNEE_Y))
    sens = float(np.float32(pickup_mod.PICKUP_SENSITIVITY))
    # a device tensor divisor: true division, as in the kernel (torch
    # multiplies by the reciprocal of a CPU-scalar divisor on CUDA)
    rng_sat_t = torch.tensor(rng_sat, dtype=f32, device=dev)
    twob = 2.0 * beta
    u_scale = float(np.float32(2.0 / 4294967295.0))
    w_scale = float(np.float32(1.0 / 2147483647.0))
    sqrt3 = float(np.float32(1.7320508080))
    pi32 = float(np.float32(np.pi))
    steady0 = float("inf") if steady is None else float(steady[0])
    steady1 = float("inf") if steady is None else float(steady[1])

    def refresh_powers(drift):
        """→ (rota, rotb, raw): folded output coefficients for sub-steps
        1..7 plus raw R⁸ in slot 7; raw = [(A_j, B_j)] for j = 1..7 (read
        by the events variant's legacy stage only)."""
        delta = drift * phase_inc
        a1 = cosm1 - delta * sin_inc
        b1 = delta * (1.0 + cosm1) + sin_inc
        dm = 1.0 - decaym1
        dj = amplitude * dm
        rota, rotb = [dj + dj * a1], [dj * b1]
        raw = [(a1, b1)]
        aj, bj = a1, b1
        for j in range(2, UNROLL + 1):
            aj, bj = (aj + a1 + aj * a1 - bj * b1,
                      bj + b1 + bj * a1 + aj * b1)
            if j < UNROLL:
                dj = dj * dm
                rota.append(dj + dj * aj)
                rotb.append(dj * bj)
                raw.append((aj, bj))
            else:
                rota.append(aj)
                rotb.append(bj)
        return rota, rotb, raw

    rota, rotb, raw = refresh_powers(drift)
    out = torch.empty((n_tiles * t_tile, lanes), dtype=f32, device=dev)
    n_f0 = float(np.float32(n0))  # the reference's f32 sample counter
    for tile in range(n_tiles):
        for gi in range(t_tile // UNROLL):
            n_g = n0 + tile * t_tile + gi * UNROLL
            if events:
                # onsets are multiples of 16: constant over the group
                active0 = (n_f0 - onset_f) >= 0.0
            if n_g & (JITTER_SUBSAMPLE - 1) == 0:
                st = irng[0:1]
                sk = torch.cat(
                    [(_mul_u32(LCG_A_POW[m + 1], st) + LCG_C_ACC[m + 1])
                     & _MASK32 for m in range(NUM_MODES)]
                    + [torch.zeros_like(st)], dim=0)
                u = (sk >> 1).to(f32) * u_scale
                noise = (u * 2.0 - 1.0) * sqrt3
                new_drift = torch.where(
                    mode_mask, revert * drift + diffusion * noise, drift)
                st_out = sk[NUM_MODES - 1:NUM_MODES]
                if events:  # a pre-onset lane's stream has not started
                    drift = torch.where(active0, new_drift, drift)
                    irng[0:1] = torch.where(active0, st_out, st)
                else:
                    drift = new_drift
                    irng[0:1] = st_out
                rota, rotb, raw = refresh_powers(drift)

            if n_f0 < steady0:
                for j in range(UNROLL):
                    n_loc = (n_f0 + j) - onset_f if events else n_f0 + j
                    cosine = 0.5 * (1.0 - torch.cos(onset_inc * n_loc))
                    shaped = torch.where(
                        onset_exp <= 1.001, cosine,
                        torch.where(onset_exp >= 1.999, cosine * cosine,
                                    torch.pow(torch.clamp(cosine, min=1e-30),
                                              onset_exp)))
                    onset8[j:j + 1] = torch.where(n_loc < onset_samps,
                                                  shaped, 1.0)
            if n_f0 < steady1:
                for j in range(UNROLL):
                    nst = _lcg(irng[1:2])
                    signed = torch.where(nst >= 2 ** 31, nst - 2 ** 32, nst)
                    white = signed.to(f32) * w_scale
                    if events:  # onset-local time, per lane
                        n_loc = (n_f0 + j) - onset_f
                        active = n_loc >= 0.0
                        nact = (n_loc < noise_dur) & active
                        irng[1:2] = torch.where(active, nst, irng[1:2])
                    else:
                        n_loc = n_f0 + j
                        nact = n_loc < noise_dur
                        irng[1:2] = nst
                    namp, z1, z2 = nstate[0:1], nstate[1:2], nstate[2:3]
                    filtered = nb0 * white + z1
                    z1_new = -na1 * filtered + z2
                    z2_new = nb2 * white - na2 * filtered
                    fade = 1.0
                    if events:
                        fade_t = torch.clamp(n_loc / 16.0, max=1.0)
                        fade = 0.5 * (1.0 - torch.cos(pi32 * fade_t))
                        fade = torch.where(n_loc < NOISE_FADE_IN, fade, 1.0)
                    elif n_loc < NOISE_FADE_IN:
                        # on the device, with its cos (as the kernel does)
                        fade_t = torch.full((1,), n_loc / 16.0, dtype=f32,
                                            device=dev)
                        fade = 0.5 * (1.0 - torch.cos(pi32 * fade_t))
                    noise8[j:j + 1] = torch.where(
                        nact, namp * fade * filtered, 0.0)
                    nstate[0:1] = torch.where(nact, namp * noise_decay, namp)
                    nstate[1:2] = torch.where(nact, z1_new, z1)
                    nstate[2:3] = torch.where(nact, z2_new, z2)

            # mode sums for the group, summed over modes in index order,
            # as the CUDA kernel does (torch's own reduction order depends
            # on the tensor's width)
            if legacy and n_f0 + UNROLL > min_rel_f:
                # legacy stage: damper and natural decay per sub-step, the
                # quadrature state of sub-step j straight from the group's
                # start through raw R^j. Never-released lanes overflow exp
                # to inf; the selects discard it.
                rows = []
                for j in range(UNROLL):
                    t_rel = (n_f0 + j) - release_f + 1.0
                    in_ramp = (t_rel >= 1.0) & (t_rel <= ramp_f)
                    post = t_rel > ramp_f
                    inst = drate * (t_rel / torch.clamp(ramp_f, min=1.0))
                    env = torch.where(in_ramp, env * torch.exp(-inst), env)
                    env = torch.where(post, env - env * dm1, env)
                    if j == 0:
                        sj = s
                    else:
                        aj, bj = raw[j - 1]
                        sj = s + torch.where(active0, s * aj + c * bj, 0.0)
                    rows.append(amplitude * sj * env)
                    env = torch.where(active0, env - env * decaym1, env)
                terms = torch.stack(rows, dim=0)
            else:
                # fast stage: spiral-folded coefficients, env advanced once
                p_row = env * s
                q_row = env * c
                if events:  # a pre-onset lane's c = 1 must not leak out
                    p_row = torch.where(active0, p_row, 0.0)
                    q_row = torch.where(active0, q_row, 0.0)
                terms = torch.stack(
                    [amplitude * p_row]
                    + [p_row * rota[j - 1] + q_row * rotb[j - 1]
                       for j in range(1, UNROLL)], dim=0)
                env_new = env - env * dm8m1
                env = torch.where(active0, env_new, env) if events \
                    else env_new
            stage = terms[:, 0]
            for m in range(1, NUM_MODES):
                stage = stage + terms[:, m]
            d_s = s * rota[UNROLL - 1] + c * rotb[UNROLL - 1]
            d_c = c * rota[UNROLL - 1] - s * rotb[UNROLL - 1]
            if events:
                s = torch.where(active0, s + d_s, s)
                c = torch.where(active0, c + d_c, c)
            else:
                s, c = s + d_s, c + d_c

            # batched pickup, serial bilinear charge recurrence
            y_raw = (stage * onset8 + noise8) * ds
            abs_y = y_raw.abs()
            sat = knee + rng_sat * torch.tanh((abs_y - knee) / rng_sat_t)
            y = torch.where(abs_y < knee, y_raw,
                            torch.where(y_raw >= 0, sat, -sat))
            omy = 1.0 - y
            alpha = beta * omy
            pn = 1.0 - alpha
            r = 1.0 / (1.0 + alpha)
            q = nstate[5:6]
            qs = []
            for j in range(UNROLL):
                q = (q * pn[j:j + 1] + twob) * r[j:j + 1]
                qs.append(q)
            nstate[5:6] = q
            n = (tile * t_tile + gi * UNROLL)
            out[n:n + UNROLL] = (torch.cat(qs, 0) * omy - 1.0) * sens \
                * post_gain
            n_f0 += UNROLL

        n_end = n0 + (tile + 1) * t_tile
        if (n_end & (RENORM_INTERVAL - 1)) < t_tile:
            r_inv = torch.rsqrt(torch.clamp(s * s + c * c, min=1e-30))
            if events:  # active as of the tile's last sample
                act = (n_f0 - 1.0) >= onset_f
                s = torch.where(act, s * r_inv, s)
                c = torch.where(act, c * r_inv, c)
            else:
                s, c = s * r_inv, c * r_inv

    if not return_state:
        return out[:num_samples]
    st_out = torch.cat([s, c, env, drift, nstate, _f32_bits(irng)], dim=0)
    return out[:num_samples], st_out


# ───────────────────────────── CUDA wrapper ─────────────────────────────


def _check(name, x, rows, lanes):
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(rows) + (lanes,):
        raise ValueError(f"{name} shape {tuple(x.shape)} != "
                         f"{tuple(rows) + (lanes,)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def render_voice_bank(params, num_samples: int, steady=None, state=None,
                      n0: int = 0, return_state: bool = False,
                      events=None, min_release=None):
    """Render V voices × num_samples → (num_samples, V) float32 on the
    params' device, or (out, state') when return_state.

    params: (N_ROWS, 8, V) float32 from make_kernel_params. steady: None or
    steady_limits(params). state/n0 carry a render across calls (n0 a
    multiple of 16; state from a previous return_state=True call). events:
    run the events variant (default: decided from the params' schedule);
    min_release: the earliest release sample of the whole schedule
    (default: read from the params). Both defaults read schedule rows back
    from the device, so callers in a loop pass them. A CPU tensor runs the
    plain version, a CUDA tensor the CUDA kernel."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    if n0 % JITTER_SUBSAMPLE:
        raise ValueError(f"n0={n0} must be a multiple of {JITTER_SUBSAMPLE}")
    lanes = params.shape[-1]
    _check("params", params, (N_ROWS, SUBLANES), lanes)
    if state is None:
        state = init_bank_state(params)
    _check("state", state, (STATE_ROWS,), lanes)
    if state.device != params.device:
        raise ValueError("params and state must be on one device")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {params.device}")
    if events is None:
        events = _has_events(params)
    if not events:
        min_rel = NEVER
    elif min_release is None:
        min_rel = _min_release(params)
    else:
        min_rel = float(min_release)

    if params.device.type == "cpu":
        PLAIN_CALLS += 1
        return render_voice_bank_plain(params, num_samples, steady, state,
                                       n0, return_state, bool(events),
                                       min_rel)
    t_tile = render_tile(lanes, num_samples, return_state)

    from openwurli_tpu_torch import _build

    lib = _build.library()
    total = -(-num_samples // t_tile) * t_tile
    out = torch.empty((total, lanes), dtype=torch.float32,
                      device=params.device)
    st_out = torch.empty_like(state)
    big = 3.0e38  # steady=None: the warm-phase branches never gate off
    s0, s1 = (big, big) if steady is None else map(float, steady)
    stream = torch.cuda.current_stream(params.device).cuda_stream
    args = (params.data_ptr(), state.data_ptr(), out.data_ptr(),
            st_out.data_ptr(), lanes, total, t_tile, int(n0),
            ctypes.c_float(s0), ctypes.c_float(s1))
    if events:
        name = "voice_bank_events"
        err = lib.ow_voice_bank_events(*args, ctypes.c_float(min_rel),
                                       stream)
    else:
        name = "voice_bank"
        err = lib.ow_voice_bank(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel failed: {_build.error(err)}")
    KERNEL_LAUNCHES += 1
    LAUNCHES_BY_KERNEL[name] += 1
    out = out[:num_samples]
    return (out, st_out) if return_state else out
