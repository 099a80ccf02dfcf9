"""DK-method preamp (Wurlitzer 200A, schematic #203720-S-3): circuit
constants, the fixed solver matrices at a given (oversampled) rate, and
the twin (main, shadow) trapezoidal step.

Port of `openwurli_tpu/circuits/dk_preamp.py`: the matrices in float64
NumPy, the step (6-iteration Newton on the 2×2 Vbe kernel, R_ldr by a
Sherman-Morrison correction) in float64 torch, repeated op for op by the
f64 engine's chain kernel E2. The Johnson-Nyquist constants that the
chain packer takes from the reference's melange preamp module live here
too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch.ops import exact

VCC = 15.0
R1 = 22_000.0      # input series R (with Cin)
R2 = 2_000_000.0   # base1 → Vcc bias
R3 = 470_000.0     # base1 → GND bias
RE1 = 33_000.0     # emit1 → GND
RC1 = 150_000.0    # coll1 → Vcc
RE2A = 270.0       # emit2 → emit2b
RE2B = 820.0       # emit2b → GND
RC2 = 1_800.0      # coll2 → Vcc
R9 = 6_800.0       # coll2 → out
R10 = 56_000.0     # out → fb

CIN = 0.022e-6     # input coupling cap (series with R1)
C3 = 100.0e-12     # Miller, stage 1 (coll1 ↔ base1)
C4 = 100.0e-12     # Miller, stage 2 (coll2 ↔ coll1)
CE1 = 4.7e-6       # feedback coupling (emit1 ↔ fb)
CE2 = 22.0e-6      # stage-2 emitter bypass

# BJT 2N5089, forward-active Ebers-Moll
IS = 3.03e-14
VT = 0.026
VBE_MAX = 0.85

BASE1, EMIT1, COLL1, EMIT2, EMIT2B, COLL2, OUT, FB = range(8)
N = 8

R_LDR_INIT = 1_000_000.0
NR_ITERS = 6
# Newton passes of the plain step (each evaluates both rows), each twin
# pair's own passes summed over the batch (a pair stops once both its rows
# have converged); read by chip_smoke.py to count a scan's or a replayed
# chunk's operations.
NEWTON_PASSES = [0]

# Thermal noise (reference gen_preamp T_ROOM_K), used by the noise stamps.
K_BOLTZMANN = 1.380649e-23
TEMP_K = 290.0


def _stamp_resistor(g, i, j, r):
    c = 1.0 / r
    g[i, i] += c
    g[j, j] += c
    g[i, j] -= c
    g[j, i] -= c


def _stamp_capacitor(c_mat, i, j, cap):
    c_mat[i, i] += cap
    c_mat[j, j] += cap
    c_mat[i, j] -= cap
    c_mat[j, i] -= cap


def build_g_dc():
    """Conductance matrix without R_ldr and Cin."""
    g = np.zeros((N, N))
    g[BASE1, BASE1] += 1.0 / R2 + 1.0 / R3
    g[EMIT1, EMIT1] += 1.0 / RE1
    g[COLL1, COLL1] += 1.0 / RC1
    _stamp_resistor(g, EMIT2, EMIT2B, RE2A)
    g[EMIT2B, EMIT2B] += 1.0 / RE2B
    g[COLL2, COLL2] += 1.0 / RC2
    _stamp_resistor(g, COLL2, OUT, R9)
    _stamp_resistor(g, OUT, FB, R10)
    return g


def build_c_matrix():
    c = np.zeros((N, N))
    _stamp_capacitor(c, COLL1, BASE1, C3)
    _stamp_capacitor(c, COLL2, COLL1, C4)
    _stamp_capacitor(c, EMIT1, FB, CE1)
    _stamp_capacitor(c, EMIT2, EMIT2B, CE2)
    return c


def build_w_vec():
    w = np.zeros(N)
    w[BASE1] = VCC / R2
    w[COLL1] = VCC / RC1
    w[COLL2] = VCC / RC2
    return w


def _compute_k(s):
    """K = N_v S N_i for the two BJT ports (Vbe1 = b1−e1, Vbe2 = c1−e2)."""
    return np.array([
        [s[BASE1, EMIT1] - s[BASE1, COLL1] - s[EMIT1, EMIT1] + s[EMIT1, COLL1],
         s[BASE1, EMIT2] - s[BASE1, COLL2] - s[EMIT1, EMIT2] + s[EMIT1, COLL2]],
        [s[COLL1, EMIT1] - s[COLL1, COLL1] - s[EMIT2, EMIT1] + s[EMIT2, COLL1],
         s[COLL1, EMIT2] - s[COLL1, COLL2] - s[EMIT2, EMIT2] + s[EMIT2, COLL2]],
    ])


def _bjt_ic_np(vbe):
    return IS * (np.exp(np.clip(vbe, -1.0, VBE_MAX) / VT) - 1.0)


def _bjt_ic_gm_np(vbe):
    e = np.exp(np.clip(vbe, -1.0, VBE_MAX) / VT)
    return IS * (e - 1.0), (IS / VT) * e


def full_dc_solve(r_ldr=R_LDR_INIT):
    """Quiescent operating point at a given R_ldr: 100-iteration damped
    Newton on the 2-D Vbe kernel. Returns (v_nl_dc (2,), v_dc (8,))."""
    g_full = build_g_dc()
    g_full[FB, FB] += 1.0 / r_ldr
    s_dc = np.linalg.inv(g_full)
    k_dc = _compute_k(s_dc)
    w = build_w_vec()
    sv = s_dc @ w
    p_dc = np.array([sv[BASE1] - sv[EMIT1], sv[COLL1] - sv[EMIT2]])

    v_nl = np.array([0.56, 0.66])
    for _ in range(100):
        ic0, gm0 = _bjt_ic_gm_np(v_nl[0])
        ic1, gm1 = _bjt_ic_gm_np(v_nl[1])
        f = np.array([
            v_nl[0] - p_dc[0] - k_dc[0, 0] * ic0 - k_dc[0, 1] * ic1,
            v_nl[1] - p_dc[1] - k_dc[1, 0] * ic0 - k_dc[1, 1] * ic1,
        ])
        if np.abs(f).max() < 1e-12:
            break
        jac = np.array([
            [1.0 - k_dc[0, 0] * gm0, -k_dc[0, 1] * gm1],
            [-k_dc[1, 0] * gm0, 1.0 - k_dc[1, 1] * gm1],
        ])
        v_nl -= np.clip(np.linalg.solve(jac, f), -2.0 * VT, 2.0 * VT)

    ic = _bjt_ic_np(v_nl)
    rhs = w.copy()
    rhs[EMIT1] += ic[0]
    rhs[COLL1] -= ic[0]
    rhs[EMIT2] += ic[1]
    rhs[COLL2] -= ic[1]
    return v_nl, s_dc @ rhs


class PreampParams(NamedTuple):
    """Fixed solver matrices (float64 NumPy)."""

    s_base: np.ndarray        # (8, 8) inv(2C/T + G_base), no R_ldr
    a_neg_base: np.ndarray    # (8, 8) 2C/T − G_base
    two_w: np.ndarray         # (8,)
    k: np.ndarray             # (2, 2) NL kernel
    s_fb_col: np.ndarray      # (8,) S[:, FB]
    s_fb_fb: float
    nv_sfb: np.ndarray        # (2,)
    sfb_ni: np.ndarray        # (2,)
    g_cin: float
    c_cin: float
    gc_1pc: float
    v_dc: np.ndarray          # (8,) DC operating point at R_LDR_INIT
    v_nl_dc: np.ndarray       # (2,)
    i_nl_dc: np.ndarray       # (2,)


def make_params(sample_rate) -> PreampParams:
    """All fixed matrices at a given (oversampled) rate."""
    sr = float(sample_rate)
    two_over_t = 2.0 / (1.0 / sr)
    alpha_cin = 2.0 * R1 * CIN * sr
    g_cin = (2.0 * CIN * sr) / (1.0 + alpha_cin)
    c_cin = (1.0 - alpha_cin) / (1.0 + alpha_cin)

    g_base = build_g_dc()
    g_base[BASE1, BASE1] += g_cin
    two_c_over_t = two_over_t * build_c_matrix()
    s_base = np.linalg.inv(two_c_over_t + g_base)
    s_fb_col = s_base[:, FB].copy()
    s_fb_row = s_base[FB, :].copy()
    v_nl_dc, v_dc = full_dc_solve(R_LDR_INIT)
    return PreampParams(
        s_base=s_base,
        a_neg_base=two_c_over_t - g_base,
        two_w=2.0 * build_w_vec(),
        k=_compute_k(s_base),
        s_fb_col=s_fb_col,
        s_fb_fb=float(s_base[FB, FB]),
        nv_sfb=np.array([s_fb_col[BASE1] - s_fb_col[EMIT1],
                         s_fb_col[COLL1] - s_fb_col[EMIT2]]),
        sfb_ni=np.array([s_fb_row[EMIT1] - s_fb_row[COLL1],
                         s_fb_row[EMIT2] - s_fb_row[COLL2]]),
        g_cin=g_cin, c_cin=c_cin, gc_1pc=g_cin * (1.0 + c_cin),
        v_dc=v_dc, v_nl_dc=v_nl_dc, i_nl_dc=_bjt_ic_np(v_nl_dc))


# ───────────────────────── per-sample step (torch) ─────────────────────────


class PreampState(NamedTuple):
    """Main and shadow stacked on axis 0: v (2, 8), i_nl / v_nl (2, 2),
    j_cin / cin_rhs_prev (2,); g_ldr_prev 0-d, shared by the twin."""

    v: torch.Tensor
    i_nl: torch.Tensor
    v_nl: torch.Tensor
    j_cin: torch.Tensor
    cin_rhs_prev: torch.Tensor
    g_ldr_prev: torch.Tensor


def step_tensors(params: PreampParams, device="cpu") -> dict:
    """The step's constants as float64 tensors on `device`."""
    s_base = params.s_base
    c = {k: torch.as_tensor(np.asarray(v, np.float64), device=device)
         for k, v in params._asdict().items()}
    c["ni_col0"] = torch.as_tensor(s_base[:, EMIT1] - s_base[:, COLL1],
                                   device=device)
    c["ni_col1"] = torch.as_tensor(s_base[:, EMIT2] - s_base[:, COLL2],
                                   device=device)
    c["k_outer"] = torch.as_tensor(
        np.asarray(params.nv_sfb)[:, None] * np.asarray(params.sfb_ni)[None],
        device=device)
    c["j_cin_dc"] = c["g_cin"] * c["v_dc"][BASE1]
    return c


def init_state(params: PreampParams, device="cpu") -> PreampState:
    """Main and shadow both at the DC operating point."""
    c = step_tensors(params, device)
    j = c["j_cin_dc"].expand(2).clone()
    return PreampState(v=c["v_dc"].expand(2, N).clone(),
                       i_nl=c["i_nl_dc"].expand(2, 2).clone(),
                       v_nl=c["v_nl_dc"].expand(2, 2).clone(),
                       j_cin=j, cin_rhs_prev=j.clone(),
                       g_ldr_prev=torch.tensor(1.0 / R_LDR_INIT,
                                               dtype=torch.float64,
                                               device=device))


def ldr_conductance(r_ldr_path):
    """Clamp the shunt at 1 kΩ, return its conductance."""
    return 1.0 / exact.maximum(r_ldr_path, 1000.0)


def _bjt_ic_gm(vbe):
    e = torch.exp(exact.div(exact.clip(vbe, -1.0, VBE_MAX), VT))
    return IS * (e - 1.0), (IS / VT) * e


def step(c: dict, state: PreampState, g_ldr, x):
    """One trapezoidal DK step of the twin (main, shadow) pair; c from
    step_tensors. Batched over axes after the twin axis: x and g_ldr
    (...,), v (2, ..., 8), i_nl / v_nl (2, ..., 2), j_cin / cin_rhs_prev
    (2, ...). Returns (state, main − shadow)."""
    u = torch.stack([x, torch.zeros_like(x)])
    # 1. history + sources
    rhs = torch.stack([exact.matvec(c["a_neg_base"], state.v[r])
                       for r in range(2)])
    rhs[..., FB] = rhs[..., FB] + (-state.g_ldr_prev) * state.v[..., FB]
    cin_rhs_now = c["g_cin"] * u + state.j_cin
    rhs[..., BASE1] = rhs[..., BASE1] + (cin_rhs_now + state.cin_rhs_prev)
    rhs[..., EMIT1] = rhs[..., EMIT1] + state.i_nl[..., 0]
    rhs[..., COLL1] = rhs[..., COLL1] + (-state.i_nl[..., 0])
    rhs[..., EMIT2] = rhs[..., EMIT2] + state.i_nl[..., 1]
    rhs[..., COLL2] = rhs[..., COLL2] + (-state.i_nl[..., 1])
    rhs = rhs + c["two_w"]
    # 2-3. predictor, Sherman-Morrison correction for R_ldr
    v_pred_base = torch.stack([exact.matvec(c["s_base"], rhs[r])
                               for r in range(2)])
    sm_k = g_ldr / (1.0 + c["s_fb_fb"] * g_ldr)
    v_pred = v_pred_base - (sm_k * v_pred_base[..., FB])[..., None] * \
        c["s_fb_col"]
    # 4-5. NL port voltages, corrected kernel, masked Newton
    p0 = v_pred[..., BASE1] - v_pred[..., EMIT1]
    p1 = v_pred[..., COLL1] - v_pred[..., EMIT2]
    k_corr = c["k"] - sm_k[..., None, None] * c["k_outer"]
    k00, k01, k10, k11 = (k_corr[..., 0, 0], k_corr[..., 0, 1],
                          k_corr[..., 1, 0], k_corr[..., 1, 1])
    v0, v1 = state.v_nl[..., 0], state.v_nl[..., 1]
    streams = p0[0].numel()  # twin pairs still iterating
    for _ in range(NR_ITERS):
        NEWTON_PASSES[0] += streams
        ic0, gm0 = _bjt_ic_gm(v0)
        ic1, gm1 = _bjt_ic_gm(v1)
        f0 = v0 - p0 - k00 * ic0 - k01 * ic1
        f1 = v1 - p1 - k10 * ic0 - k11 * ic1
        converged = (torch.abs(f0) < 1e-9) & (torch.abs(f1) < 1e-9)
        if bool(converged.all()):
            break  # the remaining masked iterations change nothing
        streams = int((~converged.all(0)).sum())
        j00 = 1.0 - k00 * gm0
        j01 = -k01 * gm1
        j10 = -k10 * gm0
        j11 = 1.0 - k11 * gm1
        det = j00 * j11 - j01 * j10
        big = torch.abs(det) > 1e-30
        ok = ~converged & big
        inv_det = torch.where(big, 1.0 / det, 0.0)
        dv0 = inv_det * (j11 * f0 - j01 * f1)
        dv1 = inv_det * (j00 * f1 - j10 * f0)
        v0 = v0 - torch.where(ok, dv0, 0.0)
        v1 = v1 - torch.where(ok, dv1, 0.0)
    # 6-7. final currents, node update
    ic0, ic1 = _bjt_ic_gm(v0)[0], _bjt_ic_gm(v1)[0]
    s_ni = ic0[..., None] * c["ni_col0"] + ic1[..., None] * c["ni_col1"]
    dot = c["sfb_ni"][0] * ic0 + c["sfb_ni"][1] * ic1
    v_new = v_pred + s_ni - (sm_k * dot)[..., None] * c["s_fb_col"]
    # 8. Cin-R1 companion
    j_cin = -c["gc_1pc"] * (u - v_new[..., BASE1]) - c["c_cin"] * \
        state.j_cin
    out = v_new[0, ..., OUT] - v_new[1, ..., OUT]
    bad = ~torch.isfinite(out)
    jdc = c["j_cin_dc"]
    b1 = bad[..., None]
    return PreampState(
        v=torch.where(b1, c["v_dc"], v_new),
        i_nl=torch.where(b1, c["i_nl_dc"], torch.stack([ic0, ic1], -1)),
        v_nl=torch.where(b1, c["v_nl_dc"], torch.stack([v0, v1], -1)),
        j_cin=torch.where(bad, jdc, j_cin),
        cin_rhs_prev=torch.where(bad, jdc, cin_rhs_now),
        g_ldr_prev=g_ldr), torch.where(bad, 0.0, out)
