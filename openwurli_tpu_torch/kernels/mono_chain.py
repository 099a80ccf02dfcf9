"""Mono analog chain (kernel K2): tremolo → twin DK preamp → Class-AB power
amp → 2× oversampling → speaker, per stream, in float32 deviation form.

Port of `openwurli_tpu/kernels/mono_chain.py`, noise-off variant. Pieces:

  * the host packers `pack_consts` (float64 → the reference's 21 constant
    arrays and ~90 scalars, with all of its self-checks), `init_state`,
    `make_controls`, `unpack_state` / `pack_state` and the packed state
    layout (STATE_ROWS = 328);
  * the plain float32 step functions `trem_update`, `preamp_step`,
    `pa_step` and `base_step` in torch ops on (rows, S) tensors, op for op
    the reference's, and `render_chain_plain`, a Python loop over base
    samples — the CPU path and the oracle the CUDA kernel is held to;
  * `render`, the wrapper: a CPU tensor goes to the plain version, a CUDA
    tensor to `csrc/mono_chain.cu`. No fallback.

Only the reduced 10-port power-amp solve (`PA_ACTIVE` / `PA_RELEG`) is
ported: the reference's dense 16-port branch never runs in production.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch import tables
from openwurli_tpu_torch.circuits import dk_preamp as dkp
from openwurli_tpu_torch.circuits import gp, mna
from openwurli_tpu_torch.circuits import power_amp as pamod
from openwurli_tpu_torch.circuits import speaker as spkmod
from openwurli_tpu_torch.circuits import tremolo as trmod
from openwurli_tpu_torch.ops import allpass

TREM_SUB_OS = 4
SUB_BASE = TREM_SUB_OS // 2  # tremolo update period in base samples
N_PA_ITERS = 8
N_PRE_ITERS = 5
N_TREM_ITERS = 3
PA_CONV_TOL = 1e-4
PA_ACTIVE = (0, 1, 2, 3, 4, 5, 6, 7, 10, 12)
PA_RELEG = (8, 9, 11, 13, 14, 15)
PA_FAIL_TOL = 0.5
T_TILE = 1024

f32 = np.float32

# Launch counters: KERNEL_LAUNCHES counts CUDA launches, PLAIN_CALLS counts
# calls served by the plain version.
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


class ChainConsts(NamedTuple):
    """arrays: name → float32 NumPy array; scalars: name → float/int/tuple."""

    arrays: dict
    scalars: dict


# ───────────────────────── constants packing ─────────────────────────────


def _perm_be_bc(n_bjt):
    """Port permutation: interleaved (be,bc)×B → [be0..be_{B-1}, bc...]."""
    return np.concatenate([np.arange(n_bjt) * 2, np.arange(n_bjt) * 2 + 1])


@functools.lru_cache(maxsize=None)
def pack_consts(base_sr: float) -> ChainConsts:
    """Every constant of the chain at base rate `base_sr`, float64 math,
    packed to float32 arrays and Python scalars (cached per rate)."""
    os_sr = 2.0 * float(base_sr)
    A = {}
    S = {}

    # ── preamp (DK 8-node, trapezoidal) ──
    pp = dkp.make_params(os_sr)
    s_base, a_neg, v_dc = pp.s_base, pp.a_neg_base, pp.v_dc
    i_dc, v_nl_dc = pp.i_nl_dc, pp.v_nl_dc
    sfb, k2, nvsfb, sfbni = pp.s_fb_col, pp.k, pp.nv_sfb, pp.sfb_ni
    g0 = 1.0 / dkp.R_LDR_INIT
    B1, E1, C1, E2, C2, OUT, FB = (dkp.BASE1, dkp.EMIT1, dkp.COLL1,
                                   dkp.EMIT2, dkp.COLL2, dkp.OUT, dkp.FB)

    sa8 = s_base @ a_neg
    A["pre_SA"] = np.asarray(
        np.block([[sa8, np.zeros((8, 8))], [np.zeros((8, 8)), sa8]]), f32)
    s_b1 = s_base[:, B1]
    s_e1c1 = s_base[:, E1] - s_base[:, C1]
    s_e2c2 = s_base[:, E2] - s_base[:, C2]
    A["pre_cols"] = np.stack([sfb, s_b1, s_e1c1, s_e2c2], axis=1).astype(f32)

    # Differenced port-drive rows (f64 here): the p0/p1 contractions never
    # form the ±80 V pump-scale node rows in f32.
    sap = np.zeros((4, 16))
    sap[0, 0:8] = sa8[B1] - sa8[E1]
    sap[1, 0:8] = sa8[C1] - sa8[E2]
    sap[2, 8:16] = sa8[B1] - sa8[E1]
    sap[3, 8:16] = sa8[C1] - sa8[E2]
    A["pre_SA_p"] = sap.astype(f32)
    # Dekker pre-split (12+12 mantissa bits) of the injection columns, in
    # f32 arithmetic so that it matches the in-kernel split exactly.
    _v = A["pre_cols"]
    _t = (_v * np.float32(4097.0)).astype(f32)
    _hi = (_t - (_t - _v).astype(f32)).astype(f32)
    A["pre_cols_hi"] = _hi
    A["pre_cols_lo"] = (_v - _hi).astype(f32)
    for nm, col in (("cfb", sfb), ("cb1", s_b1), ("ce1", s_e1c1),
                    ("ce2", s_e2c2)):
        S[f"pre_{nm}_p0"] = float(col[B1] - col[E1])
        S[f"pre_{nm}_p1"] = float(col[C1] - col[E2])

    # ── Johnson-Nyquist noise stamps (read only by the noise variant) ──
    nz_half = 0.5 * np.sqrt(8.0 * dkp.K_BOLTZMANN * dkp.TEMP_K * os_sr)
    E2B = dkp.EMIT2B
    nz_res = ((B1, None, dkp.R2), (B1, None, dkp.R3),
              (E1, None, dkp.RE1), (C1, None, dkp.RC1),
              (E2, E2B, dkp.RE2A), (E2B, None, dkp.RE2B),
              (C2, None, dkp.RC2), (C2, OUT, dkp.R9),
              (OUT, FB, dkp.R10))
    nz_inj = np.zeros((8, len(nz_res)))
    for _r, (n1, n2, ohms) in enumerate(nz_res):
        nz_inj[n1, _r] += 1.0
        if n2 is not None:
            nz_inj[n2, _r] -= 1.0
        nz_inj[:, _r] *= nz_half * np.sqrt(1.0 / ohms)
    A["pre_NS"] = (s_base @ nz_inj).astype(f32)
    A["pre_NP"] = np.stack([(s_base[B1] - s_base[E1]) @ nz_inj,
                            (s_base[C1] - s_base[E2]) @ nz_inj]).astype(f32)
    S["nz_u_sigma"] = float(nz_half * np.sqrt(dkp.R1))

    # DC fixed point of the discrete step (deviation-origin self-check)
    j_dc = float(pp.g_cin) * v_dc[B1]
    rhs_dc = a_neg @ v_dc + 2.0 * dkp.build_w_vec()
    rhs_dc[FB] += -g0 * v_dc[FB]
    rhs_dc[B1] += 2.0 * j_dc
    rhs_dc[E1] += i_dc[0]
    rhs_dc[C1] -= i_dc[0]
    rhs_dc[E2] += i_dc[1]
    rhs_dc[C2] -= i_dc[1]
    v_pb_dc = s_base @ rhs_dc
    smk0 = g0 / (1.0 + float(pp.s_fb_fb) * g0)
    c0 = v_pb_dc - smk0 * v_pb_dc[FB] * sfb
    q0 = smk0 * (sfbni[0] * i_dc[0] + sfbni[1] * i_dc[1])
    v_dc_recon = c0 + s_e1c1 * i_dc[0] + s_e2c2 * i_dc[1] - q0 * sfb
    if not np.abs(v_dc_recon - v_dc).max() < 1e-9:
        raise AssertionError(
            "preamp deviation-form origin check failed: "
            f"{np.abs(v_dc_recon - v_dc).max():.3e}")

    S.update(
        pre_k00=float(k2[0, 0]), pre_k01=float(k2[0, 1]),
        pre_k10=float(k2[1, 0]), pre_k11=float(k2[1, 1]),
        pre_nvsfb0=float(nvsfb[0]), pre_nvsfb1=float(nvsfb[1]),
        pre_sfbni0=float(sfbni[0]), pre_sfbni1=float(sfbni[1]),
        pre_smk0=smk0, pre_g0=g0, pre_sfbfb=float(pp.s_fb_fb),
        pre_vpbdcfb=float(v_pb_dc[FB]),
        pre_vdcfb=float(v_dc[FB]),
        pre_pdc0=float(c0[B1] - c0[E1]), pre_pdc1=float(c0[C1] - c0[E2]),
        pre_idc0=float(i_dc[0]), pre_idc1=float(i_dc[1]), pre_q0=q0,
        pre_gcin=float(pp.g_cin), pre_ccin=float(pp.c_cin),
        pre_gc1pc=float(pp.gc_1pc),
        pre_vnl_dc0=float(v_nl_dc[0]), pre_vnl_dc1=float(v_nl_dc[1]),
    )

    # ── power amp (21-dim BE, M=16) ──
    nl_pa = pamod.build_netlist()
    pa = pamod.make_params(os_sr)
    sol = pa.solver
    s_m, a_hist, n_v, n_i, w = sol.s, sol.a_hist, sol.n_v, sol.n_i, sol.w
    v_dc_pa, i_dc_pa, v_nl_dc_pa = sol.v_dc, sol.i_dc, sol.v_nl_dc
    n_pa, m_pa = s_m.shape[0], n_v.shape[0]
    if (n_pa, m_pa) != (21, 16):
        raise AssertionError((n_pa, m_pa))
    perm = _perm_be_bc(8)
    n_v = n_v[perm, :]
    n_i = n_i[:, perm]
    i_dc_pa = i_dc_pa[perm]
    v_nl_dc_pa = v_nl_dc_pa[perm]

    sa = s_m @ a_hist
    sni = s_m @ n_i
    k_pa = n_v @ sni
    nvsa = n_v @ sa
    # BE linear-history carry: z' = SA z + (SA SNi) δi + S w_extra
    A["pa_P"] = np.block([[sa, sa @ sni], [nvsa, nvsa @ sni]]).astype(f32)
    A["pa_K"] = k_pa.astype(f32)
    A["pa_cols"] = np.stack(
        [s_m[:, pa.input_row], s_m[:, pa.v1_row], s_m[:, pa.v2_row]],
        axis=1).astype(f32)
    v_lin_dc = s_m @ (a_hist @ v_dc_pa + w)
    if not np.abs(v_lin_dc + sni @ i_dc_pa - v_dc_pa).max() < 1e-6:
        raise AssertionError("power-amp DC linear-carry check failed")
    p_dc_pa = n_v @ v_lin_dc
    if not np.abs(v_nl_dc_pa - p_dc_pa - k_pa @ i_dc_pa).max() < 1e-6:
        raise AssertionError("power-amp DC port-voltage check failed")
    # Per-port NR step clamp: vbe 0.5 V, vbc 2 V.
    clamp_pa = np.concatenate([np.full(8, 0.5), np.full(8, 2.0)])
    nvt_pa, vcrit_pa = mna.junction_limits(nl_pa)
    corr0_pa = v_nl_dc_pa - p_dc_pa - k_pa @ i_dc_pa
    A["pa_nvcols"] = np.stack(
        [n_v @ s_m[:, pa.input_row], n_v @ s_m[:, pa.v1_row],
         n_v @ s_m[:, pa.v2_row], corr0_pa, i_dc_pa, v_nl_dc_pa,
         sni[pa.out_idx, :], clamp_pa, nvt_pa[perm], vcrit_pa[perm]],
        axis=1).astype(f32)
    A["pa_gp"] = gp.pack_bjt_params([b[4] for b in nl_pa.bjts],
                                    np.float64).astype(f32)
    A["eye16"] = np.eye(16, dtype=f32)
    A["pa_K_act"] = k_pa[list(PA_ACTIVE), :].astype(f32)
    A["pa_K_rel"] = k_pa[list(PA_RELEG), :].astype(f32)
    A["pa_eye_act"] = np.eye(len(PA_ACTIVE), dtype=f32)
    S.update(
        pa_vdc_out=float(v_dc_pa[pa.out_idx]), pa_out_idx=int(pa.out_idx),
        pa_headroom=pamod.HEADROOM, pa_rail_bias=pamod.RAIL_DC_BIAS,
        pa_rail_open=pamod.RAIL_V_OPEN, pa_rail_reff=pamod.RAIL_R_EFF,
        pa_load=pamod.SPEAKER_LOAD_OHMS,
        pa_a_att=float(pa.alpha_attack), pa_a_rel=float(pa.alpha_release),
        pa_a_iavg=float(pa.alpha_i_avg),
    )

    # ── tremolo (7-dim trapezoidal, M=4), at the SUBSAMPLED rate ──
    nl_t = trmod.build_netlist()
    tp = trmod.make_params(os_sr / TREM_SUB_OS)
    tsol = tp.solver
    s_t, ah_t, nv_t, ni_t = tsol.s, tsol.a_hist, tsol.n_v, tsol.n_i
    w_t, ws_t = tsol.w, tsol.w_scale
    v_dc_t, i_dc_t, v_nl_dc_t = tsol.v_dc, tsol.i_dc, tsol.v_nl_dc
    if (s_t.shape[0], nv_t.shape[0]) != (7, 4):
        raise AssertionError((s_t.shape[0], nv_t.shape[0]))
    perm_t = _perm_be_bc(2)
    nv_t = nv_t[perm_t, :]
    ni_t = ni_t[:, perm_t]
    i_dc_t = i_dc_t[perm_t]
    v_nl_dc_t = v_nl_dc_t[perm_t]

    sa_t = s_t @ ah_t
    sni_t = s_t @ ni_t
    k_t = nv_t @ sni_t
    nvsa_t = nv_t @ sa_t
    # trap carries i_prev in the rhs: z' = SA z + (SA SNi + SNi) δi
    A["trem_P"] = np.block(
        [[sa_t, sa_t @ sni_t + sni_t],
         [nvsa_t, nvsa_t @ sni_t + k_t]]).astype(f32)
    A["trem_K"] = k_t.astype(f32)
    v_lin_dc_t = s_t @ (ah_t @ v_dc_t + ws_t * w_t + ni_t @ i_dc_t)
    if not np.abs(v_lin_dc_t + sni_t @ i_dc_t - v_dc_t).max() < 1e-6:
        raise AssertionError("tremolo DC linear-carry check failed")
    p_dc_t = nv_t @ v_lin_dc_t
    # settled limit-cycle state → deviation-carry form
    st0 = trmod.settled_osc_state(os_sr)
    d0 = st0.v - v_dc_t
    di0 = st0.i_nl[perm_t] - i_dc_t
    z0 = d0 - sni_t @ di0
    vnl0 = st0.v_nl[perm_t]
    nvt_t, vcrit_t = mna.junction_limits(nl_t)
    corr0_t = v_nl_dc_t - p_dc_t - k_t @ i_dc_t
    cols_t = np.zeros((7, 9), dtype=np.float64)
    cols_t[:4, 0] = corr0_t
    cols_t[:4, 1] = i_dc_t
    cols_t[:4, 2] = v_nl_dc_t
    cols_t[:4, 3] = sni_t[tp.out_idx, :]
    cols_t[:, 4] = z0
    cols_t[:4, 5] = di0
    cols_t[:4, 6] = vnl0
    cols_t[:4, 7] = nvt_t[perm_t]
    cols_t[:4, 8] = vcrit_t[perm_t]
    A["trem_cols"] = cols_t.astype(f32)
    A["trem_gp"] = gp.pack_bjt_params([b[4] for b in nl_t.bjts],
                                      np.float64).astype(f32)
    A["eye4"] = np.eye(4, dtype=f32)
    dt_sub = TREM_SUB_OS / os_sr
    S.update(
        trem_vdc_out=float(v_dc_t[tp.out_idx]),
        trem_out_idx=int(tp.out_idx),
        trem_vmin=trmod.V_OUT_MIN, trem_vmax=trmod.V_OUT_MAX,
        trem_att=float(np.exp(-dt_sub / trmod.ATTACK_TAU)),
        trem_rel=float(np.exp(-dt_sub / trmod.RELEASE_TAU)),
        trem_gamma=trmod.GAMMA,
        trem_ln_rmax=float(np.log(trmod.R_LDR_MAX)),
        trem_ln_span=float(np.log(trmod.R_LDR_MIN)
                           - np.log(trmod.R_LDR_MAX)),
        trem_rmax=trmod.R_LDR_MAX, trem_r18=trmod.R18_SERIES,
    )

    # ── oversampler / speaker / gains ──
    S["os_a"] = tuple(float(x) for x in allpass.BRANCH_A_COEFFS)
    S["os_b"] = tuple(float(x) for x in allpass.BRANCH_B_COEFFS)
    S["spk_thermal_alpha"] = float(1.0 / (spkmod.THERMAL_TAU * base_sr))
    S["post_gain"] = float(tables.POST_SPEAKER_GAIN)
    S["drive"] = float(tables.FIXED_CIRCUIT_DRIVE)
    S["base_sr"] = float(base_sr)
    S = {k: (float(v) if isinstance(v, np.floating) else v)
         for k, v in S.items()}
    return ChainConsts(arrays=A, scalars=S)


ARRAY_NAMES = ("pre_SA", "pre_SA_p", "pre_cols", "pre_cols_hi",
               "pre_cols_lo", "pre_NS", "pre_NP", "pa_P", "pa_K",
               "pa_cols", "pa_nvcols", "pa_gp", "eye16", "pa_K_act",
               "pa_K_rel", "pa_eye_act", "trem_P", "trem_K", "trem_cols",
               "trem_gp", "eye4")


# The float scalars the step functions read, in the fixed order in which
# the CUDA kernel receives them (csrc/mono_chain.cu mirrors this list in
# its `Sc` enum). Products and quotients of pack-time constants are taken
# here in float64 and rounded once, as the reference's Python-scalar
# arithmetic does.
SCALAR_NAMES = (
    "pre_g0", "pre_vdcfb", "pre_gcin", "pre_sfbfb", "pre_smk0",
    "pre_vpbdcfb", "pre_k00", "pre_k01", "pre_k10", "pre_k11",
    "pre_nv0s0", "pre_nv0s1", "pre_nv1s0", "pre_nv1s1",
    "pre_pdc0", "pre_pdc1", "pre_cfb_p0", "pre_cfb_p1", "pre_cb1_p0",
    "pre_cb1_p1", "pre_ce1_p0", "pre_ce1_p1", "pre_ce2_p0", "pre_ce2_p1",
    "pre_inv_vt", "pre_is", "pre_is_vt", "pre_vmax",
    "pre_sfbni0", "pre_sfbni1", "pre_q0", "pre_idc0", "pre_idc1",
    "pre_gc1pc", "pre_ccin", "pre_vnl_dc0", "pre_vnl_dc1",
    "pa_rail_bias", "pa_vdc_out", "pa_inv_headroom", "pa_inv_load",
    "pa_rail_open", "pa_rail_reff", "pa_a_iavg", "pa_a_att", "pa_a_rel",
    "pa_out_idx",
    "trem_vdc_out", "trem_out_idx", "trem_vmax", "trem_vspan", "trem_att",
    "trem_rel", "trem_gamma", "trem_ln_rmax", "trem_ln_span", "trem_rmax",
    "trem_r18",
    "os_a0", "os_a1", "os_a2", "os_b0", "os_b1", "os_b2",
    "spk_thermal_alpha", "post_gain", "drive",
)


def chain_scalars(consts: ChainConsts) -> dict:
    """name → float for every entry of SCALAR_NAMES."""
    sc = consts.scalars
    d = {k: v for k, v in sc.items() if not isinstance(v, tuple)}
    d.update(
        pre_nv0s0=sc["pre_nvsfb0"] * sc["pre_sfbni0"],
        pre_nv0s1=sc["pre_nvsfb0"] * sc["pre_sfbni1"],
        pre_nv1s0=sc["pre_nvsfb1"] * sc["pre_sfbni0"],
        pre_nv1s1=sc["pre_nvsfb1"] * sc["pre_sfbni1"],
        pre_inv_vt=1.0 / dkp.VT, pre_is=dkp.IS, pre_is_vt=dkp.IS / dkp.VT,
        pre_vmax=dkp.VBE_MAX,
        pa_inv_headroom=1.0 / sc["pa_headroom"],
        pa_inv_load=1.0 / sc["pa_load"],
        trem_vspan=sc["trem_vmax"] - sc["trem_vmin"],
    )
    for i in range(3):
        d[f"os_a{i}"] = sc["os_a"][i]
        d[f"os_b{i}"] = sc["os_b"][i]
    return {k: float(d[k]) for k in SCALAR_NAMES}


def scalar_tensors(consts: ChainConsts) -> dict:
    """chain_scalars as float32 0-d CPU tensors (usable with tensors on
    any device; rounding as for a Python scalar), plus the two output
    indices as ints."""
    d = {k: torch.tensor(v, dtype=torch.float32)
         for k, v in chain_scalars(consts).items()}
    d["pa_out_idx"] = int(consts.scalars["pa_out_idx"])
    d["trem_out_idx"] = int(consts.scalars["trem_out_idx"])
    return d


# ───────────────────────── state / controls ──────────────────────────────

STATE_SPEC = (
    # Twin preamp state in (shadow, diff) basis: the shadow carries the
    # zero-input tremolo pump, the diff carries main − shadow (the signal).
    ("pre_d", 16),        # node deviations [shadow 0:8 | diff 8:16]
    ("pre_vnl", 4),       # [p0 main, p0 shadow, p1 main, p1 shadow] (abs)
    ("pre_dic", 4),       # [i0 sh−dc, i0 m−sh, i1 sh−dc, i1 m−sh]
    ("pre_dj", 2),        # δ j_cin [shadow, diff]
    ("pre_dprev", 2),     # δ cin_rhs_prev [shadow, diff]
    ("pre_gldr", 1),      # previous-sample LDR conductance (absolute)
    ("trem_z", 7),
    ("trem_di", 4),
    ("trem_vnl", 4),      # [be0, be1, bc0, bc1] (abs)
    ("trem_env", 1),
    ("gldr_cur", 1),
    ("gldr_upd_prev", 1),  # previous tremolo update (interpolation start)
    ("trem_phase", 1),    # OS sub-samples elapsed in the current hold
    ("pa_z", 21),
    ("pa_di", 16),
    ("pa_vnl", 16),       # [be×8 | bc×8] (abs)
    ("pa_vnl_prev", 16),
    ("pa_rails", 4),      # [v_pos, v_neg, i_avg_pos, i_avg_neg] (abs)
    ("pa_lastgood", 1),
    ("os_ua", 3), ("os_ub", 3), ("os_da", 3), ("os_db", 3), ("os_delay", 1),
    ("spk_hpf", 2), ("spk_lpf", 2), ("spk_thermal", 1),
    ("guard_fires", 1),
    # Thermal-noise state (noise variant only; inert here): previous draws
    # and 40 per-stream LCG streams as f32 bit patterns.
    ("nz_w", 9),
    ("nz_lcg", 40),
)
# Each component starts on an 8-row boundary (the reference's tile layout).
_OFFSETS = {}
_off = 0
for _name, _r in STATE_SPEC:
    _OFFSETS[_name] = (_off, _off + _r)
    _off += -(-_r // 8) * 8
STATE_ROWS = _off

CTRL_SPEC = (
    ("volume", 1), ("rail_sag", 1), ("div_top", 1), ("r_lower", 1),
    ("hpf", 5), ("lpf", 5), ("a2", 1), ("a3", 1), ("thermal_coeff", 1),
    ("char", 1), ("noise", 1),
)
CTRL_ROWS = sum(r for _, r in CTRL_SPEC)
_CTRL_OFF = {}
_off = 0
for _name, _r in CTRL_SPEC:
    _CTRL_OFF[_name] = (_off, _off + _r)
    _off += _r


def unpack_state(flat):
    return {name: flat[a:b] for name, (a, b) in _OFFSETS.items()}


def pack_state(st):
    """{name: (r, S) tensor} → (STATE_ROWS, S); pad rows are zero."""
    first = next(iter(st.values()))
    flat = torch.zeros((STATE_ROWS,) + tuple(first.shape[1:]),
                       dtype=first.dtype, device=first.device)
    for name, (a, b) in _OFFSETS.items():
        flat[a:b] = st[name]
    return flat


def unpack_controls(rows):
    return {name: rows[a:b] for name, (a, b) in _CTRL_OFF.items()}


def init_state(base_sr: float, n_streams: int, device="cpu"):
    """(STATE_ROWS, S) float32 tensor: deviation zeros + absolute rows."""
    c = pack_consts(float(base_sr))
    sc = c.scalars
    flat = np.zeros((STATE_ROWS, n_streams), dtype=f32)

    def put(name, vals):
        a, b = _OFFSETS[name]
        flat[a:b] = np.asarray(vals, dtype=f32).reshape(b - a, 1)

    put("pre_vnl", [sc["pre_vnl_dc0"], sc["pre_vnl_dc0"],
                    sc["pre_vnl_dc1"], sc["pre_vnl_dc1"]])
    put("pre_gldr", [sc["pre_g0"]])
    tc = c.arrays["trem_cols"].astype(np.float64)
    put("trem_z", tc[:, 4])
    put("trem_di", tc[:4, 5])
    put("trem_vnl", tc[:4, 6])
    put("gldr_cur", [sc["pre_g0"]])
    put("gldr_upd_prev", [sc["pre_g0"]])
    put("pa_vnl", c.arrays["pa_nvcols"][:, 5])
    put("pa_vnl_prev", c.arrays["pa_nvcols"][:, 5])
    put("pa_rails", [sc["pa_rail_bias"], sc["pa_rail_bias"], 0.0, 0.0])
    # Per-(row, stream) LCG seeds: splitmix32 finalizer over the cell index.
    a, b = _OFFSETS["nz_lcg"]
    with np.errstate(over="ignore"):
        idx = (np.arange(b - a, dtype=np.uint32)[:, None]
               * np.uint32(n_streams)
               + np.arange(n_streams, dtype=np.uint32)[None, :])
        z = idx + np.uint32(0x9E3779B9)
        z = (z ^ (z >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        z = (z ^ (z >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        z = z ^ (z >> np.uint32(16))
    flat[a:b] = z.view(np.float32)
    return torch.from_numpy(flat).to(device)


def make_controls(base_sr, n_streams, volume=0.5, depth=0.5, character=0.0,
                  rail_sag=True, noise_level=0.0, device="cpu"):
    """(CTRL_ROWS, S) float32 tensor; scalars broadcast, arrays may be
    per-stream (S,)."""
    S = n_streams
    rows = np.zeros((CTRL_ROWS, S), dtype=f32)

    def put(name, vals):
        a, b = _CTRL_OFF[name]
        rows[a:b] = np.asarray(vals, dtype=np.float64).astype(f32)

    def per_stream(x):
        return np.broadcast_to(np.asarray(x, dtype=np.float64), (S,))

    depth = per_stream(depth)
    char = per_stream(character)
    put("volume", per_stream(volume))
    put("rail_sag", per_stream(rail_sag))
    r_up = trmod.R_VIB_POT * (1.0 - depth)
    with np.errstate(divide="ignore", invalid="ignore"):
        top = np.where(r_up > 0.0, r_up * trmod.R_VIB_BRIDGE
                       / (r_up + trmod.R_VIB_BRIDGE), 0.0)
    put("div_top", top)
    put("r_lower", trmod.R_VIB_POT * depth)
    cc = spkmod.coeffs_for_character(char, float(base_sr))
    put("hpf", np.stack(list(cc["hpf"])))
    put("lpf", np.stack(list(cc["lpf"])))
    put("a2", cc["a2"])
    put("a3", cc["a3"])
    put("thermal_coeff", cc["thermal_coeff"])
    put("char", char)
    put("noise", per_stream(noise_level))
    return torch.from_numpy(rows).to(device)


# ───────────────────────── step functions (torch, f32) ───────────────────
#
# Shapes follow the reference: every quantity is (rows, S) with streams on
# the last axis; constant columns are (rows, 1). `c` maps ARRAY_NAMES and
# the control rows to tensors, `sc` is the scalar dict of pack_consts.


def chain_tensors(consts: ChainConsts, controls):
    """Everything the step functions read, as tensors on the controls'
    device: the constant arrays, the control rows, and per-circuit
    derived views (Gummel-Poon parameter columns, Jacobian gathers)."""
    dev = controls.device
    c = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in consts.arrays.items()}
    c.update(unpack_controls(controls))
    c["trem_gpc"] = gp.param_columns(c["trem_gp"], 2)
    c["pa_gpc"] = gp.param_columns(c["pa_gp"], 8)
    c["trem_jac"] = _jac_gather(c["eye4"], c["trem_K"], range(4), 2)
    c["pa_jac_act"] = _jac_gather(c["pa_eye_act"], c["pa_K_act"],
                                  PA_ACTIVE, 8)
    c["pa_jac_rel"] = _jac_gather(None, c["pa_K_rel"], PA_ACTIVE, 8)
    sc = consts.scalars
    c["trem_vspan"] = torch.tensor(sc["trem_vmax"] - sc["trem_vmin"],
                                   dtype=torch.float32, device=dev)
    c["pre_vnl_dc"] = torch.tensor(
        [[sc["pre_vnl_dc0"]], [sc["pre_vnl_dc0"]], [sc["pre_vnl_dc1"]],
         [sc["pre_vnl_dc1"]]], dtype=torch.float32, device=dev)
    c["pa_init_rails"] = torch.tensor(
        [[sc["pa_rail_bias"]], [sc["pa_rail_bias"]], [0.0], [0.0]],
        dtype=torch.float32, device=dev)
    return c


def _matvec(P, x):
    """P (r, n) @ x (n, S), summed over n in index order. The CUDA kernel
    sums in the same order, so the two agree to the last bit where their
    elementwise functions do."""
    terms = (P[:, :, None] * x[None]).unbind(1)
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _rowsum(x):
    """Sum over rows in index order → (1, S)."""
    rows = x.unbind(0)
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc[None]


def _K(v):
    """float32 0-d constant (see gp.const)."""
    return gp.const(v, torch.float32)


def _col(arr, j, rows=None):
    c = arr[:, j:j + 1]
    return c if rows is None else c[:rows]


@functools.lru_cache(maxsize=None)
def _ge_masks(m, device):
    iota = torch.arange(m, device=device)[:, None]
    return ([iota > k for k in range(m)], [iota < k for k in range(m)])


def _ge_solve_flat(cols, rhs, m):
    """Per-stream m×m solve, no pivoting (unit-dominant NR Jacobians).

    cols: (m, m, S) stacked matrix columns (cols[j] = column j), rhs
    (m, S). Each elimination step updates only the not-yet-eliminated
    column blocks, with the reference's full-height row updates."""
    below_mask, above_mask = _ge_masks(m, rhs.device)
    flat = torch.cat([cols, rhs[None]], dim=0)
    invs, u_cols = [], []
    for k in range(m):
        pivcol = flat[0]
        piv = pivcol[k:k + 1]
        tiny = _K(1e-30)
        inv = torch.reciprocal(torch.where(piv.abs() > tiny, piv, tiny))
        invs.append(inv)
        u_cols.append(pivcol)
        below = torch.where(below_mask[k], pivcol, _K(0.0)) * inv
        rest = flat[1:]
        flat = rest - below * rest[:, k:k + 1]
    acc = flat[0]
    xs = [None] * m
    for k in range(m - 1, -1, -1):
        xk = acc[k:k + 1] * invs[k]
        xs[k] = xk
        if k:
            acc = acc - torch.where(above_mask[k], u_cols[k], _K(0.0)) * xk
    return torch.cat(xs, dim=0)


@functools.lru_cache(maxsize=None)
def _port_index(ports, device):
    return torch.tensor(ports, dtype=torch.long, device=device)


def _scatter_rows(x_act, x_rel, order, releg, n):
    """Interleave (n_act, S) + (n_rel, S) back to natural row order."""
    if sorted(tuple(order) + tuple(releg)) != list(range(n)):
        raise ValueError(f"ports {order} + {releg} do not cover 0..{n - 1}")
    pos = {r: i for i, r in enumerate(tuple(order) + tuple(releg))}
    perm = _port_index(tuple(pos[r] for r in range(n)), x_act.device)
    return torch.cat([x_act, x_rel], dim=0).index_select(0, perm)


def _ge_solve_ports(cols_act, cols_rel, f_act, f_rel, order, releg):
    """Solve the reduced block system [[A,0],[C,I]] dv = f per stream.

    cols_act (n_act, n_act, S): A's columns (rows and columns in `order`);
    cols_rel (n_act, n_rel, S): C's columns. dv_rel = f_rel − C·dv_act.
    Returns dv in natural row order."""
    n_act = len(order)
    x_act = _ge_solve_flat(cols_act, f_act, n_act)
    acc = f_rel
    for j in range(n_act):
        acc = acc - cols_rel[j] * x_act[j:j + 1]
    return _scatter_rows(x_act, acc, tuple(order), tuple(releg),
                         n_act + len(releg))


def _two_sum(a, b):
    """Error-free a+b → (sum, err) (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split12(x):
    """Dekker split of an f32 value into 12+12 mantissa-bit halves."""
    t = x * 4097.0
    hi = t - (t - x)
    return hi, x - hi


def _prod_err(a_hi, a_lo, b, p):
    """Exact f32 rounding error of p = (a_hi+a_lo)·b (a pre-split)."""
    b_hi, b_lo = _split12(b)
    return (((a_hi * b_hi - p) + a_hi * b_lo) + a_lo * b_hi) + a_lo * b_lo


def _pnjlim(v_old, v_new, nvt, vcrit):
    """SPICE junction limiting; a step crossing vcrit from below lands on
    vcrit instead of log-walking up from v_old."""
    delta = v_new - v_old
    lim = v_old + nvt * torch.log1p(torch.maximum(delta, _K(0.0)) / nvt)
    lim = torch.maximum(lim, torch.minimum(v_new, vcrit))
    return torch.where((v_new > vcrit) & (delta > _K(2.0) * nvt), lim,
                       v_new)


def _allpass_step(coeffs, state, x):
    """3-section allpass cascade; state (3,S), x (1,S) → (state, y)."""
    ss = []
    y = x
    for i in range(3):
        out = coeffs[i] * y + state[i:i + 1]
        ss.append(y - coeffs[i] * out)
        y = out
    return torch.cat(ss, dim=0), y


def _jac_gather(eye, K, ports, n_half):
    """Static pieces of the Newton-Jacobian columns for `ports`: (eyeT,
    K[:, b]ᵀ, K[:, b+n_half]ᵀ) as (ports, rows, 1) plus the port list."""
    b_idx = [j % n_half for j in ports]
    ka = K[:, b_idx].T[:, :, None].contiguous()
    kb = K[:, [b + n_half for b in b_idx]].T[:, :, None].contiguous()
    eye_t = None if eye is None else eye.T[:, :, None].contiguous()
    return eye_t, ka, kb, list(ports)


def _jac_cols(gather, g1_all, g2_all):
    """Stacked columns (ports, rows, S): eye[:, j] − K[:, b]·g1 −
    K[:, b+n_half]·g2, or −K[:, b]·g1 − K[:, b+n_half]·g2 without eye.
    g1_all/g2_all hold each port's dI/dV entries in natural port order
    ([dib/dvbe; dib/dvbc] and [dic/dvbe; dic/dvbc])."""
    eye_t, ka, kb, ports = gather
    idx = _port_index(tuple(ports), g1_all.device)
    g1 = g1_all.index_select(0, idx)[:, None]
    g2 = g2_all.index_select(0, idx)[:, None]
    first = (-ka) * g1 if eye_t is None else eye_t - ka * g1
    return first - kb * g2


def trem_update(c, sc, st):
    """One subsampled tremolo step → state with new tremolo rows."""
    z, di, vnl, env = (st["trem_z"], st["trem_di"], st["trem_vnl"],
                       st["trem_env"])
    K = c["trem_K"]
    cols_c = c["trem_cols"]
    corr0, i_dc = _col(cols_c, 0, 4), _col(cols_c, 1, 4)
    vnl_dc, sni_out = _col(cols_c, 2, 4), _col(cols_c, 3, 4)
    gpp = c["trem_gpc"]

    big = _matvec(c["trem_P"], torch.cat([z, di], dim=0))
    z_new, p_dev = big[0:7], big[7:11]
    for _ in range(N_TREM_ITERS):
        ib, ic, gbb, gbc, gcb, gcc = gp.bjt_currents_derivs_packed(
            gpp, vnl[0:2], vnl[2:4])
        i_abs = torch.cat([ib, ic], dim=0)
        f = (vnl - vnl_dc) - p_dev - corr0 - _matvec(K, i_abs - i_dc)
        cols = _jac_cols(c["trem_jac"], torch.cat([gbb, gbc], dim=0),
                         torch.cat([gcb, gcc], dim=0))
        dv = torch.clamp(_ge_solve_flat(cols, f, 4), -0.5, 0.5)
        vnl = _pnjlim(vnl, vnl - dv, _col(cols_c, 7, 4), _col(cols_c, 8, 4))

    ibf, icf = gp.bjt_currents_packed(gpp, vnl[0:2], vnl[2:4])
    di_new = torch.cat([ibf, icf], dim=0) - i_dc
    oi = sc["trem_out_idx"]
    v_out = (sc["trem_vdc_out"] + z_new[oi:oi + 1]
             + _rowsum(sni_out * di_new))

    # Divide by a tensor on the device: torch turns division by a CPU
    # scalar into a multiply by its reciprocal on CUDA.
    led = torch.clamp((sc["trem_vmax"] - v_out) / c["trem_vspan"], 0.0, 1.0)
    coeff = torch.where(led > env, sc["trem_att"], sc["trem_rel"])
    env_new = led + coeff * (env - led)
    drv = torch.clamp(env_new, 0.0, 1.0)
    pw = torch.exp(sc["trem_gamma"] * torch.log(torch.clamp(drv, min=1e-30)))
    r_ldr = torch.where(drv < 1e-6, sc["trem_rmax"],
                        torch.exp(sc["trem_ln_rmax"] + sc["trem_ln_span"]
                                  * pw))
    branch = sc["trem_r18"] + r_ldr
    r_low = c["r_lower"]
    low = torch.where(r_low > 0.0, r_low * branch / (r_low + branch), 0.0)
    gldr = 1.0 / torch.clamp(c["div_top"] + low, min=1000.0)

    st = dict(st)
    st["trem_z"] = z_new
    st["trem_di"] = di_new
    st["trem_vnl"] = vnl
    st["trem_env"] = env_new
    st["gldr_upd_prev"] = st["gldr_cur"]
    st["gldr_cur"] = gldr
    st["trem_phase"] = torch.zeros_like(st["trem_phase"])
    return st


def preamp_step(c, sc, st, u_main, gldr):
    """Twin DK preamp, one oversampled sample (noise off). u_main (1,S).
    Returns (st, out) with out = main − shadow (1,S)."""
    B1, OUT, FB = dkp.BASE1, dkp.OUT, dkp.FB
    inv_vt, IS, is_vt = sc["pre_inv_vt"], sc["pre_is"], sc["pre_is_vt"]
    lo, vmax = -1.0, float(sc["pre_vmax"])
    one, zero = _K(1.0), _K(0.0)
    d = st["pre_d"]
    gprev = st["pre_gldr"]
    cols = c["pre_cols"]
    col_fb, col_b1 = _col(cols, 0), _col(cols, 1)
    col_e1c1, col_e2c2 = _col(cols, 2), _col(cols, 3)

    sad = _matvec(c["pre_SA"], d)
    d_sh, d_df = d[0:8], d[8:16]
    dj, dpv, dic = st["pre_dj"], st["pre_dprev"], st["pre_dic"]
    c_fb_sh = -(gprev * d_sh[FB:FB + 1]
                + (gprev - sc["pre_g0"]) * sc["pre_vdcfb"])
    c_b1_sh = dj[0:1] + dpv[0:1]
    c_fb_df = -gprev * d_df[FB:FB + 1]
    c_b1_df = sc["pre_gcin"] * u_main + dj[1:2] + dpv[1:2]

    # pb accumulation, compensated: Dekker products with the constant
    # factor pre-split at pack time, TwoSum cascade, one final collapse.
    ch, clo = c["pre_cols_hi"], c["pre_cols_lo"]
    splits = [(_col(cols, j), _col(ch, j), _col(clo, j)) for j in range(4)]

    def _pb_comp(sad8, cfs):
        s = sad8
        lo = None
        for (col, col_hi, col_lo), cf in zip(splits, cfs):
            p = col * cf
            e = _prod_err(col_hi, col_lo, cf, p)
            s, e2 = _two_sum(s, p)
            lo = e + e2 if lo is None else lo + (e + e2)
        return s + lo

    pb_sh = _pb_comp(sad[0:8], (c_fb_sh, c_b1_sh, dic[0:1], dic[2:3]))
    pb_df = _pb_comp(sad[8:16], (c_fb_df, c_b1_df, dic[1:2], dic[3:4]))

    smk = gldr / (1.0 + sc["pre_sfbfb"] * gldr)
    kc00 = sc["pre_k00"] - smk * sc["pre_nv0s0"]
    kc01 = sc["pre_k01"] - smk * sc["pre_nv0s1"]
    kc10 = sc["pre_k10"] - smk * sc["pre_nv1s0"]
    kc11 = sc["pre_k11"] - smk * sc["pre_nv1s1"]
    tpart_sh = smk * pb_sh[FB:FB + 1] + (smk - sc["pre_smk0"]) \
        * sc["pre_vpbdcfb"]
    tpart_df = smk * pb_df[FB:FB + 1]
    # The node rows reach pump scale (±80 V in the shadow) and feed the
    # next sample's state, so their update is accumulated in float64 from
    # the float32 terms (every product exact) and rounded once: XLA
    # contracts these multiply-adds into FMAs, and with four separately
    # rounded float32 products the fixed-trajectory chain error rises from
    # −62 to −51 dB. The CUDA kernel does the same float64 operations.
    f64 = torch.float64
    cfb64 = col_fb.to(f64)
    pred_sh = pb_sh.to(f64) - tpart_sh.to(f64) * cfb64
    pred_df = pb_df.to(f64) - tpart_df.to(f64) * cfb64

    # NR port drives through the differenced coefficient rows.
    p_sad = _matvec(c["pre_SA_p"], d)
    p0_sh = (sc["pre_pdc0"] + p_sad[0:1]
             + sc["pre_cfb_p0"] * c_fb_sh + sc["pre_cb1_p0"] * c_b1_sh
             + sc["pre_ce1_p0"] * dic[0:1] + sc["pre_ce2_p0"] * dic[2:3]
             - tpart_sh * sc["pre_cfb_p0"])
    p1_sh = (sc["pre_pdc1"] + p_sad[1:2]
             + sc["pre_cfb_p1"] * c_fb_sh + sc["pre_cb1_p1"] * c_b1_sh
             + sc["pre_ce1_p1"] * dic[0:1] + sc["pre_ce2_p1"] * dic[2:3]
             - tpart_sh * sc["pre_cfb_p1"])
    p0_df = (p_sad[2:3]
             + sc["pre_cfb_p0"] * c_fb_df + sc["pre_cb1_p0"] * c_b1_df
             + sc["pre_ce1_p0"] * dic[1:2] + sc["pre_ce2_p0"] * dic[3:4]
             - tpart_df * sc["pre_cfb_p0"])
    p1_df = (p_sad[3:4]
             + sc["pre_cfb_p1"] * c_fb_df + sc["pre_cb1_p1"] * c_b1_df
             + sc["pre_ce1_p1"] * dic[1:2] + sc["pre_ce2_p1"] * dic[3:4]
             - tpart_df * sc["pre_cfb_p1"])
    p0 = torch.cat([p0_sh + p0_df, p0_sh], dim=0)  # [main, shadow]
    p1 = torch.cat([p1_sh + p1_df, p1_sh], dim=0)

    vnl0 = st["pre_vnl"][0:2]
    vnl1 = st["pre_vnl"][2:4]
    tol, tiny = _K(1e-6), _K(1e-30)
    for _ in range(N_PRE_ITERS):
        e0 = torch.exp(torch.clamp(vnl0, lo, vmax) * inv_vt)
        e1 = torch.exp(torch.clamp(vnl1, lo, vmax) * inv_vt)
        ic0, gm0 = IS * (e0 - one), is_vt * e0
        ic1, gm1 = IS * (e1 - one), is_vt * e1
        f0 = vnl0 - p0 - kc00 * ic0 - kc01 * ic1
        f1 = vnl1 - p1 - kc10 * ic0 - kc11 * ic1
        j00 = one - kc00 * gm0
        j01 = -kc01 * gm1
        j10 = -kc10 * gm0
        j11 = one - kc11 * gm1
        det = j00 * j11 - j01 * j10
        conv = (f0.abs() < tol) & (f1.abs() < tol)
        det_ok = det.abs() > tiny
        ok = (~conv) & det_ok
        inv = torch.where(det_ok, torch.reciprocal(det), zero)
        vnl0 = vnl0 - torch.where(ok, inv * (j11 * f0 - j01 * f1), zero)
        vnl1 = vnl1 - torch.where(ok, inv * (j00 * f1 - j10 * f0), zero)

    icn0 = IS * (torch.exp(torch.clamp(vnl0, lo, vmax) * inv_vt) - one)
    icn1 = IS * (torch.exp(torch.clamp(vnl1, lo, vmax) * inv_vt) - one)
    i0_sh, i1_sh = icn0[1:2], icn1[1:2]
    di0 = icn0[0:1] - i0_sh
    di1 = icn1[0:1] - i1_sh
    q_sh = smk * (sc["pre_sfbni0"] * i0_sh + sc["pre_sfbni1"] * i1_sh) \
        - sc["pre_q0"]
    q_df = smk * (sc["pre_sfbni0"] * di0 + sc["pre_sfbni1"] * di1)
    ce1, ce2 = col_e1c1.to(f64), col_e2c2.to(f64)
    dn_sh = (pred_sh + ce1 * (i0_sh - sc["pre_idc0"]).to(f64)
             + ce2 * (i1_sh - sc["pre_idc1"]).to(f64)
             - q_sh.to(f64) * cfb64).to(torch.float32)
    dn_df = (pred_df + ce1 * di0.to(f64) + ce2 * di1.to(f64)
             - q_df.to(f64) * cfb64).to(torch.float32)

    dj_sh = sc["pre_gc1pc"] * dn_sh[B1:B1 + 1] - sc["pre_ccin"] * dj[0:1]
    dj_df = sc["pre_gc1pc"] * (dn_df[B1:B1 + 1] - u_main) \
        - sc["pre_ccin"] * dj[1:2]
    st = dict(st)
    st["pre_d"] = torch.cat([dn_sh, dn_df], dim=0)
    st["pre_vnl"] = torch.cat([vnl0, vnl1], dim=0)
    st["pre_dic"] = torch.cat([i0_sh - sc["pre_idc0"], di0,
                               i1_sh - sc["pre_idc1"], di1], dim=0)
    st["pre_dj"] = torch.cat([dj_sh, dj_df], dim=0)
    st["pre_dprev"] = torch.cat([dj[0:1], sc["pre_gcin"] * u_main
                                 + dj[1:2]], dim=0)
    st["pre_gldr"] = gldr
    return st, dn_df[OUT:OUT + 1]


def pa_step(c, sc, st, x, rail_sag):
    """Power amp, one oversampled sample. x (1,S) volts. Returns (st, out)
    with out ∈ [−1, 1] (HEADROOM-normalised, guard-held)."""
    nvcols = c["pa_nvcols"]
    corr0, i_dc = _col(nvcols, 3), _col(nvcols, 4)
    vnl_dc, sni_out = _col(nvcols, 5), _col(nvcols, 6)
    clamp, nvt_col, vcrit_col = (_col(nvcols, 7), _col(nvcols, 8),
                                 _col(nvcols, 9))
    gpp = c["pa_gpc"]
    K = c["pa_K"]

    rails = st["pa_rails"]
    off_p = (rails[0:1] - sc["pa_rail_bias"]) * rail_sag
    off_n = (rails[1:2] - sc["pa_rail_bias"]) * rail_sag
    big = _matvec(c["pa_P"], torch.cat([st["pa_z"], st["pa_di"]],
                                       dim=0))
    pa_cols = c["pa_cols"]
    z_new = (big[0:21] + _col(pa_cols, 0) * x + _col(pa_cols, 1) * off_p
             + _col(pa_cols, 2) * off_n)
    p_dev = (big[21:37] + _col(nvcols, 0) * x + _col(nvcols, 1) * off_p
             + _col(nvcols, 2) * off_n)

    # First-order warm start: vbe ports barely extrapolated, vbc freely.
    vnl_old = st["pa_vnl"]
    ws_clamp = torch.cat([torch.full_like(vnl_old[0:8], 0.02),
                          torch.full_like(vnl_old[8:16], 2.0)], dim=0)
    ws = vnl_old + torch.clamp(vnl_old - st["pa_vnl_prev"], -ws_clamp,
                               ws_clamp)
    ws = _pnjlim(vnl_old, ws, nvt_col, vcrit_col)
    vnl = ws

    def resid_from(v, i_):
        return (v - vnl_dc) - p_dev - corr0 - _matvec(K, i_ - i_dc)

    act = _port_index(PA_ACTIVE, vnl_old.device)
    rel = _port_index(PA_RELEG, vnl_old.device)
    fn0 = None
    for _ in range(N_PA_ITERS):
        ib, ic, gbb, gbc, gcb, gcc = gp.bjt_currents_derivs_packed(
            gpp, vnl[0:8], vnl[8:16])
        f = resid_from(vnl, torch.cat([ib, ic], dim=0))
        fn = f.abs().amax(0, keepdim=True)
        if fn0 is None:
            fn0 = fn
        g1_all = torch.cat([gbb, gbc], dim=0)
        g2_all = torch.cat([gcb, gcc], dim=0)
        cols_a = _jac_cols(c["pa_jac_act"], g1_all, g2_all)
        cols_r = _jac_cols(c["pa_jac_rel"], g1_all, g2_all)
        dv = _ge_solve_ports(cols_a, cols_r, f.index_select(0, act),
                             f.index_select(0, rel), PA_ACTIVE, PA_RELEG)
        dv = torch.clamp(dv, -clamp, clamp)
        dv = torch.where(fn < _K(PA_CONV_TOL), _K(0.0), dv)
        vnl = _pnjlim(vnl, vnl - dv, nvt_col, vcrit_col)

    ib, ic = gp.bjt_currents_packed(gpp, vnl[0:8], vnl[8:16])
    i_abs = torch.cat([ib, ic], dim=0)
    fn_final = resid_from(vnl, i_abs).abs().amax(0, keepdim=True)
    # Explosion reset: NR ended farther than it started → keep the warm
    # start (the guard below holds the output).
    exploded = fn_final > torch.clamp(4.0 * fn0, min=1.0)
    vnl = torch.where(exploded, ws, vnl)
    ib_ws, ic_ws = gp.bjt_currents_packed(gpp, ws[0:8], ws[8:16])
    i_abs = torch.where(exploded, torch.cat([ib_ws, ic_ws], dim=0), i_abs)

    di_new = i_abs - i_dc
    oi = sc["pa_out_idx"]
    out_dev = z_new[oi:oi + 1] + _rowsum(sni_out * di_new)
    raw = sc["pa_vdc_out"] + out_dev
    result = raw * sc["pa_inv_headroom"]

    # Divergence guard: hold on NR failure, reset + hold when insane.
    nr_failed = (fn_final > PA_FAIL_TOL) | exploded
    reset = (z_new.abs().amax(0, keepdim=True) > 100.0) \
        | ~torch.isfinite(result)
    bad = reset | nr_failed
    z_new = torch.where(reset, 0.0, z_new)
    di_new = torch.where(reset, 0.0, di_new)
    vnl = torch.where(reset, vnl_dc, vnl)
    vnl_prev = torch.where(reset, vnl_dc, vnl_old)
    out = torch.where(bad, st["pa_lastgood"], torch.clamp(result, -1.0, 1.0))

    # Rail dynamics from the raw output voltage.
    i_pos = torch.clamp(raw * sc["pa_inv_load"], min=0.0)
    i_neg = torch.clamp(-raw * sc["pa_inv_load"], min=0.0)
    iavg_p = rails[2:3] + sc["pa_a_iavg"] * (i_pos - rails[2:3])
    iavg_n = rails[3:4] + sc["pa_a_iavg"] * (i_neg - rails[3:4])
    tgt_p = sc["pa_rail_open"] - iavg_p * sc["pa_rail_reff"]
    tgt_n = sc["pa_rail_open"] - iavg_n * sc["pa_rail_reff"]
    a_p = torch.where(tgt_p < rails[0:1], sc["pa_a_att"], sc["pa_a_rel"])
    a_n = torch.where(tgt_n < rails[1:2], sc["pa_a_att"], sc["pa_a_rel"])
    new_rails = torch.cat([rails[0:1] + a_p * (tgt_p - rails[0:1]),
                           rails[1:2] + a_n * (tgt_n - rails[1:2]),
                           iavg_p, iavg_n], dim=0)
    rails = torch.where(rail_sag > 0.5,
                        torch.where(bad, c["pa_init_rails"], new_rails),
                        rails)

    st = dict(st)
    st["pa_z"] = z_new
    st["pa_di"] = di_new
    st["pa_vnl"] = vnl
    st["pa_vnl_prev"] = vnl_prev
    st["pa_rails"] = rails
    st["pa_lastgood"] = out
    return st, out


_GUARD_ZERO = ("pre_d", "pre_dic", "pre_dj", "pre_dprev", "pa_z", "pa_di",
               "os_ua", "os_ub", "os_da", "os_db", "os_delay", "spk_hpf",
               "spk_lpf", "spk_thermal", "pa_lastgood")


def base_step(c, sc, st, x):
    """One base-rate sample: 2× upsample → 2×(preamp → power amp) →
    downsample → speaker → NaN guard. x (1,S) → (st, out (1,S))."""
    st = dict(st)
    os_a = (sc["os_a0"], sc["os_a1"], sc["os_a2"])
    os_b = (sc["os_b0"], sc["os_b1"], sc["os_b2"])
    st["os_ua"], e = _allpass_step(os_a, st["os_ua"], x)
    st["os_ub"], o = _allpass_step(os_b, st["os_ub"], x)

    g_cur, g_prev, ph = st["gldr_cur"], st["gldr_upd_prev"], st["trem_phase"]
    ys = []
    for t_os, u in enumerate((e, o)):
        frac = (ph + (t_os + 1.0)) * (1.0 / TREM_SUB_OS)
        gldr = g_prev + frac * (g_cur - g_prev)
        st, pre_out = preamp_step(c, sc, st, u, gldr)
        st, y = pa_step(c, sc, st, pre_out * sc["drive"], c["rail_sag"])
        ys.append(y)
    st["trem_phase"] = ph + 2.0
    st["os_da"], a = _allpass_step(os_a, st["os_da"], ys[0])
    st["os_db"], b = _allpass_step(os_b, st["os_db"], ys[1])
    amp_out = (a + st["os_delay"]) * 0.5
    st["os_delay"] = b

    # Speaker: Hammerstein waveshaper, tanh limit, thermal, HPF → LPF.
    a2, a3 = c["a2"], c["a3"]
    x2 = amp_out * amp_out
    shaped = (amp_out + a2 * x2 + a3 * x2 * amp_out) / (1.0 + a2 + a3)
    limited = torch.where(c["char"] < 0.001, shaped, torch.tanh(shaped))
    thermal = st["spk_thermal"] + (x2 - st["spk_thermal"]) \
        * sc["spk_thermal_alpha"]
    tgain = 1.0 / (1.0 + c["thermal_coeff"] * torch.sqrt(thermal))
    st["spk_thermal"] = thermal

    def bq(rows, state, xin):
        y = rows[0:1] * xin + state[0:1]
        z1 = rows[1:2] * xin - rows[3:4] * y + state[1:2]
        z2 = rows[2:3] * xin - rows[4:5] * y
        return torch.cat([z1, z2], dim=0), y

    st["spk_hpf"], filt = bq(c["hpf"], st["spk_hpf"], limited * tgain)
    st["spk_lpf"], spk_out = bq(c["lpf"], st["spk_lpf"], filt)
    out = spk_out * sc["post_gain"] * c["volume"]

    # Final NaN guard: reset the chain, output silence.
    bad = ~torch.isfinite(out)
    for nm in _GUARD_ZERO:
        st[nm] = torch.where(bad, 0.0, st[nm])
    st["pre_vnl"] = torch.where(bad, c["pre_vnl_dc"], st["pre_vnl"])
    vnl_dc_pa = _col(c["pa_nvcols"], 5)
    st["pa_vnl"] = torch.where(bad, vnl_dc_pa, st["pa_vnl"])
    st["pa_vnl_prev"] = torch.where(bad, vnl_dc_pa, st["pa_vnl_prev"])
    st["guard_fires"] = st["guard_fires"] + bad.to(out.dtype)
    return st, torch.where(bad, 0.0, out)


def render_chain_plain(consts: ChainConsts, controls, state, audio):
    """Plain-torch K2 on the inputs' device: audio (T, S) → (out, state').

    A Python loop over base samples running the step functions above:
    the tremolo update on every SUB_BASE-th sample (before base_step),
    as the reference kernel and its scan twin do."""
    c = chain_tensors(consts, controls)
    sc = scalar_tensors(consts)
    st = {k: v.clone() for k, v in unpack_state(state).items()}
    t_len = audio.shape[0]
    out = torch.empty_like(audio)
    with torch.inference_mode():
        for i in range(t_len):
            if i % SUB_BASE == 0:
                st = trem_update(c, sc, st)
            st, y = base_step(c, sc, st, audio[i:i + 1])
            out[i:i + 1] = y
    return out, pack_state(st)


# ───────────────────────────── CUDA wrapper ─────────────────────────────


@functools.lru_cache(maxsize=None)
def _kernel_inputs(base_sr: float, device: str):
    """The packed constant buffer (ARRAY_NAMES order) and the scalar
    vector (SCALAR_NAMES order) on `device`, cached per rate and device."""
    consts = pack_consts(base_sr)
    flat = np.concatenate([consts.arrays[n].ravel() for n in ARRAY_NAMES])
    scal = np.asarray(list(chain_scalars(consts).values()), dtype=f32)
    return (torch.from_numpy(flat.astype(f32)).to(device),
            torch.from_numpy(scal).to(device))


def _check(name, x, shape):
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def render(base_sr, controls, state, audio, noise=False):
    """Run the chain over audio (T, S) float32 → (out (T, S), state').

    controls (CTRL_ROWS, S) from make_controls, state (STATE_ROWS, S) from
    init_state or a previous call; T a multiple of SUB_BASE. A CPU tensor
    runs the plain version, a CUDA tensor the CUDA kernel."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    if noise:
        raise NotImplementedError(
            "the thermal-noise chain variant (kernel K5) is not ported yet")
    t_len, s = audio.shape
    if t_len % SUB_BASE:
        raise ValueError(f"T={t_len} must be a multiple of {SUB_BASE}")
    _check("audio", audio, (t_len, s))
    _check("controls", controls, (CTRL_ROWS, s))
    _check("state", state, (STATE_ROWS, s))
    if not (audio.device == controls.device == state.device):
        raise ValueError("audio, controls and state must be on one device")
    consts = pack_consts(float(base_sr))

    if audio.device.type == "cpu":
        PLAIN_CALLS += 1
        return render_chain_plain(consts, controls, state, audio)
    if audio.device.type != "cuda":
        raise ValueError(f"unsupported device {audio.device}")

    from openwurli_tpu_torch import _build

    lib = _build.library()
    flat, scal = _kernel_inputs(float(base_sr), str(audio.device))
    out = torch.empty_like(audio)
    st_out = torch.empty_like(state)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    err = lib.ow_mono_chain(
        flat.data_ptr(), flat.numel(), scal.data_ptr(), scal.numel(),
        controls.data_ptr(), state.data_ptr(), audio.data_ptr(),
        out.data_ptr(), st_out.data_ptr(), s, t_len, stream)
    if err:
        raise RuntimeError(f"mono_chain kernel failed: {_build.error(err)}")
    KERNEL_LAUNCHES += 1
    return out, st_out
