"""The 12-node preamp variant: full Gummel-Poon 2N5089s, the 1N4148
protection diode and Johnson-Nyquist thermal noise.

Port of `openwurli_tpu/circuits/melange_preamp.py`. The netlist
(spice/melange/wurli-preamp.cir without R_ldr), its trapezoidal solver
matrices, the DC point (solved WITH R_ldr = 1 MΩ on fb, as the
reference's baked DC point is), the Sherman-Morrison projections that put
the tremolo's LDR conductance on fb at run time, and the per-resistor
noise stamps are float64 NumPy (`make_params`). The step (float64 torch,
batched over leading axes) advances the twin (main, shadow) pair:

  * the noise key advances on every step (JAX's threefry split), ten
    normals scaled by each resistor's σ and the noise scale give the new
    draws w, and w + w_prev (the two-draw trapezoidal stamp) is injected
    on the main row only;
  * the trapezoidal history, fb's explicit LDR term and the input row;
  * the predictor with the rank-1 LDR correction;
  * at most 12 Newton iterations on the 5 ports, each an f32 elimination
    (`mna.ge_solve_f32`) with the step clipped to ±0.5 V; a row whose
    max |f| < 1e-9 stays put, and the loop ends once both rows have
    (the remaining iterations would change nothing);
  * the node update; a non-finite output resets v, i_nl and v_nl to the
    DC point (the key and w_prev still advance).

The f64 engine's kernels (`csrc/engine.cu` `melange_step`) repeat the
step op for op.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch import prng
from openwurli_tpu_torch.circuits import gp, mna
from openwurli_tpu_torch.ops import exact

K_BOLTZMANN = 1.380649e-23
TEMP_K = 290.0  # the reference's T_ROOM_K
R_LDR_INIT = 1_000_000.0
NR_MAX_ITER = 12
NOISE_SEED = 0x5EED
N, M, N_RES = 13, 5, 10  # nodes + sources, ports, resistors

# Newton work of the plain step, summed over the batch: "steps" (twin
# solves), "checks" (residual passes, both rows; a pair stops once both
# its rows have converged) and "updates" (rows updated: Jacobian, f32
# elimination, clipped step). Read by chip_smoke.py to count the
# operations a scan or a replayed chunk needed.
NEWTON_COUNTS = {"steps": 0, "checks": 0, "updates": 0}


def build_netlist() -> mna.Netlist:
    """spice/melange/wurli-preamp.cir WITHOUT R_ldr (handled via SM)."""
    nl = mna.Netlist()
    q2n5089 = mna.BjtModel(
        is_=3.03e-14, bf=1434.0, nf=1.005, vaf=98.5, ikf=0.01358,
        ise=2.88e-15, ne=1.262, br=4.62, nr=1.0, var=22.0, ikr=0.1,
        isc=1.065e-11, nc=1.41, cje=3.22e-12, cjc=1.35e-12)
    d1n4148 = mna.DiodeModel(is_=2.52e-9, n=1.752)

    nl.r("in", "mid_in", 22e3)
    nl.c("in", "0", 1e-12)
    nl.c("mid_in", "base1", 0.022e-6)
    nl.r("vcc", "base1", 2e6)
    nl.r("base1", "0", 470e3)
    nl.diode("D1", "0", "base1", d1n4148)
    nl.bjt("Q1", "coll1", "base1", "emit1", q2n5089)
    nl.r("vcc", "coll1", 150e3)
    nl.r("emit1", "0", 33e3)
    nl.c("emit1", "fb", 4.7e-6)
    nl.c("coll1", "base1", 100e-12)
    nl.bjt("Q2", "coll2", "coll1", "emit2a", q2n5089)
    nl.r("vcc", "coll2", 1.8e3)
    nl.r("emit2a", "emit2b", 270.0)
    nl.c("emit2a", "emit2b", 22e-6)
    nl.r("emit2b", "0", 820.0)
    nl.c("coll2", "coll1", 100e-12)
    nl.r("coll2", "out", 6.8e3)
    nl.r("out", "fb", 56e3)
    nl.v("V1", "vcc", "0", 15.0)
    nl.set_input("in")
    return nl


class MelangePreampParams(NamedTuple):
    """Fixed matrices at one rate (float64 NumPy)."""

    solver: mna.SolverParams
    fb_idx: int
    out_idx: int
    input_row: int
    sample_rate: float
    s_fb_col: np.ndarray     # (n,) S[:, fb]
    s_fb_fb: float
    nv_sfb: np.ndarray       # (M,) N_v S[:, fb]
    sfb_ni: np.ndarray       # (M,) S[fb, :] N_i
    noise_inject: np.ndarray  # (n, n_res) ±1 per resistor's nodes
    noise_sigma: np.ndarray  # (n_res,)


class MelangePreampState(NamedTuple):
    """Twin (main, shadow) on axis -2: v (..., 2, n), i_nl / v_nl (..., 2,
    M); g_ldr_prev (...,); noise_key (..., 2) int64 u32 words;
    noise_w_prev (..., n_res)."""

    v: torch.Tensor
    i_nl: torch.Tensor
    v_nl: torch.Tensor
    g_ldr_prev: torch.Tensor
    noise_key: torch.Tensor
    noise_w_prev: torch.Tensor


@functools.lru_cache(maxsize=None)
def make_params(sample_rate) -> MelangePreampParams:
    nl = build_netlist()
    # the DC point WITH the R_ldr branch (the reference's baked DC point:
    # fb sits at the out·R_ldr/(R10 + R_ldr) divider); the run-time
    # matrices stay LDR-free (Sherman-Morrison)
    nl_dc = build_netlist()
    nl_dc.r("fb", "0", R_LDR_INIT)
    solver = mna.make_solver_params(nl, sample_rate, integrator="trap",
                                    dc=mna.dc_solve(nl_dc))
    asm = nl.assemble()
    fb = nl._nodes["fb"]
    s = solver.s
    s_fb_col, s_fb_row = s[:, fb], s[fb, :]
    # Johnson noise: one current source per physical resistor, across its
    # nodes; per-sample draw w = ½·sqrt(8 kB T fs)·sqrt(1/R)·N(0, 1),
    # injected as w[n] + w[n-1]
    injects, sigmas = [], []
    scale_half = 0.5 * np.sqrt(8.0 * K_BOLTZMANN * TEMP_K * sample_rate)
    for n1, n2, ohms in nl.resistors:
        col = np.zeros(asm["n"])
        if n1 >= 0:
            col[n1] += 1.0
        if n2 >= 0:
            col[n2] -= 1.0
        injects.append(col)
        sigmas.append(scale_half * np.sqrt(1.0 / ohms))
    return MelangePreampParams(
        solver=solver, fb_idx=fb, out_idx=nl._nodes["out"],
        input_row=asm["input_row"], sample_rate=float(sample_rate),
        s_fb_col=s_fb_col.copy(), s_fb_fb=float(s[fb, fb]),
        nv_sfb=asm["n_v"] @ s_fb_col, sfb_ni=s_fb_row @ asm["n_i"],
        noise_inject=np.stack(injects, axis=1),
        noise_sigma=np.asarray(sigmas))


# ───────────────────────── per-sample step (torch) ─────────────────────────


def step_tensors(params: MelangePreampParams, device="cpu") -> dict:
    """The step's constants as float64 tensors on `device`, and the
    netlist's device functions (`mna.Netlist.device_current_fn`,
    `gp.device_derivs_fn`)."""
    sp = params.solver

    def t(x):
        return torch.tensor(np.asarray(x, np.float64), device=device)

    nl = build_netlist()
    return {
        "a_hist": t(sp.a_hist), "s": t(sp.s), "n_v": t(sp.n_v),
        "n_i": t(sp.n_i), "s_ni": t(sp.s_ni), "k": t(sp.k),
        "ws_w": t(sp.w_scale * sp.w), "v_dc": t(sp.v_dc),
        "i_dc": t(sp.i_dc), "v_nl_dc": t(sp.v_nl_dc),
        "s_fb_col": t(params.s_fb_col), "s_fb_fb": t(params.s_fb_fb),
        "k_outer": t(params.nv_sfb[:, None] * params.sfb_ni[None, :]),
        "sfb_ni": t(params.sfb_ni), "inject": t(params.noise_inject),
        "sigma": t(params.noise_sigma),
        "currents": nl.device_current_fn(device),
        "derivs": gp.device_derivs_fn(nl, device),
        "fb": params.fb_idx, "out": params.out_idx,
        "input_row": params.input_row}


def init_state(params: MelangePreampParams, batch_shape=(), device="cpu",
               seed=NOISE_SEED) -> MelangePreampState:
    """Both rows at the DC point, the key at PRNGKey(seed), no draws."""
    sp = params.solver
    bs2 = tuple(batch_shape) + (2,)

    def t(x, shape):
        return torch.tensor(np.asarray(x, np.float64), device=device) \
            .expand(shape + np.shape(x)).clone()

    return MelangePreampState(
        v=t(sp.v_dc, bs2), i_nl=t(sp.i_dc, bs2), v_nl=t(sp.v_nl_dc, bs2),
        g_ldr_prev=torch.full(tuple(batch_shape), 1.0 / R_LDR_INIT,
                              dtype=torch.float64, device=device),
        noise_key=torch.from_numpy(prng.prng_key(seed)).to(device)
        .expand(tuple(batch_shape) + (2,)).clone(),
        noise_w_prev=torch.zeros(tuple(batch_shape) + (N_RES,),
                                 dtype=torch.float64, device=device))


def newton_jacobian(c, k_corr, v_nl):
    """I − K_corr·dI/dV for port voltages (..., M): column k of the
    block-diagonal dI/dV holds its block's two entries (top, bot; a
    diode's bot is 0), so each entry is δ − (K[r, r0]·top + K[r, r0+1]·bot)
    with r0 the block's first port (the diode: δ − K[r, 4]·top)."""
    top, bot = c["derivs"](v_nl)
    k = k_corr.unsqueeze(-3)                                   # twin axis
    cols = [k[..., :, 2 * (col // 2)] * top[..., None, col]
            + k[..., :, 2 * (col // 2) + 1] * bot[..., None, col]
            for col in range(M - 1)]
    cols.append(k[..., :, M - 1] * top[..., None, M - 1])
    eye = torch.eye(M, dtype=torch.float64, device=v_nl.device)
    return eye - torch.stack(cols, dim=-1)


def step(c: dict, state: MelangePreampState, g_ldr, x, noise_scale):
    """One trapezoidal step of the twin pair; c from step_tensors; g_ldr,
    x and noise_scale (= noise_enabled · noise_gain) broadcast over the
    batch. Returns (state, main − shadow)."""
    dev = state.v.device
    g_ldr = torch.as_tensor(g_ldr, dtype=torch.float64, device=dev)
    x = torch.as_tensor(x, dtype=torch.float64, device=dev)
    scale = torch.as_tensor(noise_scale, dtype=torch.float64, device=dev)
    fb, out_i, row_in = c["fb"], c["out"], c["input_row"]

    # thermal noise on the main row
    new_key, sub = prng.split(state.noise_key)
    noise = prng.normal_f64(sub, N_RES)
    w_new = noise * c["sigma"] * scale[..., None]
    i_noise = exact.matvec(c["inject"], w_new + state.noise_w_prev)
    i_noise2 = torch.stack([i_noise, torch.zeros_like(i_noise)], dim=-2)

    # history, fb's explicit LDR term, sources, input, device currents
    v = state.v
    rhs = exact.matvec(c["a_hist"], v)
    rhs[..., fb] = rhs[..., fb] + (-state.g_ldr_prev[..., None]) * v[..., fb]
    rhs = rhs + c["ws_w"]
    u = torch.stack(torch.broadcast_tensors(x, torch.zeros_like(x)), dim=-1)
    rhs[..., row_in] = rhs[..., row_in] + u
    rhs = rhs + exact.matvec(c["n_i"], state.i_nl)
    rhs = rhs + i_noise2

    # predictor, Sherman-Morrison correction for g_ldr on fb
    v_pred_base = exact.matvec(c["s"], rhs)
    sm_k = g_ldr / (1.0 + c["s_fb_fb"] * g_ldr)
    sm_k2 = sm_k[..., None]
    v_pred = v_pred_base - (sm_k2 * v_pred_base[..., fb])[..., None] * \
        c["s_fb_col"]
    p = exact.matvec(c["n_v"], v_pred)
    k_corr = c["k"] - sm_k[..., None, None] * c["k_outer"]

    v_nl = state.v_nl
    k_rows = k_corr.unsqueeze(-3)
    pairs = v_nl[..., 0, 0].numel()  # twin pairs still iterating
    NEWTON_COUNTS["steps"] += pairs
    for _ in range(NR_MAX_ITER):
        NEWTON_COUNTS["checks"] += pairs
        i_nl = c["currents"](v_nl)
        f = v_nl - p - exact.matvec(k_rows, i_nl)
        conv = exact.max_abs(f) < 1e-9
        if bool(conv.all()):
            break  # converged rows stay put: the rest would change nothing
        NEWTON_COUNTS["updates"] += int((~conv).sum())
        pairs = int((~conv.all(-1)).sum())
        dv = mna.ge_solve_f32(newton_jacobian(c, k_corr, v_nl), f)
        v_nl = v_nl - torch.where(conv[..., None], 0.0,
                                  exact.clip(dv, -0.5, 0.5))

    i_new = c["currents"](v_nl)
    s_ni_i = exact.matvec(c["s_ni"], i_new)
    sfb_dot = exact.matvec(c["sfb_ni"][None], i_new)[..., 0]
    v_new = v_pred + s_ni_i - (sm_k2 * sfb_dot)[..., None] * c["s_fb_col"]
    out = v_new[..., 0, out_i] - v_new[..., 1, out_i]

    bad = ~torch.isfinite(out)
    b2 = bad[..., None, None]
    return MelangePreampState(
        v=torch.where(b2, c["v_dc"], v_new),
        i_nl=torch.where(b2, c["i_dc"], i_new),
        v_nl=torch.where(b2, c["v_nl_dc"], v_nl),
        g_ldr_prev=g_ldr.expand(bad.shape).clone(),
        noise_key=new_key, noise_w_prev=w_new), torch.where(bad, 0.0, out)
