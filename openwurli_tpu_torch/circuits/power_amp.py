"""Wurlitzer 200A Class AB power amplifier: netlist, rail-dynamics
constants and solver matrices (backward Euler), and the per-sample step.

Port of `openwurli_tpu/circuits/power_amp.py`: the circuit model and
the behavioral closed-loop model (`behavioral_process`). The step (float64 torch, repeated op for
op by the f64 engine's chain kernel E2) pushes the previous sample's rail
offsets into the source vector, solves with 16 masked Newton iterations,
applies the two-tier divergence guard, and updates the rails after the
solve from the raw output.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch.circuits import mna
from openwurli_tpu_torch.ops import exact

NR_ITERS = 16

HEADROOM = 22.0
RAIL_V_OPEN = 24.5
RAIL_DC_BIAS = 22.5
RAIL_R_EFF = 3.5
SPEAKER_LOAD_OHMS = 8.0
RAIL_TAU_ATTACK = 0.008
RAIL_TAU_RELEASE = 0.015
RAIL_TAU_I_AVG = 0.030


def build_netlist() -> mna.Netlist:
    """spice/melange/wurli-power-amp.cir topology."""
    nl = mna.Netlist()
    q2n5087 = mna.BjtModel(
        is_=3.18e-14, bf=254.8, nf=1.003, vaf=115.0, ikf=0.01, ise=5.32e-15,
        ne=1.34, br=3.56, nr=1.005, var=26.0, ikr=0.01, isc=1.7e-13,
        nc=1.214, cje=3.33e-12, cjc=1.66e-12)
    mpsa06 = mna.BjtModel(
        is_=1.5e-14, bf=200.0, nf=1.0, vaf=100.0, ikf=0.2, ise=5e-13,
        ne=1.5, br=4.0, nr=1.0, var=20.0, ikr=0.1, cje=10e-12, cjc=6e-12)
    mpsa56 = mna.BjtModel(
        is_=1.5e-14, bf=200.0, nf=1.0, vaf=100.0, ikf=0.2, ise=5e-13,
        ne=1.5, br=4.0, nr=1.0, var=20.0, ikr=0.1, cje=10e-12, cjc=6e-12)
    tip35c = mna.BjtModel(
        is_=5e-12, bf=60.0, nf=1.0, vaf=80.0, ikf=5.0, ise=3e-10, ne=1.8,
        br=5.0, nr=1.0, var=20.0, ikr=1.0, cje=200e-12, cjc=150e-12)
    tip36c = mna.BjtModel(
        is_=5e-12, bf=40.0, nf=1.0, vaf=60.0, ikf=5.0, ise=3e-10, ne=1.8,
        br=4.0, nr=1.0, var=20.0, ikr=1.0, cje=200e-12, cjc=180e-12)

    # Input coupling + bias
    nl.c("in", "in_ac", 4.7e-6)
    nl.c("in_ac", "0", 1e-9)
    nl.c("in", "0", 1e-12)
    nl.r("in_ac", "0", 15e3)
    # Differential pair (PNP)
    nl.r("emit_pair", "vp", 10e3)
    nl.bjt("Q7", "coll7", "in_ac", "emit_pair", q2n5087, pnp=True)
    nl.bjt("Q8", "coll8", "fb_inv", "emit_pair", q2n5087, pnp=True)
    nl.r("coll7", "vn", 1e3)
    nl.r("coll8", "vn", 1e-3)
    # Feedback network
    nl.r("out", "fb_inv", 15e3)
    nl.r("fb_inv", "c10_node", 220.0)
    nl.c("c10_node", "0", 22e-6)
    # VAS + Miller compensation + bootstrapped load
    nl.bjt("Q14", "drv_bot", "coll7", "vn", mpsa06)
    nl.c("drv_bot", "coll7", 100e-12)
    nl.r("vp", "boot", 1.8e3)
    nl.r("boot", "vas_out", 1.8e3)
    nl.c("boot", "out", 100e-6)
    # Vbe multiplier
    nl.bjt("Q9", "vas_out", "bias_mid", "drv_bot", mpsa06)
    nl.r("vas_out", "bias_mid", 160.0)
    nl.r("bias_mid", "drv_bot", 220.0)
    # Top Sziklai (NPN driver + PNP output)
    nl.bjt("Q10", "base11", "vas_out", "nodeC", mpsa06)
    nl.bjt("Q11", "nodeC", "base11", "vp", tip36c, pnp=True)
    nl.r("base11", "vp", 270.0)
    # Bottom Sziklai (PNP driver + NPN output)
    nl.bjt("Q12", "base13", "drv_bot", "nodeD", mpsa56, pnp=True)
    nl.bjt("Q13", "nodeD", "base13", "vn", tip35c)
    nl.r("base13", "vn", 270.0)
    # Output emitter resistors + speaker load
    nl.r("nodeC", "out", 0.47)
    nl.r("nodeD", "out", 0.47)
    nl.r("out", "0", SPEAKER_LOAD_OHMS)
    # Supplies (runtime rail offsets) + input drive
    nl.v("V1", "vp", "0", RAIL_DC_BIAS)
    nl.v("V2", "0", "vn", RAIL_DC_BIAS)
    nl.set_input("in")
    return nl


class PowerAmpParams(NamedTuple):
    solver: mna.SolverParams
    out_idx: int
    v1_row: int
    v2_row: int
    input_row: int
    sample_rate: float
    alpha_attack: float
    alpha_release: float
    alpha_i_avg: float


@functools.lru_cache(maxsize=None)
def make_params(sample_rate) -> PowerAmpParams:
    nl = build_netlist()
    asm = nl.assemble()
    dt = 1.0 / sample_rate

    def e(tau):
        return float(1.0 - np.exp(-dt / tau))

    return PowerAmpParams(
        solver=mna.make_solver_params(nl, sample_rate, integrator="be"),
        out_idx=nl._nodes["out"],
        v1_row=asm["vsrc_rows"]["V1"],
        v2_row=asm["vsrc_rows"]["V2"],
        input_row=asm["input_row"],
        sample_rate=float(sample_rate),
        alpha_attack=e(RAIL_TAU_ATTACK),
        alpha_release=e(RAIL_TAU_RELEASE),
        alpha_i_avg=e(RAIL_TAU_I_AVG))



class RailState(NamedTuple):
    """Behavioral rail-sag state (0-d float64 tensors)."""

    v_rail_pos: torch.Tensor
    v_rail_neg: torch.Tensor
    i_avg_pos: torch.Tensor
    i_avg_neg: torch.Tensor


class PowerAmpState(NamedTuple):
    circuit: mna.SolverState
    rails: RailState
    last_good: torch.Tensor


def init_rails(device="cpu") -> RailState:
    b = torch.tensor(RAIL_DC_BIAS, dtype=torch.float64, device=device)
    z = torch.zeros((), dtype=torch.float64, device=device)
    return RailState(b, b, z, z)


def init_state(params: PowerAmpParams, device="cpu") -> PowerAmpState:
    return PowerAmpState(
        circuit=mna.init_state(params.solver, device),
        rails=init_rails(device),
        last_good=torch.zeros((), dtype=torch.float64, device=device))


def rails_step(params: PowerAmpParams, rails: RailState, v_out) -> RailState:
    """Current envelope (30 ms) → load-line target → asymmetric
    attack/release."""
    i_pos = exact.maximum(v_out / SPEAKER_LOAD_OHMS, 0.0)
    i_neg = exact.maximum(-v_out / SPEAKER_LOAD_OHMS, 0.0)
    i_avg_pos = rails.i_avg_pos + params.alpha_i_avg * (i_pos
                                                        - rails.i_avg_pos)
    i_avg_neg = rails.i_avg_neg + params.alpha_i_avg * (i_neg
                                                        - rails.i_avg_neg)
    target_pos = RAIL_V_OPEN - i_avg_pos * RAIL_R_EFF
    target_neg = RAIL_V_OPEN - i_avg_neg * RAIL_R_EFF
    att = torch.full_like(target_pos, params.alpha_attack)
    a_p = torch.where(target_pos < rails.v_rail_pos, att,
                      params.alpha_release)
    a_n = torch.where(target_neg < rails.v_rail_neg, att,
                      params.alpha_release)
    return RailState(
        v_rail_pos=rails.v_rail_pos + a_p * (target_pos - rails.v_rail_pos),
        v_rail_neg=rails.v_rail_neg + a_n * (target_neg - rails.v_rail_neg),
        i_avg_pos=i_avg_pos, i_avg_neg=i_avg_neg)


_STEP_FNS = {}


def circuit_step_fn(params: PowerAmpParams, device):
    """The circuit's mna step for these params on `device`, cached."""
    key = (id(params), str(torch.device(device)))
    hit = _STEP_FNS.get(key)
    if hit is None or hit[0] is not params:
        hit = (params, mna.make_step(build_netlist(), params.solver,
                                     nr_iters=NR_ITERS, device=device))
        _STEP_FNS[key] = hit
    return hit[1]


def step(params: PowerAmpParams, state: PowerAmpState, x, rail_sag=True):
    """One circuit sample; x a float64 tensor of input volts, batch shape
    (...) as the state's ((), one circuit, in the engine) → (state, out ∈
    [-1, 1]). rail_sag: a bool, or a bool tensor that broadcasts over the
    batch (one flag per circuit)."""
    sag = torch.as_tensor(rail_sag, dtype=torch.bool, device=x.device)
    sag_f = sag.to(torch.float64)
    w_extra = torch.zeros_like(state.circuit.v)
    w_extra[..., params.v1_row] = (state.rails.v_rail_pos
                                   - RAIL_DC_BIAS) * sag_f
    w_extra[..., params.v2_row] = (state.rails.v_rail_neg
                                   - RAIL_DC_BIAS) * sag_f
    w_extra[..., params.input_row] = x
    circuit, v = circuit_step_fn(params, x.device)(state.circuit, w_extra)
    raw = v[..., params.out_idx]
    result = exact.div(raw, HEADROOM)

    # Divergence guard, two tiers: insane (non-finite, |v| > 100 V) →
    # reset the solver to its DC point and hold the last good output;
    # Newton non-convergence → hold the output but keep the solver state.
    nr_failed = circuit.nr_resid > 1e-3
    insane = torch.any(~torch.isfinite(circuit.v)
                       | (torch.abs(circuit.v) > 100.0), dim=-1)
    reset = ~torch.isfinite(result) | insane
    bad = reset | nr_failed
    clean = mna.init_state(params.solver, x.device)
    r = reset[..., None]
    circuit = circuit._replace(
        v=torch.where(r, clean.v, circuit.v),
        i_nl=torch.where(r, clean.i_nl, circuit.i_nl),
        v_nl=torch.where(r, clean.v_nl, circuit.v_nl))
    clamped = exact.clip(result, -1.0, 1.0)
    out = torch.where(bad, state.last_good, clamped)
    stepped = rails_step(params, state.rails, raw)
    rails = RailState(*[torch.where(sag, torch.where(bad, ini, new), cur)
                        for new, ini, cur in zip(stepped, init_rails(x.device),
                                                 state.rails)])
    return PowerAmpState(circuit=circuit, rails=rails, last_good=out), out


# ── behavioral closed-loop model (the reference's legacy power amp) ──

OPEN_LOOP_GAIN = 19_000.0
FEEDBACK_BETA = 220.0 / (220.0 + 15_000.0)
CROSSOVER_VT = 0.013
QUIESCENT_GAIN = 0.1
BEHAVIORAL_NR_ITER = 8


def behavioral_process(x):
    """Memoryless closed-loop solve of y = f(A(x − βy)), f the crossover
    gain blend and a tanh rail clip: 8 fixed Newton iterations from the
    clipped linear estimate (float64 tensor in, output normalised to ±1).
    csrc/engine.cu `behavioral` repeats it op for op."""
    clg = OPEN_LOOP_GAIN / (1.0 + OPEN_LOOP_GAIN * FEEDBACK_BETA)
    y = exact.clip(x * clg, -HEADROOM + 1e-6, HEADROOM - 1e-6)
    vt_sq = CROSSOVER_VT * CROSSOVER_VT
    q = QUIESCENT_GAIN
    for _ in range(BEHAVIORAL_NR_ITER):
        v = OPEN_LOOP_GAIN * (x - FEEDBACK_BETA * y)
        exp_term = torch.exp(-v * v / torch.full_like(v, vt_sq))
        cross_gain = q + (1.0 - q) * (1.0 - exp_term)
        v_cross = v * cross_gain
        dcross_dv = cross_gain + v * (1.0 - q) * (
            2.0 * v / torch.full_like(v, vt_sq)) * exp_term
        tanh_val = torch.tanh(exact.div(v_cross, HEADROOM))
        f_val = HEADROOM * tanh_val
        f_deriv = (1.0 - tanh_val * tanh_val) * dcross_dv
        residual = y - f_val
        jacobian = 1.0 + OPEN_LOOP_GAIN * FEEDBACK_BETA * f_deriv
        y = y - residual / jacobian
    return exact.div(y, HEADROOM)
