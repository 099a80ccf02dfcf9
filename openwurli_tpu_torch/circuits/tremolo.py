"""Wurlitzer 200A tremolo: Twin-T oscillator → CdS vactrol → vibrato
divider shunt.

Port of `openwurli_tpu/circuits/tremolo.py`: the netlist, constants and
solver matrices (NumPy); the per-sample oscillator step, vactrol envelope
and divider (`osc_step`, `step`, `shunt_impedance`, torch float64, the
f64 engine's chain); and the settled limit-cycle state. The oscillator's
DC point is an unstable equilibrium, so `settled_osc_state` runs 2 s of
its step from a perturbed start; rates in `data/tremolo_settled.npz` are
read from there, any other rate is settled on the card by kernel E3
(`kernels/engine.py`), or by the plain loop when the caller asks for the
CPU.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch.ops import exact

from openwurli_tpu_torch import DATA_DIR
from openwurli_tpu_torch.circuits import mna

ATTACK_TAU = 0.0025
RELEASE_TAU = 0.035
GAMMA = 0.9
R_LDR_MIN = 9_000.0
R_LDR_MAX = 1_000_000.0

R18_SERIES = 680.0
R_VIB_BRIDGE = 18_000.0
R_VIB_POT = 50_000.0

V_OUT_MIN = 0.70
V_OUT_MAX = 10.95

SETTLE_SECONDS = 2.0
SETTLED_PATH = os.path.join(DATA_DIR, "tremolo_settled.npz")


def build_netlist() -> mna.Netlist:
    """Twin-T oscillator (spice/melange/wurli-tremolo.cir)."""
    nl = mna.Netlist()
    q2n2924 = mna.BjtModel(is_=1.4e-14, bf=200.0)
    nl.c("out", "node_hp", 0.12e-6)
    nl.c("node_hp", "base3", 0.12e-6)
    nl.r("node_hp", "0", 27e3)
    nl.r("out", "node_lp", 680e3)
    nl.r("node_lp", "base3", 680e3)
    nl.c("node_lp", "0", 0.12e-6)
    nl.bjt("Q3", "out", "base3", "emit3", q2n2924)
    nl.r("base3", "0", 680e3)
    nl.r("emit3", "0", 10e3)
    nl.bjt("Q4", "out", "emit3", "0", q2n2924)
    nl.r("vcc", "out", 4.7e3)
    nl.c("out", "0", 1e-12)
    nl.v("V1", "vcc", "0", 15.0)
    return nl


class TremoloParams(NamedTuple):
    solver: mna.SolverParams
    out_idx: int
    sample_rate: float
    ldr_attack: float
    ldr_release: float


@functools.lru_cache(maxsize=None)
def make_params(sample_rate) -> TremoloParams:
    nl = build_netlist()
    dt = 1.0 / sample_rate
    return TremoloParams(
        solver=mna.make_solver_params(nl, sample_rate, integrator="trap"),
        out_idx=nl._nodes["out"], sample_rate=float(sample_rate),
        ldr_attack=float(np.exp(-dt / ATTACK_TAU)),
        ldr_release=float(np.exp(-dt / RELEASE_TAU)))


class TremoloState(NamedTuple):
    osc: mna.SolverState
    ldr_envelope: torch.Tensor
    r_ldr: torch.Tensor


_LN_R_MAX = math.log(R_LDR_MAX)
_LN_MIN_MINUS_MAX = math.log(R_LDR_MIN) - math.log(R_LDR_MAX)
_STEP_FNS = {}


def osc_step_fn(params: TremoloParams, device):
    """The oscillator's mna step for these params on `device` (4 Newton
    iterations: the ~5.5 Hz oscillation converges in 1-2), cached."""
    key = (id(params), str(torch.device(device)))
    hit = _STEP_FNS.get(key)
    if hit is None or hit[0] is not params:
        hit = (params, mna.make_step(build_netlist(), params.solver,
                                     nr_iters=4, device=device))
        _STEP_FNS[key] = hit
    return hit[1]


def osc_step(params: TremoloParams, osc: mna.SolverState):
    """One oscillator sample → (osc, LED drive in [0, 1])."""
    step_fn = osc_step_fn(params, osc.v.device)
    osc, v = step_fn(osc, torch.zeros_like(osc.v))
    led = exact.clip(exact.div(V_OUT_MAX - v[..., params.out_idx],
                               V_OUT_MAX - V_OUT_MIN), 0.0, 1.0)
    return osc, led


def shunt_impedance(depth, r_ldr):
    """Vibrato divider: Z = (R_up ∥ 18k) + (R_low ∥ (680 + R_ldr))."""
    r_upper = R_VIB_POT * (1.0 - depth)
    r_lower = R_VIB_POT * depth
    top = torch.where(r_upper > 0.0,
                      r_upper * R_VIB_BRIDGE / (r_upper + R_VIB_BRIDGE), 0.0)
    branch = R18_SERIES + r_ldr
    low = torch.where(r_lower > 0.0,
                      r_lower * branch / (r_lower + branch), 0.0)
    return top + low


def step(params: TremoloParams, state: TremoloState, depth):
    """One sample: oscillator → vactrol envelope → CdS R → shunt Ω."""
    osc, led = osc_step(params, state.osc)
    coeff = torch.where(led > state.ldr_envelope,
                        torch.full_like(led, params.ldr_attack),
                        params.ldr_release)
    env = led + coeff * (state.ldr_envelope - led)
    drive = exact.clip(env, 0.0, 1.0)
    log_r = _LN_R_MAX + _LN_MIN_MINUS_MAX * torch.pow(
        exact.maximum(drive, 1e-30), GAMMA)
    r_ldr = torch.where(drive < 1e-6, R_LDR_MAX, torch.exp(log_r))
    return (TremoloState(osc=osc, ldr_envelope=env, r_ldr=r_ldr),
            shunt_impedance(depth, r_ldr))


def settle_steps(sample_rate) -> int:
    return int(sample_rate * SETTLE_SECONDS)


def perturbed_start(params: TremoloParams, device="cpu") -> mna.SolverState:
    """The DC operating point with 1 mV on the output node: where the
    settle scan starts."""
    osc = mna.init_state(params.solver, device)
    v = osc.v.clone()
    v[params.out_idx] += 1e-3
    return osc._replace(v=v)


@functools.lru_cache(maxsize=None)
def _settled(sample_rate, device_type):
    key = f"sr{int(round(sample_rate))}"
    with np.load(SETTLED_PATH) as z:
        if f"{key}_v" in z:
            return mna.SolverState(
                v=np.asarray(z[f"{key}_v"], np.float64),
                i_nl=np.asarray(z[f"{key}_i"], np.float64),
                v_nl=np.asarray(z[f"{key}_vnl"], np.float64),
                nr_resid=0.0)
    from openwurli_tpu_torch.kernels import engine as ek

    params = make_params(sample_rate)
    st = ek.tremolo_settle(sample_rate, perturbed_start(params, device_type),
                           settle_steps(sample_rate))
    return mna.SolverState(v=st.v.cpu().numpy(), i_nl=st.i_nl.cpu().numpy(),
                           v_nl=st.v_nl.cpu().numpy(),
                           nr_resid=float(st.nr_resid))


def settled_osc_state(sample_rate, device="cuda") -> mna.SolverState:
    """The oscillator's steady-amplitude state (NumPy float64 fields).

    Read from `data/tremolo_settled.npz` where it holds the rate (44.1,
    48, 88.2, 96 kHz); otherwise computed by `SETTLE_SECONDS` of the
    oscillator step from `perturbed_start`: on the card through kernel
    E3, on the CPU through the plain loop when `device` is the CPU.
    Cached per rate and per device kind; nothing falls back from the card
    to the CPU."""
    return _settled(float(sample_rate), torch.device(device).type)


def init_state(sample_rate, batch_shape=(), device="cpu") -> TremoloState:
    """Settled oscillator (fresh counters) and a dark LDR, broadcast over
    the batch dims `batch_shape` (copies), on `device`."""
    osc = settled_osc_state(sample_rate, device)
    batch = tuple(batch_shape)

    def t(x):
        x = np.asarray(x, np.float64)
        return torch.as_tensor(np.broadcast_to(x, batch + x.shape).copy(),
                               device=device)

    diag = mna.SolverDiag(*[torch.zeros(batch, dtype=torch.int32,
                                        device=device)
                            for _ in mna.SolverDiag._fields])
    return TremoloState(
        osc=mna.SolverState(v=t(osc.v), i_nl=t(osc.i_nl), v_nl=t(osc.v_nl),
                            nr_resid=t(osc.nr_resid), diag=diag),
        ldr_envelope=t(0.0), r_ldr=t(R_LDR_MAX))
