"""Wurlitzer 200A tremolo: Twin-T oscillator netlist, CdS vactrol and
vibrato-divider constants, solver matrices, and the settled limit-cycle
state.

Port of the pack-time half of `openwurli_tpu/circuits/tremolo.py`; the
subsampled tremolo update runs inside the mono-chain kernel.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np

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


def settled_osc_state(sample_rate) -> mna.SolverState:
    """The oscillator's steady-amplitude limit-cycle state, read from the
    reference's `data/tremolo_settled.npz` (44.1/48/88.2/96 kHz)."""
    key = f"sr{int(round(sample_rate))}"
    with np.load(SETTLED_PATH) as z:
        if f"{key}_v" not in z:
            raise NotImplementedError(
                f"no settled tremolo state for {sample_rate} Hz in "
                f"{SETTLED_PATH}; the {SETTLE_SECONDS:g} s settle scan that "
                "would compute it is f64 step-function work (slice 4)")
        return mna.SolverState(
            v=np.asarray(z[f"{key}_v"], np.float64),
            i_nl=np.asarray(z[f"{key}_i"], np.float64),
            v_nl=np.asarray(z[f"{key}_vnl"], np.float64))
