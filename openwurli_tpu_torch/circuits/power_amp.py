"""Wurlitzer 200A Class AB power amplifier: netlist, rail-dynamics
constants and solver matrices (backward Euler).

Port of the pack-time half of `openwurli_tpu/circuits/power_amp.py`; the
per-sample Newton solve runs inside the mono-chain kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from openwurli_tpu_torch.circuits import mna

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
