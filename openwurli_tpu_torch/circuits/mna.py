"""Generic MNA circuit assembly and DC operating point (pack time).

Port of the pack-time half of `openwurli_tpu/circuits/mna.py`: netlist →
fixed MNA matrices (float64 NumPy), the source-stepped Newton DC solve
(float64 torch on the CPU, closed-form Gummel-Poon Jacobian), the solver
matrices for a sample rate and integrator, and SPICE junction limits.
The per-sample f64 step (`make_step`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch.circuits import gp

VT_300K = 0.02585126075417566  # kT/q at 300.15 K


@dataclasses.dataclass
class BjtModel:
    """Gummel-Poon parameters (SPICE .model card subset)."""

    is_: float = 1e-14
    bf: float = 100.0
    nf: float = 1.0
    vaf: float = float("inf")
    ikf: float = float("inf")
    ise: float = 0.0
    ne: float = 1.5
    br: float = 1.0
    nr: float = 1.0
    var: float = float("inf")
    ikr: float = float("inf")
    isc: float = 0.0
    nc: float = 2.0
    cje: float = 0.0
    cjc: float = 0.0
    vt: float = VT_300K


@dataclasses.dataclass
class DiodeModel:
    is_: float = 1e-14
    n: float = 1.0
    cj0: float = 0.0
    vt: float = VT_300K


class Netlist:
    """Circuit builder. Node names are strings; '0' is ground."""

    def __init__(self):
        self.resistors = []   # (n1, n2, ohms)
        self.capacitors = []  # (n1, n2, farads)
        self.vsources = []    # (name, n_plus, n_minus, volts)
        self.bjts = []        # (name, nc, nb, ne, BjtModel, sign)
        self.diodes = []      # (name, n_plus, n_minus, DiodeModel)
        self.input_node = None
        self._nodes = {}

    def _node(self, name):
        if name in ("0", 0, "gnd", "GND"):
            return -1
        if name not in self._nodes:
            self._nodes[name] = len(self._nodes)
        return self._nodes[name]

    def r(self, n1, n2, ohms):
        self.resistors.append((self._node(n1), self._node(n2), float(ohms)))

    def c(self, n1, n2, farads):
        self.capacitors.append((self._node(n1), self._node(n2),
                                float(farads)))

    def v(self, name, np_, nm, volts):
        self.vsources.append((name, self._node(np_), self._node(nm),
                              float(volts)))

    def bjt(self, name, nc, nb, ne, model: BjtModel, pnp=False):
        self.bjts.append((name, self._node(nc), self._node(nb),
                          self._node(ne), model, -1.0 if pnp else 1.0))
        # Constant-value junction caps (zero-bias CJE/CJC) as linear caps.
        if model.cje:
            self.capacitors.append((self._node(nb), self._node(ne),
                                    model.cje))
        if model.cjc:
            self.capacitors.append((self._node(nb), self._node(nc),
                                    model.cjc))

    def diode(self, name, np_, nm, model: DiodeModel):
        self.diodes.append((name, self._node(np_), self._node(nm), model))
        if model.cj0:
            self.capacitors.append((self._node(np_), self._node(nm),
                                    model.cj0))

    def set_input(self, node):
        self.input_node = self._node(node)

    @property
    def n_nodes(self):
        return len(self._nodes)

    def dims(self):
        n_vs = len(self.vsources) + (1 if self.input_node is not None else 0)
        return self.n_nodes + n_vs, 2 * len(self.bjts) + len(self.diodes)

    def assemble(self):
        """G, C, w, N_v, N_i and the source-row map (float64 NumPy)."""
        n, m = self.dims()
        nn = self.n_nodes
        g = np.zeros((n, n))
        c_mat = np.zeros((n, n))
        w = np.zeros(n)

        def stamp2(mat, i, j, val):
            if i >= 0:
                mat[i, i] += val
            if j >= 0:
                mat[j, j] += val
            if i >= 0 and j >= 0:
                mat[i, j] -= val
                mat[j, i] -= val

        for n1, n2, ohms in self.resistors:
            stamp2(g, n1, n2, 1.0 / ohms)
        for n1, n2, farads in self.capacitors:
            stamp2(c_mat, n1, n2, farads)

        vsrc_rows = {}
        row = nn
        for name, np_, nm_, volts in self.vsources:
            if np_ >= 0:
                g[np_, row] += 1.0
                g[row, np_] += 1.0
            if nm_ >= 0:
                g[nm_, row] -= 1.0
                g[row, nm_] -= 1.0
            w[row] = volts
            vsrc_rows[name] = row
            row += 1
        input_row = None
        if self.input_node is not None:
            g[self.input_node, row] += 1.0
            g[row, self.input_node] += 1.0
            input_row = row
            row += 1

        n_v = np.zeros((m, n))
        n_i = np.zeros((n, m))
        port = 0
        for _, nc_, nb_, ne_, _model, sign in self.bjts:
            for node, val in ((nb_, sign), (ne_, -sign)):
                if node >= 0:
                    n_v[port, node] += val
            for node, val in ((nb_, sign), (nc_, -sign)):
                if node >= 0:
                    n_v[port + 1, node] += val
            for node, val in ((nb_, -sign), (ne_, sign)):
                if node >= 0:
                    n_i[node, port] += val
            for node, val in ((nc_, -sign), (ne_, sign)):
                if node >= 0:
                    n_i[node, port + 1] += val
            port += 2
        for _, np_, nm_, _model in self.diodes:
            for node, val in ((np_, 1.0), (nm_, -1.0)):
                if node >= 0:
                    n_v[port, node] += val
            for node, val in ((np_, -1.0), (nm_, 1.0)):
                if node >= 0:
                    n_i[node, port] += val
            port += 1
        return dict(g=g, c=c_mat, w=w, n_v=n_v, n_i=n_i,
                    vsrc_rows=vsrc_rows, input_row=input_row, n=n, m=m)

    def device_fn(self):
        """f(v_nl (M,) f64 tensor) → (i_nl (M,), dI/dV_nl (M, M))."""
        bjt_p = gp.param_columns(torch.from_numpy(gp.pack_bjt_params(
            [b[4] for b in self.bjts], np.float64)), len(self.bjts))
        diodes = [d[3] for d in self.diodes]
        n_bjt = len(self.bjts)
        m = 2 * n_bjt + len(diodes)

        def fn(v_nl):
            i_nl = torch.zeros(m, dtype=torch.float64)
            jac = torch.zeros((m, m), dtype=torch.float64)
            if n_bjt:
                ib, ic, gbb, gbc, gcb, gcc = gp.bjt_currents_derivs_packed(
                    bjt_p, v_nl[0:2 * n_bjt:2, None], v_nl[1:2 * n_bjt:2,
                                                           None])
                b = torch.arange(n_bjt)
                i_nl[2 * b], i_nl[2 * b + 1] = ib[:, 0], ic[:, 0]
                jac[2 * b, 2 * b], jac[2 * b, 2 * b + 1] = gbb[:, 0], gbc[:, 0]
                jac[2 * b + 1, 2 * b] = gcb[:, 0]
                jac[2 * b + 1, 2 * b + 1] = gcc[:, 0]
            for k, model in enumerate(diodes):
                idx = 2 * n_bjt + k
                nvt = model.n * model.vt
                val, dval = gp._limexp_d(v_nl[idx] / nvt)
                i_nl[idx] = model.is_ * (val - 1.0)
                jac[idx, idx] = model.is_ * dval / nvt
            return i_nl, jac

        return fn


class SolverParams(NamedTuple):
    """Fixed per-sample-rate solver matrices (float64 NumPy)."""

    s: np.ndarray        # (n, n) inv(A); A = G + α C
    a_hist: np.ndarray   # (n, n) history matrix
    n_v: np.ndarray      # (M, n)
    n_i: np.ndarray      # (n, M)
    s_ni: np.ndarray     # (n, M) = S N_i
    k: np.ndarray        # (M, M) = N_v S N_i
    w: np.ndarray        # (n,) DC source vector
    w_scale: np.ndarray  # (n,) 2.0 trapezoidal node rows, else 1.0
    v_dc: np.ndarray     # (n,) DC operating point
    i_dc: np.ndarray     # (M,)
    v_nl_dc: np.ndarray  # (M,)
    trap_i_hist: float   # 1.0 trapezoidal (rhs += N_i i_prev), 0.0 BE


class SolverState(NamedTuple):
    v: np.ndarray
    i_nl: np.ndarray
    v_nl: np.ndarray


def dc_solve(netlist: Netlist, n_iter=300, clamp=0.1, source_steps=8):
    """Nonlinear DC operating point by source-stepped Newton.

    Supplies ramp to full value over `source_steps` stages, each stage
    warm-started and run for `n_iter` trust-region Newton steps (no port
    moves more than `clamp` volts per step). Returns (v_dc, i_dc, v_nl)."""
    asm = netlist.assemble()
    g, w, n_v, n_i = asm["g"], asm["w"], asm["n_v"], asm["n_i"]
    n, m = asm["n"], asm["m"]
    dev = netlist.device_fn()
    s_dc = np.linalg.inv(g + np.eye(n) * 1e-12)
    k_dc = torch.from_numpy(n_v @ s_dc @ n_i)
    p_full = torch.from_numpy(n_v @ (s_dc @ w))
    eye_m = torch.eye(m, dtype=torch.float64)

    v_nl = torch.zeros(m, dtype=torch.float64)
    for k in range(source_steps):
        p = p_full * ((k + 1) / source_steps)
        for _ in range(n_iter):
            i_nl, jdev = dev(v_nl)
            f = v_nl - p - k_dc @ i_nl
            dv = torch.linalg.solve(eye_m - k_dc @ jdev, f)
            scale = min(1.0, clamp / max(float(dv.abs().max()), 1e-30))
            v_nl = v_nl - dv * scale
    i_nl = dev(v_nl)[0]
    resid = float((v_nl - p_full - k_dc @ i_nl).abs().max())
    if not resid <= 1e-9:
        raise RuntimeError(f"DC solve did not converge: residual {resid}")
    i_nl, v_nl = i_nl.numpy(), v_nl.numpy()
    return s_dc @ (w + n_i @ i_nl), i_nl, v_nl


def make_solver_params(netlist: Netlist, sample_rate,
                       integrator="trap") -> SolverParams:
    """Assemble the fixed matrices for one rate + integrator."""
    asm = netlist.assemble()
    g, c_mat, w = asm["g"], asm["c"], asm["w"]
    n_v, n_i = asm["n_v"], asm["n_i"]
    t = 1.0 / float(sample_rate)
    n_nodes = netlist.n_nodes
    if integrator == "trap":
        a = g + (2.0 / t) * c_mat
        a_hist = (2.0 / t) * c_mat - g
        # Voltage-source rows are algebraic: no history, w scale 1.
        a_hist[n_nodes:, :] = 0.0
        w_scale = np.full(a.shape[0], 2.0)
        w_scale[n_nodes:] = 1.0
        trap_i = 1.0
    elif integrator == "be":
        a = g + (1.0 / t) * c_mat
        a_hist = (1.0 / t) * c_mat
        w_scale = np.ones(a.shape[0])
        trap_i = 0.0
    else:
        raise ValueError(integrator)
    s = np.linalg.inv(a)
    v_dc, i_dc, v_nl_dc = dc_solve(netlist)
    return SolverParams(s=s, a_hist=a_hist, n_v=n_v, n_i=n_i, s_ni=s @ n_i,
                        k=n_v @ s @ n_i, w=w, w_scale=w_scale, v_dc=v_dc,
                        i_dc=i_dc, v_nl_dc=v_nl_dc, trap_i_hist=trap_i)


def junction_limits(netlist: Netlist):
    """Per-port (nvt, vcrit) for SPICE junction limiting (NumPy (M,))."""
    nvt, vcrit = [], []
    for _, _, _, _, model, _sign in netlist.bjts:
        for n_em in (model.nf, model.nr):
            v = n_em * model.vt
            nvt.append(v)
            vcrit.append(v * np.log(v / (np.sqrt(2.0) * model.is_)))
    for _, _, _, model in netlist.diodes:
        v = model.n * model.vt
        nvt.append(v)
        vcrit.append(v * np.log(v / (np.sqrt(2.0) * model.is_)))
    return np.asarray(nvt), np.asarray(vcrit)
