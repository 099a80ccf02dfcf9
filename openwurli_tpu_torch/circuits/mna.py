"""Generic MNA circuit solver: netlist → per-sample DK step.

Port of `openwurli_tpu/circuits/mna.py`. At pack time: netlist → fixed MNA
matrices (float64 NumPy), the source-stepped Newton DC solve (float64
torch on the CPU, closed-form Gummel-Poon Jacobian), the solver matrices
for a sample rate and integrator with their backward-Euler variant, and
SPICE junction limits. Per sample (`make_step`, float64 torch): the
trapezoidal or backward-Euler companion step with masked Newton on the
M-dimensional kernel, an f32 unpivoted elimination per iteration
(`ge_solve_f32`), and the robustness ladder with its `SolverDiag`
counters. The f64 engine kernels (`csrc/engine.cu`) repeat the step op
for op.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch.circuits import gp
from openwurli_tpu_torch.ops import exact

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

    def device_current_fn(self, device="cpu"):
        """f(v_nl (..., M) float64) → i_nl (..., M): [ib, ic] per BJT, then
        one current per diode (gp.device_current_fn)."""
        return gp.device_current_fn(self, device)

    def device_jacobian_fn(self, device="cpu"):
        """f(v_nl (M,)) → dI/dV_nl (M, M), block-diagonal: 2×2 per BJT,
        1×1 per diode (gp.analytic_device_jacobian_fn)."""
        return gp.analytic_device_jacobian_fn(self, device)


def bjt_currents(model: BjtModel, vbe, vbc):
    """DC Gummel-Poon (ib, ic) of one BJT model at port voltages (vbe,
    vbc), NPN convention (float64 tensors)."""
    p = torch.from_numpy(gp.pack_current_params([model])[0]).to(vbe.device)
    return gp.bjt_currents(dict(zip(gp.CURRENT_NAMES, p)), vbe, vbc)


def diode_current(model: DiodeModel, vd):
    """Junction diode current at vd (float64 tensor)."""
    return model.is_ * (gp.limexp(exact.div(vd, model.n * model.vt)) - 1.0)


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
    # Backward-Euler variant (== primary when integrator="be"): the
    # dissipative integrator failed samples are replayed with, and held
    # for FALLBACK_COOLDOWN samples.
    s_be: np.ndarray
    a_hist_be: np.ndarray
    s_ni_be: np.ndarray
    k_be: np.ndarray
    w_scale_be: np.ndarray


class SolverDiag(NamedTuple):
    """Robustness counters (int32 0-d tensors)."""

    cooldown: object   # BE-fallback samples remaining
    nr_fail: object    # Newton non-convergence / ringing / non-finite
    nan_reset: object  # NaN → DC-OP resets
    damp: object       # voltage-damping net hits
    be_steps: object   # samples integrated with BE


class SolverState(NamedTuple):
    v: object        # (n,)
    i_nl: object     # (M,)
    v_nl: object     # (M,) Newton warm start
    nr_resid: object = 0.0  # last solve's final Newton residual [V]
    diag: object = None


# Work done by the plain steps' Newton loops, by port count M: "solves"
# (Newton calls) and "iterations" (f32 eliminations). chip_smoke.py reads
# it to count the operations a replayed chunk needed.
NEWTON_COUNTS = collections.Counter()

FALLBACK_COOLDOWN = 64   # samples of BE after a failure
RINGING_VOLTS = 55.0     # node swing that counts as a failure
DAMP_VOLTS = 30.0        # per-sample node-delta damping net
FAIL_RESID = 1e-3        # Newton residual that counts as a failure [V]


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


def make_solver_params(netlist: Netlist, sample_rate, integrator="trap",
                       dc=None) -> SolverParams:
    """Assemble the fixed matrices for one rate + integrator. `dc`, the
    operating point (v_dc, i_dc, v_nl_dc), defaults to this netlist's own
    `dc_solve`."""
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
    v_dc, i_dc, v_nl_dc = dc_solve(netlist) if dc is None else dc
    s_be = np.linalg.inv(g + (1.0 / t) * c_mat)
    return SolverParams(s=s, a_hist=a_hist, n_v=n_v, n_i=n_i, s_ni=s @ n_i,
                        k=n_v @ s @ n_i, w=w, w_scale=w_scale, v_dc=v_dc,
                        i_dc=i_dc, v_nl_dc=v_nl_dc, trap_i_hist=trap_i,
                        s_be=s_be, a_hist_be=(1.0 / t) * c_mat,
                        s_ni_be=s_be @ n_i, k_be=n_v @ s_be @ n_i,
                        w_scale_be=np.ones(a.shape[0]))


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


# ───────────────────────── per-sample step (torch) ─────────────────────────


def init_diag(device="cpu") -> SolverDiag:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return SolverDiag(z, z, z, z, z)


def init_state(params: SolverParams, device="cpu") -> SolverState:
    """The DC operating point, as float64 tensors on `device`."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    return SolverState(v=t(params.v_dc), i_nl=t(params.i_dc),
                       v_nl=t(params.v_nl_dc), nr_resid=t(0.0),
                       diag=init_diag(device))


def pnjlim(v_old, v_new, nvt, vcrit):
    """SPICE junction limiting: a forward step past vcrit by more than
    2·nvt is log-compressed to v_old + nvt·ln(1 + δ/nvt)."""
    delta = v_new - v_old
    lim = v_old + nvt * torch.log1p(exact.maximum(delta, 0.0) / nvt)
    apply = (v_new > vcrit) & (delta > 2.0 * nvt)
    return torch.where(apply, lim, v_new)


def ge_solve_numpy(a, b):
    """Unpivoted Gaussian elimination in float32 (NumPy): a (..., m, m), b
    (..., m) float32 → x (..., m) float32, each system on its own.

    Pivot guard |p| > 1e-30 (else 1e-30, also for a NaN pivot), the pivot
    row scaled by the f32 reciprocal, every update c − a·b rounded once
    from float64 (the product of two floats is exact there), as XLA's
    contracted multiply-adds round it; back substitution row by row, each
    row's terms in increasing column order. Only IEEE basic operations,
    elementwise over the batch: any IEEE device rounds them alike, and
    `csrc/engine.cu` writes them the same way. Columns left of the running
    pivot are never read again, so they are not updated (the reference
    updates them, to no effect on x)."""
    m = a.shape[-1]
    aug = np.concatenate([a, b[..., None]], axis=-1).astype(np.float32)
    tiny = np.float32(1e-30)
    with np.errstate(all="ignore"):
        for k in range(m):
            piv = aug[..., k, k]
            inv = np.float32(1.0) / np.where(np.abs(piv) > tiny, piv, tiny)
            row = aug[..., k, k + 1:] * inv[..., None]
            aug[..., k, k + 1:] = row
            if k + 1 < m:
                aug[..., k + 1:, k + 1:] = (
                    aug[..., k + 1:, k + 1:].astype(np.float64)
                    - aug[..., k + 1:, k:k + 1].astype(np.float64)
                    * row[..., None, :].astype(np.float64)).astype(
                        np.float32)
        x = np.zeros(aug.shape[:-1], dtype=np.float32)
        for i in range(m - 1, -1, -1):
            acc = aug[..., i, m]
            for j in range(i + 1, m):
                acc = (acc.astype(np.float64) - aug[..., i, j].astype(
                    np.float64) * x[..., j].astype(np.float64)).astype(
                        np.float32)
            x[..., i] = acc
    return x


def ge_solve_f32(a, b):
    """The reference's f32 elimination for a float64 Newton step: a (..., m,
    m), b (..., m) float64 tensors → x (..., m) float64 on their device.
    Computed on the host by `ge_solve_numpy` (basic IEEE operations
    only)."""
    x = ge_solve_numpy(a.detach().cpu().numpy().astype(np.float32),
                       b.detach().cpu().numpy().astype(np.float32))
    return torch.from_numpy(x.astype(np.float64)).to(a.device)


def solver_tensors(params: SolverParams, device="cpu") -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float64), device=device)
            for k, v in params._asdict().items()}


def make_step(netlist: Netlist, params: SolverParams, nr_iters,
              nr_tol=1e-9, device="cpu"):
    """The per-sample step of this netlist on `device`:
    step(state, w_extra (..., n)) → (state, v (..., n)), the state's
    tensors of batch shape (...) ((), one circuit, in the engine).

    Newton runs up to `nr_iters` masked iterations; each circuit of the
    batch leaves the loop once its residual has converged (the remaining
    masked iterations would change nothing), as a kernel thread does. The robustness ladder: trapezoidal primary → failure
    (residual > 1e-3, ringing > 55 V, non-finite) → backward-Euler replay
    of the sample and a 64-sample BE hold → the 30 V damping net → NaN
    reset to the DC operating point, each counted in SolverDiag."""
    c = solver_tensors(params, device)
    dev_fn = gp.device_current_fn(netlist, device)
    derivs = gp.device_derivs_fn(netlist, device)
    r0 = torch.from_numpy(gp.block_rows(netlist)).to(device)
    m = int(params.k.shape[0])
    bjt_cols = torch.arange(m, device=device) < 2 * len(netlist.bjts)
    eye = torch.eye(m, dtype=torch.float64, device=device)
    nvt_np, vcrit_np = junction_limits(netlist)
    nvt = torch.from_numpy(nvt_np).to(device)
    vcrit = torch.from_numpy(vcrit_np).to(device)
    n_nodes = netlist.n_nodes
    trap_primary = float(params.trap_i_hist) != 0.0

    def kj_cols(k_eff):
        """K's two block-row columns per Jacobian column (zero second
        column for a diode)."""
        k1 = torch.where(bjt_cols, k_eff[:, (r0 + 1).clamp(max=m - 1)], 0.0)
        return k_eff[:, r0], k1

    mats = {False: (c["a_hist"], c["s"], c["s_ni"], c["k"], c["w_scale"],
                    c["trap_i_hist"]),
            True: (c["a_hist_be"], c["s_be"], c["s_ni_be"], c["k_be"],
                   c["w_scale_be"], 0.0)}
    cols = {be: kj_cols(mats[be][3]) for be in (False, True)}

    def nr_solve(p, v_nl, k_eff, k0, k1, live):
        """→ (v_nl, its currents, the final residual); a circuit keeps
        the values of the iteration where it converged. `live` (batch
        bool) marks the circuits that run this solve (the others are
        computed and discarded by the caller, and not counted)."""
        NEWTON_COUNTS[m, "solves"] += int(live.sum())
        done = ~live
        i_out = resid = None
        for _ in range(nr_iters):
            i_nl = dev_fn(v_nl)
            f = v_nl - p - exact.matvec(k_eff, i_nl)
            r = exact.max_abs(f)
            conv = (r < nr_tol) & ~done
            i_out = i_nl if i_out is None else torch.where(
                conv[..., None], i_nl, i_out)
            resid = r if resid is None else torch.where(conv, r, resid)
            done = done | conv
            if bool(torch.all(done)):
                return v_nl, i_out, resid
            NEWTON_COUNTS[m, "iterations"] += int((~done).sum())
            top, bot = derivs(v_nl)
            jac = eye - (k0 * top[..., None, :] + k1 * bot[..., None, :])
            dv = exact.clip(ge_solve_f32(jac, f), -2.0, 2.0)
            v_nl = torch.where(done[..., None], v_nl,
                               pnjlim(v_nl, v_nl - dv, nvt, vcrit))
        i_nl = dev_fn(v_nl)
        f = v_nl - p - exact.matvec(k_eff, i_nl)
        return (v_nl, torch.where(done[..., None], i_out, i_nl),
                torch.where(done, resid, exact.max_abs(f)))

    def solve_once(state, w_extra, be, live):
        a_hist, s_mat, s_ni, k_eff, w_sc, trap_i = mats[be]
        rhs = exact.matvec(a_hist, state.v) + w_sc * c["w"] + w_extra
        rhs = rhs + trap_i * exact.matvec(c["n_i"], state.i_nl)
        v_lin = exact.matvec(s_mat, rhs)
        p = exact.matvec(c["n_v"], v_lin)
        v_nl, i_new, resid = nr_solve(p, state.v_nl, k_eff, *cols[be], live)
        return v_lin + exact.matvec(s_ni, i_new), i_new, v_nl, resid

    def failed(v, resid):
        ring = exact.max_abs(v[..., :n_nodes]) > RINGING_VOLTS
        nonfin = ~torch.all(torch.isfinite(v), dim=-1)
        return (resid > FAIL_RESID) | ring | nonfin

    def step(state: SolverState, w_extra):
        dg = state.diag
        every = torch.ones(state.v.shape[:-1], dtype=torch.bool,
                           device=state.v.device)
        v, i_new, v_nl, resid = solve_once(state, w_extra, False, every)
        need_be = (failed(v, resid) | (dg.cooldown > 0)) if trap_primary \
            else ~every
        if bool(torch.any(need_be)):
            be = solve_once(state, w_extra, True, need_be)
            v, i_new, v_nl = [torch.where(need_be[..., None], x, y) for x, y
                              in zip(be[:3], (v, i_new, v_nl))]
            resid = torch.where(need_be, be[3], resid)
        fail = failed(v, resid)

        dv = v - state.v
        dv_max = exact.max_abs(dv)
        damp_hit = torch.isfinite(dv_max) & (dv_max > DAMP_VOLTS)
        # (a Python number over a tensor would multiply by its reciprocal)
        scale = torch.where(damp_hit, torch.full_like(dv_max, DAMP_VOLTS)
                            / exact.maximum(dv_max, 1e-30), 1.0)
        v = state.v + dv * scale[..., None]

        bad = ~torch.all(torch.isfinite(v), dim=-1)
        v = torch.where(bad[..., None], c["v_dc"], v)
        i_new = torch.where(bad[..., None], c["i_dc"], i_new)
        v_nl = torch.where(bad[..., None], c["v_nl_dc"], v_nl)
        one = torch.ones((), dtype=torch.int32, device=v.device)
        diag = SolverDiag(
            cooldown=torch.where(fail, FALLBACK_COOLDOWN * one,
                                 torch.clamp(dg.cooldown - 1, min=0)),
            nr_fail=dg.nr_fail + fail.to(torch.int32),
            nan_reset=dg.nan_reset + bad.to(torch.int32),
            damp=dg.damp + damp_hit.to(torch.int32),
            be_steps=dg.be_steps + need_be.to(torch.int32))
        return SolverState(v=v, i_nl=i_new, v_nl=v_nl, nr_resid=resid,
                           diag=diag), v

    return step
