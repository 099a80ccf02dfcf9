"""Closed-form Gummel-Poon currents and derivatives on torch tensors.

Port of `openwurli_tpu/circuits/gp.py`: `pack_bjt_params` (NumPy) and the
packed evaluation used by the mono chain's step functions, where the BJTs
of one circuit evaluate as (n_bjt, S) tensor ops with per-BJT constants in
(n_bjt, 1) columns. The arithmetic is dtype-generic: float32 in the chain,
float64 in the DC operating-point solve and the f64 engine.

For the f64 engine's Newton steps (`mna.make_step`), as in the reference:
the currents come from `mna.bjt_currents`' arithmetic (divisions by n·vt,
`device_current_fn`), the Jacobian from the closed-form derivatives
(`device_derivs_fn`, `analytic_device_jacobian_fn`). Both are per-device
block functions: a BJT's currents depend only on its own two ports.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openwurli_tpu_torch.ops import exact

_XC = 40.0
_EXC = float(np.exp(_XC))

PARAM_NAMES = (
    "is_", "inv_nfvt", "inv_nrvt", "inv_vaf", "inv_var", "inv_ikf",
    "inv_ikr", "ise", "inv_nevt", "isc", "inv_ncvt", "inv_bf", "inv_br",
)
N_PARAMS = len(PARAM_NAMES)


def _inv_or_zero(x):
    return 0.0 if np.isinf(x) else 1.0 / x


def pack_bjt_params(models, dtype=np.float32):
    """models: sequence of mna.BjtModel → (n_bjt, N_PARAMS) array."""
    return np.asarray([[
        m.is_, 1.0 / (m.nf * m.vt), 1.0 / (m.nr * m.vt),
        _inv_or_zero(m.vaf), _inv_or_zero(m.var), _inv_or_zero(m.ikf),
        _inv_or_zero(m.ikr), m.ise, 1.0 / (m.ne * m.vt), m.isc,
        1.0 / (m.nc * m.vt), 1.0 / m.bf, 1.0 / m.br,
    ] for m in models], dtype=dtype)


def param_columns(packed, n):
    """(n_bjt, N_PARAMS) tensor → {name: (n, 1) column}."""
    return {name: packed[:n, i:i + 1] for i, name in enumerate(PARAM_NAMES)}


@functools.lru_cache(maxsize=None)
def const(value, dtype):
    """A 0-d CPU tensor: arithmetic with it rounds exactly like the
    Python scalar would, but dispatches faster (hot per-sample loops)."""
    return torch.tensor(value, dtype=dtype)


def _limexp_d(x):
    """limexp (linear past x = 40) and its derivative."""
    xc, exc = const(_XC, x.dtype), const(_EXC, x.dtype)
    e = torch.exp(torch.minimum(x, xc))
    lin = x < xc
    return (torch.where(lin, e, exc * (const(1.0, x.dtype) + (x - xc))),
            torch.where(lin, e, exc))


def _limexp4(p, vbe, vbc):
    """limexp and derivative of the four junction exponents, evaluated as
    one stacked tensor: [vbe/(nf·vt), vbc/(nr·vt), vbe/(ne·vt),
    vbc/(nc·vt)] (elementwise the same arithmetic as four calls)."""
    n = vbe.shape[0]
    x = torch.cat([vbe * p["inv_nfvt"], vbc * p["inv_nrvt"],
                   vbe * p["inv_nevt"], vbc * p["inv_ncvt"]], dim=0)
    val, dval = _limexp_d(x)
    return val.split(n), dval.split(n)


def bjt_currents_derivs_packed(p, vbe, vbc):
    """→ (ib, ic, dib/dvbe, dib/dvbc, dic/dvbe, dic/dvbc), NPN convention."""
    dt = vbe.dtype
    zero, one, half = const(0.0, dt), const(1.0, dt), const(0.5, dt)
    q1_min = const(1e-4, dt)
    is_ = p["is_"]
    (ef, er, el, ec), (def_, der, dle, dlc) = _limexp4(p, vbe, vbc)
    i_f = is_ * (ef - one)
    i_r = is_ * (er - one)
    dif = is_ * def_ * p["inv_nfvt"]
    dir_ = is_ * der * p["inv_nrvt"]

    q1_arg = one - vbc * p["inv_vaf"] - vbe * p["inv_var"]
    clipped = q1_arg < q1_min
    q1 = torch.reciprocal(torch.maximum(q1_arg, q1_min))
    q1sq = q1 * q1
    dq1_be = torch.where(clipped, zero, p["inv_var"] * q1sq)
    dq1_bc = torch.where(clipped, zero, p["inv_vaf"] * q1sq)

    q2 = i_f * p["inv_ikf"] + i_r * p["inv_ikr"]
    root = torch.sqrt(one + const(4.0, dt) * torch.maximum(q2, zero))
    h = half * (one + root)
    dh_dq2 = torch.where(q2 > zero, torch.reciprocal(root), zero)
    qb = q1 * h
    dqb_be = dq1_be * h + q1 * dh_dq2 * (dif * p["inv_ikf"])
    dqb_bc = dq1_bc * h + q1 * dh_dq2 * (dir_ * p["inv_ikr"])

    inv_qb = torch.reciprocal(qb)
    ict = (i_f - i_r) * inv_qb
    dict_be = (dif - ict * dqb_be) * inv_qb
    dict_bc = (-dir_ - ict * dqb_bc) * inv_qb

    ibe = i_f * p["inv_bf"] + p["ise"] * (el - one)
    ibc = i_r * p["inv_br"] + p["isc"] * (ec - one)
    dibe_be = dif * p["inv_bf"] + p["ise"] * dle * p["inv_nevt"]
    dibc_bc = dir_ * p["inv_br"] + p["isc"] * dlc * p["inv_ncvt"]
    return (ibe + ibc, ict - ibc, dibe_be, dibc_bc, dict_be,
            dict_bc - dibc_bc)


def bjt_currents_packed(p, vbe, vbc):
    """Currents only — the same math as the derivatives function."""
    dt = vbe.dtype
    zero, one = const(0.0, dt), const(1.0, dt)
    is_ = p["is_"]
    (ef, er, el, ec), _ = _limexp4(p, vbe, vbc)
    i_f = is_ * (ef - one)
    i_r = is_ * (er - one)
    q1 = torch.reciprocal(torch.maximum(
        one - vbc * p["inv_vaf"] - vbe * p["inv_var"], const(1e-4, dt)))
    q2 = i_f * p["inv_ikf"] + i_r * p["inv_ikr"]
    qb = q1 * const(0.5, dt) * (one + torch.sqrt(
        one + const(4.0, dt) * torch.maximum(q2, zero)))
    ict = (i_f - i_r) / qb
    ibe = i_f * p["inv_bf"] + p["ise"] * (el - one)
    ibc = i_r * p["inv_br"] + p["isc"] * (ec - one)
    return ibe + ibc, ict - ibc


# ── f64 engine: the reference's mna-form currents and block derivatives ──

CURRENT_NAMES = (
    "is_", "nf_vt", "nr_vt", "inv_vaf", "inv_var", "inv_ikf", "inv_ikr",
    "bf", "br", "ise", "ne_vt", "isc", "nc_vt",
)


def pack_current_params(models):
    """models → (n_bjt, 13) float64 in CURRENT_NAMES order (the divisors
    and inverses exactly as `mna.bjt_currents` forms them)."""
    return np.asarray([[
        m.is_, m.nf * m.vt, m.nr * m.vt, _inv_or_zero(m.vaf),
        _inv_or_zero(m.var), _inv_or_zero(m.ikf), _inv_or_zero(m.ikr),
        m.bf, m.br, m.ise, m.ne * m.vt, m.isc, m.nc * m.vt,
    ] for m in models], dtype=np.float64).reshape(len(models), 13)


def diode_current_deriv(model, vd):
    """Junction diode current and conductance at vd (float64 tensor):
    (is·(limexp(vd/(n·vt)) − 1), is·limexp'(vd/(n·vt))/(n·vt))."""
    nvt = model.n * model.vt
    val, dval = _limexp_d(exact.div(vd, nvt))
    return model.is_ * (val - 1.0), exact.div(model.is_ * dval, nvt)


def limexp(x):
    """exp, linear past x = 40 (the SPICE Newton safeguard)."""
    return torch.where(x < _XC, torch.exp(exact.minimum(x, _XC)),
                       _EXC * (1.0 + (x - _XC)))


def bjt_currents(p, vbe, vbc):
    """DC Gummel-Poon (ib, ic), NPN convention; p maps CURRENT_NAMES to
    per-BJT tensors broadcastable against vbe/vbc."""
    i_f = p["is_"] * (limexp(vbe / p["nf_vt"]) - 1.0)
    i_r = p["is_"] * (limexp(vbc / p["nr_vt"]) - 1.0)
    q1 = 1.0 / exact.maximum(1.0 - vbc * p["inv_vaf"] - vbe * p["inv_var"],
                             1e-4)
    q2 = i_f * p["inv_ikf"] + i_r * p["inv_ikr"]
    qb = q1 * 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * exact.maximum(q2, 0.0)))
    ict = (i_f - i_r) / qb
    ibe = i_f / p["bf"] + p["ise"] * (limexp(vbe / p["ne_vt"]) - 1.0)
    ibc = i_r / p["br"] + p["isc"] * (limexp(vbc / p["nc_vt"]) - 1.0)
    return ibe + ibc, ict - ibc


def _netlist_columns(netlist, device):
    n_bjt = len(netlist.bjts)
    models = [b[4] for b in netlist.bjts]
    cur = torch.from_numpy(pack_current_params(models)).to(device)
    der = torch.from_numpy(pack_bjt_params(models, np.float64)).to(device)
    diodes = [(d[3].is_, d[3].n * d[3].vt) for d in netlist.diodes]
    return (n_bjt, {k: cur[:, i] for i, k in enumerate(CURRENT_NAMES)},
            {k: der[:, i] for i, k in enumerate(PARAM_NAMES)}, diodes)


def device_current_fn(netlist, device="cpu"):
    """f(v_nl (..., M) float64) → i_nl (..., M): [ib, ic] per BJT, then
    diodes."""
    n_bjt, cur, _, diodes = _netlist_columns(netlist, device)

    def fn(v_nl):
        ib, ic = bjt_currents(cur, v_nl[..., 0:2 * n_bjt:2],
                              v_nl[..., 1:2 * n_bjt:2])
        parts = [torch.stack([ib, ic], dim=-1).flatten(-2)]
        for k, (is_, nvt) in enumerate(diodes):
            vd = v_nl[..., 2 * n_bjt + k:2 * n_bjt + k + 1]
            parts.append(is_ * (limexp(exact.div(vd, nvt)) - 1.0))
        return torch.cat(parts, dim=-1)

    return fn


def device_derivs_fn(netlist, device="cpu"):
    """f(v_nl (..., M)) → (top, bot), each (..., M): the two entries of
    Jacobian column k inside its device block, dI[r0]/dV[k] and
    dI[r0+1]/dV[k] with r0 the block's first port (a diode column has
    top = its conductance and bot = 0)."""
    n_bjt, _, der, diodes = _netlist_columns(netlist, device)

    def fn(v_nl):
        _, _, dib_be, dib_bc, dic_be, dic_bc = bjt_currents_derivs_packed(
            der, v_nl[..., 0:2 * n_bjt:2], v_nl[..., 1:2 * n_bjt:2])
        top = [torch.stack([dib_be, dib_bc], dim=-1).flatten(-2)]
        bot = [torch.stack([dic_be, dic_bc], dim=-1).flatten(-2)]
        for k, (is_, nvt) in enumerate(diodes):
            vd = v_nl[..., 2 * n_bjt + k:2 * n_bjt + k + 1]
            _, dval = _limexp_d(exact.div(vd, nvt))
            top.append(exact.div(is_ * dval, nvt))
            bot.append(torch.zeros_like(vd))
        return torch.cat(top, dim=-1), torch.cat(bot, dim=-1)

    return fn


def block_rows(netlist):
    """r0 per port: the first port of its device block (NumPy int)."""
    n_bjt = len(netlist.bjts)
    m = 2 * n_bjt + len(netlist.diodes)
    return np.asarray([2 * (k // 2) if k < 2 * n_bjt else k
                       for k in range(m)])


def analytic_device_jacobian_fn(netlist, device="cpu"):
    """dI/dV_nl as a dense block-diagonal (M, M) float64 tensor."""
    derivs = device_derivs_fn(netlist, device)
    r0 = torch.from_numpy(block_rows(netlist)).to(device)
    n_bjt = len(netlist.bjts)

    def jac(v_nl):
        top, bot = derivs(v_nl)
        m = top.shape[0]
        out = torch.zeros((m, m), dtype=torch.float64, device=v_nl.device)
        cols = torch.arange(m, device=v_nl.device)
        out[r0, cols] = top
        bjt = cols < 2 * n_bjt
        out[r0[bjt] + 1, cols[bjt]] = bot[bjt]
        return out

    return jac
