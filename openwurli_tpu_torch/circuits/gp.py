"""Closed-form Gummel-Poon currents and derivatives on torch tensors.

Port of `openwurli_tpu/circuits/gp.py`: `pack_bjt_params` (NumPy) and the
packed evaluation used by the mono chain's step functions, where the BJTs
of one circuit evaluate as (n_bjt, S) tensor ops with per-BJT constants in
(n_bjt, 1) columns. The arithmetic is dtype-generic: float32 in the chain,
float64 in the DC operating-point solve.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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
