"""Mono chain (K2) of the PyTorch port: the reduced power-amp solve and one
call of each plain step function against the JAX step functions on the
same float32 state (fresh, and mid-render).

Step gate: the port's result may differ from the reference's by no more
than the reference's own response to a 2-ulp perturbation of the input
state (alternating ±2⁻²² relative per element), plus 1e-6 of the
component's magnitude for components the perturbation does not reach.
The two sides differ only in rounding — XLA fuses multiply-adds and has
its own f32 exp/log1p/tanh — and measure at most 2.6× that sensitivity
(pre_dj of a mid-render base_step, 8e-12 on a row of magnitude 6e-6),
mostly far below it. A flat 1e-5-of-magnitude gate is not reachable: deviation-
form state (pre_d, pa_di) is small next to the terms it is summed from,
and one base_step moves up to 1.2e-3 of its own magnitude (recorded in
ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu.kernels import mono_chain as mc
from openwurli_tpu_torch import convert
from openwurli_tpu_torch.kernels import mono_chain as pmc

torch.set_num_threads(1)

BASE_SR = 44100.0
S = 3
DEPTH = np.array([0.0, 0.5, 1.0])
CHAR = np.array([0.0, 1.0, 0.0])


def quick_signal(t_len=2048, lvl=0.05):
    tt = np.arange(t_len) / BASE_SR
    env = np.minimum(np.arange(t_len) / 400.0, 1.0)
    return (env * lvl * (np.sin(2 * np.pi * 220 * tt)
                         + 0.5 * np.sin(2 * np.pi * 440 * tt))
            ).astype(np.float32)


def test_ge_solve_ports_block_identity():
    """Reduced-pivot solve == dense solve of [[A,0],[C,I]]."""
    rng = np.random.default_rng(1)
    s, n = 7, 16
    order, releg = pmc.PA_ACTIVE, pmc.PA_RELEG
    a_full = np.zeros((s, n, n))
    a_full[:, :, :] = np.eye(n)[None]
    for j in order:
        a_full[:, :, j] = 0.15 * rng.standard_normal((s, n))
        a_full[:, j, j] += 1.0
    b = rng.standard_normal((s, n))
    x_ref = np.linalg.solve(a_full, b[..., None])[..., 0]
    cols_a = torch.tensor(np.stack([a_full[:, list(order), j].T
                                    for j in order]), dtype=torch.float32)
    cols_r = torch.tensor(np.stack([a_full[:, list(releg), j].T
                                    for j in order]), dtype=torch.float32)
    f_act = torch.tensor(b[:, list(order)].T, dtype=torch.float32)
    f_rel = torch.tensor(b[:, list(releg)].T, dtype=torch.float32)
    x = pmc._ge_solve_ports(cols_a, cols_r, f_act, f_rel, order, releg)
    assert x.shape == (n, s)
    assert np.abs(x.numpy().T - x_ref).max() < 1e-4


def test_scatter_rows_asserts_cover():
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="cover"):
        pmc._scatter_rows(x, x, (0, 1), (2, 4), 4)


@pytest.fixture(scope="module")
def env():
    consts = mc.pack_consts(BASE_SR)
    ctrl = mc.make_controls(BASE_SR, S, volume=0.5, depth=DEPTH,
                            character=CHAR)
    c, sc = mc._merged_consts(consts, jnp.asarray(ctrl))
    jit = {
        "trem": jax.jit(lambda st: mc.trem_update(c, sc, st)),
        "pre": jax.jit(lambda st, u, g: mc.preamp_step(c, sc, st, u, g)),
        "pa": jax.jit(lambda st, x: mc.pa_step(c, sc, st, x,
                                               c["rail_sag"])),
        "base": jax.jit(lambda st, x: mc.base_step(c, sc, st, x)),
    }
    pconsts = convert.chain_consts_from_numpy(
        {k: np.asarray(v) for k, v in consts.arrays.items()},
        consts.scalars)
    pc = pmc.chain_tensors(pconsts, torch.from_numpy(np.asarray(ctrl)))
    psc = pmc.scalar_tensors(pconsts)

    st0 = mc.unpack_state(jnp.asarray(mc.init_state(BASE_SR, S)))
    # mid-render state: 256 samples of the quick signal through the
    # reference's own step functions (tremolo update before every
    # SUB_BASE-th sample, as render_cpu does)
    audio = quick_signal(256)
    st = dict(st0)
    for i in range(256):
        if i % mc.SUB_BASE == 0:
            st = jit["trem"](st)
        st, _ = jit["base"](st, jnp.asarray(np.repeat(audio[i], S)[None]))
    return jit, pc, psc, {"fresh": st0, "mid": st}


def _to_torch(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


def _perturbed(st):
    out = {}
    for k, v in st.items():
        a = np.array(v)
        sign = np.where(np.arange(a.size).reshape(a.shape) % 2 == 0,
                        1.0, -1.0)
        out[k] = jnp.asarray((a * (1.0 + 2.0 ** -22 * sign))
                             .astype(np.float32))
    return out


def _assert_close(ref, ref_pert, got, what):
    for k in ref:
        r = np.asarray(ref[k], np.float64)
        sens = np.abs(np.asarray(ref_pert[k], np.float64) - r).max()
        err = np.abs(r - got[k].numpy().astype(np.float64)).max()
        bound = sens + 1e-6 * np.abs(r).max()
        assert err <= bound, f"{what}: {k} off by {err:.3e} (reference " \
            f"2-ulp sensitivity {sens:.3e})"


@pytest.mark.parametrize("which", ["fresh", "mid"])
def test_trem_update(env, which):
    jit, pc, psc, states = env
    st = states[which]
    _assert_close(jit["trem"](st), jit["trem"](_perturbed(st)),
                  pmc.trem_update(pc, psc, _to_torch(st)),
                  f"trem_update/{which}")


@pytest.mark.parametrize("which", ["fresh", "mid"])
def test_preamp_step(env, which):
    jit, pc, psc, states = env
    st = states[which]
    u = np.full((1, S), 0.05, np.float32)
    g = np.asarray(st["gldr_cur"])

    def ref_of(s):
        out, y = jit["pre"](s, jnp.asarray(u), jnp.asarray(g))
        return dict(out, out=y)

    got, y = pmc.preamp_step(pc, psc, _to_torch(st), torch.from_numpy(u),
                             torch.from_numpy(np.array(g)))
    _assert_close(ref_of(st), ref_of(_perturbed(st)), dict(got, out=y),
                  f"preamp_step/{which}")


@pytest.mark.parametrize("which", ["fresh", "mid"])
def test_pa_step(env, which):
    jit, pc, psc, states = env
    st = states[which]
    x = np.array([[0.01, -0.02, 0.005]], np.float32)

    def ref_of(s):
        out, y = jit["pa"](s, jnp.asarray(x))
        return dict(out, out=y)

    got, y = pmc.pa_step(pc, psc, _to_torch(st), torch.from_numpy(x),
                         pc["rail_sag"])
    _assert_close(ref_of(st), ref_of(_perturbed(st)), dict(got, out=y),
                  f"pa_step/{which}")


@pytest.mark.parametrize("which", ["fresh", "mid"])
def test_base_step(env, which):
    jit, pc, psc, states = env
    st = states[which]
    x = np.array([[0.05, -0.03, 0.02]], np.float32)

    def ref_of(s):
        out, y = jit["base"](s, jnp.asarray(x))
        return dict(out, out=y)

    got, y = pmc.base_step(pc, psc, _to_torch(st), torch.from_numpy(x))
    _assert_close(ref_of(st), ref_of(_perturbed(st)), dict(got, out=y),
                  f"base_step/{which}")
