"""The melange preamp (12 nodes, full Gummel-Poon, the protection diode,
thermal noise), its noise stream and the behavioral power amp in the
PyTorch port, against the JAX package (CPU, float64).

  * `make_params`: every matrix within 1e-12 of the reference's largest
    entry (the DC point is a separate Newton solve in each package).
  * The netlist's device functions with its diode (`mna.Netlist.
    device_current_fn` / `device_jacobian_fn`, `mna.bjt_currents`,
    `mna.diode_current`) within 1e-13 of the reference's.
  * The noise stream: the threefry words of `split` and `key_data` equal
    the reference's bit for bit over 1000 steps from PRNGKey(0x5EED), and
    so do the uniforms behind `jax.random.normal`. The normals miss the
    2-ulp target: XLA's CPU `log1p` (its own approximation, up to ~128
    ulp from the correctly rounded w = −log1p(−u²) on these draws) and
    its multiply-add contractions in the erfinv polynomial move the
    reference's normals by up to 26 ulp (measured over these 10000
    draws); the port takes the device's libm `log1p`, as XLA does on a
    GPU. Gate: 64 ulp, and the erfinv constants equal the ones XLA
    compiles (ROADMAP queue 3). Their effect on the preamp's output is
    some 1e-22 V.
  * `step`, noise off and on (gain 30), after 1 and 64 steps, at both
    R_ldr endpoints and with a swept LDR: every state row and the output
    within 1e-12 of the row's magnitude, else within the reference's own
    response to 1-ulp perturbations (the state entering every step and
    the f32 Newton solve's inputs) + 3 dB; the key words exactly. A NaN
    input resets the twin to the DC point while the key advances.
  * `behavioral_process` over ±6 V, NaN and ±inf: within 4 ulp (NaN where
    the reference is NaN), and the reference's gain and clip gates.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu.circuits import melange_preamp as jmp
from openwurli_tpu.circuits import mna as jmna
from openwurli_tpu.circuits import power_amp as jpa
from openwurli_tpu_torch import convert, prng
from openwurli_tpu_torch.circuits import melange_preamp as mp
from openwurli_tpu_torch.circuits import mna
from openwurli_tpu_torch.circuits import power_amp as pa
from test_torch_engine_steps import assert_gate, f32_solve_twin, np_tree

torch.set_num_threads(1)

SR = 88200.0
NORMAL_ULP_GATE = 64


@pytest.fixture(scope="module")
def params():
    return jmp.make_params(SR), mp.make_params(SR)


def test_make_params_matches_reference(params):
    jp, tp = params
    pairs = [(k, getattr(jp.solver, k), getattr(tp.solver, k))
             for k in ("s", "a_hist", "n_v", "n_i", "s_ni", "k", "w",
                       "w_scale", "v_dc", "i_dc", "v_nl_dc")]
    pairs += [(k, getattr(jp, k), getattr(tp, k))
              for k in ("s_fb_col", "s_fb_fb", "nv_sfb", "sfb_ni",
                        "noise_inject", "noise_sigma")]
    for name, a, b in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        scale = max(np.abs(a).max(), 1e-300)
        assert np.abs(a - b).max() <= 1e-12 * scale, name
    for k in ("fb_idx", "out_idx", "input_row", "sample_rate"):
        assert getattr(jp, k) == getattr(tp, k), k
    # the converter carries the reference's params over unchanged
    cp = convert.melange_params_from_numpy(np_tree(jp))
    assert np.array_equal(cp.solver.s, np.asarray(jp.solver.s))


def test_device_functions_with_the_diode():
    from openwurli_tpu.circuits import gp as jgp

    jnet, pnet = jmp._cached_netlist(), mp.build_netlist()
    v = np.random.default_rng(5).uniform(-3.0, 1.0, (8, 5))
    v[0, 4] = 45.0 * 1.752 * 0.02585  # the diode past limexp's switch
    cur, jac = pnet.device_current_fn(), pnet.device_jacobian_fn()
    jcur = jax.jit(jnet.device_current_fn())
    jjac = jax.jit(jgp.analytic_device_jacobian_fn(jnet))
    # the batch axes of the port's functions: all rows at once
    batch = cur(torch.from_numpy(v)).numpy()
    for k, row in enumerate(v):
        ri, rj = np.asarray(jcur(row)), np.asarray(jjac(row))
        pi, pj = cur(torch.from_numpy(row)).numpy(), jac(torch.from_numpy(
            row)).numpy()
        np.testing.assert_allclose(pi, ri, rtol=1e-13,
                                   atol=1e-13 * np.abs(ri).max())
        np.testing.assert_allclose(pj, rj, rtol=1e-13,
                                   atol=1e-13 * np.abs(rj).max())
        assert np.array_equal(batch[k], pi)
    q = jnet.bjts[0][4]
    ib, ic = jmna.bjt_currents(q, jnp.asarray(v[:, 0]), jnp.asarray(v[:, 1]))
    pb, pc = mna.bjt_currents(q, torch.from_numpy(v[:, 0]),
                              torch.from_numpy(v[:, 1]))
    np.testing.assert_allclose(pb.numpy(), np.asarray(ib), rtol=1e-13)
    np.testing.assert_allclose(pc.numpy(), np.asarray(ic), rtol=1e-13)
    d = jnet.diodes[0][3]
    np.testing.assert_allclose(
        mna.diode_current(d, torch.from_numpy(v[:, 4])).numpy(),
        np.asarray(jmna.diode_current(d, jnp.asarray(v[:, 4]))), rtol=1e-13)


def _ulps(a, b):
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


def test_noise_stream_matches_reference():
    key = jax.random.PRNGKey(0x5EED).astype(jnp.uint32)
    tk = torch.from_numpy(prng.prng_key(0x5EED))
    assert np.array_equal(np.asarray(key).astype(np.int64), tk.numpy())

    @jax.jit
    def jstep(k):
        new, sub = jax.random.split(jax.random.wrap_key_data(
            k, impl="threefry2x32"))
        u = jax.random.uniform(sub, (10,), jnp.float64,
                               minval=prng.NORMAL_LO, maxval=1.0)
        return (jax.random.key_data(new).astype(jnp.uint32),
                jax.random.key_data(sub).astype(jnp.uint32), u,
                jax.random.normal(sub, (10,), jnp.float64))

    worst = 0.0
    for _ in range(1000):
        jnew, jsub, ju, jn = (np.asarray(x) for x in jstep(key))
        tnew, tsub = prng.split(tk)
        assert np.array_equal(jnew.astype(np.int64), tnew.numpy())
        assert np.array_equal(jsub.astype(np.int64), tsub.numpy())
        # the uniforms behind the normals, bit for bit
        k1, k2 = tsub[0, None], tsub[1, None]
        i = torch.arange(10)
        b1, b2 = prng.threefry2x32(k1, k2, torch.zeros_like(i), i)
        u = ((b1 << 20) | (b2 >> 12)).double() * 2.0 ** -52 * 2.0 \
            + prng.NORMAL_LO
        assert np.array_equal(u.numpy(), ju)
        worst = max(worst, float(_ulps(prng.normal_f64(tsub, 10).numpy(),
                                       jn).max()))
        key, tk = jnp.asarray(jnew), tnew
    print(f"normals: worst {worst} ulp of the reference")
    assert worst <= NORMAL_ULP_GATE


def test_erfinv_constants_are_xlas():
    """The polynomial's coefficients and its range constants, read from
    the program XLA compiles for jax.scipy.special.erfinv (float64)."""
    hlo = jax.jit(jax.scipy.special.erfinv).lower(
        jnp.zeros(4, jnp.float64)).compile().as_text()
    consts = {float(c) for c in re.findall(r"constant\(([-0-9.e+]+)\)", hlo)}
    mine = set(prng.ERFINV_LT_6_25 + prng.ERFINV_LT_16 + prng.ERFINV_GT_16)
    assert mine <= consts, sorted(mine - consts)
    assert {6.25, 16.0, -3.125, 3.25, 5.0} <= consts
    x = np.linspace(-0.999, 0.999, 4001)
    ref = np.asarray(jax.jit(jax.scipy.special.erfinv)(x))
    got = prng.erfinv(torch.from_numpy(x)).numpy()
    assert _ulps(got, ref).max() <= NORMAL_ULP_GATE
    assert prng.erfinv(torch.tensor([1.0, -1.0], dtype=torch.float64)
                       ).tolist() == [float("inf"), float("-inf")]


# ── the step ──

STREAMS = 3
N_STEPS = 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = 0.004 * rng.standard_normal((N_STEPS, STREAMS))
    t = np.arange(N_STEPS)
    r_sweep = np.exp(np.log(1e6) + (np.log(1.9e4) - np.log(1e6))
                     * 0.5 * (1 - np.cos(2 * np.pi * t / N_STEPS)))
    r = np.stack([np.full(N_STEPS, 1e6), np.full(N_STEPS, 1.9e4), r_sweep],
                 axis=1)
    return x, 1.0 / np.maximum(r, 1000.0)


def _nudge(tree, key):
    """Every float leaf moved by one ulp, up or down at random."""
    leaves, tdef = jax.tree.flatten(tree)
    keys = jax.random.split(key, len(leaves))
    out = []
    for x, k in zip(leaves, keys):
        if x.dtype == jnp.float64:
            x = jnp.nextafter(x, jnp.where(jax.random.bernoulli(
                k, 0.5, x.shape), jnp.inf, -jnp.inf))
        out.append(x)
    return jax.tree.unflatten(tdef, out)


_JAX_STEPS = {}


def _jax_step(jp, twin_seed):
    """The reference step vmapped over the streams, jitted once per twin
    seed (None: the reference itself); a twin nudges the state entering
    the step by one ulp and the f32 Newton solve's inputs by one f32
    ulp."""
    if twin_seed in _JAX_STEPS:
        return _JAX_STEPS[twin_seed]

    def step(s, xv, gv, noise, t):
        if twin_seed is not None:
            s = _nudge(s, jax.random.fold_in(
                jax.random.PRNGKey(twin_seed), t))
        return jax.vmap(lambda s1, g1, x1: jmp.step(
            jp, s1, g1, x1, noise_enabled=noise, noise_gain=30.0))(
                s, gv, xv)

    fn = jax.jit(step)
    if twin_seed is not None:
        orig = jmna.ge_solve_f32
        jmna.ge_solve_f32 = f32_solve_twin(twin_seed)
        st0 = jax.tree.map(lambda a: jnp.stack([a] * STREAMS),
                           jmp.init_state(jp))
        try:  # trace and compile with the twin solve patched in
            fn = fn.lower(st0, jnp.zeros(STREAMS), jnp.zeros(STREAMS),
                          True, 0).compile()
        finally:
            jmna.ge_solve_f32 = orig
    _JAX_STEPS[twin_seed] = fn
    return fn


def _jax_run(jp, x, g, noise, n, twin_seed=None):
    """n steps of the reference step over the streams."""
    fn = _jax_step(jp, twin_seed)
    st = jax.tree.map(lambda a: jnp.stack([a] * STREAMS),
                      jmp.init_state(jp))
    outs = []
    for t in range(n):
        st, y = fn(st, jnp.asarray(x[t]), jnp.asarray(g[t]),
                   jnp.asarray(noise), jnp.asarray(t))
        outs.append(y)
    return np_tree(st), np.stack([np.asarray(y) for y in outs])


def _port_run(tp, x, g, noise, n):
    c = mp.step_tensors(tp)
    st = mp.init_state(tp, (STREAMS,))
    outs = []
    scale = torch.full((STREAMS,), 30.0 if noise else 0.0,
                       dtype=torch.float64)
    for t in range(n):
        st, y = mp.step(c, st, torch.from_numpy(g[t]),
                        torch.from_numpy(x[t]), scale)
        outs.append(y)
    return st, torch.stack(outs)


def _as_tree(st, out):
    return {"v": st.v, "i_nl": st.i_nl, "v_nl": st.v_nl,
            "g_ldr_prev": st.g_ldr_prev, "noise_w_prev": st.noise_w_prev,
            "out": out}


@pytest.mark.parametrize("noise", [False, True], ids=["noise_off",
                                                      "noise_on"])
@pytest.mark.parametrize("n", [1, N_STEPS])
def test_step_matches_reference(params, noise, n):
    jp, _ = params
    # the reference's params in the port: only the step arithmetic differs
    tp = convert.melange_params_from_numpy(np_tree(jp))
    x, g = _inputs()
    ref_st, ref_out = _jax_run(jp, x, g, noise, n)
    port_st, port_out = _port_run(tp, x, g, noise, n)
    assert np.array_equal(port_st.noise_key.numpy(),
                          np.asarray(ref_st.noise_key).astype(np.int64))
    twins = [_as_tree(*_jax_run(jp, x, g, noise, n, twin_seed=s))
             for s in (1, 2)]
    ref = _as_tree(ref_st, ref_out)
    port = {k: v.numpy() for k, v in _as_tree(port_st, port_out).items()}
    assert_gate(f"melange step x{n} noise={noise}", port, ref, *twins)


def test_nan_input_resets_the_twin_and_advances_the_key(params):
    jp, tp = params
    c = mp.step_tensors(tp)
    st = mp.init_state(tp)
    st, _ = mp.step(c, st, 1e-6, 0.001, 30.0)
    key = st.noise_key.clone()
    st2, y = mp.step(c, st, 1e-6, float("nan"), 30.0)
    assert float(y) == 0.0
    sp = tp.solver
    assert np.array_equal(st2.v.numpy(), np.broadcast_to(sp.v_dc, (2, 13)))
    assert np.array_equal(st2.i_nl.numpy(), np.broadcast_to(sp.i_dc, (2, 5)))
    assert np.array_equal(st2.v_nl.numpy(),
                          np.broadcast_to(sp.v_nl_dc, (2, 5)))
    assert np.array_equal(st2.noise_key.numpy(), prng.split(key)[0].numpy())
    assert torch.isfinite(st2.noise_w_prev).all()
    assert float(st2.noise_w_prev.abs().max()) > 0.0
    # the reference does the same
    js = jmp.init_state(jp)
    js, _ = jmp.step(jp, js, 1e-6, 0.001, True, 30.0)
    js2, jy = jmp.step(jp, js, 1e-6, float("nan"), True, 30.0)
    assert float(jy) == 0.0
    assert np.array_equal(np.asarray(js2.v), st2.v.numpy())
    assert np.array_equal(np.asarray(js2.noise_key).astype(np.int64),
                          st2.noise_key.numpy())


# ── the behavioral power amp ──


def test_behavioral_process_matches_reference():
    x = np.concatenate([np.linspace(-6.0, 6.0, 2001),
                        np.geomspace(1e-9, 1.0, 200),
                        [5.0, -5.0, np.nan, np.inf, -np.inf, 0.0]])
    ref = np.asarray(jax.jit(jpa.behavioral_process)(jnp.asarray(x)))
    got = pa.behavioral_process(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isnan(ref), np.isnan(got))
    fin = ~np.isnan(ref)
    assert _ulps(got[fin], ref[fin]).max() <= 4


def test_behavioral_model_gain_and_clip():
    g = float(pa.behavioral_process(torch.tensor(0.001,
                                                 dtype=torch.float64))) \
        * pa.HEADROOM / 0.001
    assert 60.0 < g < 75.0
    y = float(pa.behavioral_process(torch.tensor(5.0, dtype=torch.float64)))
    assert 0.85 < y <= 1.0
