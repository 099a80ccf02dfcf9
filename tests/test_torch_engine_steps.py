"""The f64 engine's step functions in the PyTorch port against the JAX
package's, on the same seeded states and inputs (CPU, float64).

Each step runs once and 64 times from the reference's own states (its
params are handed to the port, so only the step arithmetic differs).
Target: every state row and output within 1e-12 of the row's magnitude.
Where a row misses it, the gate is the reference's own response to a
1-ulp perturbation of its inputs, +3 dB, the larger over two
seeds: the state entering every step, every sample's input, the params
(per step where they are arguments), and in the circuits the f32 Newton
solve's right-hand side (one f32 ulp), whose rounding XLA places
differently.
XLA contracts multiply-adds into FMAs and sums its dots in its own order;
the filters with a pole near 1 (the speaker's 20-30 Hz high-pass), the
preamp's main − shadow difference and the rows after an f32 Newton solve
carry those roundings (ROADMAP queue 3). `nr_resid`, the final Newton
residual, is rounding noise below the 1e-9 V Newton tolerance and is held
to that in volts. The prng draws, the solver counters and the slot logic
are exact. An output sequence is one row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import prng as jprng
from openwurli_tpu import voice as jvoice
from openwurli_tpu.circuits import dk_preamp as jdk
from openwurli_tpu.circuits import mna as jmna
from openwurli_tpu.circuits import power_amp as jpa
from openwurli_tpu.circuits import speaker as jspk
from openwurli_tpu.circuits import tremolo as jtrem
from openwurli_tpu.ops import allpass as jap
from openwurli_tpu.ops import biquad as jbq
from openwurli_tpu_torch import convert, hammer, pickup, prng, reed, voice
from openwurli_tpu_torch.circuits import dk_preamp, mna, power_amp, speaker
from openwurli_tpu_torch.circuits import tremolo
from openwurli_tpu_torch.ops import allpass, biquad

torch.set_num_threads(1)

SR = 44100.0
OS_SR = 88200.0
TARGET = 1e-12
GATE_DB = 3.0


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_tree(x):
    """NumPy leaves → float64 / int64 / bool tensors (same structure)."""
    if isinstance(x, tuple):
        return type(x)(*[t_tree(y) for y in x])
    a = np.asarray(x)
    if a.dtype == np.uint32 or a.dtype.kind == "i":
        return torch.from_numpy(a.astype(np.int64))
    if a.dtype == bool:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.astype(np.float64))


def leaves(x, prefix=""):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        out = {}
        for k, v in zip(x._fields, x):
            out.update(leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(x, list) and all(np.ndim(np.asarray(y)) == 0
                                   for y in x):
        return {prefix.rstrip("."): np.asarray(
            [float(np.asarray(y)) for y in x], dtype=np.float64)}
    if isinstance(x, (dict, list, tuple)):
        out = {}
        for k, v in (x.items() if isinstance(x, dict) else enumerate(x)):
            out.update(leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return {prefix.rstrip("."): np.asarray(x, dtype=np.float64)}


def rel_errors(port, ref):
    """{row: max |port − ref| / max(|ref|)} over matching leaves."""
    p, r = leaves(port), leaves(ref)
    assert set(p) == set(r), set(p) ^ set(r)
    out = {}
    for k in r:
        a, b = p[k], r[k]
        assert a.shape == b.shape, k
        both_nan = np.isnan(a) & np.isnan(b)
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        fin = np.abs(b[np.isfinite(b)])
        scale = 1.0 if k.endswith("nr_resid") else max(
            fin.max(initial=0.0), 1e-300)
        d = np.where(both_nan | (a == b), 0.0, np.abs(a - b))
        out[k] = float(np.max(d, initial=0.0) / scale)
    return out


def ulp_twin(tree, seed=0):
    """Every float leaf moved by one ulp, alternating up and down."""
    rng = np.random.default_rng(seed)

    def f(x):
        a = np.asarray(x)
        if a.dtype != np.float64:
            return a
        sgn = rng.choice([-np.inf, np.inf], size=a.shape)
        return np.nextafter(a, sgn)

    return jax.tree.map(f, tree)


def f32_solve_twin(seed):
    """A reference `ge_solve_f32` whose f32 matrix and right-hand side are
    moved by one f32 ulp (random signs from `seed`): patched in for twin
    runs."""
    orig = jmna.ge_solve_f32

    def twin(a, b):
        m = b.shape[-1]
        rng = np.random.default_rng(seed)
        sa = rng.choice([-np.inf, np.inf], (m, m)).astype(np.float32)
        sb = rng.choice([-np.inf, np.inf], m).astype(np.float32)
        return orig(jnp.nextafter(a.astype(jnp.float32), sa),
                    jnp.nextafter(b.astype(jnp.float32), sb))

    return twin


def ulp(x, seed):
    """x (array or float) moved by one ulp, up or down at random."""
    a = np.asarray(x, np.float64)
    sgn = np.random.default_rng(seed).choice([-np.inf, np.inf], a.shape)
    return np.nextafter(a, sgn)


def assert_gate(name, port, ref, *twins):
    """port vs ref within TARGET of each row's magnitude, else within the
    largest response of the reference's 1-ulp twins + 3 dB."""
    err = rel_errors(port, ref)
    twin_errs = [rel_errors(t, ref) for t in twins]
    twin_err = {k: max(t[k] for t in twin_errs) for k in err}
    bad = {}
    for k, e in err.items():
        floor = 1e-9 if k.endswith("nr_resid") else TARGET
        gate = max(floor, twin_err[k] * 10 ** (GATE_DB / 20))
        if not e <= gate:
            bad[k] = (e, twin_err[k])
    worst = max(err.items(), key=lambda kv: kv[1])
    print(f"{name}: worst {worst[0]} {worst[1]:.3g}")
    assert not bad, f"{name}: rows past their gate {bad}"
    return err


# ── prng ──


def test_lcg_draws_bit_exact():
    s = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    s32 = jnp.asarray(s.astype(np.uint32))
    for jf, pf in ((jprng.lcg_uniform_scaled, prng.lcg_uniform_scaled),
                   (jprng.lcg_signed_unit, prng.lcg_signed_unit)):
        js, jn = jf(s32)
        ps, pn = pf(torch.from_numpy(s.astype(np.int64)))
        assert np.array_equal(np.asarray(js).astype(np.int64), ps.numpy())
        assert np.array_equal(np.asarray(jn), pn.numpy())


# ── voice: reed, hammer noise, pickup ──

NOTES = np.array([36.0, 60.0, 60.0, 84.0, 93.0, 72.0])
VELS = np.array([0.9, 0.3, 1.0, 0.6, 0.8, 0.05])


@pytest.fixture(scope="module")
def voices():
    """Reference voice params and a state with every branch in reach:
    jitter draws (n a multiple of 16), dampers mid-ramp and about to end
    their ramp, an undamped top key, a renorm at n = 1024, an attack-noise
    burst ending inside the run."""
    vp, det = jvoice.note_on_params(jnp.asarray(NOTES), jnp.asarray(VELS),
                                    SR, mlp_enabled=True)
    seeds = jnp.asarray((NOTES.astype(np.uint32) * np.uint32(2654435761)))
    vs = jvoice.init_state(vp, det, jnp.asarray(VELS), SR, seeds)
    off = jnp.asarray([False, True, True, True, True, False])
    vs = jvoice.note_off(vp, vs, SR, active=off)
    vp, vs = np_tree(vp), np_tree(vs)
    r = vs.reed
    r = r._replace(
        n=np.array([0, 1008, 48, 16, 1020, 5], np.int64),
        damper_release_count=np.array([0.0, 10.0, 1090.0, 300.0, 0.0, 0.0]),
        s=np.full((6, 7), 0.3), c=np.full((6, 7), 0.9))
    nz = vs.noise._replace(
        remaining=np.array([661, 20, 5, 0, 661, 40], np.int32),
        fade_in_remaining=np.array([16, 0, 3, 0, 16, 0], np.int32),
        bpf=jbq.BiquadState(np.full(6, 1e-3), np.full(6, -2e-3)))
    return vp, vs._replace(reed=r, noise=nz)


def _run(step, params, state, n):
    outs = []
    for _ in range(n):
        state, y = step(params, state)
        outs.append(y)
    return state, outs


@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("part", ["reed", "noise", "voice"])
def test_voice_steps(voices, part, n):
    vp, vs = voices
    jstep, pstep, jp, js, pp, ps = {
        "reed": (jax.jit(jvoice.reed.step), reed.step, vp.reed, vs.reed,
                 None, None),
        "noise": (jax.jit(jvoice.hammer.noise_step), hammer.noise_step,
                  vp.noise, vs.noise, None, None),
        "voice": (jax.jit(jvoice.step), voice.step, vp, vs, None, None),
    }[part]
    pp, ps = t_tree(jp), t_tree(js)
    ref = _run(jstep, jp, js, n)
    twin = _run(jstep, jp, ulp_twin(js), n)
    port = _run(pstep, pp, ps, n)
    assert_gate(f"{part} x{n}", np_tree(port), np_tree(ref),
                np_tree(twin))


def test_voice_is_silent_and_note_off(voices):
    vp, vs = voices
    pp, ps = t_tree(vp), t_tree(vs)
    assert np.array_equal(
        np.asarray(jvoice.is_silent(vp, vs, SR)),
        voice.is_silent(pp, ps, SR).numpy())
    act = np.array([True, False, True, False, True, True])
    ref = np_tree(jvoice.note_off(vp, vs, SR, active=jnp.asarray(act)))
    port = voice.note_off(pp, ps, SR, torch.from_numpy(act))
    assert_gate("note_off", np_tree(port), ref, ref)


def test_pickup_past_the_knee():
    x = np.linspace(-1.5, 1.5, 301)
    ds = np.full_like(x, 0.85)
    jp = jvoice.pickup.make_params(SR, jnp.asarray(ds))
    js = jvoice.pickup.init_state(x.shape)
    pp = pickup.PickupParams(*[torch.from_numpy(np.asarray(a)) for a in jp])
    ps = pickup.PickupState(torch.ones(x.shape, dtype=torch.float64))
    for _ in range(3):
        js, jy = jax.jit(jvoice.pickup.step)(jp, js, jnp.asarray(x))
        ps, py = pickup.step(pp, ps, torch.from_numpy(x))
    assert_gate("pickup", np_tree((ps, py)), np_tree((js, jy)),
                np_tree((js, jy)))
    assert np.abs(np.asarray(jvoice.pickup.soft_saturate(
        jnp.asarray(x)))).max() < 0.98


# ── ops: allpass, biquad, speaker ──


def _signal(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n) * 0.2


def test_allpass_up_down():
    x = _signal(64)
    js, ps = jap.init_state(), allpass.init_state()
    jo, po = [], []
    for v in x:
        js, (e, o) = jap.up_step(js, jnp.asarray(v))
        js, y = jap.down_step(js, e * 0.5, o * 0.5)
        ps, (pe, pod) = allpass.up_step(ps, torch.tensor(v))
        ps, py = allpass.down_step(ps, pe * 0.5, pod * 0.5)
        jo.append(y)
        po.append(py)
    assert_gate("allpass", np_tree((ps, po)), np_tree((js, jo)),
                np_tree((js, jo)))


@pytest.mark.parametrize("character", [0.0, 1.0, 0.37])
def test_speaker_step(character):
    x = _signal(64, seed=4) * 3.0
    jparams = jspk.make_params(SR)
    pparams = speaker.make_params(SR)
    jc = jspk.coeffs_for_character(character, jparams.sample_rate)
    pc = speaker.coeffs_t(torch.tensor(character, dtype=torch.float64),
                          pparams.sample_rate)
    assert_gate("speaker coeffs", np_tree(pc), np_tree(jc), np_tree(jc))
    jstep = jax.jit(jspk.step)

    def run_j(xs, seed=None):
        st, outs = jspk.init_state(), []
        for k, v in enumerate(xs):
            c, p = jc, jparams
            if seed is not None:
                st = ulp_twin(np_tree(st), seed + k)
                c = ulp_twin(np_tree(jc), seed + 5000 + k)
            st, y = jstep(p, st, c, jnp.asarray(v))
            outs.append(y)
        return np_tree((st, outs))

    pst, po = speaker.init_state(), []
    for v in x:
        pst, py = speaker.step(pparams, pst, pc, torch.tensor(v))
        po.append(py)
    ref = run_j(x)
    assert_gate(f"speaker c={character}", np_tree((pst, po)), ref,
                run_j(ulp(x, 1), 100), run_j(ulp(x, 2), 200))


def test_biquad_step():
    jc = jbq.lowpass(1000.0, 0.7, SR)
    pc = biquad.design_t("lowpass", torch.tensor(1000.0,
                                                 dtype=torch.float64),
                         0.7, SR)
    js, ps = jbq.init_state(), biquad.init_state()
    for v in _signal(64, seed=5):
        js, jy = jbq.step(jc, js, jnp.asarray(v))
        ps, py = biquad.step(pc, ps, torch.tensor(v))
    assert_gate("biquad", np_tree((pc, ps, py)), np_tree((jc, js, jy)),
                np_tree((jc, js, jy)))


# ── circuits ──


@pytest.mark.parametrize("kind", ["tremolo", "power_amp"])
def test_device_currents_and_jacobian(kind):
    """gp.device_current_fn / analytic_device_jacobian_fn against the
    reference's netlist currents and closed-form Jacobian, on port
    voltages spread over cut-off, conduction and past limexp's knee."""
    from openwurli_tpu.circuits import gp as jgp
    from openwurli_tpu_torch.circuits import gp

    jmod, pmod = (jtrem, tremolo) if kind == "tremolo" else (jpa, power_amp)
    jnet, pnet = jmod._cached_netlist(), pmod.build_netlist()
    m = 2 * len(pnet.bjts)
    v = np.random.default_rng(9).uniform(-3.0, 1.2, (16, m))
    v[0, 0] = 45.0 * 0.02585  # past limexp's switch at 40·n·vt
    cur, jac = gp.device_current_fn(pnet), gp.analytic_device_jacobian_fn(
        pnet)
    jcur = jax.jit(jnet.device_current_fn())
    jjac = jax.jit(jgp.analytic_device_jacobian_fn(jnet))
    for row in v:
        ri, rj = np.asarray(jcur(row)), np.asarray(jjac(row))
        pi, pj = cur(torch.from_numpy(row)), jac(torch.from_numpy(row))
        np.testing.assert_allclose(pi.numpy(), ri, rtol=1e-13,
                                   atol=1e-13 * np.abs(ri).max())
        np.testing.assert_allclose(pj.numpy(), rj, rtol=1e-13,
                                   atol=1e-13 * np.abs(rj).max())
        assert np.array_equal(pj.numpy() == 0.0, rj == 0.0)


@pytest.fixture(scope="module")
def preamp():
    jp = jdk.make_params(OS_SR)
    pp = dk_preamp.PreampParams(*[np.asarray(x) if np.ndim(x) else float(x)
                                  for x in np_tree(jp)])
    return jp, pp


@pytest.mark.parametrize("n", [1, 64])
def test_dk_preamp_step(preamp, n):
    jp, pp = preamp
    c = dk_preamp.step_tensors(pp)
    rng = np.random.default_rng(7)
    xs = rng.standard_normal(n) * 0.05
    gs = 1.0 / rng.uniform(2e4, 1e6, n)
    jstep = jax.jit(jdk.step)

    def run_j(params, st, xs, gs, seed=None):
        outs = []
        for k, (x, g) in enumerate(zip(xs, gs)):
            p = params
            if seed is not None:
                st = ulp_twin(np_tree(st), seed + k)
                p = ulp_twin(params, seed + 5000 + k)
            st, y = jstep(p, st, jnp.asarray(g), jnp.asarray(x))
            outs.append(y)
        return np_tree((st, outs))

    js0 = np_tree(jdk.init_state(jp))
    ps = dk_preamp.PreampState(*[torch.from_numpy(np.array(x, np.float64))
                                 for x in js0])
    outs = []
    for x, g in zip(xs, gs):
        ps, y = dk_preamp.step(c, ps, torch.tensor(g), torch.tensor(x))
        outs.append(y)
    jpn = np_tree(jp)
    assert_gate(f"dk_preamp x{n}", np_tree((ps, outs)),
                run_j(jpn, js0, xs, gs),
                run_j(jpn, js0, ulp(xs, 1), ulp(gs, 2), 100),
                run_j(jpn, js0, ulp(xs, 4), gs, 200))
    assert float(dk_preamp.ldr_conductance(torch.tensor(
        500.0, dtype=torch.float64))) == \
        float(jdk.ldr_conductance(500.0))


def _solver(jparams):
    return convert.solver_params_from_numpy(np_tree(jparams))


_JSTEPS = {}


def jax_circuit_step(kind, twin):
    """The reference circuit step, jitted once per (kind, twin); twin 0 is
    the reference, twin k > 0 has 1-ulp params and a Newton solve with its
    f32 inputs moved by one ulp (seed k)."""
    key = (kind, twin)
    if key not in _JSTEPS:
        mod, iters = (jtrem, 4) if kind == "tremolo" else (jpa, 16)
        sp = mod.make_params(OS_SR).solver
        if twin:
            sp = ulp_twin(np_tree(sp), 7 + twin)
        step = jmna.make_step(mod._cached_netlist(), sp, nr_iters=iters)
        if twin:
            solve = f32_solve_twin(twin)
            orig = jmna.ge_solve_f32

            def step_twin(st, w, _step=step):
                jmna.ge_solve_f32 = solve  # read while tracing only
                try:
                    return _step(st, w)
                finally:
                    jmna.ge_solve_f32 = orig

            _JSTEPS[key] = jax.jit(step_twin)
        else:
            _JSTEPS[key] = jax.jit(step)
    return _JSTEPS[key]


def _run_circuit(step, st, ws, seed=None):
    for k, w in enumerate(ws):
        if seed is not None:
            st = ulp_twin(np_tree(st), seed + k)
        st, v = step(st, w)
    return st, v


CASES = ["normal", "spike", "nan", "damp"]


def _circuit_inputs(kind, n, case):
    """w_extra rows per sample for the two circuits."""
    if kind == "tremolo":
        ws = np.zeros((n, 7))
        if case == "spike":
            ws[0, 6] = 100.0  # the supply jumps past 55 V: BE + cooldown
        elif case == "nan":
            ws[0, 6] = np.nan
        elif case == "damp":
            ws[0, 6] = -40.0
        return ws
    p = jpa.make_params(OS_SR)
    ws = np.zeros((n, 21))
    ws[:, p.input_row] = 0.3 * np.sin(np.arange(n) * 0.05)
    if case == "spike":
        ws[0, p.v1_row] = 200.0  # node swing far past 55 V
    elif case == "nan":
        ws[0, p.input_row] = np.nan
    elif case == "damp":
        ws[0, p.v1_row] = 60.0
    return ws


@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["tremolo", "power_amp"])
def test_mna_make_step(kind, case, n):
    if kind == "tremolo":
        net, iters = tremolo.build_netlist(), 4
        jparams = jtrem.make_params(OS_SR)
    else:
        net, iters = power_amp.build_netlist(), 16
        jparams = jpa.make_params(OS_SR)
    js0 = np_tree(jmna.init_state(jparams.solver))
    if kind == "tremolo":
        js0 = js0._replace(v=js0.v + np.array([1e-3, 0, 0, 0, 0, 0, 0]))
    ws = _circuit_inputs(kind, n, case)
    pstep = mna.make_step(net, _solver(jparams.solver), nr_iters=iters)
    ref = np_tree(_run_circuit(jax_circuit_step(kind, 0), js0,
                               [jnp.asarray(w) for w in ws]))
    twins = [np_tree(_run_circuit(jax_circuit_step(kind, s), js0,
                                  [jnp.asarray(ulp(w, s)) for w in ws],
                                  100 * s)) for s in (1, 2)]
    port = _run_circuit(pstep, convert.solver_state_from_numpy(js0),
                        [torch.from_numpy(w) for w in ws])
    pd = {k: int(v) for k, v in port[0].diag._asdict().items()}
    rd = {k: int(v) for k, v in ref[0].diag._asdict().items()}
    print(kind, case, n, rd)
    assert pd == rd
    if case == "spike":
        assert rd["nr_fail"] > 0
        assert rd["be_steps"] > 0 or kind == "power_amp"
        assert rd["cooldown"] > 0
    if case == "nan":
        assert rd["nan_reset"] > 0
    if case == "damp":
        assert rd["damp"] > 0
    assert_gate(f"mna {kind} {case} x{n}", np_tree(port), ref, *twins)


def _pa_params(jp):
    return power_amp.PowerAmpParams(
        solver=_solver(jp.solver), out_idx=jp.out_idx, v1_row=jp.v1_row,
        v2_row=jp.v2_row, input_row=jp.input_row, sample_rate=OS_SR,
        alpha_attack=float(jp.alpha_attack),
        alpha_release=float(jp.alpha_release),
        alpha_i_avg=float(jp.alpha_i_avg))


@pytest.mark.parametrize("sag", [True, False])
@pytest.mark.parametrize("n", [1, 64])
def test_power_amp_step(sag, n):
    jp = jpa.make_params(OS_SR)
    pp = _pa_params(jp)
    xs = 0.1 * np.sin(np.arange(n) * 0.07)
    js0 = np_tree(jpa.init_state(jp))
    js0 = js0._replace(rails=js0.rails._replace(
        v_rail_pos=np.asarray(22.52), i_avg_neg=np.asarray(0.01)))

    def run_j(twin, st, xs, seed=None):
        cstep = jax_circuit_step("power_amp", twin)
        outs = []
        for k, x in enumerate(xs):
            if seed is not None:
                st = ulp_twin(np_tree(st), seed + k)
            # the reference's power_amp.step around the (twin) circuit step
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jpa, "_step_fn", lambda sr: cstep)
                st, y = jpa.step(jp, st, jnp.asarray(x), rail_sag=sag)
            outs.append(y)
        return np_tree((st, outs))

    ps = power_amp.PowerAmpState(
        circuit=convert.solver_state_from_numpy(js0.circuit),
        rails=power_amp.RailState(*[torch.tensor(float(x),
                                                 dtype=torch.float64)
                                    for x in js0.rails]),
        last_good=torch.tensor(float(js0.last_good), dtype=torch.float64))
    outs = []
    for x in xs:
        ps, y = power_amp.step(pp, ps, torch.tensor(x), sag)
        outs.append(y)
    assert_gate(f"power_amp sag={sag} x{n}", np_tree((ps, outs)),
                run_j(0, js0, xs), run_j(1, js0, ulp(xs, 4), 100),
                run_j(2, js0, ulp(xs, 5), 200))


@pytest.mark.parametrize("n", [1, 64])
def test_tremolo_step(n):
    jp = jtrem.make_params(OS_SR)
    pp = tremolo.TremoloParams(
        solver=_solver(jp.solver), out_idx=jp.out_idx, sample_rate=OS_SR,
        ldr_attack=float(jp.ldr_attack), ldr_release=float(jp.ldr_release))
    depths = np.linspace(0.0, 1.0, n)
    js0 = np_tree(jtrem.init_state(OS_SR))

    def run_j(twin, st, depths, seed=None):
        cstep = jax_circuit_step("tremolo", twin)
        outs = []
        for k, d in enumerate(depths):
            if seed is not None:
                st = ulp_twin(np_tree(st), seed + k)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jtrem, "_osc_step_fn", lambda sr: cstep)
                st, y = jtrem.step(jp, st, jnp.asarray(d))
            outs.append(y)
        return np_tree((st, outs))

    ps = tremolo.TremoloState(
        osc=convert.solver_state_from_numpy(js0.osc),
        ldr_envelope=torch.tensor(float(js0.ldr_envelope),
                                  dtype=torch.float64),
        r_ldr=torch.tensor(float(js0.r_ldr), dtype=torch.float64))
    outs = []
    for d in depths:
        ps, y = tremolo.step(pp, ps, torch.tensor(d, dtype=torch.float64))
        outs.append(y)
    assert_gate(f"tremolo x{n}", np_tree((ps, outs)),
                run_j(0, js0, depths),
                run_j(1, js0, ulp(depths, 5), 100),
                run_j(2, js0, ulp(depths, 6), 200))
    sh = tremolo.shunt_impedance(torch.tensor([0.0, 0.3, 1.0],
                                              dtype=torch.float64),
                                 torch.tensor(5e4, dtype=torch.float64))
    np.testing.assert_allclose(
        sh.numpy(), np.asarray(jtrem.shunt_impedance(
            jnp.asarray([0.0, 0.3, 1.0]), 5e4)), rtol=1e-15)
