"""The stage benchmark's new kernels' plain versions in the PyTorch port
against the JAX package's scans (CPU, float64), and the port's
`tools/torch_stage_bench.py` at a tiny size.

  * E8 (`kernels/engine.tremolo_scan`): 4 circuits from distinct seeded
    starts × 256 steps at depths 0, 0.5, 1 and 0.5 against a `lax.scan`
    of the reference's `tremolo.step` at 88.2 kHz;
  * E9 (`kernels/engine.power_amp_scan`): 4 streams × 64 samples (the
    stage bench's sine, a 200 V spike, a NaN input, a 2 V sine) against a
    `lax.scan` of `power_amp.step(rail_sag=True)`.

Target: every output column and state row within 1e-12 of its
magnitude. Where a row misses it, the gate of `test_torch_engine_steps.py`
for the same steps: the reference's own response to 1-ulp perturbations
(its solver params, its state entering every step, the f32 Newton solve's
inputs, and E9's inputs), the larger of two seeds, + 3 dB. The solver
counters are held exactly, except on E9's NaN stream after its NaN
sample (see the test).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu.circuits import power_amp as jpa
from openwurli_tpu.circuits import tremolo as jtrem
from openwurli_tpu_torch import convert
from openwurli_tpu_torch.kernels import engine as ek
from test_torch_engine_steps import (assert_gate, jax_circuit_step, np_tree,
                                     ulp, ulp_twin)

torch.set_num_threads(1)

SR = 88200.0
DEPTHS = np.array([0.0, 0.5, 1.0, 0.5])


def _trem_start():
    """The reference's batched settled tremolo, each circuit's node
    voltages and LDR envelope moved to a seeded start of its own."""
    st = np_tree(jtrem.init_state(SR, (len(DEPTHS),)))
    rng = np.random.default_rng(8)
    osc = st.osc._replace(v=st.osc.v + rng.uniform(-0.05, 0.05,
                                                   st.osc.v.shape))
    env = rng.uniform(0.0, 0.8, len(DEPTHS))
    return st._replace(osc=osc, ldr_envelope=env,
                       r_ldr=np.full(len(DEPTHS), jtrem.R_LDR_MAX))


def _trem_rows(out, st):
    rows = {f"out{j}": out[:, j] for j in range(out.shape[1])}
    o = st.osc
    rows.update(v=o.v, i_nl=o.i_nl, v_nl=o.v_nl, nr_resid=o.nr_resid,
                env=st.ldr_envelope, r_ldr=st.r_ldr)
    rows["diag"] = np.stack([np.asarray(d, np.float64) for d in o.diag])
    return {k: np.asarray(v, np.float64) for k, v in rows.items()}


def _jax_tremolo(st0, n, twin=0):
    """A lax.scan of the reference's tremolo.step (twin 0), or its step
    per sample with twin k's 1-ulp perturbations."""
    jp = jtrem.make_params(SR)
    depth = jnp.asarray(DEPTHS)
    if not twin:
        st, out = jax.jit(lambda st: jax.lax.scan(
            lambda s, _: jtrem.step(jp, s, depth), st, None, length=n))(st0)
        return _trem_rows(np.asarray(out), np_tree(st))
    cstep = jax_circuit_step("tremolo", twin)

    def body(st):
        orig = jtrem._osc_step_fn
        jtrem._osc_step_fn = lambda sr: cstep   # read while tracing only
        try:
            return jtrem.step(jp, st, depth)
        finally:
            jtrem._osc_step_fn = orig

    step, st, outs = jax.jit(body), st0, []
    for k in range(n):
        st, y = step(ulp_twin(np_tree(st), 1000 * twin + k))
        outs.append(np.asarray(y))
    return _trem_rows(np.stack(outs), np_tree(st))


def test_tremolo_scan_plain_matches_reference():
    n = 256
    st0 = _trem_start()
    port_st = convert.solver_state_from_numpy(st0.osc)
    state = ek.tremolo_rows(ek.tremolo.TremoloState(
        osc=port_st, ldr_envelope=torch.from_numpy(st0.ldr_envelope),
        r_ldr=torch.from_numpy(st0.r_ldr))).contiguous()
    calls = ek.TREMOLO_SCAN_PLAIN_CALLS
    out = ek.tremolo_scan(SR, state, torch.from_numpy(DEPTHS), n)
    assert ek.TREMOLO_SCAN_PLAIN_CALLS == calls + 1
    port = _trem_rows(out.numpy(), np_tree(jax.tree.map(
        lambda a: a.numpy(), ek.tremolo_unrows(state))))
    ref = _jax_tremolo(st0, n)
    np.testing.assert_array_equal(port["diag"], ref["diag"])
    # the depths reach the shunt: 0 keeps only the upper leg's 50k ∥ 18k
    np.testing.assert_allclose(port["out0"], 50e3 * 18e3 / 68e3, rtol=1e-15)
    assert np.ptp(port["out2"]) > 1e3
    twins = [_jax_tremolo(st0, n, s) for s in (1, 2)]
    assert_gate("E8 plain", port, ref, *twins)


def _pa_inputs(n):
    t = np.arange(n)
    sine = 0.05 * np.sin(2 * np.pi * 1000 * t / SR)
    x = np.stack([sine, sine.copy(), sine.copy(),
                  2.0 * np.sin(2 * np.pi * 3000 * t / SR)], axis=1)
    x[10, 1] = 200.0
    x[20, 2] = np.nan
    return x


def _pa_rows(out, st):
    """Gate rows per stream j: its output column and its state."""
    c = st.circuit
    diag = np.stack([np.asarray(d, np.float64) for d in c.diag], -1)
    rails = np.stack([np.asarray(r) for r in st.rails], -1)
    rows = {}
    for j in range(out.shape[1]):
        rows.update({f"{j}.out": out[:, j], f"{j}.v": c.v[j],
                     f"{j}.i_nl": c.i_nl[j], f"{j}.v_nl": c.v_nl[j],
                     f"{j}.nr_resid": c.nr_resid[j], f"{j}.rails": rails[j],
                     f"{j}.last_good": st.last_good[j],
                     f"{j}.diag": diag[j]})
    return {k: np.asarray(v, np.float64) for k, v in rows.items()}


def _jax_power_amp(x, twin=0):
    """A lax.scan of the reference's power_amp.step with rail sag (twin
    0), or its step per sample with twin k's 1-ulp perturbations."""
    jp = jpa.make_params(SR)
    st0 = jpa.init_state(jp, (x.shape[1],))
    if not twin:
        st, out = jax.jit(lambda st, xs: jax.lax.scan(
            lambda s, xt: jpa.step(jp, s, xt, rail_sag=True), st, xs))(
                st0, jnp.asarray(x))
        return _pa_rows(np.asarray(out), np_tree(st))
    cstep = jax_circuit_step("power_amp", twin)

    def body(st, xt):
        orig = jpa._step_fn
        jpa._step_fn = lambda sr: cstep   # read while tracing only
        try:
            return jpa.step(jp, st, xt, rail_sag=True)
        finally:
            jpa._step_fn = orig

    step, st, outs = jax.jit(body), st0, []
    for k in range(x.shape[0]):
        st = ulp_twin(np_tree(st), 1000 * twin + k)
        st, y = step(st, jnp.asarray(ulp(x[k], 100 * twin + k)))
        outs.append(np.asarray(y))
    return _pa_rows(np.stack(outs), np_tree(st))


def test_power_amp_scan_plain_matches_reference():
    n, nan_at = 64, 20
    x = _pa_inputs(n)
    state = ek.init_power_amp_scan_state(SR, x.shape[1])
    calls = ek.POWER_AMP_SCAN_PLAIN_CALLS
    out = ek.power_amp_scan(SR, torch.from_numpy(x.copy()), state)
    assert ek.POWER_AMP_SCAN_PLAIN_CALLS == calls + 1
    port = _pa_rows(out.numpy(), np_tree(jax.tree.map(
        lambda a: a.numpy(), ek.power_amp_unrows(state))))
    ref = _jax_power_amp(x)
    twins = [_jax_power_amp(x, s) for s in (1, 2)]
    # the spike's sample is bad (a node past 100 V, Newton failing): the
    # output holds the last good sample, the solver and the rails reset
    assert ref["1.diag"][1] > 0 and ref["1.out"][10] == ref["1.out"][9]
    for j in (0, 1, 3):
        np.testing.assert_array_equal(port[f"{j}.diag"], ref[f"{j}.diag"])
    whole = [k for k in ref if not k.startswith("2.")]
    assert_gate("E9 plain", *[{k: r[k] for k in whole}
                              for r in (port, ref, *twins)])
    # The NaN stream: held to the gate through the NaN sample, where the
    # solver resets to its DC point (and outputs it). From that point the solver's Newton fails for a few samples
    # (residuals near 90 V) and its state is rounding noise: the
    # reference's own counters for this stream differ between a batch of
    # one and this batch of four. After it, both recover to the drive.
    head = {k: r["2.out"][:nan_at + 1] for k, r in
            zip(("port", "ref", "t1", "t2"), (port, ref, *twins))}
    assert_gate("E9 plain, NaN stream to its NaN sample",
                {"out2": head["port"]}, {"out2": head["ref"]},
                {"out2": head["t1"]}, {"out2": head["t2"]})
    assert port["2.diag"][2] == ref["2.diag"][2] == 1     # one NaN reset
    assert np.isfinite(port["2.out"]).all()
    assert np.abs(port["2.out"]).max() <= 1.0
    np.testing.assert_allclose(port["2.out"][-16:], ref["2.out"][-16:],
                               rtol=0, atol=2e-3)


def test_stage_states_round_trip():
    """The packed rows hold every field: unrows then rows is the
    identity, and the initial states are the steps' own."""
    st = ek.init_tremolo_scan_state(SR, 3)
    assert st.shape == (ek.TREM_ROWS, 3)
    assert torch.equal(ek.tremolo_rows(ek.tremolo_unrows(st)), st)
    ref = np_tree(jtrem.init_state(SR, (3,)))
    np.testing.assert_array_equal(
        st[:7].T.numpy(), np.asarray(ref.osc.v, np.float64))
    pa = ek.init_power_amp_scan_state(SR, 2)
    assert pa.shape == (ek.PA_ROWS, 2)
    assert torch.equal(ek.power_amp_rows(ek.power_amp_unrows(pa)), pa)


def test_stage_bench_tool_cpu(capsys):
    """The tool's header and four stage lines, in the reference's print
    format and order (tools/stage_bench.py:86-92), finite."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_stage_bench.py")
    spec = importlib.util.spec_from_file_location("torch_stage_bench", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    counts = (ek.TREMOLO_SCAN_PLAIN_CALLS, ek.POWER_AMP_SCAN_PLAIN_CALLS)
    tool.main(["--device", "cpu", "--batch", "2", "--samples", "8",
               "--reps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "batch=2 samples=8 (us per sample, best of 1)"
    assert len(lines) == 5
    for line, name in zip(lines[1:], ("voices", "preamp twin", "tremolo",
                                      "power amp")):
        m = re.fullmatch(r"  (.{12}) +(\S+) us/sample", line)
        assert m and m.group(1).rstrip() == name, line
        us = float(m.group(2))
        assert np.isfinite(us) and us > 0.0
        assert line == f"  {name:12s} {us:9.1f} us/sample"
    # one untimed and one timed call of each plain scan
    assert (ek.TREMOLO_SCAN_PLAIN_CALLS, ek.POWER_AMP_SCAN_PLAIN_CALLS) == \
        (counts[0] + 2, counts[1] + 2)
    # --newton: two lines more, the Newton work of the plain scans
    tool.main(["--device", "cpu", "--batch", "1", "--samples", "4",
               "--reps", "1", "--newton", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 7
    for line, name in zip(lines[5:], ("tremolo", "power amp")):
        m = re.fullmatch(r"  (.{12}) Newton over 4 samples: (\S+) calls per "
                         r"step, (\S+) eliminations per call", line)
        assert m and m.group(1).rstrip() == name, line
        assert float(m.group(2)) == 1.0 and float(m.group(3)) >= 1.0


def test_stage_wrappers_check_their_arguments():
    st = ek.init_tremolo_scan_state(SR, 2)
    with pytest.raises(ValueError):
        ek.tremolo_scan(SR, st, torch.zeros(3, dtype=torch.float64), 4)
    with pytest.raises(TypeError):
        ek.tremolo_scan(SR, st, torch.zeros(2, dtype=torch.float32), 4)
    pa = ek.init_power_amp_scan_state(SR, 2)
    with pytest.raises(ValueError):
        ek.power_amp_scan(SR, torch.zeros((4, 3), dtype=torch.float64), pa)
    with pytest.raises(ValueError):
        ek.power_amp_scan(SR, torch.zeros((4, 2), dtype=torch.float64),
                          pa[:, :1].contiguous().repeat(1, 2)[:, :1])
