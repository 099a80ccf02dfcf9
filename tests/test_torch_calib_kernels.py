"""The calibration sweep's kernels' plain versions in the PyTorch port
against the JAX package's scans (CPU, float64).

  * E4<tap> (`kernels/render.voice_tap`, run_calibrate's T1 and T2): the
    reed alone into the pickup, on run_calibrate's own host packing,
    against the reference's `reed.render` and a scan of `pickup.step`
    (`openwurli_tpu/calib/calibrate.py:74-103`). Target: the reed's and
    the pickup's samples within 1e-12 of each column's peak. The pickup's
    output, (q·(1 − y) − 1)·S with q ≈ 1, carries XLA's multiply-add
    contractions of the charge update (ROADMAP queue 3): a column that
    misses the target is gated at the reference's own response to a
    1-ulp perturbation of the pickup's charge entering every sample (two
    seeds, the larger) + 3 dB. The reed is held to the target alone.
  * E6 (`kernels/render.pa_speaker_scan`, T5): volume², the power amp with
    rail sag, the speaker, the post-speaker gain, against the reference's
    `power_amp.step` and `speaker.step` per sample (`calibrate.py:
    123-137`). Target: every output column and state row within 1e-12 of
    its magnitude; where the power amp's f32 Newton solve misses that, the
    gate of `test_torch_engine_steps.py`: the reference's own response to
    1-ulp perturbations (its solver params, its state entering every
    sample, its inputs, the f32 solve's inputs), the larger of two seeds,
    + 3 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import hammer as jhammer
from openwurli_tpu import pickup as jpickup
from openwurli_tpu import reed as jreed
from openwurli_tpu import tables as jtables
from openwurli_tpu import variation as jvariation
from openwurli_tpu.circuits import mna as jmna
from openwurli_tpu.circuits import power_amp as jpa
from openwurli_tpu.circuits import speaker as jspk
from openwurli_tpu_torch import tables
from openwurli_tpu_torch.calib import calibrate
from openwurli_tpu_torch.kernels import render as kr
from test_torch_engine_steps import (assert_gate, f32_solve_twin, np_tree,
                                     ulp, ulp_twin)

torch.set_num_threads(1)

SR = 44100.0
TARGET = 1e-12
GATE_DB = 3.0


def _grid():
    g, v = (a.ravel() for a in np.meshgrid(
        np.array([33.0, 60.0, 96.0]), np.array([1.0, 64.0, 127.0]) / 127.0,
        indexing="ij"))
    return g, v


def _jax_taps(g, v, n, twin=0):
    """The reference's T1 and T2 (calibrate.py:74-103) → (reed, t2); twin
    k > 0 moves the pickup's charge entering every sample by one ulp
    (random directions from seed k)."""
    gj, vj = jnp.asarray(g), jnp.asarray(v)
    params = jtables.note_params(gj)
    freq = params["fundamental_hz"]
    ds_actual = jtables.pickup_displacement_scale(
        gj, jtables.CalibrationConfig())
    detuned = freq * jvariation.freq_detune(gj)
    dwell = jhammer.dwell_attenuation(vj, detuned, params["mode_ratios"])
    amp_offsets = jvariation.mode_amplitude_offsets(gj)
    vel_scale = jtables.velocity_scurve(vj) ** jtables.velocity_exponent(gj)
    amplitudes = (params["mode_amplitudes"] * dwell * amp_offsets
                  * vel_scale[..., None])
    reed_params = jreed.make_params(
        detuned, params["mode_ratios"], amplitudes,
        params["mode_decay_rates"], jnp.zeros_like(vj), vj, SR)
    seed = gj.astype(jnp.uint32) * jnp.uint32(2654435761)
    reed_state = jreed.init_state(reed_params, seed)
    _, reed_buf = jreed.render(reed_params, reed_state, n)
    pk_params = jpickup.make_params(SR, ds_actual)
    key = jax.random.PRNGKey(twin)

    def body(st, tx):
        t, x = tx
        if twin:
            up = jax.random.bernoulli(jax.random.fold_in(key, t), 0.5,
                                      st.q.shape)
            st = st._replace(q=jnp.nextafter(
                st.q, jnp.where(up, jnp.inf, -jnp.inf)))
        return jpickup.step(pk_params, st, x)

    _, t2 = jax.lax.scan(body, jpickup.init_state(gj.shape),
                         (jnp.arange(n), reed_buf))
    return np.asarray(reed_buf), np.asarray(t2)


def _col_err(a, b):
    return np.abs(a - b).max(axis=0) / np.abs(b).max(axis=0)


def test_voice_tap_plain_matches_reference():
    g, v = _grid()
    n = 1100  # past the renorm at n = 1024
    taps = calibrate.pack_taps(g, v, tables.CalibrationConfig(), "cpu")
    t2, reed = kr.voice_tap(*taps.cols, n)
    ref_reed, ref_t2 = _jax_taps(g, v, n)
    err = _col_err(reed.numpy(), ref_reed)
    assert (err <= TARGET).all(), err
    err = _col_err(t2.numpy(), ref_t2)
    twin = np.max([_col_err(_jax_taps(g, v, n, s)[1], ref_t2)
                   for s in (1, 2)], axis=0)
    gate = np.maximum(TARGET, twin * 10 ** (GATE_DB / 20))
    print(f"t2 port {err}, twin {twin}")
    assert (err <= gate).all(), (err, gate)
    # the pickup's displacement scale is run_calibrate's, not the voice's
    np.testing.assert_array_equal(
        taps.ds_actual.numpy(),
        tables.pickup_displacement_scale(g, tables.CalibrationConfig()))


def test_voice_tap_skips_the_noise_and_the_gain():
    """E4<tap> is voice.step without the attack noise and the post-pickup
    gain: with both set to nothing in the packed columns, E4 itself gives
    the same samples."""
    from openwurli_tpu_torch.kernels import engine as ek

    g, v = _grid()
    taps = calibrate.pack_taps(g, v, tables.CalibrationConfig(), "cpu")
    a = [c.clone() for c in taps.cols]
    b = [c.clone() for c in taps.cols]
    b[1][ek.S_NAMP] = 0.0
    out, _ = kr.voice_tap(*a, 300)
    full = kr.voice_render(*b, 300)
    assert torch.equal(out, full)
    assert torch.equal(a[1][ek.S_Q], b[1][ek.S_Q])


_JSTEPS = {}


def _jax_t5_step(twin):
    """The reference's T5 body (calibrate.py:129-134), jitted over the
    batch, volume and character traced; twin k > 0: the power amp's
    solver params moved by one ulp and its f32 Newton solve's inputs by
    one f32 ulp (seed k)."""
    if twin not in _JSTEPS:
        pa_params = jpa.make_params(SR)
        spk_params = jspk.make_params(SR)
        sp = pa_params.solver
        if twin:
            sp = ulp_twin(np_tree(sp), 7 + twin)
        cstep = jmna.make_step(jpa._cached_netlist(), sp, nr_iters=16)

        def body(pa_st, spk_st, x, volume, character):
            coeffs = jspk.coeffs_for_character(character, SR)
            orig_fn, orig_solve = jpa._step_fn, jmna.ge_solve_f32
            jpa._step_fn = lambda sr: cstep   # read while tracing only
            if twin:
                jmna.ge_solve_f32 = f32_solve_twin(twin)
            try:
                pa_st, y = jpa.step(pa_params, pa_st, x * volume * volume,
                                    rail_sag=True)
            finally:
                jpa._step_fn, jmna.ge_solve_f32 = orig_fn, orig_solve
            spk_st, z = jspk.step(spk_params, spk_st, coeffs, y)
            return pa_st, spk_st, z * jtables.POST_SPEAKER_GAIN

        _JSTEPS[twin] = jax.jit(body)
    return _JSTEPS[twin]


def _run_jax_t5(x, volume, character, twin=0):
    g = x.shape[1]
    pa_st = jpa.init_state(jpa.make_params(SR), (g,))
    spk_st = jspk.init_state((g,))
    step = _jax_t5_step(twin)
    vol, char = jnp.float64(volume), jnp.float64(character)
    outs = []
    for k in range(x.shape[0]):
        xt = x[k] if not twin else ulp(x[k], 100 * twin + k)
        if twin:
            pa_st, spk_st = ulp_twin(np_tree((pa_st, spk_st)),
                                     1000 * twin + k)
        pa_st, spk_st, z = step(pa_st, spk_st, jnp.asarray(xt), vol, char)
        outs.append(np.asarray(z))
    return _tree(np.stack(outs), np_tree(pa_st), np_tree(spk_st))


def _tree(out, pa, spk):
    """Output columns and end state as gate rows."""
    rows = {f"out{j}": out[:, j] for j in range(out.shape[1])}
    c = pa.circuit
    rows.update(v=c.v, i_nl=c.i_nl, v_nl=c.v_nl,
                rails=np.stack([np.asarray(r) for r in pa.rails]),
                last_good=pa.last_good,
                spk=np.stack([spk.hpf.z1, spk.hpf.z2, spk.lpf.z1, spk.lpf.z2,
                              spk.thermal_state]))
    rows["diag"] = np.stack([np.asarray(d, np.float64) for d in c.diag])
    return rows


@pytest.mark.parametrize("character", [1.0, 0.0])
def test_pa_speaker_plain_matches_reference(character):
    n, volume = 96, 0.4
    t = np.arange(n)
    x = np.stack([0.3 * np.sin(t * 0.05), 2.0 * np.sin(t * 0.11),
                  0.02 * np.sin(t * 0.3), 40.0 * np.sin(t * 0.07)], axis=1)
    st = kr.init_pa_speaker_state(SR, x.shape[1])
    out = kr.pa_speaker_scan(SR, torch.from_numpy(x.copy()), st, volume,
                             character)
    pa, spk = kr.pa_speaker_unrows(st)
    port = _tree(out.numpy(), np_tree(jax.tree.map(
        lambda a: a.numpy(), pa)), np_tree(jax.tree.map(
            lambda a: a.numpy(), spk)))
    ref = _run_jax_t5(x, volume, character)
    np.testing.assert_array_equal(port["diag"], ref["diag"])
    twins = [_run_jax_t5(x, volume, character, s) for s in (1, 2)]
    assert_gate(f"E6 plain, character {character}", port, ref, *twins)
