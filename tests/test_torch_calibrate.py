"""`calib.calibrate.run_calibrate` in the PyTorch port against the JAX
package's (CPU, float64), on a 2-note × 2-velocity grid.

`DURATION_S` and the measurement window are patched the same way in both
modules, to a 20 ms render (the plain power amp costs ~15 ms per sample
on one core). Target: every CSV column of the taps T1-T3, and the
columns that depend on them alone, within 1e-9 dB (y_peak and ds_actual
within 1e-9 relative). T4 (the DK preamp) and T5 (power amp, speaker)
carry the reference's XLA roundings: the DK preamp's main − shadow
cancellation (ROADMAP queue 3) and the power amp's f32 Newton solve. Their
columns are gated at the reference's own response to 1-ulp perturbations
(the DK state entering every step, the power amp's solver params and its
f32 solve's inputs), the larger of two seeds, + 3 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu.calib import calibrate as jcal
from openwurli_tpu.circuits import dk_preamp as jdk
from openwurli_tpu.circuits import mna as jmna
from openwurli_tpu.circuits import power_amp as jpa
from openwurli_tpu_torch.calib import calibrate
from test_torch_engine_steps import f32_solve_twin, np_tree, ulp_twin

torch.set_num_threads(1)

GATE_DB = 3.0
EXACT_COLS = ("midi", "velocity", "ds_at_c4", "trim_db")
RELATIVE_COLS = ("ds_actual", "y_peak")
DB_COLS = ("t2_peak_db", "t2_rms_db", "t2_h2_h1_db", "t3_peak_db",
           "t3_rms_db", "proxy_db", "proxy_error_db")
TWIN_COLS = ("t4_peak_db", "t4_rms_db", "t4_h2_h1_db", "t5_peak_db",
             "t5_rms_db", "t5_h2_h1_db", "tanh_compression_db")
NOTES, VELOCITIES = [40, 80], [30, 127]


class _NudgedDK:
    """The reference's dk_preamp module with the state entering every step
    moved by one ulp (directions drawn from `seed` and the step's input
    bits)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __getattr__(self, name):
        return getattr(jdk, name)

    def step(self, params, pre, g, x):
        bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
        key = jax.random.fold_in(self.key, jnp.sum(bits, dtype=jnp.uint32))
        leaves, tdef = jax.tree.flatten(pre)
        keys = jax.random.split(key, len(leaves))
        pre = jax.tree.unflatten(tdef, [
            jnp.nextafter(a, jnp.where(jax.random.bernoulli(k, 0.5, a.shape),
                                       jnp.inf, -jnp.inf))
            if a.dtype == jnp.float64 else a for a, k in zip(leaves, keys)])
        return jdk.step(params, pre, g, x)


def _twin(seed):
    """The reference's run_calibrate with the DK and power-amp twins."""
    sp = ulp_twin(np_tree(jpa.make_params(calibrate.BASE_SR).solver),
                  7 + seed)
    cstep = jmna.make_step(jpa._cached_netlist(), sp, nr_iters=16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcal, "dk_preamp", _NudgedDK(seed))
        mp.setattr(jpa, "_step_fn", lambda sr: cstep)
        mp.setattr(jmna, "ge_solve_f32", f32_solve_twin(seed))
        return jcal.run_calibrate(NOTES, VELOCITIES)


def test_run_calibrate_matches_reference(monkeypatch):
    for mod in (jcal, calibrate):
        monkeypatch.setattr(mod, "DURATION_S", 0.02)
        monkeypatch.setattr(mod, "MEASURE_START_S", 0.004)
        monkeypatch.setattr(mod, "MEASURE_END_S", 0.018)
    port = calibrate.run_calibrate(NOTES, VELOCITIES, device="cpu")
    ref = jcal.run_calibrate(NOTES, VELOCITIES)
    assert set(port) == set(ref)
    assert set(port) == set(EXACT_COLS + RELATIVE_COLS + DB_COLS
                            + TWIN_COLS)
    for k in port:
        assert port[k].shape == (2, 2) and np.isfinite(port[k]).all(), k
    for k in EXACT_COLS:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    for k in RELATIVE_COLS:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-9, atol=0,
                                   err_msg=k)
    for k in DB_COLS:
        np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=1e-9,
                                   err_msg=k)
    twins = [_twin(s) for s in (1, 2)]
    for k in TWIN_COLS:
        err = np.abs(port[k] - ref[k])
        twin = np.max([np.abs(t[k] - ref[k]) for t in twins], axis=0)
        gate = np.maximum(1e-9, twin * 10 ** (GATE_DB / 20))
        print(f"{k}: port {err.max():.3g} dB, twin {twin.max():.3g} dB")
        assert (err <= gate).all(), (k, err, gate)


def test_calibrate_csv_matches_reference(tmp_path):
    """The CSV writer's 21 columns and formatting, on the same rows."""
    rng = np.random.default_rng(3)
    rows = {k: rng.normal(size=(2, 3)) * 10 for k in
            EXACT_COLS + RELATIVE_COLS + DB_COLS + TWIN_COLS}
    rows["midi"] = np.array([[21.0] * 3, [108.0] * 3])
    rows["velocity"] = np.array([[1.0, 64.0, 127.0]] * 2)
    a, b = tmp_path / "port.csv", tmp_path / "ref.csv"
    calibrate.write_calibrate_csv(a, rows)
    jcal.write_calibrate_csv(b, rows)
    assert a.read_text() == b.read_text()
    assert [calibrate.midi_note_name(m) for m in (21, 60, 61, 108)] == \
        ["A0", "C4", "C#4", "C8"]
